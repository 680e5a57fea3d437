"""Forward flash attention: causal attention with GQA, tanh logit softcap and
a sliding window, f32 accumulation, output in q's dtype.

Port of the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention``. The CUDA kernel is
``csrc/flash_attention.cu`` (its header says what bounds it on the card and
how it is laid out) with two routes picked by dtype: bfloat16 on the tensor
cores (wgmma fed by TMA, helpers in ``csrc/hopper.cuh``), float32 on the CUDA
cores. ``flash_attention_plain`` is the same function in plain PyTorch.
``flash_attention`` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. Unlike the Pallas wrapper
(``src/repro/kernels/ops.py:24-27``) the window is a runtime int, so gemma2's
alternating per-layer window goes through the kernel, and Sq, Sk need not
divide any block size.

Registered as the custom op ``repro_torch::flash_attention`` with a fake
(shape-only) implementation and a flop formula, so the probe's trace passes
through it and counts ``4 * B * Hq * (visible q-k pairs) * D`` flops.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
             _I, _I, ctypes.c_float, _I, _P]


def visible_mask(sq: int, sk: int, *, causal: bool, window: int,
                 device=None) -> torch.Tensor:
    """[Sq, Sk] bool, True = attend: top-left causal (q_pos starts at 0) and
    the window rule ``q - k < window`` (window <= 0: none)."""
    delta = (torch.arange(sq, device=device)[:, None]
             - torch.arange(sk, device=device)[None, :])
    m = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        m &= delta >= 0
    if window > 0:
        m &= delta < window
    return m


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          logit_softcap: float = 0.0) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] -> [B, Hq, Sq, D]."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    kr = k.float().repeat_interleave(g, dim=1)
    vr = v.float().repeat_interleave(g, dim=1)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    mask = visible_mask(sq, sk, causal=causal, window=window, device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def tma_strides(t: torch.Tensor) -> tuple:
    """Element strides of dims B, H, S; a dim of size 0 or 1 takes the
    stride it would have if dense (its own stride is never used, and TMA
    checks it)."""
    out, dense = [0, 0, 0], t.shape[3]
    for i in (2, 1, 0):
        out[i] = dense if t.shape[i] <= 1 else t.stride(i)
        dense = out[i] * max(t.shape[i], 1)
    return tuple(out)


def check_tma_layout(q, k, v, strides) -> None:
    """The bf16 route reads q, k, v with TMA: each must start on 16 bytes
    and every stride must be a multiple of 16 bytes (8 elements). A layout
    that breaks this raises; nothing is copied behind the caller's back."""
    for name, t, st in zip("qkv", (q, k, v), strides):
        if t.data_ptr() % 16 or any(x % 8 for x in st):
            raise ValueError(
                f"flash kernel (bf16, TMA): {name} needs a 16-byte aligned "
                f"start and B, H, S strides that are multiples of 8 "
                f"elements, got data_ptr % 16 = {t.data_ptr() % 16}, "
                f"strides {st}")


def _launch(q, k, v, causal: bool, window: int,
            logit_softcap: float) -> torch.Tensor:
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes float32/bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash kernel: unsupported shapes q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)} (head dim "
                         f"in {HEAD_DIMS}, Hq a multiple of Hkv)")
    if any(t.stride(-1) != 1 for t in (q, k, v)) \
            or not (q.device == k.device == v.device):
        raise ValueError("flash kernel needs unit stride along the head dim "
                         "and q, k, v on one device")
    strides = [tma_strides(t) for t in (q, k, v)]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        check_tma_layout(q, k, v, strides)
    fn = build.load("flash_attention", "repro_flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, sq, sk, d,
                *strides[0], *strides[1], *strides[2],
                int(causal), int(window), float(logit_softcap),
                _DTYPES[q.dtype], stream)
    build.check(rc, "flash_attention")
    LAUNCHES.add()
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, logit_softcap: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v, causal, window, logit_softcap)


@_flash_op.register_fake
def _(q, k, v, causal, window, logit_softcap):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def visible_pairs(sq: int, sk: int, *, causal: bool, window: int) -> int:
    """Number of (q, k) pairs the mask lets through, computed per row."""
    total = 0
    for qp in range(sq):
        hi = min(qp + 1, sk) if causal else sk
        lo = max(qp - window + 1, 0) if window > 0 else 0
        total += max(hi - lo, 0)
    return total


@register_flop_formula(torch.ops.repro_torch.flash_attention, get_raw=True)
def _flash_flops(q, k, v, causal, window, logit_softcap, *args, **kwargs):
    b, hq, sq, d = q.shape
    return 4 * b * hq * d * visible_pairs(sq, k.shape[2], causal=causal,
                                          window=window)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] -> [B, Hq, Sq, D]."""
    return torch.ops.repro_torch.flash_attention(
        q, k, v, bool(causal), int(window or 0), float(logit_softcap or 0.0))
