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

A row that sees no key (top-left causal with Sq > Sk and a window: the
rows from Sk + window - 1 on) gets o = 0 and lse = +inf on every route, the
two card routes and the plain versions, so the backward passes it no
gradient: attention over no keys has no weights (ROADMAP C10; the JAX
package's ``naive_attention`` gives V's mean there).

Registered as the custom op ``repro_torch::flash_attention`` with a fake
(shape-only) implementation and a flop formula, so the probe's trace passes
through it and counts ``4 * B * Hq * (visible q-k pairs) * D`` flops.

Training goes through a second op, ``repro_torch::flash_attention_lse``,
``(o, lse)``: the same kernel launch, which also writes each row's natural-log
log-sum-exp (f32 ``[B, Hq, Sq]``; both routes). It is differentiable
(``torch.library.register_autograd``): it saves ``(q, k, v, o, lse)`` and
nothing of size Sq x Sk, and its backward is the op
``repro_torch::flash_attention_bwd``, ``(dq, dk, dv)``, the port of the
reference's recompute backward (``_make_flash_cvjp``,
``src/repro/models/layers.py:215``): on a CUDA tensor the backward kernels of
``csrc/flash_attention.cu`` (two routes picked by dtype: bfloat16 on the
tensor cores, wgmma fed by TMA, P and dS rounded to bf16 where they feed a
product; float32 on the CUDA cores with ``cp.async`` double-buffered tiles;
f32 accumulation and no atomics on both), on a CPU tensor
``flash_attention_bwd_plain``. Its flop formula is
``10 * B * Hq * (visible pairs) * D``: five products against the forward's
two. ``BWD_LAUNCHES`` counts the backward's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()
BWD_LAUNCHES = build.LaunchCounter()
NEG_INF = -1e30
# the head dims both routes are built for (zamba2-2.7b's 80 is staged as
# 128 columns on the tensor cores; nemotron-4-340b's 192 takes 64-key tiles)
HEAD_DIMS = (32, 64, 80, 128, 192, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
             _I, _I, ctypes.c_float, _I, _P]
_BWD_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                 _I, _I, _I, ctypes.c_float, _I, _P]
# every C entry point of csrc/flash_attention.cu with its ctypes signature
ENTRY_POINTS = {"repro_flash_attention": _ARGTYPES,
                "repro_flash_attention_bwd": _BWD_ARGTYPES}


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Arithmetic type of the plain versions: f32, or f64 for f64 inputs
    (``torch.autograd.gradcheck``)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


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
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] -> [B, Hq, Sq, D]. A row
    that sees no key (top-left causal, Sq > Sk and a window) gets zeros."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    acc = _acc(q.dtype)
    kr = k.to(acc).repeat_interleave(g, dim=1)
    vr = v.to(acc).repeat_interleave(g, dim=1)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kr) * scale
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    mask = visible_mask(sq, sk, causal=causal, window=window, device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=acc,
                                        device=q.device))
    # a row that sees no key has no weights: zeros (C10)
    p = torch.where(mask.any(-1, keepdim=True), torch.softmax(s, dim=-1),
                    torch.zeros((), dtype=acc, device=q.device))
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def _masked_scores(q, k, *, causal: bool, window: int, logit_softcap: float,
                   acc: torch.dtype, k_start: int = 0):
    """Scaled, capped scores of q against k (GQA: k repeated to Hq heads)
    for keys from ``k_start``, masked to NEG_INF, and the mask."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    kr = k.to(acc).repeat_interleave(hq // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kr) * (1.0 / math.sqrt(d))
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    mask = visible_mask(sq, k_start + k.shape[2], causal=causal,
                        window=window, device=q.device)[:, k_start:]
    return torch.where(mask, s, torch.full((), NEG_INF, dtype=acc,
                                           device=q.device)), mask


def flash_attention_lse_plain(q, k, v, *, causal: bool = True,
                              window: int = 0, logit_softcap: float = 0.0):
    """(o in q's dtype, lse f32 [B, Hq, Sq]; f64 throughout for f64 q):
    the forward and each row's log-sum-exp of its masked scores; a row that
    sees no key gets o = 0 and lse = +inf."""
    acc = _acc(q.dtype)
    s, mask = _masked_scores(q, k, causal=causal, window=window,
                             logit_softcap=logit_softcap, acc=acc)
    # a row that sees no key: lse = +inf, so that exp(s - lse) = 0 gives
    # o = 0 here and no gradient in the backward (C10)
    lse = torch.where(mask.any(-1), torch.logsumexp(s, dim=-1),
                      torch.full((), math.inf, dtype=acc, device=q.device))
    p = torch.exp(s - lse[..., None])
    vr = v.to(acc).repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, logit_softcap: float = 0.0,
                              block_k: int = 512):
    """(dq, dk, dv): the reference's recompute backward (``bwd`` of
    ``_make_flash_cvjp``, ``src/repro/models/layers.py:242-294``) over KV
    blocks of ``block_k`` keys: delta = rowsum(dO O), P = exp(s - lse)
    and dS = P (dP - delta) times (1 - (s / cap)^2) under a softcap, both
    zero where masked (so a row that sees no key passes no gradient);
    dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), dV = P^T dO, dK and dV
    summed over the query heads of each KV head. f32 (f64 for f64
    inputs); the results in the inputs' dtypes."""
    acc = _acc(q.dtype)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.to(acc), do.to(acc)
    delta = (dof * o.to(acc)).sum(dim=-1)
    lse = lse.to(acc)
    dq = torch.zeros(b, hq, sq, d, dtype=acc, device=q.device)
    dk = torch.empty(b, hkv, sk, d, dtype=acc, device=q.device)
    dv = torch.empty(b, hkv, sk, d, dtype=acc, device=q.device)
    for j in range(0, sk, block_k):
        kj, vj = k[:, :, j:j + block_k], v[:, :, j:j + block_k]
        n = kj.shape[2]
        s, mask = _masked_scores(q, kj, causal=causal, window=window,
                                 logit_softcap=logit_softcap, acc=acc,
                                 k_start=j)
        zero = torch.zeros((), dtype=acc, device=q.device)
        p = torch.where(mask, torch.exp(s - lse[..., None]), zero)
        vjr = vj.to(acc).repeat_interleave(g, dim=1)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vjr)
        ds = p * (dp - delta[..., None])
        if logit_softcap:
            ds = ds * (1.0 - torch.square(s / logit_softcap))
        ds = torch.where(mask, ds, zero)
        kjr = kj.to(acc).repeat_interleave(g, dim=1)
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kjr) * scale
        dkj = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
        dvj = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        dk[:, :, j:j + n] = dkj.reshape(b, hkv, g, n, d).sum(dim=2)
        dv[:, :, j:j + n] = dvj.reshape(b, hkv, g, n, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def rows_on_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the f32 route can copy its rows with 16-byte
    ``cp.async`` (a 16-byte aligned start, B, H, S strides that are
    multiples of 4 elements), else a dense copy: unlike the bf16 route's
    TMA, which raises, this route takes any view."""
    if t.data_ptr() % 16 == 0 and all(x % 4 == 0 for x in tma_strides(t)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v, causal: bool, window: int, logit_softcap: float,
            lse: bool = False):
    """The forward kernel's output, and with ``lse`` the rows'
    log-sum-exp as well (a pair)."""
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
    if q.dtype == torch.float32:
        q, k, v = (rows_on_16_bytes(t) for t in (q, k, v))
    strides = [tma_strides(t) for t in (q, k, v)]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rows = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) \
        if lse else None
    if out.numel() == 0:
        return (out, rows) if lse else out
    if q.dtype == torch.bfloat16:
        check_tma_layout(q, k, v, strides)
    fn = build.load("flash_attention", "repro_flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                rows.data_ptr() if lse else None, b, hq, hkv, sq, sk, d,
                *strides[0], *strides[1], *strides[2],
                int(causal), int(window), float(logit_softcap),
                _DTYPES[q.dtype], stream)
    build.check(rc, "flash_attention")
    LAUNCHES.add()
    return (out, rows) if lse else out


def _launch_bwd(q, k, v, o, lse, do, causal: bool, window: int,
                logit_softcap: float):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == o.dtype == do.dtype) \
            or q.dtype not in _DTYPES or lse.dtype != torch.float32:
        raise TypeError(f"flash backward kernel takes float32/bfloat16 q, k, "
                        f"v, o, do of one dtype and f32 lse, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}, {o.dtype}, {do.dtype}, "
                        f"{lse.dtype}")
    if d not in HEAD_DIMS or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d or hkv == 0 or hq % hkv \
            or o.shape != q.shape or do.shape != q.shape \
            or lse.shape != q.shape[:3]:
        raise ValueError(f"flash backward kernel: unsupported shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)}")
    if len({t.device for t in (q, k, v, o, lse, do)}) != 1:
        raise ValueError("flash backward kernel: inputs on one device")
    # dense rows starting on 16 bytes: the kernels move tiles in vectors
    q, k, v, o, lse, do = (
        t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
            memory_format=torch.contiguous_format)
        for t in (q, k, v, o, lse, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    # lse and delta in rows padded to a multiple of 64 (the kernels' tiles)
    scratch = torch.empty(2 * b * hq * (-(-sq // 64) * 64),
                          dtype=torch.float32, device=q.device)
    fn = build.load("flash_attention", "repro_flash_attention_bwd",
                    _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b, hq, hkv, sq, sk, d, int(causal), int(window),
                float(logit_softcap), _DTYPES[q.dtype], stream)
    build.check(rc, "flash_attention_bwd")
    BWD_LAUNCHES.add()
    return dq, dk, dv


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


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=())
def _flash_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int, logit_softcap: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, causal=causal, window=window,
                                         logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v, causal, window, logit_softcap, lse=True)


@_flash_lse_op.register_fake
def _(q, k, v, causal, window, logit_softcap):
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty(q.shape[:3], dtype=_acc(q.dtype), device=q.device))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  causal: bool, window: int, logit_softcap: float
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window,
                                         logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd: no kernel for device "
                           f"{q.device}")
    return _launch_bwd(q, k, v, o, lse, do, causal, window, logit_softcap)


@_flash_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal, window, logit_softcap):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup(ctx, inputs, output):
    q, k, v, causal, window, logit_softcap = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.mark_non_differentiable(lse)
    ctx.args = (causal, window, logit_softcap)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, o, lse, do, *ctx.args)
    return dq, dk, dv, None, None, None


torch.library.register_autograd("repro_torch::flash_attention_lse", _backward,
                                setup_context=_setup)


def visible_pairs(sq: int, sk: int, *, causal: bool, window: int) -> int:
    """Number of (q, k) pairs the mask lets through, computed per row."""
    total = 0
    for qp in range(sq):
        hi = min(qp + 1, sk) if causal else sk
        lo = max(qp - window + 1, 0) if window > 0 else 0
        total += max(hi - lo, 0)
    return total


@register_flop_formula([torch.ops.repro_torch.flash_attention,
                        torch.ops.repro_torch.flash_attention_lse],
                       get_raw=True)
def _flash_flops(q, k, v, causal, window, logit_softcap, *args, **kwargs):
    b, hq, sq, d = q.shape
    return 4 * b * hq * d * visible_pairs(sq, k.shape[2], causal=causal,
                                          window=window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd,
                       get_raw=True)
def _flash_bwd_flops(q, k, v, o, lse, do, causal, window, logit_softcap,
                     *args, **kwargs):
    b, hq, sq, d = q.shape
    return 10 * b * hq * d * visible_pairs(sq, k.shape[2], causal=causal,
                                           window=window)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] -> [B, Hq, Sq, D]. Under
    autograd (grad enabled and an input that requires it) the
    differentiable ``flash_attention_lse`` op; otherwise the forward
    alone, whose launch writes no lse."""
    args = (q, k, v, bool(causal), int(window or 0),
            float(logit_softcap or 0.0))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return torch.ops.repro_torch.flash_attention_lse(*args)[0]
    return torch.ops.repro_torch.flash_attention(*args)
