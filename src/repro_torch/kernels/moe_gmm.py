"""Grouped matmul, the MoE expert FFN's hot loop: rows of ``x [T, D]`` are
sorted by expert, expert e owns the next ``group_sizes[e]`` rows, and row t
of the output is ``x[t] @ w[expert_of(t)]`` with ``w [E, D, F]``, f32
accumulation, output in x's dtype. Rows past ``sum(group_sizes)`` belong to
no expert and come out as zeros.

Port of the Pallas TPU kernel ``src/repro/kernels/moe_gmm.py::moe_gmm``. The
CUDA kernel is ``csrc/moe_gmm.cu`` (its header says what bounds it on the
card and how it is laid out); ``moe_gmm_plain`` is the same function in
plain PyTorch. ``moe_gmm`` takes the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises. Unlike the Pallas kernel,
which needs every group size to be a multiple of its row tile, any sizes
work, and they stay on the device: nothing here reads them on the host.

Registered as the custom op ``repro_torch::moe_gmm`` with a fake
(shape-only) implementation and a flop formula ``2·T·D·F``: T is the static
row count, so the probe charges the worst case, every row computed.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()
MAX_EXPERTS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor,
                  group_sizes: torch.Tensor) -> torch.Tensor:
    """x [T, D], w [E, D, F], group_sizes [E] -> [T, F] in x's dtype. One
    product of all rows per expert, kept where the row is that expert's
    (the reference's ``searchsorted(cumsum(group_sizes), arange(T),
    right)``; E for rows past the groups): static shapes, so it also runs
    inside a CUDA graph (the reference's ``w[expert_of]`` gather would make
    a [T, D, F] copy of the weights)."""
    t, f = x.shape[0], w.shape[2]
    bounds = torch.cumsum(group_sizes.clamp(min=0), 0)
    rows = torch.arange(t, device=x.device, dtype=bounds.dtype)
    expert_of = torch.searchsorted(bounds, rows, right=True)[:, None]
    out = torch.zeros((t, f), dtype=x.dtype, device=x.device)
    for e in range(w.shape[0]):
        out = torch.where(expert_of == e, x @ w[e], out)
    return out


def _launch(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
            few_rows=None) -> torch.Tensor:
    """``few_rows`` picks the bf16 kernel's 16-row tile; by default it is
    taken when there are at most 16 rows an expert on average."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"moe_gmm kernel takes float32/bfloat16 x and w of "
                        f"one dtype, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1] \
            or group_sizes.shape != (w.shape[0],) \
            or not 1 <= w.shape[0] <= MAX_EXPERTS:
        raise ValueError(f"moe_gmm kernel: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)} (want [T, D], [E, D, F]"
                         f", [E], 1 <= E <= {MAX_EXPERTS})")
    if not (x.device == w.device == group_sizes.device):
        raise ValueError("moe_gmm kernel needs x, w and group_sizes on one "
                         "device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gmm kernel needs contiguous x and w")
    t, d = x.shape
    e, _, f = w.shape
    if max(t, d, f) >= 2 ** 31:
        raise ValueError(f"moe_gmm kernel: dims {t}, {d}, {f} exceed int32")
    out = torch.empty((t, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if few_rows is None:
        few_rows = t <= 16 * e
    sizes = group_sizes.to(torch.int32).contiguous()  # stays on the card
    fn = build.load("moe_gmm", "repro_moe_gmm", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), sizes.data_ptr(), out.data_ptr(),
                t, d, f, e, _DTYPES[x.dtype], int(few_rows), stream)
    build.check(rc, "moe_gmm")
    LAUNCHES.add()
    return out


@torch.library.custom_op("repro_torch::moe_gmm", mutates_args=())
def _gmm_op(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w, group_sizes)
    if x.device.type != "cuda":
        raise RuntimeError(f"moe_gmm: no kernel for device {x.device}")
    return _launch(x, w, group_sizes)


@_gmm_op.register_fake
def _(x, w, group_sizes):
    return x.new_empty((x.shape[0], w.shape[2]))


@register_flop_formula(torch.ops.repro_torch.moe_gmm, get_raw=True)
def _gmm_flops(x, w, group_sizes, *args, **kwargs):
    return 2 * x.shape[0] * x.shape[1] * w.shape[2]


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x [T, D] sorted by expert, w [E, D, F], group_sizes [E] int (on x's
    device) -> [T, F] in x's dtype; rows past the groups are zeros."""
    return torch.ops.repro_torch.moe_gmm(x, w, group_sizes)
