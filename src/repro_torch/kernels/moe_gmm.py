"""Grouped matmul, the MoE expert FFN's hot loop: rows of ``x [T, D]`` are
sorted by expert, expert e owns the next ``group_sizes[e]`` rows, and row t
of the output is ``x[t] @ w[expert_of(t)]`` with ``w [E, D, F]``, f32
accumulation, output in x's dtype. Rows past ``sum(group_sizes)`` belong to
no expert and come out as zeros. ``moe_gmm_gated`` computes a gated FFN's
first half, ``act(x @ wi[e]) * (x @ wg[e])`` (act silu or tanh gelu), in
one launch: x is read once for both products, and the activation and the
product are applied in f32 and rounded once.

Port of the Pallas TPU kernel ``src/repro/kernels/moe_gmm.py::moe_gmm``. The
CUDA kernels are ``csrc/moe_gmm.cu`` (its header says what bounds them on
the card and how they are laid out); ``moe_gmm_plain`` and
``moe_gmm_gated_plain`` are the same functions in plain PyTorch. The
wrappers take the plain versions only for CPU tensors; for CUDA tensors
they launch a kernel or raise. ``gmm_route`` picks the kernel from dtype,
shape and alignment: ``"f32"`` (CUDA cores), ``"wgmma"`` (bf16 with many
rows an expert: warp-specialised ``wgmma`` fed by TMA; widths a multiple of
8 and 16-byte aligned pointers) or ``"small"`` (bf16 otherwise: ``wmma`` on
16-row tiles, the decode step's route). Unlike the Pallas kernel, which
needs every group size to be a multiple of its row tile, any sizes work,
and they stay on the device: nothing here reads them on the host.

Registered as the custom ops ``repro_torch::moe_gmm`` and
``repro_torch::moe_gmm_gated`` with fake (shape-only) implementations and
flop formulas ``2·T·D·F`` and ``4·T·D·F``: T is the static row count, so
the probe charges the worst case, every row computed. ``LAUNCHES`` counts
every launch of either op's kernel; ``GATED_LAUNCHES`` the gated op's alone.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()
GATED_LAUNCHES = build.LaunchCounter()
MAX_EXPERTS = 256
ACTS = {"silu_gated": 1, "gelu_gated": 2}
ROUTES = {"small": 0, "wgmma": 1, "f32": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_GATED_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
# every C entry point of csrc/moe_gmm.cu with its ctypes signature
ENTRY_POINTS = {"repro_moe_gmm": _ARGTYPES, "repro_moe_gmm_gated": _GATED_ARGTYPES}


def gmm_route(dtype: torch.dtype, t: int, d: int, f: int, e: int,
              aligned: bool) -> str:
    """The kernel for these operands: ``"f32"`` for float32; for bfloat16
    ``"wgmma"`` where TMA can take them (d and f multiples of 8, d > 0,
    every pointer 16-byte aligned: ``aligned``) and there are more than 16
    rows an expert on average, else ``"small"``."""
    if dtype == torch.float32:
        return "f32"
    if d % 8 or f % 8 or d == 0 or not aligned or t <= 16 * e:
        return "small"
    return "wgmma"


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


def gated_act(h: torch.Tensor, act: str) -> torch.Tensor:
    """The gate's activation: silu, or gelu with the tanh approximation."""
    if act == "silu_gated":
        return F.silu(h)
    return F.gelu(h, approximate="tanh")


def moe_gmm_gated_plain(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                        group_sizes: torch.Tensor, act: str) -> torch.Tensor:
    """``act(moe_gmm_plain(x, wi)) * moe_gmm_plain(x, wg)``, both products,
    the activation and the product in f32, cast to x's dtype once."""
    xf = x.float()
    h = gated_act(moe_gmm_plain(xf, wi.float(), group_sizes), act) \
        * moe_gmm_plain(xf, wg.float(), group_sizes)
    return h.to(x.dtype)


def _check(x: torch.Tensor, ws, group_sizes: torch.Tensor) -> None:
    w = ws[0]
    if x.dtype not in _DTYPES or any(v.dtype != x.dtype for v in ws):
        raise TypeError(f"moe_gmm kernel takes float32/bfloat16 x and w of "
                        f"one dtype, got {x.dtype}, "
                        f"{[v.dtype for v in ws]}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1] \
            or any(v.shape != w.shape for v in ws) \
            or group_sizes.shape != (w.shape[0],) \
            or not 1 <= w.shape[0] <= MAX_EXPERTS:
        raise ValueError(f"moe_gmm kernel: x {tuple(x.shape)}, w "
                         f"{[tuple(v.shape) for v in ws]}, group_sizes "
                         f"{tuple(group_sizes.shape)} (want [T, D], [E, D, F]"
                         f", [E], 1 <= E <= {MAX_EXPERTS})")
    if any(t.device != x.device for t in (*ws, group_sizes)):
        raise ValueError("moe_gmm kernel needs x, w and group_sizes on one "
                         "device")
    if not (x.is_contiguous() and all(v.is_contiguous() for v in ws)):
        raise ValueError("moe_gmm kernel needs contiguous x and w")
    if max(*x.shape, w.shape[2]) >= 2 ** 31:
        raise ValueError(f"moe_gmm kernel: dims {tuple(x.shape)}, "
                         f"{w.shape[2]} exceed int32")


def _launch(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
            wg=None, act=None, route=None) -> torch.Tensor:
    """One launch of the kernel ``route`` names (by default ``gmm_route``'s
    choice): the plain product, or with ``wg`` and ``act`` the gated one."""
    ws = (w,) if wg is None else (w, wg)
    _check(x, ws, group_sizes)
    t, d = x.shape
    e, _, f = w.shape
    out = torch.empty((t, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    aligned = all(v.data_ptr() % 16 == 0 for v in (x, *ws, out))
    if route is None:
        route = gmm_route(x.dtype, t, d, f, e, aligned)
    if route not in ROUTES or (route == "f32") != (x.dtype == torch.float32):
        raise ValueError(f"moe_gmm: no route {route!r} for {x.dtype}")
    sizes = group_sizes.to(torch.int32).contiguous()  # stays on the card
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (t, d, f, e, _DTYPES[x.dtype], ROUTES[route])
        if wg is None:
            fn = build.load("moe_gmm", "repro_moe_gmm", _ARGTYPES)
            rc = fn(x.data_ptr(), w.data_ptr(), sizes.data_ptr(),
                    out.data_ptr(), *args, stream)
        else:
            fn = build.load("moe_gmm", "repro_moe_gmm_gated",
                            _GATED_ARGTYPES)
            rc = fn(x.data_ptr(), w.data_ptr(), wg.data_ptr(),
                    sizes.data_ptr(), out.data_ptr(), *args, ACTS[act],
                    stream)
    build.check(rc, f"moe_gmm ({route} route)")
    LAUNCHES.add()
    if wg is not None:
        GATED_LAUNCHES.add()
    return out


def _device_check(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")


@torch.library.custom_op("repro_torch::moe_gmm", mutates_args=())
def _gmm_op(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w, group_sizes)
    _device_check(x, "moe_gmm")
    return _launch(x, w, group_sizes)


@_gmm_op.register_fake
def _(x, w, group_sizes):
    return x.new_empty((x.shape[0], w.shape[2]))


@register_flop_formula(torch.ops.repro_torch.moe_gmm, get_raw=True)
def _gmm_flops(x, w, group_sizes, *args, **kwargs):
    return 2 * x.shape[0] * x.shape[1] * w.shape[2]


@torch.library.custom_op("repro_torch::moe_gmm_gated", mutates_args=())
def _gated_op(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
              group_sizes: torch.Tensor, act: str) -> torch.Tensor:
    if act not in ACTS:
        raise ValueError(f"moe_gmm_gated: unknown act {act!r} (want one of "
                         f"{sorted(ACTS)})")
    if x.device.type == "cpu":
        return moe_gmm_gated_plain(x, wi, wg, group_sizes, act)
    _device_check(x, "moe_gmm_gated")
    return _launch(x, wi, group_sizes, wg=wg, act=act)


@_gated_op.register_fake
def _(x, wi, wg, group_sizes, act):
    return x.new_empty((x.shape[0], wi.shape[2]))


@register_flop_formula(torch.ops.repro_torch.moe_gmm_gated, get_raw=True)
def _gated_flops(x, wi, wg, group_sizes, *args, **kwargs):
    return 4 * x.shape[0] * x.shape[1] * wi.shape[2]


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """x [T, D] sorted by expert, w [E, D, F], group_sizes [E] int (on x's
    device) -> [T, F] in x's dtype; rows past the groups are zeros."""
    return torch.ops.repro_torch.moe_gmm(x, w, group_sizes)


def moe_gmm_gated(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                  group_sizes: torch.Tensor, act: str) -> torch.Tensor:
    """``act(x @ wi[e]) * (x @ wg[e])`` per row in one launch, ``act`` one
    of ``"silu_gated"``, ``"gelu_gated"``; shapes and rows past the groups
    as ``moe_gmm``."""
    return torch.ops.repro_torch.moe_gmm_gated(x, wi, wg, group_sizes, act)
