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

Both ops are differentiable (``torch.library.register_autograd``; the group
sizes take no gradient). ``moe_gmm`` saves x and w, and its backward is the
op ``repro_torch::moe_gmm_bwd``, ``(dx, dw)``: ``dx = dy w[e]^T`` per row
(zeros past the groups) and ``dw[e] = x_e^T dy_e`` (zeros for an empty
group). ``moe_gmm_gated`` saves x, wi and wg, and its backward,
``repro_torch::moe_gmm_gated_bwd``, ``(dx, dwi, dwg, dpre)``, recomputes the
two pre-activations instead of saving them (``csrc/moe_gmm.cu`` says why);
``dpre`` (``[2, T, F]``, f32 for f32 inputs and bf16 for bf16 ones:
``dpre_dtype``) holds their gradients, which the backward's products read:
it is an output so that a probe's trace charges it (0.94e9 B at
mixtral-8x7b's f32 training shape), and the autograd formula drops it. On a
CUDA tensor each launches the backward kernels of ``csrc/moe_gmm.cu`` on the
route ``gmm_bwd_route`` picks (f32 accumulation, deterministic: no atomics,
no transposed copy of w): ``"f32"`` and ``"cuda_cores"`` (bf16 widths off 8,
unaligned pointers or no rows) on the CUDA cores, ``"wgmma"`` (bf16
otherwise) on the tensor cores; on a CPU tensor ``moe_gmm_bwd_plain`` /
``moe_gmm_gated_bwd_plain``, the chain rule of the plain forwards in f32,
with dpre rounded to bf16 for bf16 inputs as the card rounds it. Flop
formulas ``4·T·D·F`` and ``12·T·D·F``. ``BWD_LAUNCHES`` counts every
backward op's launch (its kernels run in one call), ``GATED_BWD_LAUNCHES``
the gated op's alone.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()
GATED_LAUNCHES = build.LaunchCounter()
BWD_LAUNCHES = build.LaunchCounter()
GATED_BWD_LAUNCHES = build.LaunchCounter()
MAX_EXPERTS = 256
ACTS = {"silu_gated": 1, "gelu_gated": 2}
ROUTES = {"small": 0, "wgmma": 1, "f32": 0}
BWD_ROUTES = {"f32": 0, "cuda_cores": 0, "wgmma": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_GATED_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_BWD_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_GATED_BWD_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _I, _I, _P]
# every C entry point of csrc/moe_gmm.cu with its ctypes signature
ENTRY_POINTS = {"repro_moe_gmm": _ARGTYPES,
                "repro_moe_gmm_gated": _GATED_ARGTYPES,
                "repro_moe_gmm_bwd": _BWD_ARGTYPES,
                "repro_moe_gmm_gated_bwd": _GATED_BWD_ARGTYPES}


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


def gmm_bwd_route(dtype: torch.dtype, t: int, d: int, f: int,
                  aligned: bool) -> str:
    """The backward's kernels for these operands: ``"f32"`` for float32;
    for bfloat16 ``"wgmma"`` where TMA can take them (d and f multiples of
    8 and above 0, at least one row, every pointer 16-byte aligned:
    ``aligned``), else ``"cuda_cores"``."""
    if dtype == torch.float32:
        return "f32"
    if d % 8 or f % 8 or not (d and f and t) or not aligned:
        return "cuda_cores"
    return "wgmma"


def dpre_dtype(dtype: torch.dtype) -> torch.dtype:
    """The gated backward's dpre for inputs of ``dtype``: bf16 stays bf16
    (the tensor cores take bf16 operands, and the reference's bf16 autodiff
    holds these gradients in bf16 too); others keep their arithmetic
    type."""
    return torch.bfloat16 if dtype == torch.bfloat16 else _acc(dtype)


def _expert_of(t: int, group_sizes: torch.Tensor, device) -> torch.Tensor:
    """[T, 1]: each row's expert, E for rows past the groups."""
    bounds = torch.cumsum(group_sizes.clamp(min=0), 0)
    rows = torch.arange(t, device=device, dtype=bounds.dtype)
    return torch.searchsorted(bounds, rows, right=True)[:, None]


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Arithmetic type of the plain backward: f32, or f64 for f64 inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor,
                  group_sizes: torch.Tensor) -> torch.Tensor:
    """x [T, D], w [E, D, F], group_sizes [E] -> [T, F] in x's dtype. One
    product of all rows per expert, kept where the row is that expert's
    (the reference's ``searchsorted(cumsum(group_sizes), arange(T),
    right)``; E for rows past the groups): static shapes, so it also runs
    inside a CUDA graph (the reference's ``w[expert_of]`` gather would make
    a [T, D, F] copy of the weights)."""
    t, f = x.shape[0], w.shape[2]
    expert_of = _expert_of(t, group_sizes, x.device)
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
    the activation and the product in f32 (f64 for f64 inputs), cast to x's
    dtype once."""
    acc = _acc(x.dtype)
    xf = x.to(acc)
    h = gated_act(moe_gmm_plain(xf, wi.to(acc), group_sizes), act) \
        * moe_gmm_plain(xf, wg.to(acc), group_sizes)
    return h.to(x.dtype)


def moe_gmm_bwd_plain(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      group_sizes: torch.Tensor):
    """(dx [T, D] in x's dtype, dw [E, D, F] in w's) of ``moe_gmm_plain``
    for the output gradient dy [T, F]: its chain rule in f32 (f64 for f64
    inputs), rounded once. Expert e's rows: dx = dy w[e]^T, dw[e] = x_e^T
    dy_e; rows past the groups give dx = 0, an empty group dw[e] = 0."""
    acc = _acc(x.dtype)
    expert_of = _expert_of(x.shape[0], group_sizes, x.device)
    xf, yf = x.to(acc), dy.to(acc)
    dx = torch.zeros(x.shape, dtype=acc, device=x.device)
    dw = torch.empty(w.shape, dtype=acc, device=x.device)
    for e in range(w.shape[0]):
        ye = torch.where(expert_of == e, yf, yf.new_zeros(()))
        dx = dx + ye @ w[e].to(acc).T
        dw[e] = xf.T @ ye
    return dx.to(x.dtype), dw.to(w.dtype)


def _gated_act_grad(a: torch.Tensor, act: str) -> torch.Tensor:
    """d act(a) / da for ``gated_act``."""
    if act == "silu_gated":
        sg = torch.sigmoid(a)
        return sg * (1 + a * (1 - sg))
    k0, k1 = math.sqrt(2 / math.pi), 0.044715
    th = torch.tanh(k0 * (a + k1 * a ** 3))
    return 0.5 * (1 + th) + 0.5 * a * (1 - th * th) * k0 * (1 + 3 * k1 * a * a)


def moe_gmm_gated_bwd_plain(dh: torch.Tensor, x: torch.Tensor,
                            wi: torch.Tensor, wg: torch.Tensor,
                            group_sizes: torch.Tensor, act: str):
    """(dx, dwi, dwg, dpre) of ``moe_gmm_gated_plain`` for the output
    gradient dh [T, F]: the pre-activations a = x wi[e], g = x wg[e]
    recomputed, da = dh g act'(a), dg = dh act(a) (zeros past the groups;
    ``dpre`` is [da, dg] in ``dpre_dtype``: rounded to bf16 for bf16 inputs,
    as the card's kernels round them before their products), then the plain
    backward of each product, summed into dx; in f32 (f64 for f64 inputs),
    rounded once."""
    acc = _acc(x.dtype)
    xf, hf = x.to(acc), dh.to(acc)
    a = moe_gmm_plain(xf, wi.to(acc), group_sizes)
    g = moe_gmm_plain(xf, wg.to(acc), group_sizes)
    dpre = torch.stack([hf * g * _gated_act_grad(a, act),
                        hf * gated_act(a, act)]).to(dpre_dtype(x.dtype))
    return (*moe_gmm_gated_bwd_products_plain(dpre, x, wi, wg, group_sizes),
            dpre)


def moe_gmm_gated_bwd_products_plain(dpre: torch.Tensor, x: torch.Tensor,
                                     wi: torch.Tensor, wg: torch.Tensor,
                                     group_sizes: torch.Tensor):
    """(dx, dwi, dwg) of the gated pair from its pre-activations' gradients
    ``dpre`` = [da, dg] [2, T, F], the second half of
    ``moe_gmm_gated_bwd_plain``: the plain backward of each product, summed
    into dx, in f32 (f64 for f64 inputs), rounded once. Given the kernels'
    own dpre, it is their products' plain version on the same inputs: where
    da or dg is rounded to bf16, two right implementations may round an
    element near a rounding boundary apart by one bf16 unit, which dw then
    carries times x."""
    acc = _acc(x.dtype)
    xf = x.to(acc)
    da, dg = dpre.to(acc)
    dx_i, dwi = moe_gmm_bwd_plain(da, xf, wi.to(acc), group_sizes)
    dx_g, dwg = moe_gmm_bwd_plain(dg, xf, wg.to(acc), group_sizes)
    return (dx_i + dx_g).to(x.dtype), dwi.to(wi.dtype), dwg.to(wg.dtype)


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


def _launch_bwd(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                group_sizes: torch.Tensor, wg=None, act=None, route=None):
    """One call of the backward kernels on the route ``route`` names (by
    default ``gmm_bwd_route``'s choice): (dx, dw) of the plain product, or
    with ``wg`` and ``act`` (dx, dwi, dwg, dpre) of the gated one, ``dy``
    being the output's gradient."""
    ws = (w,) if wg is None else (w, wg)
    _check(x, ws, group_sizes)
    t, d = x.shape
    e, _, f = w.shape
    extra = ()
    if dy.shape != (t, f) or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"moe_gmm backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}, want ({t}, {f}) "
                         f"{x.dtype} on {x.device}")
    dy = dy.contiguous()
    dx = torch.empty((t, d), dtype=x.dtype, device=x.device)
    dws = [torch.empty(w.shape, dtype=x.dtype, device=x.device) for _ in ws]
    if wg is not None:
        # the pre-activations' gradients, [2, T, F]
        extra = (torch.empty((2, t, f), dtype=dpre_dtype(x.dtype),
                             device=x.device),)
    if route is None:
        aligned = all(v.data_ptr() % 16 == 0
                      for v in (dy, x, *ws, dx, *dws, *extra))
        route = gmm_bwd_route(x.dtype, t, d, f, aligned)
    if route not in BWD_ROUTES \
            or (route == "f32") != (x.dtype == torch.float32):
        raise ValueError(f"moe_gmm backward: no route {route!r} for "
                         f"{x.dtype}")
    sizes = group_sizes.to(torch.int32).contiguous()  # stays on the card
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        dims = (t, d, f, e, _DTYPES[x.dtype], BWD_ROUTES[route])
        if wg is None:
            fn = build.load("moe_gmm", "repro_moe_gmm_bwd", _BWD_ARGTYPES)
            rc = fn(dy.data_ptr(), x.data_ptr(), w.data_ptr(),
                    sizes.data_ptr(), dx.data_ptr(), dws[0].data_ptr(),
                    *dims, stream)
        else:
            dpre, = extra
            fn = build.load("moe_gmm", "repro_moe_gmm_gated_bwd",
                            _GATED_BWD_ARGTYPES)
            rc = fn(dy.data_ptr(), x.data_ptr(), w.data_ptr(),
                    wg.data_ptr(), sizes.data_ptr(), dpre.data_ptr(),
                    dx.data_ptr(), dws[0].data_ptr(), dws[1].data_ptr(),
                    *dims, ACTS[act], stream)
    build.check(rc, f"moe_gmm backward ({route} route)")
    BWD_LAUNCHES.add()
    if wg is not None:
        GATED_BWD_LAUNCHES.add()
    return (dx, *dws, *extra)


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


@torch.library.custom_op("repro_torch::moe_gmm_bwd", mutates_args=())
def _gmm_bwd_op(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                group_sizes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return moe_gmm_bwd_plain(dy, x, w, group_sizes)
    _device_check(x, "moe_gmm_bwd")
    return _launch_bwd(dy, x, w, group_sizes)


@_gmm_bwd_op.register_fake
def _(dy, x, w, group_sizes):
    return torch.empty_like(x), torch.empty_like(w)


@register_flop_formula(torch.ops.repro_torch.moe_gmm_bwd, get_raw=True)
def _gmm_bwd_flops(dy, x, w, group_sizes, *args, **kwargs):
    return 4 * x.shape[0] * x.shape[1] * w.shape[2]


@torch.library.custom_op("repro_torch::moe_gmm_gated_bwd", mutates_args=())
def _gated_bwd_op(dh: torch.Tensor, x: torch.Tensor, wi: torch.Tensor,
                  wg: torch.Tensor, group_sizes: torch.Tensor, act: str
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    if act not in ACTS:
        raise ValueError(f"moe_gmm_gated_bwd: unknown act {act!r}")
    if x.device.type == "cpu":
        return moe_gmm_gated_bwd_plain(dh, x, wi, wg, group_sizes, act)
    _device_check(x, "moe_gmm_gated_bwd")
    return _launch_bwd(dh, x, wi, group_sizes, wg=wg, act=act)


@_gated_bwd_op.register_fake
def _(dh, x, wi, wg, group_sizes, act):
    return (torch.empty_like(x), torch.empty_like(wi), torch.empty_like(wg),
            x.new_empty((2, x.shape[0], wi.shape[2]),
                        dtype=dpre_dtype(x.dtype)))


@register_flop_formula(torch.ops.repro_torch.moe_gmm_gated_bwd, get_raw=True)
def _gated_bwd_flops(dh, x, wi, wg, group_sizes, *args, **kwargs):
    return 12 * x.shape[0] * x.shape[1] * wi.shape[2]


def _gmm_setup(ctx, inputs, output):
    x, w, group_sizes = inputs
    ctx.save_for_backward(x, w, group_sizes)


def _gmm_backward(ctx, dy):
    x, w, group_sizes = ctx.saved_tensors
    dx, dw = torch.ops.repro_torch.moe_gmm_bwd(dy, x, w, group_sizes)
    return dx, dw, None


def _gated_setup(ctx, inputs, output):
    x, wi, wg, group_sizes, act = inputs
    ctx.save_for_backward(x, wi, wg, group_sizes)
    ctx.act = act


def _gated_backward(ctx, dh):
    x, wi, wg, group_sizes = ctx.saved_tensors
    dx, dwi, dwg, _ = torch.ops.repro_torch.moe_gmm_gated_bwd(
        dh, x, wi, wg, group_sizes, ctx.act)
    return dx, dwi, dwg, None, None


_gmm_op.register_autograd(_gmm_backward, setup_context=_gmm_setup)
_gated_op.register_autograd(_gated_backward, setup_context=_gated_setup)


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
