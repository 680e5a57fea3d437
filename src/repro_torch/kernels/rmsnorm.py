"""Fused RMSNorm: ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last
dimension, in f32, written in x's dtype.

Port of the Pallas TPU kernel ``src/repro/kernels/rmsnorm.py::rmsnorm``. The
CUDA kernel is ``csrc/rmsnorm.cu`` (its header says what bounds it on the
card); ``rmsnorm_plain`` is the same function in plain PyTorch. ``rmsnorm``
takes the plain version only for a CPU tensor; for a CUDA tensor it launches
the kernel or raises. It is registered as the custom op
``repro_torch::rmsnorm`` so that the probe's fake-tensor trace passes through
it without running it.

The op is differentiable (``torch.library.register_autograd``): its forward
saves x and scale, and its backward is the op ``repro_torch::rmsnorm_bwd``,
``(dx, dscale)``, which launches the backward kernels of ``csrc/rmsnorm.cu``
on a CUDA tensor (a row pass for dx and per-block dscale partials, then a
reduction pass down the columns: no atomics, the same dscale every run) and
runs ``rmsnorm_bwd_plain`` on a CPU tensor. ``BWD_LAUNCHES`` counts the
backward's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()
BWD_LAUNCHES = build.LaunchCounter()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]
_P, _I = ctypes.c_void_p, ctypes.c_int
_BWD_ARGTYPES = [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, ctypes.c_float,
                 _I, _I, _I, _I, _P]
# every C entry point of csrc/rmsnorm.cu with its ctypes signature
ENTRY_POINTS = {"repro_rmsnorm": _ARGTYPES, "repro_rmsnorm_bwd": _BWD_ARGTYPES}
# blocks of rows of the backward's first pass (each writes a row of dscale
# partials that the second pass sums)
BWD_BLOCKS = 512


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Arithmetic type of the plain versions: f32, or f64 for f64 inputs
    (``torch.autograd.gradcheck``)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    acc = _acc(x.dtype)
    xf = x.to(acc)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.to(acc))).to(x.dtype)


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                      eps: float = 1e-5):
    """(dx, dscale) of ``rmsnorm_plain`` for the output cotangent dy: with
    r = rsqrt(mean(x^2) + eps) and g = dy (1 + scale),
    dx = r g - x r^3 mean(g x) and dscale = sum over rows of dy x r."""
    acc = _acc(x.dtype)
    xf, g = x.to(acc), dy.to(acc)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gw = g * (1.0 + scale.to(acc))
    dx = r * gw - xf * r.pow(3) * (gw * xf).mean(dim=-1, keepdim=True)
    dscale = (g * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    d = x.shape[-1]
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32/bfloat16, got "
                        f"x {x.dtype}, scale {scale.dtype}")
    if scale.shape != (d,) or scale.device != x.device:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} on "
                         f"{scale.device} for x {tuple(x.shape)} on {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and scale")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    fn = build.load("rmsnorm", "repro_rmsnorm", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                float(eps), _DTYPES[x.dtype], _DTYPES[scale.dtype], stream)
    build.check(rc, "rmsnorm")
    LAUNCHES.add()
    return out


def _launch_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float):
    d = x.shape[-1]
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES \
            or dy.dtype != x.dtype:
        raise TypeError(f"rmsnorm backward kernel takes float32/bfloat16 x "
                        f"and dy of one dtype, got x {x.dtype}, dy "
                        f"{dy.dtype}, scale {scale.dtype}")
    if dy.shape != x.shape or scale.shape != (d,) \
            or not (x.device == dy.device == scale.device):
        raise ValueError(f"rmsnorm backward: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, scale {tuple(scale.shape)} on "
                         f"one device")
    x, scale, dy = x.contiguous(), scale.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, dscale.zero_()
    per_block = -(-rows // BWD_BLOCKS)
    nblk = -(-rows // per_block)
    partial = torch.empty(nblk, d, dtype=torch.float32, device=x.device)
    fn = build.load("rmsnorm", "repro_rmsnorm_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                dscale.data_ptr(), partial.data_ptr(), rows, d, float(eps),
                per_block, nblk, _DTYPES[x.dtype], _DTYPES[scale.dtype],
                stream)
    build.check(rc, "rmsnorm_bwd")
    BWD_LAUNCHES.add()
    return dx, dscale


@torch.library.custom_op("repro_torch::rmsnorm_bwd", mutates_args=())
def _rmsnorm_bwd_op(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, scale, dy, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rmsnorm_bwd: no kernel for device {x.device}")
    return _launch_bwd(x, scale, dy, eps)


@_rmsnorm_bwd_op.register_fake
def _(x, scale, dy, eps):
    return torch.empty_like(x), torch.empty_like(scale)


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def _rmsnorm_op(x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rmsnorm: no kernel for device {x.device}")
    return _launch(x, scale, eps)


@_rmsnorm_op.register_fake
def _(x, scale, eps):
    return torch.empty_like(x)


def _setup(ctx, inputs, output):
    x, scale, eps = inputs
    ctx.save_for_backward(x, scale)
    ctx.eps = eps


def _backward(ctx, dy):
    x, scale = ctx.saved_tensors
    dx, dscale = torch.ops.repro_torch.rmsnorm_bwd(x, scale, dy, ctx.eps)
    return dx, dscale, None


torch.library.register_autograd("repro_torch::rmsnorm", _backward,
                                setup_context=_setup)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: [..., d]; scale: [d]. Matches ``models.layers.rms_norm``."""
    return torch.ops.repro_torch.rmsnorm(x, scale, eps)
