"""Fused RMSNorm: ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last
dimension, in f32, written in x's dtype.

Port of the Pallas TPU kernel ``src/repro/kernels/rmsnorm.py::rmsnorm``. The
CUDA kernel is ``csrc/rmsnorm.cu`` (its header says what bounds it on the
card); ``rmsnorm_plain`` is the same function in plain PyTorch. ``rmsnorm``
takes the plain version only for a CPU tensor; for a CUDA tensor it launches
the kernel or raises. It is registered as the custom op
``repro_torch::rmsnorm`` so that the probe's fake-tensor trace passes through
it without running it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: [..., d]; scale: [d]. Matches ``models.layers.rms_norm``."""
    return torch.ops.repro_torch.rmsnorm(x, scale, eps)
