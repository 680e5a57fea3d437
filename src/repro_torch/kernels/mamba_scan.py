"""Selective-scan recurrence ``h_t = a_t * h_{t-1} + b_t`` from a zero state,
in f32: the Mamba-1 hot loop.

Port of the Pallas TPU kernel ``src/repro/kernels/mamba_scan.py::mamba_scan``.
The CUDA kernel is ``csrc/mamba_scan.cu`` (its header says what bounds it on
the card and how it is laid out); ``mamba_scan_plain`` is the same function
in plain PyTorch, a loop over the sequence. ``mamba_scan`` takes the plain
version only for CPU tensors; for CUDA tensors it launches the kernel or
raises. The Pallas ``chunk``/``block_e`` tiling exists for VMEM and is not
part of the signature; any S >= 1 and any B*E*N work (the Pallas kernel
asserted divisibility).

Registered as the custom op ``repro_torch::mamba_scan`` with a fake
(shape-only) implementation and a flop formula (``2·B·S·E·N``: one multiply
and one add per element), so the probe's trace passes through it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _LL, _LL, _LL, _P]


def mamba_scan_plain(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: [B, S, E, N] f32 -> (h_all [B, S, E, N], h_last [B, E, N]);
    ``kernels/ref.py::mamba_scan_ref`` with a zero h0."""
    h_all = torch.empty_like(b)
    h = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        h = torch.addcmul(b[:, t], a[:, t], h, out=h_all[:, t])
    return h_all, h.clone()


def _launch(a: torch.Tensor, b: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"mamba_scan kernel takes float32 a and b, got "
                        f"{a.dtype}, {b.dtype}")
    if a.dim() != 4 or a.shape != b.shape or a.shape[1] < 1 \
            or a.device != b.device:
        raise ValueError(f"mamba_scan kernel: a {tuple(a.shape)} on "
                         f"{a.device}, b {tuple(b.shape)} on {b.device} "
                         f"(want one [B, S, E, N] shape, S >= 1, one device)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mamba_scan kernel needs contiguous a and b")
    bsz, s, e, n = a.shape
    h_all = torch.empty_like(b)
    h_last = torch.empty((bsz, e, n), dtype=b.dtype, device=b.device)
    if h_all.numel() == 0:
        return h_all, h_last
    fn = build.load("mamba_scan", "repro_mamba_scan", _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), h_all.data_ptr(),
                h_last.data_ptr(), bsz, s, e * n, stream)
    build.check(rc, "mamba_scan")
    LAUNCHES.add()
    return h_all, h_last


@torch.library.custom_op("repro_torch::mamba_scan", mutates_args=())
def _scan_op(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    if a.device.type == "cpu":
        return mamba_scan_plain(a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"mamba_scan: no kernel for device {a.device}")
    return _launch(a, b)


@_scan_op.register_fake
def _(a, b):
    bsz, _, e, n = a.shape
    return (torch.empty_like(b),
            torch.empty((bsz, e, n), dtype=b.dtype, device=b.device))


@register_flop_formula(torch.ops.repro_torch.mamba_scan, get_raw=True)
def _scan_flops(a, b, *args, **kwargs):
    return 2 * a.numel()


def mamba_scan(a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: [B, S, E, N] f32 -> (h_all [B, S, E, N], h_last [B, E, N])."""
    return torch.ops.repro_torch.mamba_scan(a, b)
