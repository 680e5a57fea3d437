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

The op is differentiable (``torch.library.register_autograd``): it saves
``a`` and ``h_all`` and its backward is the op
``repro_torch::mamba_scan_bwd``, ``(da, db)``, the reverse scan
``g_t = dh_all_t + a_{t+1} g_{t+1}`` (``g_{S-1}`` also takes ``dh_last``),
``da_t = g_t h_{t-1}``, ``db_t = g_t``: on a CUDA tensor the backward kernel
of ``csrc/mamba_scan.cu`` (deterministic: a thread owns its channels), on a
CPU tensor ``mamba_scan_bwd_plain``, autograd through ``mamba_scan_plain``.
Its flop formula is ``3·B·S·E·N`` (an fma and a product per element).
``BWD_LAUNCHES`` counts the backward's launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

LAUNCHES = build.LaunchCounter()
BWD_LAUNCHES = build.LaunchCounter()
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _LL, _LL, _LL, _P]
_BWD_ARGTYPES = [_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _P]
# every C entry point of csrc/mamba_scan.cu with its ctypes signature
ENTRY_POINTS = {"repro_mamba_scan": _ARGTYPES,
                "repro_mamba_scan_bwd": _BWD_ARGTYPES}


def mamba_scan_plain(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: [B, S, E, N] f32 -> (h_all [B, S, E, N], h_last [B, E, N]);
    ``kernels/ref.py::mamba_scan_ref`` with a zero h0. Differentiable under
    autograd (the states are stacked); otherwise each state is written into
    h_all in place."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        states, h = [], torch.zeros_like(b[:, 0])
        for t in range(b.shape[1]):
            h = torch.addcmul(b[:, t], a[:, t], h)
            states.append(h)
        return torch.stack(states, 1), h
    h_all = torch.empty_like(b)
    h = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        h = torch.addcmul(b[:, t], a[:, t], h, out=h_all[:, t])
    return h_all, h.clone()


def mamba_scan_bwd_plain(a: torch.Tensor, h_all: torch.Tensor,
                         dh_all: torch.Tensor, dh_last: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da, db) of ``mamba_scan_plain`` for the output gradients (dh_all
    [B, S, E, N], dh_last [B, E, N]): its chain rule written out as a loop
    over the sequence from the end, ``g_t = dh_all_t + a_{t+1} g_{t+1}``,
    ``da_t = g_t h_{t-1}`` (0 at t = 0), ``db_t = g_t``. The same arithmetic
    as autograd through ``mamba_scan_plain`` (which a custom op's CPU
    implementation cannot run: the autograd keys are off inside it)."""
    da, db = torch.empty_like(a), torch.empty_like(a)
    s = a.shape[1]
    g = dh_last
    for t in range(s - 1, -1, -1):
        g = dh_all[:, t] + (a[:, t + 1] * g if t + 1 < s else g)
        db[:, t] = g
        if t > 0:
            torch.mul(g, h_all[:, t - 1], out=da[:, t])
        else:
            da[:, 0] = 0
    return da, db


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


def _launch_bwd(a: torch.Tensor, h_all: torch.Tensor, dh_all: torch.Tensor,
                dh_last: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if any(t.dtype != torch.float32 for t in (a, h_all, dh_all, dh_last)):
        raise TypeError("mamba_scan backward kernel takes float32 a, h_all, "
                        "dh_all and dh_last")
    bsz, s, e, n = a.shape
    if a.dim() != 4 or h_all.shape != a.shape or dh_all.shape != a.shape \
            or dh_last.shape != (bsz, e, n) or s < 1 \
            or len({t.device for t in (a, h_all, dh_all, dh_last)}) != 1:
        raise ValueError(f"mamba_scan backward kernel: a {tuple(a.shape)}, "
                         f"h_all {tuple(h_all.shape)}, dh_all "
                         f"{tuple(dh_all.shape)}, dh_last "
                         f"{tuple(dh_last.shape)} (want [B, S, E, N] and "
                         f"[B, E, N] on one device)")
    a, h_all, dh_all, dh_last = (t.contiguous() for t in
                                 (a, h_all, dh_all, dh_last))
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    fn = build.load("mamba_scan", "repro_mamba_scan_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), h_all.data_ptr(), dh_all.data_ptr(),
                dh_last.data_ptr(), da.data_ptr(), db.data_ptr(), bsz, s,
                e * n, stream)
    build.check(rc, "mamba_scan_bwd")
    BWD_LAUNCHES.add()
    return da, db


@torch.library.custom_op("repro_torch::mamba_scan_bwd", mutates_args=())
def _scan_bwd_op(a: torch.Tensor, h_all: torch.Tensor, dh_all: torch.Tensor,
                 dh_last: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if a.device.type == "cpu":
        return mamba_scan_bwd_plain(a, h_all, dh_all, dh_last)
    if a.device.type != "cuda":
        raise RuntimeError(f"mamba_scan_bwd: no kernel for device {a.device}")
    return _launch_bwd(a, h_all, dh_all, dh_last)


@_scan_bwd_op.register_fake
def _(a, h_all, dh_all, dh_last):
    return torch.empty_like(a), torch.empty_like(a)


@register_flop_formula(torch.ops.repro_torch.mamba_scan_bwd, get_raw=True)
def _scan_bwd_flops(a, *args, **kwargs):
    return 3 * a.numel()


def _setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output[0])
    # an output no loss reached comes to the backward as None (autograd's
    # zeros would be a plain tensor beside DTensor states)
    ctx.set_materialize_grads(False)


def _backward(ctx, dh_all, dh_last):
    a, h_all = ctx.saved_tensors
    if dh_all is None:
        dh_all = torch.zeros_like(h_all)
    if dh_last is None:
        dh_last = torch.zeros_like(h_all[:, 0])
    return torch.ops.repro_torch.mamba_scan_bwd(a, h_all, dh_all, dh_last)


_scan_op.register_autograd(_backward, setup_context=_setup)


def mamba_scan(a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: [B, S, E, N] f32 -> (h_all [B, S, E, N], h_last [B, E, N])."""
    return torch.ops.repro_torch.mamba_scan(a, b)
