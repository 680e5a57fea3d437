"""Public wrappers of the four hand kernels, by the reference's names and
keywords (``src/repro/kernels/ops.py``): ``flash_attention``, ``rmsnorm``,
``mamba_scan`` and ``moe_gmm``.

Each calls the port's wrapper in ``repro_torch.kernels``: on a CUDA tensor
the hand CUDA kernel (or an error), on a CPU tensor its plain PyTorch
version. The tiling arguments that only the Pallas kernels have
(``block_q``, ``block_k``, ``chunk``) and ``interpret`` (the reference runs
its kernels in Pallas's interpreter off the TPU) are accepted and ignored:
the CUDA kernels pick their own tiles, and nothing here is interpreted.
The reference refuses a traced window (``:24-27``); the port's window is a
runtime int, so any window is taken. ``q_offset`` must be 0, as there
(train and prefill attention only).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import rmsnorm as _rn


def flash_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                    q_offset=0, block_q=128, block_k=128, interpret=None):
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] -> [B, Hq, Sq, D]."""
    if q_offset != 0:
        raise ValueError("flash_attention: train/prefill only (q_offset=0)")
    return _fa.flash_attention(q, k, v, causal=causal, window=int(window or 0),
                               logit_softcap=float(logit_softcap or 0.0))


def rmsnorm(x, scale, *, eps=1e-5, interpret=None):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim."""
    return _rn.rmsnorm(x, scale, eps)


def mamba_scan(a, b, *, chunk=64, interpret=None):
    """h_t = a_t h_{t-1} + b_t from a zero state. a, b: [B, S, E, N] f32 ->
    (h_all [B, S, E, N], h_last [B, E, N])."""
    return _ms.mamba_scan(a, b)


def moe_gmm(x, w, group_sizes, *, interpret=None):
    """x [T, D] sorted by expert, w [E, D, F], group_sizes [E] int ->
    [T, F]; ``group_sizes`` is moved to x's device if it is elsewhere."""
    return _gmm.moe_gmm(x, w, torch.as_tensor(group_sizes, device=x.device))
