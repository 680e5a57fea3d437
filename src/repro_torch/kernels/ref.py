"""Plain PyTorch oracles of the four hand kernels, by the reference's names
(``src/repro/kernels/ref.py``): the allclose targets the tests hold the
kernels and ``kernels.ops`` against. Nothing on a main path calls them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm_plain


def flash_attention_ref(q, k, v, *, causal=True, window=0, logit_softcap=0.0):
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D] -> [B, Hq, Sq, D]: softmax
    over the full masked score matrix in f32 (``models.layers.
    naive_attention``). A row that sees no key gives 0 (ROADMAP C10), where
    the reference's gives V's mean."""
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 logit_softcap=logit_softcap)


def rmsnorm_ref(x, scale, eps=1e-5):
    return rmsnorm_plain(x, scale, eps)


def mamba_scan_ref(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t. a, b: [B, S, E, N]; h0: [B, E, N].

    Returns (h_all [B, S, E, N], h_last [B, E, N])."""
    h, states = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        states.append(h)
    return torch.stack(states, 1), h


def moe_gmm_ref(x, w, group_sizes):
    """Grouped matmul: rows of x belong to expert g per group_sizes.

    x: [T, D] (rows sorted by expert), w: [E, D, F], group_sizes: [E] summing
    to T. Returns [T, F] where row t is x[t] @ w[expert_of(t)], the per-row
    einsum over a gathered [T, D, F] copy of the weights. A row past the
    groups takes the last expert, as JAX's clamped gather does."""
    t = x.shape[0]
    bounds = torch.cumsum(torch.as_tensor(group_sizes, device=x.device), 0)
    expert_of = torch.searchsorted(bounds, torch.arange(t, device=x.device),
                                   right=True).clamp(max=w.shape[0] - 1)
    return torch.einsum("td,tdf->tf", x, w[expert_of])
