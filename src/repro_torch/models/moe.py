"""Mixture-of-Experts layer: top-k router, GShard-style capacity drops, and
the expert FFN as grouped matmuls over the kept (token, slot) rows.

Port of ``src/repro/models/moe.py``. ``moe_apply`` computes the reference's
function: tokens are split into contiguous groups of ``min(group_size, S)``
per row, each expert takes at most ``capacity`` (token, slot) pairs of a
group in (token, slot) order and drops the rest, and the output is the
combine-weighted sum of the kept slots' expert outputs, with the same
load-balancing aux loss. Where the reference pads every expert to capacity
and multiplies the padding (dense dispatch einsums over [E, G, C, d]), the
port sorts the slots by expert and runs the FFN through the hand
grouped-matmul kernel (``kernels/moe_gmm.py``) on those rows; dropped slots
sort last, past the groups, and the kernel writes zeros there.

Every shape here is static: the dispatch uses a stable sort, a
``scatter_add`` count and gathers, never a boolean mask, ``nonzero`` or a
host read of the group sizes. So the probe's fake-tensor trace passes
through it (charging the static worst case, every slot computed) and the
decode step stays capturable into a CUDA graph.

Under a mesh (DTensor inputs) the layer runs on replicas
(``dist.sharding.on_replicas``): x and the expert weights are made whole
on every rank and the dispatch and the kernels run on the local copies,
so the grouped matmul sees all-replicated inputs. The reference instead
pins its dispatched [E, G, C, d] tensor with experts on ``model``
(``moe.py:76``), an all-to-all of the tokens onto the experts; expert
parallelism is ROADMAP work.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.dist.sharding import on_replicas
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_gated


def capacity(cfg: MoEConfig, group_tokens: int) -> int:
    c = int(cfg.capacity_factor * group_tokens * cfg.top_k / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 lanes


def router_topk(logits: torch.Tensor, top_k: int):
    """logits: [g, s, E] -> (weights [g,s,k] f32, indices [g,s,k], probs
    [g,s,E] f32): softmax in f32, top-k, renormalised."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, indices = torch.topk(probs, top_k, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, indices, probs


def _onehot(indices: torch.Tensor, num_experts: int) -> torch.Tensor:
    """int64 one-hot over the last dim (a comparison: ``F.one_hot`` checks
    its input's range on the host)."""
    experts = torch.arange(num_experts, device=indices.device)
    return (indices[..., None] == experts).long()


def queue_positions(indices: torch.Tensor, num_experts: int) -> torch.Tensor:
    """[g, s, k] expert choices -> each (token, slot)'s position in its
    expert's queue, counting the group's pairs in (s, k) order (reference
    ``combine_tensor``, ``moe.py:44-46``)."""
    g, s, k = indices.shape
    flat = indices.reshape(g, s * k)
    onehot = _onehot(flat, num_experts)
    before = onehot.cumsum(dim=1) - onehot
    return before.gather(-1, flat[..., None]).reshape(g, s, k)


def route(p: Dict[str, torch.Tensor], xg: torch.Tensor, cfg: MoEConfig):
    """xg: [g, s, d] -> (weights, indices, keep: each [g, s, k]; probs
    [g, s, E]). ``keep`` is False for the slots the capacity drops."""
    logits = xg @ p["router"].to(xg.dtype)
    weights, indices, probs = router_topk(logits, cfg.top_k)
    keep = queue_positions(indices, cfg.num_experts) \
        < capacity(cfg, xg.shape[1])
    return weights, indices, keep, probs


def expert_ffn(p: Dict[str, torch.Tensor], rows: torch.Tensor,
               group_sizes: torch.Tensor, act: str) -> torch.Tensor:
    """rows [n, d] sorted by expert -> [n, d]: two grouped-matmul launches,
    ``act(rows @ wi) * (rows @ wg)`` in one (a gated act, rounded once) or
    ``rows @ wi`` and torch ops (squared relu), then ``@ wo``; rows past the
    groups stay zero."""
    if act.endswith("gated"):
        h = moe_gmm_gated(rows, p["wi"], p["wg"], group_sizes, act)
    elif act == "squared_relu":
        h = torch.square(F.relu(moe_gmm(rows, p["wi"], group_sizes)))
    else:
        raise ValueError(f"unknown mlp act {act!r}")
    return moe_gmm(h, p["wo"], group_sizes)


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig,
              act: str, group_size: int = 512
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d]. p: {'router': [d,E], 'wi': [E,d,f], 'wg'?, 'wo':
    [E,f,d]}. Returns (out [B,S,d] in x's dtype, aux loss f32 scalar);
    DTensors are computed on replicas."""
    return on_replicas(_moe_apply, p, x, cfg, act, group_size)


def _moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig,
               act: str, group_size: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    gs = min(group_size, s)
    if s % gs:
        raise ValueError(f"moe_apply: sequence {s} is not a multiple of the "
                         f"group size {gs}")
    xg = x.reshape(b * (s // gs), gs, d)
    weights, indices, keep, probs = route(p, xg, cfg)
    # dispatch: the (token, slot) pairs sorted by expert, dropped ones last
    key = torch.where(keep, indices, e).reshape(-1)
    order = torch.argsort(key, stable=True)
    group_sizes = torch.zeros(e + 1, dtype=torch.int32, device=x.device) \
        .scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))[:e]
    rows = xg.reshape(-1, d).index_select(0, order // k)
    y = expert_ffn(p, rows, group_sizes, act)
    del rows
    y = torch.empty_like(y).index_copy_(0, order, y)  # back to slot order
    # combine: weights cast to x's dtype, as the reference's combine tensor
    comb = (weights * keep).to(x.dtype).float()
    out = (comb[..., None] * y.view(*indices.shape, d).float()).sum(dim=2)
    # load-balancing aux loss (Switch/GShard)
    frac_tokens = _onehot(indices[..., 0], e).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)
    return out.to(x.dtype).reshape(b, s, d), aux
