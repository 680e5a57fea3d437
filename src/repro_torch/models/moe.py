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

Under a mesh (DTensor inputs) the layer is expert-parallel where the
number of experts E divides the ``model`` axis's size m, as the reference's
rules shard them (``dist/sharding.py:133-137``, the pin at ``moe.py:73-76``):
each ``model`` rank keeps E/m experts, gathered over the data axes (FSDP on
d) but never over ``model``. The tokens reach every ``model`` rank of their
data shard (the residual's sequence, where ``seq_shard_activations`` puts
it on ``model``, is all-gathered there: the exchange the reference's
all-to-all makes), each rank routes them, runs the hand grouped matmul on
the rows of its own experts (``expert_slice_apply``: the other ranks'
slots sort past the groups, where the kernel writes zeros) and combines;
the partial outputs are summed over ``model`` (reduce-scattered back onto
a sequence-sharded residual). Where E does not divide m (mixtral-8x7b's 8
on 16) the experts are replicated on ``model`` as the reference replicates
them, and every ``model`` rank computes the whole layer for its tokens
through the same function. The aux loss's per-expert counts are summed
over the ranks before the product, so it is the whole batch's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.dist import sharding as SH
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
    DTensors are computed expert-parallel (``_moe_sharded``)."""
    if SH.is_dtensor(x):
        return _moe_sharded(p, x, cfg, act, group_size)
    xg, route_out = _route_groups(p, x, cfg, group_size)
    weights, indices, keep, probs = route_out
    out = _slice_combine(p, xg, weights, indices, keep, act, 0,
                         cfg.num_experts)
    return out.to(x.dtype).reshape(x.shape), _aux(indices, probs,
                                                  cfg.num_experts)


def _route_groups(p, x: torch.Tensor, cfg: MoEConfig, group_size: int):
    """(x as [g, gs, d] groups, ``route``'s outputs) for x [B, S, d]."""
    b, s, d = x.shape
    gs = min(group_size, s)
    if s % gs:
        raise ValueError(f"moe_apply: sequence {s} is not a multiple of the "
                         f"group size {gs}")
    xg = x.reshape(b * (s // gs), gs, d)
    return xg, route(p, xg, cfg)


def _slice_combine(p, xg: torch.Tensor, weights, indices, keep, act: str,
                   lo: int, hi: int) -> torch.Tensor:
    """The kept slots routed to experts [lo, hi) through the expert FFN
    (``p``'s weights are those experts', [hi - lo, ...]) and combined:
    [g·gs, d] f32. The slots of other experts sort last with the dropped
    ones, past the groups, where the kernel writes zeros."""
    d = xg.shape[-1]
    k = indices.shape[-1]
    n = hi - lo
    mine = keep & (indices >= lo) & (indices < hi)
    # dispatch: the (token, slot) pairs sorted by expert, the rest last
    key = torch.where(mine, indices - lo, n).reshape(-1)
    order = torch.argsort(key, stable=True)
    group_sizes = torch.zeros(n + 1, dtype=torch.int32, device=xg.device) \
        .scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))[:n]
    rows = xg.reshape(-1, d).index_select(0, order // k)
    y = expert_ffn(p, rows, group_sizes, act)
    del rows
    y = torch.empty_like(y).index_copy_(0, order, y)  # back to slot order
    # combine: weights cast to x's dtype, as the reference's combine tensor
    comb = (weights * mine).to(xg.dtype).float()
    return (comb[..., None] * y.view(*indices.shape, d).float()).sum(dim=2) \
        .reshape(-1, d)


def _aux_sums(indices: torch.Tensor, probs: torch.Tensor, e: int):
    """(tokens whose first choice is each expert, summed probabilities of
    each expert): [E] f32 each, over the groups given."""
    return (_onehot(indices[..., 0], e).float().sum(dim=(0, 1)),
            probs.sum(dim=(0, 1)))


def _aux(indices: torch.Tensor, probs: torch.Tensor, e: int) -> torch.Tensor:
    """The load-balancing aux loss (Switch/GShard)."""
    frac_tokens = _onehot(indices[..., 0], e).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return e * torch.sum(frac_tokens * frac_probs)


def expert_slice_apply(p_local: Dict[str, torch.Tensor], x: torch.Tensor,
                       cfg: MoEConfig, act: str, lo: int, hi: int,
                       group_size: int = 512) -> torch.Tensor:
    """One ``model`` rank's share of the layer on plain tensors: x [B, S,
    d] routed by the whole ``p_local["router"]`` [d, E], the kept slots of
    experts [lo, hi) through the hand grouped matmul on ``p_local``'s
    ``wi``/``wg``/``wo`` ([hi - lo, ...]) and combined. Returns that
    share of the output, [B, S, d] f32; the shares of a partition of the
    experts sum to the layer's output (``moe_apply``'s before its cast)."""
    xg, (weights, indices, keep, _) = _route_groups(p_local, x, cfg,
                                                    group_size)
    return _slice_combine(p_local, xg, weights, indices, keep, act, lo,
                          hi).reshape(x.shape)


def expert_parallel(num_experts: int, mesh) -> int:
    """How many ``model`` ranks split the experts: the axis's size where it
    divides E (the reference's ``_entry`` rule), else 1 (replicated)."""
    names = tuple(mesh.mesh_dim_names or ())
    if "model" not in names:
        return 1
    m = mesh.size(names.index("model"))
    return m if m > 1 and num_experts % m == 0 else 1


def _moe_sharded(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig,
                 act: str, group_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` on DTensors, expert-parallel on ``model`` where E
    divides it (module docstring). Each rank's work is plain tensors: its
    data shard of the tokens, whole on ``model``; the router whole; its
    E/m experts' weights, gathered over the data axes only."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    e = cfg.num_experts
    ep = expert_parallel(e, mesh)
    mi = names.index("model") if "model" in names else -1
    # the tokens: the batch on the data axes where it divides, whole on
    # ``model`` (a sequence sharded there is all-gathered)
    spec = SH._spec_for(SH.abstract(mesh), x.shape, ("batch", None, None))
    tok_pl = SH.to_placements(spec, mesh)
    xb = x.redistribute(mesh, tok_pl) if list(x.placements) != tok_pl else x

    def grads(expert_dim):
        """Placements of a gradient from this rank's work: a partial sum
        over the axes that split the tokens, and over ``model`` where the
        ranks there split the experts (sharded on ``expert_dim`` where the
        tensor holds them)."""
        out = []
        for i, pl in enumerate(tok_pl):
            if i == mi and ep > 1:
                out.append(Shard(expert_dim) if expert_dim is not None
                           else Partial())
            else:
                out.append(Partial() if isinstance(pl, Shard) else Replicate())
        return out

    local = {"router": SH.replicated(p["router"]).to_local(
        grad_placements=grads(None))}
    whole_e = [Shard(0) if i == mi and ep > 1 else Replicate()
               for i in range(mesh.ndim)]
    for name in ("wi", "wg", "wo"):
        if name in p:
            w = p[name]
            if list(w.placements) != whole_e:
                w = w.redistribute(mesh, whole_e)
            local[name] = w.to_local(grad_placements=grads(0))
    # x's own gradient keeps its rows' placements, a partial sum over
    # ``model`` where the ranks there split the experts
    part = [Partial() if i == mi and ep > 1 else pl
            for i, pl in enumerate(tok_pl)]
    x_loc = xb.to_local(grad_placements=part)
    share = e // ep
    lo = (mesh.get_local_rank(mi) if ep > 1 else 0) * share
    xg, (weights, indices, keep, probs) = _route_groups(local, x_loc, cfg,
                                                        group_size)
    out = _slice_combine(local, xg, weights, indices, keep, act, lo,
                         lo + share).to(x.dtype).reshape(x_loc.shape)
    out = SH.placed(out, mesh, part, x.shape).redistribute(mesh, x.placements)
    # the aux loss over the whole batch: each rank's per-expert sums, a
    # partial sum over the axes that split the tokens (over ``model`` each
    # rank holds the same sums, so each adds 1/ep of them)
    sums = torch.stack(_aux_sums(indices, probs, e)) / ep
    sums = SH.placed(sums, mesh, grads(None), sums.shape).redistribute(
        mesh, [Replicate()] * mesh.ndim)
    n_tok = x.shape[0] * x.shape[1]
    aux = e * torch.sum((sums[0] / n_tok) * (sums[1] / n_tok))
    return out, aux
