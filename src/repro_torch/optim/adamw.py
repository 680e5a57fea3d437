"""AdamW with dtype-configurable moments, global-norm clipping and a
warmup-cosine schedule.

Port of ``src/repro/optim/adamw.py`` with the same arithmetic: gradients
clipped by their global norm, warmup-cosine learning rate, bias-corrected
moments kept in ``moment_dtype``, decoupled weight decay on matrices only.
The schedule and the bias corrections are host scalars computed in f32, as
the reference computes them; the clip scale stays on the device, so a step
never waits on the card.

The update is written in place, tensor by tensor (the reference builds new
arrays). At gemma2-9b's widths the tied embedding alone is 917,504,000 f32
values (3.67e9 B), and a literal copy of the reference's ``upd`` would make
about six temporaries that size. Here a step's transient memory is at most
two temporaries the size of the largest parameter (f32 moments and
parameters: one), and the gradients it is given are overwritten: the train
step owns them. ``global_norm`` reduces each leaf without squaring it into
a copy. Parameters, gradients and moments may be DTensors of one
placement each (a sharded step): the update runs on the shards, and a
leaf's norm is reduced across them.

Weight decay follows the reference's own leaves: it decays a leaf whose
rank is at least 2 in the reference's tree, where every per-layer leaf is
stacked on a leading [L] dim. So the layers' norm scales and biases are
decayed, as in the reference, and the final norm is not
(``reference_rank``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

OptState = Dict[str, Any]
MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10000


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step) -> float:
    """The learning rate at ``step`` (warmup, then cosine to 0), in f32."""
    step = _f32(step)
    warm = step / max(cfg.warmup_steps, 1)
    frac = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(frac, 0.0, 1.0)))
    return float(cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos))


def init_state(cfg: AdamWConfig, params) -> OptState:
    """Zero moments shaped like ``params`` in ``moment_dtype``; ``step`` is
    a host int (the reference's int32 scalar)."""
    dt = MOMENT_DTYPES[cfg.moment_dtype]
    return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "step": 0}


def reference_rank(params) -> List[int]:
    """Each leaf's rank in the reference's tree, in ``tree_flatten`` order:
    its own, plus one for each list that holds it, which the reference
    stacks on a leading dim (``layers`` on [L]; the hybrid's ``groups`` on
    [G], and within a group ``mamba`` and ``norm_m`` on [G, k-1])."""
    ranks: List[int] = []

    def walk(node, stacked: int) -> None:
        if isinstance(node, dict):
            for val in node.values():
                walk(val, stacked)
        elif isinstance(node, (list, tuple)):
            for val in node:
                walk(val, stacked + 1)
        else:
            ranks.append(node.dim() + stacked)
    walk(params, 0)
    return ranks


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, reduced in f32, each leaf
    read once and never squared into a copy."""
    leaves = [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]
    norms = torch.stack([_whole(torch.linalg.vector_norm(
        x, dtype=torch.float32)) for x in leaves])
    return torch.sqrt(torch.sum(torch.square(norms)))


def _whole(n: torch.Tensor) -> torch.Tensor:
    """A sharded leaf's norm reduced across its shards (a DTensor's
    ``full_tensor``); a plain tensor's as is."""
    from torch.distributed.tensor import DTensor
    return n.full_tensor() if isinstance(n, DTensor) else n


def _update(cfg: AdamWConfig, p: torch.Tensor, g: torch.Tensor,
            mu: torch.Tensor, nu: torch.Tensor, *, decay: bool,
            scale: torch.Tensor, lr: float, b1t: float, b2t: float) -> None:
    """One leaf of the reference's ``upd``, in place: ``g`` (overwritten)
    and at most one more f32 temporary the leaf's size carry it."""
    g = g.to(torch.float32).mul_(scale)     # g itself when it is f32
    if mu.dtype == torch.float32:
        mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        tmp = torch.div(nu, b2t).sqrt_().add_(cfg.eps)
        delta = torch.div(mu, b1t, out=g).div_(tmp)
    else:
        # moments stored rounded; the step uses the f32 values, as the
        # reference does
        tmp = nu.float().mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        nu.copy_(tmp)
        tmp.div_(b2t).sqrt_().add_(cfg.eps)
        g.mul_(1 - cfg.b1).add_(mu, alpha=cfg.b1)
        mu.copy_(g)
        delta = g.div_(b1t).div_(tmp)
    if p.dtype == torch.float32:
        if decay:
            delta.add_(p, alpha=cfg.weight_decay)
        p.sub_(delta, alpha=lr)
    else:
        pf = tmp.copy_(p)
        if decay:
            delta.add_(pf, alpha=cfg.weight_decay)
        p.copy_(pf.sub_(delta, alpha=lr))


def apply_updates(cfg: AdamWConfig, params, grads, state: OptState
                  ) -> Tuple[Any, OptState, Dict[str, Any]]:
    """One AdamW step, in place on ``params`` and the moments; ``grads``
    (a tree like ``params``) is used as scratch. Returns (params, state,
    {grad_norm: 0-d device tensor, lr: float})."""
    step = int(state["step"]) + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1t = float(1 - torch.pow(_f32(cfg.b1), _f32(step)))
    b2t = float(1 - torch.pow(_f32(cfg.b2), _f32(step)))
    ps, spec = tree_flatten(params)
    gs = tree_flatten(grads)[0]
    mus, nus = tree_flatten(state["mu"])[0], tree_flatten(state["nu"])[0]
    with torch.no_grad():
        for p, g, mu, nu, rank in zip(ps, gs, mus, nus,
                                      reference_rank(params)):
            _update(cfg, p, g, mu, nu, decay=rank >= 2, scale=scale, lr=lr,
                    b1t=b1t, b2t=b2t)
    del gs
    return (tree_unflatten(ps, spec),
            {"mu": state["mu"], "nu": state["nu"], "step": step},
            {"grad_norm": gnorm, "lr": lr})
