"""Train-step factory: loss + gradients (+ optional microbatched gradient
accumulation, + an optional gradient compressor) + the AdamW update. This
function IS the "GPU task" body for training workloads in the paper's
framework: the scheduler receives its probed resource vector
(``repro_torch.core.probe``) before placement.

Port of ``src/repro/train/train_step.py``. Where the reference returns a
pure function for ``jax.jit``, the port's step runs eagerly and updates the
parameters and the optimizer state in place (``optim.adamw``); it returns
them all the same. Gradients come from ``torch.autograd.grad`` over the
parameters, which require grad only while the step runs. On the card every
gradient through a hand kernel is a hand kernel too (the backward ops of
flash attention, RMSNorm, the Mamba scan and the grouped matmul).
``abstract_train_state`` gives ``TensorSpec``s in place of
``jax.eval_shape``'s ShapeDtypeStructs: nothing is allocated.

The same step runs sharded: given parameters and moments that are DTensors
(placed by ``dist.sharding.param_specs``) and a batch of DTensors
(``batch_specs``), run under ``dist.sharding.activation_mesh``, the forward
and backward dispatch through DTensor (the hand kernels on each rank's
shards, ``dist.kernel_sharding``), the loss is made whole before the
backward, each gradient is brought to its parameter's placements (a
partial sum is reduce-scattered), the global grad norm is reduced across
shards and AdamW updates the DTensors in place. The model makes the plain
tensors it mixes with activations replicated DTensors
(``dist.sharding.replicated_like``; 0-d ones DTensor takes as replicated),
so nothing depends on a thread-local setting, which autograd's threads on
a card would not see.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.configs.base import ArchConfig
from repro_torch.core.probe import TensorSpec
from repro_torch.dist.sharding import is_dtensor
from repro_torch.models.model import TRAIN_FAMILIES, init_params, loss_fn
from repro_torch.optim import adamw


def _grads(cfg: ArchConfig, params, batch, attn_impl: str):
    """(loss, gradients as a list in ``tree_flatten(params)`` order); a
    DTensor parameter's gradient carries the parameter's placements."""
    leaves = tree_flatten(params)[0]
    with torch.enable_grad():
        loss = loss_fn(params, cfg, batch, attn_impl=attn_impl)
        if is_dtensor(loss):
            loss = loss.full_tensor()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if is_dtensor(g) and g.placements != p.placements else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), grads


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, *,
                    attn_impl: str = "flash_kernel",
                    num_microbatches: Optional[int] = None,
                    grad_compressor: Optional[Callable] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). With ``num_microbatches`` n > 1 the batch's rows are split
    into n consecutive blocks whose gradients are summed in f32
    accumulators and divided by n, as the reference's scan does.
    ``grad_compressor`` (e.g. ``dist.compression``) maps the gradient tree
    before the optimizer, as in the reference."""
    if cfg.family not in TRAIN_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the port trains the {', '.join(TRAIN_FAMILIES)} "
            f"families so far (family {cfg.family!r} is not ported yet, "
            f"ROADMAP A)")

    def compute_grads(params, batch):
        n = num_microbatches or 1
        if n <= 1:
            return _grads(cfg, params, batch, attn_impl)
        b = batch["tokens"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches")
        m = b // n
        acc = [torch.zeros_like(p, dtype=torch.float32)
               for p in tree_flatten(params)[0]]
        tot = None
        for i in range(n):
            micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            loss, grads = _grads(cfg, params, micro, attn_impl)
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
            tot = loss.float() if tot is None else tot + loss
        for a in acc:
            a.div_(n)
        return tot / n, acc

    def train_step(params, opt_state, batch):
        leaves, spec = tree_flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, grads = compute_grads(params, batch)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = tree_unflatten(grads, spec)
        if grad_compressor is not None:
            grads = grad_compressor(grads)
        params, opt_state, metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def abstract_train_state(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                         param_dtype: torch.dtype = torch.bfloat16,
                         device=torch.device("cpu")):
    """``TensorSpec`` trees of (params, opt_state) on ``device``: shapes
    and dtypes only, nothing allocated (the parameters are made on the
    meta device)."""
    device = torch.device(device)
    meta = init_params(cfg, None, param_dtype, torch.device("meta"))
    mdt = adamw.MOMENT_DTYPES[opt_cfg.moment_dtype]

    def spec(dtype=None):
        return lambda t: TensorSpec(tuple(t.shape), dtype or t.dtype, device)
    return (tree_map(spec(), meta),
            {"mu": tree_map(spec(mdt), meta), "nu": tree_map(spec(mdt), meta),
             "step": 0})
