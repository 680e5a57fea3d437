"""DTensor sharding strategies for the hand kernels' custom ops.

DTensor refuses an op it has no strategy for, and the kernels are
``torch.library.custom_op``s (``repro_torch.kernels``). Each forward and
backward op gets one here (``register_sharding``), listing the
placements, per mesh dim, under which the kernel computes its part of the
global result from local shards alone. DTensor redistributes the inputs to
the cheapest of them and calls the op on the local tensors, so on the card
the kernel runs on each rank's shard; it never falls back to the plain
version. The reference needs no such table: GSPMD partitions its jnp code.

  * flash attention (``flash_attention``, ``flash_attention_lse``,
    ``flash_attention_bwd``): q, k, v, o, lse (and do, dq, dk, dv) all
    replicated, all sharded on the batch dim, or all sharded on the head
    dim. Heads are offered only when the mesh's size divides both Hq and
    Hkv, so each shard keeps the GQA ratio; otherwise both are replicated.
  * RMSNorm (``rmsnorm``, ``rmsnorm_bwd``): any leading dim of x sharded,
    the last dim and the scale replicated; the backward's dscale is then a
    partial sum over the ranks' rows.
  * the scan (``mamba_scan``, ``mamba_scan_bwd``): batch or channel dim
    sharded, the time dim replicated.
  * the grouped matmul (``moe_gmm``, ``moe_gmm_gated`` and their
    backwards): all inputs replicated. The MoE layer reaches the kernel
    through plain tensors under a mesh (``models.moe._moe_sharded``: each
    ``model`` rank's own experts, ``expert_slice_apply``), so this strategy
    serves only a DTensor caller of the op itself.

``register()`` registers them once; ``dist.sharding`` calls it before any
DTensor is made.
"""
from __future__ import annotations

import threading

import torch

_DONE = False
_LOCK = threading.Lock()


def _heads_divisible(q, k) -> bool:
    n = q.mesh.size()
    return q.shape[1] % n == 0 and k.shape[1] % n == 0


def register() -> None:
    """Register every kernel op's strategies with DTensor (idempotent)."""
    global _DONE
    with _LOCK:
        if _DONE:
            return
        _register()
        _DONE = True


def _register() -> None:
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    import repro_torch.kernels.flash_attention  # noqa: F401  (the ops)
    import repro_torch.kernels.mamba_scan  # noqa: F401
    import repro_torch.kernels.moe_gmm  # noqa: F401
    import repro_torch.kernels.rmsnorm  # noqa: F401
    ops = torch.ops.repro_torch
    R = Replicate()

    # -- flash attention: outputs first, then one entry per argument
    def flash_dims(q, k):
        return [0, 1] if _heads_divisible(q, k) else [0]

    @register_sharding(ops.flash_attention.default)
    def _flash(q, k, v, causal, window, logit_softcap):
        out = [([R], [R, R, R, None, None, None])]
        for d in flash_dims(q, k):
            out.append(([Shard(d)], [Shard(d)] * 3 + [None] * 3))
        return out

    @register_sharding(ops.flash_attention_lse.default)
    def _flash_lse(q, k, v, causal, window, logit_softcap):
        out = [([R, R], [R, R, R, None, None, None])]
        for d in flash_dims(q, k):
            out.append(([Shard(d)] * 2, [Shard(d)] * 3 + [None] * 3))
        return out

    @register_sharding(ops.flash_attention_bwd.default)
    def _flash_bwd(q, k, v, o, lse, do, causal, window, logit_softcap):
        out = [([R] * 3, [R] * 6 + [None] * 3)]
        for d in flash_dims(q, k):
            out.append(([Shard(d)] * 3, [Shard(d)] * 6 + [None] * 3))
        return out

    # -- RMSNorm: rows split any way, each row whole on one rank
    @register_sharding(ops.rmsnorm.default)
    def _rmsnorm(x, scale, eps):
        out = [([R], [R, R, None])]
        for d in range(len(x.shape) - 1):
            out.append(([Shard(d)], [Shard(d), R, None]))
        return out

    @register_sharding(ops.rmsnorm_bwd.default)
    def _rmsnorm_bwd(x, scale, dy, eps):
        out = [([R, R], [R, R, R, None])]
        for d in range(len(x.shape) - 1):
            out.append(([Shard(d), Partial()], [Shard(d), R, Shard(d), None]))
        return out

    # -- the scan: [B, S, E, N] by batch or channel; h_last is [B, E, N]
    @register_sharding(ops.mamba_scan.default)
    def _scan(a, b):
        return [([R, R], [R, R]),
                ([Shard(0), Shard(0)], [Shard(0), Shard(0)]),
                ([Shard(2), Shard(1)], [Shard(2), Shard(2)])]

    @register_sharding(ops.mamba_scan_bwd.default)
    def _scan_bwd(a, h_all, dh_all, dh_last):
        return [([R, R], [R] * 4),
                ([Shard(0)] * 2, [Shard(0)] * 4),
                ([Shard(2)] * 2, [Shard(2)] * 3 + [Shard(1)])]

    # -- the grouped matmul: replicated only (the MoE layer's expert
    # parallelism runs the kernel on each rank's plain tensors)
    @register_sharding(ops.moe_gmm.default)
    def _gmm(x, w, group_sizes):
        return [([R], [R, R, R])]

    @register_sharding(ops.moe_gmm_gated.default)
    def _gmm_gated(x, wi, wg, group_sizes, act):
        return [([R], [R, R, R, R, None])]

    @register_sharding(ops.moe_gmm_bwd.default)
    def _gmm_bwd(dy, x, w, group_sizes):
        return [([R, R], [R, R, R, R])]

    @register_sharding(ops.moe_gmm_gated_bwd.default)
    def _gmm_gated_bwd(dh, x, wi, wg, group_sizes, act):
        return [([R] * 4, [R] * 5 + [None])]
