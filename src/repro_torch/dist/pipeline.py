"""Pipeline parallelism: GPipe-style microbatch schedule over a ``stage``
dimension of a ``DeviceMesh``.

Port of ``src/repro/dist/pipeline.py``. Layers are split contiguously over
stages (``stack_stage_params``); each rank runs its stage's layer slice and
passes activations to the next stage. The schedule is the reference's
fill/drain loop: with M microbatches and S stages it runs M + S - 1 ticks,
every stage computing on every tick; stage 0 feeds microbatch t on tick t
and the last stage emits microbatch t - (S - 1). Warm-up and drain ticks
compute on garbage that is never emitted, which keeps every tick the same.

Where the reference's ``shard_map`` body ``ppermute``s, the port shifts
each tick's output one stage along the ring with ``batch_isend_irecv`` on
the stage dimension's process group; at the end the outputs are zeroed off
the last stage and all-reduced over it, so every rank returns them, as the
reference's ``psum`` does.

Forward only, as the reference's test uses it: the ring's point-to-point
transfers carry no gradient (a pipeline backward is ROADMAP work).

This is the third parallelism axis next to data (batch) and model (tensor):
a pipeline task spans ``S`` devices with per-device memory ~1/S of the layer
stack — exactly the multi-chip ``ResourceVector.chips > 1`` workloads the MGB
schedulers place.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map


def stack_stage_params(params: Any, n_stages: int) -> Any:
    """Reshape each leaf's leading layer dim [L, ...] -> [S, L // S, ...]
    (stage s gets the contiguous layer slice [s * L/S, (s+1) * L/S))."""

    def split(w):
        L = w.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return w.reshape((n_stages, L // n_stages) + tuple(w.shape[1:]))

    return tree_map(split, params)


def _local_stage(w: torch.Tensor, stage: int) -> torch.Tensor:
    """This stage's slice of a stacked leaf: a DTensor sharded on its
    stage dim holds it as its local [1, ...] shard, a plain tensor holds
    every stage's."""
    from torch.distributed.tensor import DTensor
    if isinstance(w, DTensor):
        return w.to_local()[0]
    return w[stage]


def make_pipeline_forward(layer_fn: Callable, mesh, *, n_micro: int,
                          axis: str = None):
    """Build ``pipe(stage_params, x) -> y`` running ``layer_fn`` over a
    pipeline of ``mesh``'s ``axis`` dimension (default: its first) with
    ``n_micro`` microbatches.

    ``layer_fn(stage_params_slice, x)`` applies one stage's layer slice to a
    microbatch and must be shape-preserving in ``x``. ``stage_params`` is the
    output of ``stack_stage_params`` (plain tensors, the same on every
    rank, or DTensors sharded on the stage dim); ``x`` is [B, ...] with
    B % n_micro == 0, the same on every rank of the stage dimension.
    """
    axis = axis or mesh.mesh_dim_names[0]
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)

    def pipe(stage_params, x):
        batch = x.shape[0]
        assert batch % n_micro == 0, (batch, n_micro)
        mb = batch // n_micro
        xs = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
        stage = dist.get_rank(group)
        sp = tree_map(lambda w: _local_stage(w, stage), stage_params)
        nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
        prv = dist.get_global_rank(group, (stage - 1) % n_stages)

        recv = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(n_micro + n_stages - 1):
            feed = xs[min(max(t, 0), n_micro - 1)]
            inp = feed if stage == 0 else recv
            y = layer_fn(sp, inp)
            # the last stage finishes microbatch t - (S - 1) on tick t
            if stage == n_stages - 1 and t >= n_stages - 1:
                outs[t - (n_stages - 1)] = y
            if n_stages == 1:
                recv = y
                continue
            recv = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)])
            for r in reqs:
                r.wait()
        # results live on the last stage only; replicate them
        if stage != n_stages - 1:
            outs.zero_()
        dist.all_reduce(outs, group=group)
        return outs.reshape((batch,) + tuple(x.shape[1:]))

    return pipe
