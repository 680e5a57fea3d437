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
the last stage and summed over the group, so every rank returns them, as
the reference's ``psum`` does. One stage (the card's world) runs the same
schedule with no transfer.

The pipeline is differentiable, as ``jax.grad`` differentiates the
reference's. The whole schedule is one ``torch.autograd.Function`` whose
backward runs the reverse fill/drain explicitly: left to the autograd
engine, stage 0 (which never uses what the last stage sends it) would run
no backward for that transfer, and the ring would deadlock. For t = M + S
- 2 down to 0 each stage takes the cotangent of tick t's output from the
next stage (zeros where the receiver did not use it, but always sent),
adds the emitted microbatch's cotangent on the last stage, backpropagates
through ``layer_fn`` for tick t, and sends the input's cotangent to the
previous stage; stage 0 adds it to x's microbatch. Every rank issues the
same transfers in the same order. Warm-up and drain ticks get zero
cotangents, as the reference's masks give them, and are not recomputed.

What a stage saves: the inputs of its M ticks that carry a microbatch
(tick t carries microbatch t - stage), of the M + S - 1, and nothing of
``layer_fn``'s insides. The backward recomputes each such tick from its
saved input under ``enable_grad`` and takes ``torch.autograd.grad``
through it, so a stage runs its layers twice forward and once backward a
microbatch.

The gradients, on every rank of the stage dimension: x's is the sum over
stages, which is stage 0's (x is the same on every rank, the reference's
``P()``); plain stacked stage params (the same on every rank) get the
whole [S, L/S, ...] gradient, each stage's slice summed over the group; a
DTensor sharded on the stage dim gets its own slice as its local shard.
The replicated output's cotangent passes through unchanged: every rank
computes the same loss on the same output, so a sum over the group in the
backward would multiply the gradient by S.

This is the third parallelism axis next to data (batch) and model (tensor):
a pipeline task spans ``S`` devices with per-device memory ~1/S of the layer
stack — exactly the multi-chip ``ResourceVector.chips > 1`` workloads the MGB
schedulers place.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


def stack_stage_params(params: Any, n_stages: int) -> Any:
    """Reshape each leaf's leading layer dim [L, ...] -> [S, L // S, ...]
    (stage s gets the contiguous layer slice [s * L/S, (s+1) * L/S))."""

    def split(w):
        L = w.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return w.reshape((n_stages, L // n_stages) + tuple(w.shape[1:]))

    return tree_map(split, params)


class _Ring:
    """The stage dimension: this rank's stage, its neighbours' global ranks
    and the group (None with one stage: nothing is sent)."""

    def __init__(self, mesh, axis: str):
        self.n = mesh.size(mesh.mesh_dim_names.index(axis))
        self.group = mesh.get_group(axis) if self.n > 1 else None
        self.stage = dist.get_rank(self.group) if self.n > 1 else 0
        if self.n > 1:
            self.nxt = dist.get_global_rank(self.group,
                                            (self.stage + 1) % self.n)
            self.prv = dist.get_global_rank(self.group,
                                            (self.stage - 1) % self.n)

    def shift(self, send: torch.Tensor, to_next: bool) -> torch.Tensor:
        """Send ``send`` one stage along the ring (to the next stage, or
        back to the previous one) and return what the other neighbour
        sent."""
        recv = torch.empty_like(send)
        dst, src = (self.nxt, self.prv) if to_next else (self.prv, self.nxt)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send.contiguous(), dst, self.group),
            dist.P2POp(dist.irecv, recv, src, self.group)])
        for r in reqs:
            r.wait()
        return recv

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the stages, in place."""
        if self.n > 1:
            dist.all_reduce(t, group=self.group)
        return t


class _Schedule(torch.autograd.Function):
    """The fill/drain schedule over microbatches ``xs`` [M, mb, ...] and
    this rank's stage param tensors ``ws`` (whole stacked leaves, taken at
    ``[stage]``, or a DTensor's local [1, ...] shard, taken at ``[0]``)."""

    @staticmethod
    def forward(ctx, layer_fn, ring, treedef, local, xs, *ws):
        n_micro, S, stage = xs.shape[0], ring.n, ring.stage
        sp = tree_unflatten([w[0] if lc else w[stage]
                             for w, lc in zip(ws, local)], treedef)
        saved = {}
        recv = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(n_micro + S - 1):
            inp = xs[min(t, n_micro - 1)] if stage == 0 else recv
            if 0 <= t - stage < n_micro:
                saved[t] = inp
            y = layer_fn(sp, inp)
            # the last stage finishes microbatch t - (S - 1) on tick t
            if stage == S - 1 and t >= S - 1:
                outs[t - (S - 1)] = y
            recv = ring.shift(y, to_next=True) if S > 1 else y
        # results live on the last stage only; replicate them
        if stage != S - 1:
            outs.zero_()
        ring.sum(outs)
        ctx.layer_fn, ctx.ring, ctx.treedef, ctx.local = (layer_fn, ring,
                                                          treedef, local)
        ctx.saved = saved
        ctx.save_for_backward(*ws)
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_outs):
        ring, S, stage = ctx.ring, ctx.ring.n, ctx.ring.stage
        n_micro = g_outs.shape[0]
        ws = ctx.saved_tensors
        want_x = ctx.needs_input_grad[4]
        want_w = ctx.needs_input_grad[5:]
        # this stage's slices, as leaves of the recomputes
        sp_leaves = [(w.detach()[0] if lc else w.detach()[stage])
                     .requires_grad_(g)
                     for w, lc, g in zip(ws, ctx.local, want_w)]
        sp = tree_unflatten(sp_leaves, ctx.treedef)
        g_sp = [torch.zeros_like(s) if g else None
                for s, g in zip(sp_leaves, want_w)]
        g_xs = torch.zeros_like(g_outs) if want_x else None
        g_recv = torch.zeros_like(g_outs[0])
        for t in reversed(range(n_micro + S - 1)):
            g_y = g_recv
            if stage == S - 1 and t >= S - 1:
                g_y = g_y + g_outs[t - (S - 1)]
            g_inp = None
            inp = ctx.saved.pop(t, None)
            if inp is not None:
                inp = inp.detach().requires_grad_(want_x or stage > 0)
                wrt = [inp] if inp.requires_grad else []
                wrt += [s for s in sp_leaves if s.requires_grad]
            if inp is not None and wrt:
                with torch.enable_grad():
                    y = ctx.layer_fn(sp, inp)
                grads = list(torch.autograd.grad(y, wrt, g_y,
                                                 allow_unused=True))
                if inp.requires_grad:
                    g_inp = grads.pop(0)
                for i, s in enumerate(sp_leaves):
                    if s.requires_grad:
                        g = grads.pop(0)
                        if g is not None:
                            g_sp[i] += g
                if stage == 0 and want_x and g_inp is not None:
                    g_xs[t] += g_inp
            if S > 1 and t > 0:
                # stage 0's input was the feed: the last stage's output
                # it was sent is unused, its cotangent zero
                send = g_inp if stage > 0 and g_inp is not None \
                    else torch.zeros_like(g_recv)
                g_recv = ring.shift(send, to_next=False)
        ctx.saved = None
        g_ws = []
        for w, g, lc in zip(ws, g_sp, ctx.local):
            if g is None:
                g_ws.append(None)
            elif lc:
                g_ws.append(g.unsqueeze(0))
            else:
                whole = torch.zeros_like(w)
                whole[stage] = g
                g_ws.append(ring.sum(whole))
        if g_xs is not None:
            ring.sum(g_xs)
        return (None, None, None, None, g_xs, *g_ws)


def make_pipeline_forward(layer_fn: Callable, mesh, *, n_micro: int,
                          axis: str = None):
    """Build ``pipe(stage_params, x) -> y`` running ``layer_fn`` over a
    pipeline of ``mesh``'s ``axis`` dimension (default: its first) with
    ``n_micro`` microbatches.

    ``layer_fn(stage_params_slice, x)`` applies one stage's layer slice to a
    microbatch and must be shape-preserving in ``x``. ``stage_params`` is the
    output of ``stack_stage_params`` (plain tensors, the same on every
    rank, or DTensors sharded on the stage dim); ``x`` is [B, ...] with
    B % n_micro == 0, the same on every rank of the stage dimension. ``y``
    is differentiable in both (module docstring).
    """
    from torch.distributed.tensor import DTensor
    axis = axis or mesh.mesh_dim_names[0]
    ring = _Ring(mesh, axis)

    def pipe(stage_params, x):
        batch = x.shape[0]
        assert batch % n_micro == 0, (batch, n_micro)
        mb = batch // n_micro
        xs = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
        leaves, treedef = tree_flatten(stage_params)
        local = [isinstance(w, DTensor) for w in leaves]
        ws = [w.to_local() if lc else w for w, lc in zip(leaves, local)]
        ys = _Schedule.apply(layer_fn, ring, treedef, local, xs, *ws)
        return ys.reshape((batch,) + tuple(x.shape[1:]))

    return pipe
