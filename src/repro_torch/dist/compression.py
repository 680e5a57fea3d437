"""Blockwise int8 gradient compression with error feedback.

Port of ``src/repro/dist/compression.py``, with the same arithmetic:
blocks of ``BLOCK`` elements over the row-major flattened tensor (the tail
zero-padded), scale ``absmax / 127``, codes rounded half to even
(``torch.round``, as ``jnp.round``) and clipped to [-127, 127] as int8,
then dequantized. On f32 inputs the result equals the reference's bit for
bit. ``compress_decompress`` is the quantize->dequantize round trip a
``grad_compressor`` applies to gradients before the optimizer
(``repro_torch.train.train_step``).

Scaling is per-block absmax: within each block the dequantization error is
at most ``absmax(block) / 254`` per element (half a quantization step), so
blocks isolate outliers.

A DTensor gradient is compressed in the blocks of its GLOBAL flattened
order, so a sharded step quantizes as the unsharded one does. Where each
rank's shard is a whole number of global blocks (every placement
replicated, or the leading dim split evenly with a local extent that is a
multiple of ``BLOCK``) the local shard is compressed in place of the
whole; otherwise the gradient is gathered (``full_tensor``), compressed
whole on every rank, and each rank keeps its shard again.

Error feedback (``apply_with_error_feedback``) carries the per-step residual
forward so the APPLIED gradient stream telescopes: after any number of
steps, sum(applied) + residual == sum(true gradients) exactly (in f32),
which is what keeps compressed training unbiased over time.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch
from torch.utils._pytree import tree_map

BLOCK = 256


def _compress_plain(g: torch.Tensor, block: int) -> torch.Tensor:
    flat = g.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % block
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    amax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = codes.to(torch.float32) * scale
    return deq.reshape(-1)[:n].reshape(g.shape).to(g.dtype)


def blocks_are_local(g, block: int = BLOCK) -> bool:
    """Whether each rank's shard of the DTensor ``g`` is a whole number of
    global blocks in the global row-major order."""
    from torch.distributed.tensor import Replicate, Shard
    split = 1
    for size, pl in zip(g.device_mesh.shape, g.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            split *= size
        elif not isinstance(pl, Replicate):
            return False
    if split == 1:
        return True
    rows = g.shape[0]
    return rows % split == 0 \
        and (rows // split) * math.prod(g.shape[1:]) % block == 0


def compress_decompress(g: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Blockwise int8 quantize + dequantize (shape/dtype preserving; a
    DTensor keeps its placements)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(g, DTensor):
        return _compress_plain(g, block)
    mesh, placements = g.device_mesh, g.placements
    if blocks_are_local(g, block):
        return DTensor.from_local(_compress_plain(g.to_local(), block), mesh,
                                  placements, shape=g.shape,
                                  stride=g.stride())
    whole = _compress_plain(g.full_tensor(), block)
    return DTensor.from_local(whole, mesh, [Replicate()] * mesh.ndim) \
        .redistribute(mesh, placements)


def init_error_state(grads: Any) -> Any:
    """Zero residual tree matching ``grads`` (f32: residuals must accumulate
    exactly for the telescoping invariant)."""
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads)


def apply_with_error_feedback(grads: Any, err_state: Any) -> Tuple[Any, Any]:
    """(grads, residual) -> (compressed grads to apply, new residual).

    q_t = Q(g_t + e_{t-1});  e_t = (g_t + e_{t-1}) - q_t
    => sum_t q_t + e_T == sum_t g_t  (telescopes, exactly in f32).
    """
    corrected = tree_map(lambda g, e: g.to(torch.float32) + e, grads,
                         err_state)
    q = tree_map(compress_decompress, corrected)
    new_err = tree_map(lambda c, qq: c - qq, corrected, q)
    return q, new_err
