"""Elastic rescale: re-shard a live train state onto a different mesh.

Port of ``src/repro/train/elastic.py``. When a pod loses hosts (or gains
them back), training continues on a shrunken/grown mesh instead of
stalling: the sharding rules are re-derived for the new mesh
(divisibility-aware, so a 16->8-way model axis still shards), and every
leaf is re-placed. The data pipeline's global batch is re-split over the
new data-axis size.

A DTensor cannot be ``device_put`` onto a mesh over other ranks, so each
leaf is gathered whole on the old mesh (``full_tensor``, a collective every
rank of the old mesh joins) and each rank of the new mesh keeps its shard
of it under the new placements (a local slice, no transfer). Every rank of
the old mesh calls ``reshard_state``; a rank outside the new mesh holds
nothing afterwards and gets ``(None, None)``.

The scheduler composes with this: a slice task whose device count changed
simply re-enters the queue with an updated ``chips`` in its ResourceVector.
"""
from __future__ import annotations

from typing import Any, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding as SH


def _replace(x, spec, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    full = x.full_tensor() if isinstance(x, DTensor) else x
    if mesh.get_coordinate() is None:
        return None
    whole = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim)
    return whole.redistribute(mesh, SH.to_placements(spec, mesh))


def reshard_state(cfg: ArchConfig, params: Any, opt_state: Any,
                  new_mesh) -> Tuple[Any, Any]:
    """Re-place (params, opt_state) onto ``new_mesh`` under re-derived
    rules; ``(None, None)`` on a rank outside ``new_mesh``."""
    pspecs = SH.param_specs(cfg, params, new_mesh)

    def tree(t):
        return SH.zip_map(lambda x, s: _replace(x, s, new_mesh), t, pspecs)
    new_params = tree(params)
    new_opt = {"mu": tree(opt_state["mu"]), "nu": tree(opt_state["nu"]),
               "step": opt_state["step"]}
    if new_mesh.get_coordinate() is None:
        return None, None
    return new_params, new_opt


def rescale_batch_size(global_batch: int, old_data: int, new_data: int) -> int:
    """Keep per-device batch constant across the rescale (linear-scaling-rule
    LR adjustments are the optimizer schedule's job)."""
    per_dev = max(global_batch // old_data, 1)
    return per_dev * new_data
