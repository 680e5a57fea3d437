"""Device-group helpers for placements.

Port of ``src/repro/core/topology.py:97-104`` (``placement_devices`` only).
The pod/mesh model, link accounting and gang placement come with the H100
fleet model in a later slice.
"""
from __future__ import annotations

from typing import Tuple


def placement_devices(placement) -> Tuple[int, ...]:
    """Normalize a scheduler placement to flat device indices: an int from
    the flat schedulers becomes a 1-tuple, a gang reservation contributes
    its whole group."""
    idx = getattr(placement, "device_indices", None)
    if idx is not None:
        return tuple(idx)
    return (placement,)
