"""Co-execution interference model for tasks sharing a chip.

TPUs serialize programs per core, so "sharing a chip" means queued
co-execution — the TPU analogue of MPS timeslicing (DESIGN.md §2). Two
contended resources per chip:

  * compute (TensorCore-seconds): resident i needs ``core_demand`` d_i;
  * HBM bandwidth: resident i needs ``bw_demand`` b_i.

If sum(d) <= 1 and sum(b) <= 1 the chip interleaves memory-stalled tasks
behind compute with no slowdown; past either roof every resident dilates by
the larger oversubscription (processor sharing on the bottleneck resource).
An extra ``eta`` per co-resident models cache/queue overhead — calibrated so
the paper's observed kernel slowdowns (<=2.5% at typical Alg. 3 packing) are
reproduced at total demand ~1 with 2-4 residents.

This is deliberately simple: the paper's schedulers only need a monotone
"overload hurts, modestly" model, and §V-F shows slowdowns stay in single
digits under both algorithms.

Copy of ``src/repro/core/interference.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

from typing import Sequence, Tuple

ETA_PER_RESIDENT = 0.008   # calibrated: 4 residents -> ~2.4% overhead

# Checkpoint/restore penalty a preempted task pays when it resumes (the
# simulator charges it before new progress; a live training task pays it
# inside train/checkpoint.py's restore path). Calibrated to the repo's
# AsyncCheckpointer scale: a snapshot+restore round trip of a few-GB train
# state is sub-second, small against the 8-40 s benchmark jobs it protects.
CHECKPOINT_PENALTY_S = 0.5

Demand = Tuple[float, float]   # (core_demand, bw_demand)


def slowdown(demands: Sequence[Demand]) -> float:
    """Dilation factor applied to every resident task's progress rate."""
    n = len(demands)
    if n <= 1:
        return 1.0
    core = sum(d for d, _ in demands)
    bw = sum(b for _, b in demands)
    overhead = 1.0 + ETA_PER_RESIDENT * (n - 1)
    return max(core, bw, 1.0) * overhead


def rate(demands: Sequence[Demand]) -> float:
    """Progress rate (fraction of solo speed) for each resident."""
    return 1.0 / slowdown(demands)


def ici_slowdown(link_loads: Sequence[float]) -> float:
    """ICI-contention dilation for a multi-chip task whose collectives share
    mesh links with co-resident gangs.

    ``link_loads`` are the aggregate bandwidth shares (own + neighbours') on
    each link the task is charged on (``Topology.task_link_loads``). Like the
    per-chip model above, this is processor sharing on the bottleneck
    resource: as long as every shared link has headroom (sum <= 1) the
    collectives interleave with no slowdown; past the roof on ANY link the
    whole gang dilates by the worst oversubscription — a synchronized
    collective advances at its slowest link's pace. A link-free task (no
    collectives, or chips == 1) is never dilated."""
    if not link_loads:
        return 1.0
    return max(max(link_loads), 1.0)
