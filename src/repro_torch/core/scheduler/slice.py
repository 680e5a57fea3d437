"""Beyond-paper: slice-level scheduling on a pod mesh — now a thin client of
the gang placement subsystem.

Historically this module owned its own grid math (rect enumeration, per-chip
fit checks). That all lives in ``repro_torch.core.topology`` now, and the
atomic reservation + waiter-queue integration lives in
``repro_torch.core.scheduler.gang.GangScheduler``; ``SliceScheduler``
survives as the memory-hard / compute-soft (Alg. 3) configuration of that subsystem at
pod-fleet defaults — the 1000+-node story: a 2-pod 512-chip system schedules
a mix of 405B whole-slice training tasks and tiny SSM decode tasks without
fragmenting the torus, with ICI/DCN link accounting it never had before.

Copy of ``src/repro/core/scheduler/slice.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

from repro_torch.core.scheduler.base import DEFAULT_HBM
from repro_torch.core.scheduler.gang import GangScheduler
from repro_torch.core.topology import SliceRect  # noqa: F401  (legacy re-export)


class SliceScheduler(GangScheduler):
    """Places k-chip tasks on contiguous slices of a multi-pod chip grid:
    ``GangScheduler`` with the Alg. 3 policy (memory hard per member chip,
    compute + links soft with min-demand / least-link-pressure tie-breaks)
    at pod-scale defaults."""

    def __init__(self, pods: int = 2, rows: int = 16, cols: int = 16,
                 hbm_per_chip: int = DEFAULT_HBM):
        super().__init__(pods, rows, cols, policy="alg3",
                         hbm_per_chip=hbm_per_chip)
        self.name = "MGB-slice"
