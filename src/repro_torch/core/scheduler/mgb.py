"""MGB schedulers — the paper's contribution (Algorithms 2 and 3).

Alg. 2 (exact): emulates the hardware dispatcher. On a GPU that means walking
SMs and placing thread blocks; the TPU analogue (DESIGN.md §2) divides each
chip's compute-seconds into ``SLOTS`` equal slots and requires the task's
``ceil(core_demand * SLOTS)`` slots to be free — memory AND compute are hard
constraints, so a task waits until a chip can run it without dilation.

Alg. 3 (fast): memory is hard, compute is soft — among memory-feasible
devices pick the one with the least aggregate in-use core demand (the paper's
"fewest in-use warps"). Optimistic: it will oversubscribe compute to exploit
fast completions, which §V-B shows wins ~1.21x throughput over Alg. 2 at the
cost of <1% extra kernel slowdown.

Both policies are admission-only; their preemptive upgrades (evict running
lower-ranked work for an urgent arrival) live in ``scheduler.preempt`` as
``PreemptiveAlg2Scheduler`` / ``PreemptiveAlg3Scheduler`` — same
``device_feasible`` predicates, reused verbatim by the victim planner.

Copy of ``src/repro/core/scheduler/mgb.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.scheduler.base import (
    SLOTS, DeviceState, Scheduler, slots_needed,
)
from repro_torch.core.task import Task
from repro_torch.obs import explain as obsx


class MGBAlg2Scheduler(Scheduler):
    """Exact slot accounting: memory and compute both hard constraints."""

    name = "MGB-Alg2"

    def device_feasible(self, task: Task, dev: DeviceState) -> bool:
        if not dev.alive:
            return False
        if task.resources.hbm_bytes > dev.free_hbm:
            return False  # memory: hard
        # dev.used_slots is maintained on admit/release: O(1) per device
        return dev.used_slots + slots_needed(task) <= SLOTS  # compute: hard

    def device_verdict(self, task: Task, dev: DeviceState) -> Optional[dict]:
        if not dev.alive:
            return {"device": dev.index + self._trace_dev_off,
                    "reason": obsx.R_DEVICE_DEAD}
        if task.resources.hbm_bytes > dev.free_hbm:
            return {"device": dev.index + self._trace_dev_off,
                    "reason": obsx.R_MEMORY_SHORT,
                    "short_bytes": task.resources.hbm_bytes - dev.free_hbm}
        need = slots_needed(task)
        if dev.used_slots + need > SLOTS:
            return {"device": dev.index + self._trace_dev_off,
                    "reason": obsx.R_SLOTS_FULL,
                    "short_slots": dev.used_slots + need - SLOTS}
        return None

    def select_device(self, task: Task) -> Optional[DeviceState]:
        for dev in self.devices:
            if self.device_feasible(task, dev):
                return dev
        return None


class MGBAlg3Scheduler(Scheduler):
    """Memory-hard / compute-soft: min in-use demand among feasible devices."""

    name = "MGB-Alg3"

    def __init__(self, num_devices: int, max_residents: int = 0, **kw):
        super().__init__(num_devices, **kw)
        # optional resident cap (0 = none). The paper relies on the worker-pool
        # size for backpressure; the executor passes 0.
        self.max_residents = max_residents

    def device_feasible(self, task: Task, dev: DeviceState) -> bool:
        if not dev.alive:
            return False
        if task.resources.hbm_bytes > dev.free_hbm:
            return False  # memory: hard — never an OOM (paper's guarantee)
        return not (self.max_residents
                    and len(dev.residents) >= self.max_residents)

    def device_verdict(self, task: Task, dev: DeviceState) -> Optional[dict]:
        if not dev.alive:
            return {"device": dev.index + self._trace_dev_off,
                    "reason": obsx.R_DEVICE_DEAD}
        if task.resources.hbm_bytes > dev.free_hbm:
            return {"device": dev.index + self._trace_dev_off,
                    "reason": obsx.R_MEMORY_SHORT,
                    "short_bytes": task.resources.hbm_bytes - dev.free_hbm}
        if self.max_residents and len(dev.residents) >= self.max_residents:
            return {"device": dev.index + self._trace_dev_off,
                    "reason": obsx.R_MAX_RESIDENTS,
                    "cap": self.max_residents}
        return None

    def select_device(self, task: Task) -> Optional[DeviceState]:
        best: Optional[DeviceState] = None
        for dev in self.devices:
            if not self.device_feasible(task, dev):
                continue
            if best is None or dev.in_use_demand < best.in_use_demand:
                best = dev
        return best
