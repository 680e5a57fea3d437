"""Baseline schedulers the paper evaluates against (§IV):

  * **SA** — single-assignment: one job per device, dedicated access for the
    job's lifetime (Slurm-style). Memory-safe, heavily under-utilized.
  * **CG** — core-to-GPU ratio packing under MPS: round-robin up to ``ratio``
    jobs per device with NO knowledge of memory or compute needs. Memory-
    UNSAFE: admitting a task that exceeds free HBM crashes the job (OOM), the
    behaviour Table II quantifies.
  * **MemOnly** — schedGPU [Reaño et al.]: memory is the only criterion and
    there is no device reassignment — a job is admitted to the FIRST device
    with enough free memory (so compute hot-spots pile up on device 0, the
    effect Fig. 6 shows).

Copy of ``src/repro/core/scheduler/baselines.py`` with its imports rewritten
to ``repro_torch``; keep the two in step.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.scheduler.base import DeviceState, Scheduler
from repro_torch.core.task import Task


class SAScheduler(Scheduler):
    """Single-assignment: a device hosts at most one task/job at a time."""

    name = "SA"

    def device_feasible(self, task: Task, dev: DeviceState) -> bool:
        return dev.alive and not dev.residents

    def select_device(self, task: Task) -> Optional[DeviceState]:
        for dev in self.devices:
            if self.device_feasible(task, dev):
                return dev
        return None


class CGScheduler(Scheduler):
    """Ratio-based packing, memory-oblivious (the unsafe baseline).

    ``ratio`` = max co-resident jobs per device. Selection is round-robin over
    devices with a free slot; free HBM is NOT consulted — ``task_begin``
    succeeds even when the task's footprint exceeds the device, and the
    executor/simulator turns that into an OOM crash (paper Table II).
    """

    name = "CG"

    def __init__(self, num_devices: int, ratio: int = 4, **kw):
        super().__init__(num_devices, **kw)
        self.ratio = ratio
        self._rr = 0

    def can_ever_fit(self, task: Task) -> bool:
        # memory-oblivious: any alive device "fits" (and may then OOM)
        return any(d.alive for d in self.devices)

    def device_feasible(self, task: Task, dev: DeviceState) -> bool:
        # free HBM deliberately NOT consulted — the whole point of CG
        return dev.alive and len(dev.residents) < self.ratio

    def select_device(self, task: Task) -> Optional[DeviceState]:
        n = len(self.devices)
        for k in range(n):
            dev = self.devices[(self._rr + k) % n]
            if self.device_feasible(task, dev):
                self._rr = (self._rr + k + 1) % n
                return dev
        return None


class MemOnlyScheduler(Scheduler):
    """schedGPU: memory-safe but compute-blind and reassignment-free."""

    name = "schedGPU"

    def device_feasible(self, task: Task, dev: DeviceState) -> bool:
        return dev.alive and task.resources.hbm_bytes <= dev.free_hbm

    def select_device(self, task: Task) -> Optional[DeviceState]:
        for dev in self.devices:  # first fit — never balances
            if self.device_feasible(task, dev):
                return dev
        return None
