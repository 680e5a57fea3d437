"""Preemption substrate: cost model, victim-eligibility policy, progress
ledger.

The paper's scheduler is admission-only — once a kernel is placed it runs to
completion, so under overload a late-arriving urgent job can only wait (or be
shed). This module supplies the pieces the preemptive scheduler layer
(``repro_torch.core.scheduler.preempt``) builds on:

  * **decision rule** (``outranks``): an arriving waiter may evict a resident
    only if it STRICTLY outranks it on the same order the admission queue
    enforces — higher priority class first, then earlier absolute deadline
    (EDF) within a class. Strictness means preemption only ever moves
    resources up the rank order, so eviction chains terminate (a victim can
    never preempt its preemptor back);
  * **cost model** (``preemption_cost``): evicting a resident forfeits its
    in-flight state, so the victim set is chosen to minimize
    ``remaining work x held memory`` — the product of the compute we would
    re-run without a checkpoint and the state a checkpoint would have to
    move. ``remaining_estimate`` supplies the remaining-work term from the
    progress ledger minus time-in-residence (the simulator overwrites the
    estimate with its exact value at eviction);
  * **progress ledger** (``ProgressLedger``): uid -> remaining solo-work
    seconds, banked at eviction so resumed work is work-conserving — the
    simulator restarts the task at its remaining work (plus a configurable
    checkpoint/restore penalty) instead of from scratch, and the live
    executor's cost estimates stay honest across repeated evictions;
  * **guardrails** (``PreemptionPolicy``): ``min_runtime_s`` before a
    resident becomes preemptible (no thrash on fresh admissions),
    ``budget`` evictions per job after which it is immune, and
    ``aging_step`` priority escalation per eviction so a repeatedly-bumped
    low-priority job eventually outranks the stream that keeps displacing
    it (starvation freedom).

Copy of ``src/repro/core/preemption.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import interference
from repro_torch.core.task import Task

# floor on the remaining-work estimate: a task observed nearly done still
# costs SOMETHING to evict (checkpoint + restore round trip at minimum)
_REMAINING_FLOOR_S = 1e-3


@dataclasses.dataclass
class PreemptionPolicy:
    """Guardrail knobs for the preemptive scheduler layer.

    Defaults are calibrated for the repo's benchmark scales (jobs of seconds
    to tens of virtual seconds): a resident must survive ``min_runtime_s``
    before it is eligible as a victim, a job is evicted at most ``budget``
    times before becoming immune, and each eviction raises the victim's
    priority by ``aging_step`` classes so sustained high-priority arrivals
    cannot starve it forever. ``checkpoint_penalty_s`` is the restore cost a
    resumed task pays before making new progress (the simulator charges it
    explicitly; a live training task pays it inside its own
    checkpoint-restore path).
    """
    min_runtime_s: float = 0.25
    budget: int = 3
    aging_step: int = 1
    checkpoint_penalty_s: float = interference.CHECKPOINT_PENALTY_S


class ProgressLedger:
    """Remaining-work bank for preempted tasks, keyed by task uid.

    ``set_remaining`` is called at eviction (the scheduler estimates; the
    simulator overwrites with the exact value), ``remaining`` answers cost
    queries and the resume path, ``clear`` drops the entry on completion.
    Mutations happen under the owning scheduler's lock, so no lock here.
    """

    def __init__(self) -> None:
        self._remaining: Dict[int, float] = {}

    def set_remaining(self, uid: int, seconds: float) -> None:
        self._remaining[uid] = max(seconds, _REMAINING_FLOOR_S)

    def remaining(self, task: Task) -> float:
        """Remaining solo-work seconds: the banked value for a previously
        preempted task, the full estimate otherwise."""
        return self._remaining.get(task.uid, task.resources.est_seconds)

    def remaining_or_none(self, uid: int) -> Optional[float]:
        """Banked remaining work, or None if the task was never preempted
        (callers then start it from its full estimate)."""
        return self._remaining.get(uid)

    def clear(self, uid: int) -> None:
        self._remaining.pop(uid, None)

    def __len__(self) -> int:
        return len(self._remaining)


def outranks(waiter: Task, resident: Task) -> bool:
    """Strict rank order for the eviction decision — the admission queue's
    own order (priority class desc, then EDF within a class). A waiter that
    merely TIES a resident never preempts it: strictness is what makes
    eviction chains terminate and keeps equal-class work FIFO."""
    if waiter.priority != resident.priority:
        return waiter.priority > resident.priority
    if waiter.deadline_t is None:
        return False  # no deadline: cannot outrank within its own class
    return resident.deadline_t is None or waiter.deadline_t < resident.deadline_t


def remaining_estimate(task: Task, ledger: ProgressLedger,
                       elapsed_s: float) -> float:
    """Remaining-work estimate for a RESIDENT task: its banked (or full)
    remaining work minus time in residence this attempt. An estimate — wall
    residence overstates progress on a shared chip — but it only has to rank
    victims, and the simulator replaces it with the exact value at eviction."""
    return max(ledger.remaining(task) - max(elapsed_s, 0.0),
               _REMAINING_FLOOR_S)


def preemption_cost(task: Task, remaining_s: float) -> float:
    """Eviction cost of a resident: remaining work x held memory (GB·s).

    Both terms measure forfeited/moved state: the compute a checkpointless
    restart would redo, and the bytes a checkpoint must serialize + restore.
    A gang charges its WHOLE footprint — it is evicted whole or not at all."""
    return remaining_s * (task.resources.hbm_bytes / 1e9)
