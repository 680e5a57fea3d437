"""Reference admission queue: the historical sorted-list implementation.

Before the fleet-scale refactor the waiter queue was a flat list kept sorted
by ``_Waiter.key`` via ``bisect.insort``, and every drain was a full rank-
order scan. That implementation is preserved here VERBATIM (modulo the class
name) as a test-only oracle and benchmark foil:

  * the property battery (``tests/test_sched_scale.py``) replays seeded
    priority/EDF/aging/restart traces through both queues and asserts
    identical admission sequences — the indexed queue in ``base.py`` must be
    bit-for-bit order-equivalent;
  * ``benchmarks/bench_sched_scale.py`` measures the pre-refactor engine's
    admissions/sec against the indexed engine at depth 1e2→1e5.

Do NOT use these classes in production paths: enqueue is O(n) memmove and
every wakeup is O(queue). They exist so the old behaviour stays executable.

Copy of ``src/repro/core/scheduler/reference.py`` with its imports rewritten
to ``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import bisect
import math
from typing import Any, List, Tuple

from repro_torch.core.scheduler.base import (
    DEADLINE_SHED, AdmitCallback, WaiterQueueMixin, _Waiter,
)
from repro_torch.core.scheduler.mgb import MGBAlg2Scheduler, MGBAlg3Scheduler
from repro_torch.core.task import Task


class SortedListWaiterQueueMixin(WaiterQueueMixin):
    """The pre-refactor queue: a bisect-sorted list + full-scan drain.

    Overrides exactly the methods whose implementation moved to the index;
    everything else (epoch fencing, deferred notifications, the admission
    entry points) is shared with the production mixin, so a divergence in a
    parity test localises to the queue representation itself."""

    def _init_waiters(self) -> None:
        super()._init_waiters()
        # kept sorted by _Waiter.key; the drain scans it in rank order
        self._waiters: List[_Waiter] = []

    def _enqueue_locked(self, task: Task, callback: AdmitCallback, *,
                        restart: bool = False) -> _Waiter:
        if restart:
            self._restart_seq -= 1
            seq = self._restart_seq
        else:
            self._seq += 1
            seq = self._seq
        w = _Waiter(task,
                    callback,
                    getattr(task, "priority", 0)
                    + getattr(task, "age_boost", 0),
                    getattr(task, "deadline_t", None), restart, seq,
                    vec=task.resources)
        w.sort_key = w.key
        bisect.insort(self._waiters, w, key=lambda x: x.key)
        return w

    def _drain_locked(self, freed: Any = None
                      ) -> List[Tuple[_Waiter, Any, int]]:
        """The historical rank-order scan (deadline shed, freed-capacity
        hint, bounded failed-vector memo, preemption dominance memo)."""
        fired: List[Tuple[_Waiter, Any, int]] = []
        still: List[_Waiter] = []
        failed: List[Any] = []    # ResourceVectors infeasible this pass
        pfailed: List[Tuple[Any, int, float]] = []
        now = self._clock() if self.shed_expired else None
        # scan a snapshot: a mid-scan preemption re-enqueues its victims into
        # self._waiters (emptied here), so they survive the final merge
        pending, self._waiters = self._waiters, []
        for w in pending:  # already sorted by rank
            if (now is not None and w.deadline_t is not None
                    and now > w.deadline_t):
                self._admit_cbs.pop(w.task.uid, None)
                self._forget_task_locked(w.task)
                fired.append((w, DEADLINE_SHED,
                              self._epochs.get(w.task.uid, 0)))
                continue
            placement = None
            if freed is not None and not self._hint_may_fit(w.task, freed):
                self.hint_skips += 1
            elif any(f == w.task.resources for f in failed):
                pass  # identical vector already failed this pass
            else:
                placement = self._admit_locked(w.task)
                if placement is None and len(failed) < self._DRAIN_MEMO:
                    failed.append(w.task.resources)
            if placement is None and self.preempt_enabled:
                tprio = getattr(w.task, "priority", 0)
                tdl = w.task.deadline_t if w.task.deadline_t is not None \
                    else math.inf
                dominated = any(
                    res == w.task.resources
                    and (prio > tprio or (prio == tprio and dl <= tdl))
                    for res, prio, dl in pfailed)
                if dominated:
                    placement = None
                else:
                    placement = self._preempt_admit_locked(w.task)
                if placement is None:
                    if not dominated and len(pfailed) < self._DRAIN_MEMO:
                        pfailed.append((w.task.resources, tprio, tdl))
                else:
                    failed.clear()
                    pfailed.clear()
                    freed = None
            if placement is None:
                still.append(w)
            else:
                self._admit_cbs[w.task.uid] = w.callback
                fired.append((w, placement,
                              self._epochs.get(w.task.uid, 0)))
        if self._waiters:
            # preemption victims were re-enqueued mid-scan: merge survivors
            for w in still:
                bisect.insort(self._waiters, w, key=lambda x: x.key)
        else:
            self._waiters = still
        return fired

    # -- introspection / cancellation (all O(n) scans, as before) ----------
    def waiting_count(self) -> int:
        with self._lock:
            return len(self._waiters)

    def queue_stats(self) -> dict:
        # recomputed by scan — the very behaviour the satellite replaces;
        # shape-compatible with the production counters for parity tests
        with self._lock:
            per_class: dict = {}
            for w in self._waiters:
                per_class[w.priority] = per_class.get(w.priority, 0) + 1
            return {
                "depth": len(self._waiters),
                "per_class": per_class,
                "classes": len({w.vec for w in self._waiters}),
                "hint_skips": self.hint_skips,
            }

    def waiting_tasks(self) -> List[Task]:
        with self._lock:
            return [w.task for w in self._waiters]

    def cancel_wait(self, task: Task) -> bool:
        with self._lock:
            for w in self._waiters:
                if w.task.uid == task.uid:
                    self._waiters.remove(w)
                    self._admit_cbs.pop(task.uid, None)
                    return True
        return False

    def cancel_all_waiters(self) -> List[Task]:
        with self._lock:
            out = [w.task for w in self._waiters]
            for w in self._waiters:
                self._admit_cbs.pop(w.task.uid, None)
            self._waiters.clear()
            return out

    def _fail_impossible_locked(self) -> List[Tuple[_Waiter, Any, int]]:
        failed: List[Tuple[_Waiter, Any, int]] = []
        still: List[_Waiter] = []
        for w in self._waiters:
            if self.can_ever_fit(w.task):
                still.append(w)
            else:
                self._forget_task_locked(w.task)
                failed.append((w, None, self._epochs.get(w.task.uid, 0)))
        self._waiters = still
        return failed


class ReferenceAlg2Scheduler(SortedListWaiterQueueMixin, MGBAlg2Scheduler):
    """MGB Alg. 2 over the pre-refactor sorted-list queue (oracle)."""

    name = "MGB-Alg2-reference"


class ReferenceAlg3Scheduler(SortedListWaiterQueueMixin, MGBAlg3Scheduler):
    """MGB Alg. 3 over the pre-refactor sorted-list queue (oracle)."""

    name = "MGB-Alg3-reference"
