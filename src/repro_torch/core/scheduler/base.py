"""Scheduler substrate: per-device state + the task_begin/task_end API,
plus the waiter/notification machinery behind the event-driven executor.

The paper's scheduler is a user-level daemon; probes talk to it over shared
memory and a blocked ``task_begin`` sleeps on *notify* until ``task_end``
frees capacity. Here it is an in-process object with the same contract in
three flavours:

    dev = sched.task_begin(task)        # None => no feasible device
    sched.admit_or_enqueue(task, cb)    # non-blocking: cb fires on admission
    dev = sched.task_begin_blocking(t)  # condition-variable wait, no spinning
    sched.task_end(task)                # frees resources, re-drives waiters

``admit_or_enqueue`` is the serving-scale path: a blocked task holds **no**
thread — it sits in an *admission queue* ordered by (priority desc, deadline
EDF, arrival FIFO) and every ``task_end`` (or ``revive``) re-drives admission
in that order, firing the stored callback with the placement. A ``task_end``
drain is *hinted* with the freed capacity so waiters that provably cannot
use it are skipped without a probe, and (opt-in, ``shed_expired``) waiters
whose deadline already passed are failed with ``DEADLINE_SHED`` instead of
admitted late. The ordering is
enforced here, in the queue itself: callers just stamp ``task.priority`` /
``task.deadline_t`` (``Cluster.submit`` does this per job) and park. Within
one priority class arrival order is stable; tasks with deadlines rank by
earliest absolute deadline ahead of deadline-less peers of the same priority.
``mark_dead`` evicts residents; evicted tasks that were admitted through the
waiter path are re-enqueued at the *front of their priority class* (eviction
restart) and their callback fires again when they land on a surviving device.

Stale completions (a task evicted mid-run whose old incarnation later calls
``task_end``) are fenced with a per-task *epoch*: eviction bumps the epoch, so
a ``task_end(task, epoch=old)`` from the superseded run is a no-op and cannot
release the re-admitted incarnation's resources.

**Queue representation (fleet scale).** The admission queue is an indexed
structure (``_WaiterIndex``), not a sorted list: waiters live in per-
resource-class lazy-deletion heaps keyed by ``_Waiter.key``, alongside a
deadline min-heap for O(log n) shedding and maintained depth counters so
stats never scan the queue under the lock. Enqueue/cancel are O(log n) /
O(1) instead of the old ``bisect.insort`` O(n) memmove, and the
non-preemptive drain visits *resource classes* rather than waiters: within
one drain pass feasibility depends only on the resource vector (admissions
only consume capacity), so one failed probe retires the whole class for the
pass. This produces the exact admission sequence of the historical sorted-
list scan (kept verbatim in ``scheduler.reference`` as the test oracle) —
only the ``begin_attempts`` probe count can differ when more than
``_DRAIN_MEMO`` distinct vectors fail in a single pass, because the class
skip is effectively an unbounded memo. Preemption-enabled hosts take the
full rank-order scan path (eviction invalidates the class-skip premise),
also against the index.

``DeviceState`` tracks free HBM and the aggregate core demand ("in-use warps")
of resident tasks; death marking supports the fault-tolerance tests (a dead
device is never selected and its residents re-enter the queue).

Copy of ``src/repro/core/scheduler/base.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.task import Task, observed_highwater
from repro_torch.obs import events as obs
from repro_torch.obs import explain as obsx

# 16 GB v5e HBM per chip (the paper's P100/V100 also had 16 GB)
DEFAULT_HBM = 16 * 1024**3

# Per-chip compute slots (Alg. 2's per-SM TB/warp table analogue). Lives here
# rather than in mgb.py so DeviceState can maintain the in-use slot count
# incrementally on admit/release.
SLOTS = 16

# callback(task, placement, epoch) — placement is a device index for the flat
# schedulers and a GangReservation for the gang/slice schedulers
AdmitCallback = Callable[[Task, Any, int], None]


class _DeadlineShed:
    """Sentinel placement: the waiter's deadline passed while it was parked
    and the scheduler's ``shed_expired`` policy failed it at the drain
    instead of admitting it late. Distinct from ``None`` (permanently
    infeasible — give up) so callers can report shed work separately."""

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "DEADLINE_SHED"


DEADLINE_SHED = _DeadlineShed()

# preallocated skip-verdict reasons (obs.explain): collapse-recorded on the
# drain's probe-avoidance paths, so the tuples must not be rebuilt per skip
_HINT_SKIP_REASONS = ({"reason": obsx.R_HINT_SKIP},)
_CLASS_MEMO_REASONS = ({"reason": obsx.R_CLASS_MEMO},)
_PREEMPT_MEMO_REASONS = ({"reason": "preempt_memo_skip"},)


def slots_needed(task: Task) -> int:
    """Compute slots a task occupies while resident (>= 1 even at demand 0:
    a resident kernel always holds an issue slot)."""
    return max(1, math.ceil(task.resources.demand * SLOTS))


@dataclasses.dataclass
class DeviceState:
    index: int
    total_hbm: int = DEFAULT_HBM
    used_hbm: int = 0
    alive: bool = True
    residents: Dict[int, Task] = dataclasses.field(default_factory=dict)
    # in-use compute slots, maintained incrementally on admit/release so the
    # MGB Alg. 2 feasibility check is O(1) per candidate device instead of
    # O(residents) (it runs once per device per placement attempt)
    used_slots: int = 0

    @property
    def free_hbm(self) -> int:
        return self.total_hbm - self.used_hbm

    @property
    def in_use_demand(self) -> float:
        """Aggregate dominant-resource demand — the paper's 'active warps'."""
        return sum(t.resources.demand for t in self.residents.values())

    def demands(self) -> List[tuple]:
        return [(t.resources.core_demand, t.resources.bw_demand)
                for t in self.residents.values()]

    def admit(self, task: Task) -> None:
        self.used_hbm += task.resources.hbm_bytes
        self.used_slots += slots_needed(task)
        self.residents[task.uid] = task

    def release(self, task: Task) -> None:
        if task.uid in self.residents:
            del self.residents[task.uid]
            self.used_hbm -= task.resources.hbm_bytes
            self.used_slots -= slots_needed(task)
            if task.placed_host is not None:
                # settle the host's row budget on EVERY release path —
                # normal shrink, eviction, preemption alike
                task.placed_host.grown_now -= 1
                task.placed_host = None

    def oom(self) -> bool:
        return self.used_hbm > self.total_hbm


@dataclasses.dataclass
class _Waiter:
    task: Task
    callback: AdmitCallback
    priority: int = 0
    deadline_t: Optional[float] = None
    restart: bool = False       # evicted resident re-entering its class front
    seq: int = 0                # arrival order (negative for restarts)
    # resource vector cached at enqueue: Task.resources REBUILDS the vector
    # per access for multi-unit tasks, and the index buckets by it
    vec: Any = None
    # key cached at enqueue: heap pushes compare it many times
    sort_key: Tuple[int, int, float, int] = (0, 1, math.inf, 0)

    @property
    def key(self) -> Tuple[int, int, float, int]:
        """Admission rank: priority class desc, eviction-restarts at the
        front of their class, then EDF (no deadline sorts last), then stable
        arrival order."""
        return (-self.priority, 0 if self.restart else 1,
                self.deadline_t if self.deadline_t is not None else math.inf,
                self.seq)


class _WaiterIndex:
    """Indexed admission queue: per-resource-class heaps + lazy deletion.

    Waiters are bucketed by their (hashable, frozen) ``ResourceVector`` —
    feasibility within one drain pass depends only on that vector, so the
    drain works class-at-a-time. Each bucket is a min-heap of
    ``(sort_key, waiter)``; ``sort_key`` is globally unique (the seq field
    breaks every tie), so the waiter itself is never compared. Removal is
    O(1): drop the uid from ``_live`` and let stale heap entries evaporate
    when they surface at a bucket head. A parallel deadline min-heap serves
    expiry shedding without scanning, and depth counters (total, per
    priority class, per vector class) are maintained on add/discard so the
    stats paths never walk the queue."""

    __slots__ = ("_buckets", "_live", "_class_depth", "_vec_depth",
                 "_deadlines", "_dl_seq")

    def __init__(self) -> None:
        self._buckets: Dict[Any, List[Tuple[tuple, _Waiter]]] = {}
        self._live: Dict[int, _Waiter] = {}
        self._class_depth: Dict[int, int] = {}   # priority class -> depth
        self._vec_depth: Dict[Any, int] = {}     # resource class -> depth
        self._deadlines: List[Tuple[float, int, _Waiter]] = []
        self._dl_seq = 0

    def __len__(self) -> int:
        return len(self._live)

    def add(self, w: _Waiter) -> None:
        self._live[w.task.uid] = w
        heapq.heappush(self._buckets.setdefault(w.vec, []), (w.sort_key, w))
        self._class_depth[w.priority] = \
            self._class_depth.get(w.priority, 0) + 1
        self._vec_depth[w.vec] = self._vec_depth.get(w.vec, 0) + 1
        if w.deadline_t is not None:
            self._dl_seq += 1
            heapq.heappush(self._deadlines, (w.deadline_t, self._dl_seq, w))

    def discard(self, uid: int) -> Optional[_Waiter]:
        """O(1) removal by task uid (heap entries die lazily)."""
        w = self._live.pop(uid, None)
        if w is None:
            return None
        c = self._class_depth[w.priority] - 1
        if c:
            self._class_depth[w.priority] = c
        else:
            del self._class_depth[w.priority]
        v = self._vec_depth[w.vec] - 1
        if v:
            self._vec_depth[w.vec] = v
        else:
            del self._vec_depth[w.vec]
        return w

    def get(self, uid: int) -> Optional[_Waiter]:
        return self._live.get(uid)

    def classes(self) -> List[Any]:
        """Snapshot of the distinct resource-vector classes currently live."""
        return list(self._vec_depth.keys())

    def class_size(self, vec: Any) -> int:
        return self._vec_depth.get(vec, 0)

    def class_depth_snapshot(self) -> Dict[int, int]:
        return dict(self._class_depth)

    def peek_class(self, vec: Any) -> Optional[Tuple[tuple, _Waiter]]:
        """Best-ranked live waiter of a class (popping stale entries)."""
        h = self._buckets.get(vec)
        if h is None:
            return None
        while h:
            key, w = h[0]
            if self._live.get(w.task.uid) is w:
                return key, w
            heapq.heappop(h)
        del self._buckets[vec]
        return None

    def pop_expired(self, now: float) -> List[_Waiter]:
        """Remove + return every live waiter whose deadline is strictly past
        (``now > deadline``), best-deadline first. O(shed · log n)."""
        out: List[_Waiter] = []
        dl = self._deadlines
        while dl and dl[0][0] < now:
            _, _, w = heapq.heappop(dl)
            if self._live.get(w.task.uid) is w:
                self.discard(w.task.uid)
                out.append(w)
        return out

    def sorted_waiters(self) -> List[_Waiter]:
        """Rank-ordered snapshot (introspection / the preemptive scan path —
        NOT the indexed hot path)."""
        return sorted(self._live.values(), key=lambda w: w.sort_key)

    def take_all_sorted(self) -> List[_Waiter]:
        """Empty the index, returning the waiters in rank order."""
        out = self.sorted_waiters()
        self._buckets.clear()
        self._live.clear()
        self._class_depth.clear()
        self._vec_depth.clear()
        self._deadlines.clear()
        return out


class WaiterQueueMixin:
    """Admission queue + wakeup machinery shared by ``Scheduler`` and
    ``SliceScheduler`` (the paper's notify path), ordered by priority /
    deadline / arrival (see ``_Waiter.key``).

    Host class contract: ``self._lock`` (a ``threading.Lock``) and
    ``self._admit_locked(task) -> Optional[placement]`` (admission under the
    lock). Callbacks always fire OUTSIDE the lock, so a callback may call back
    into the scheduler without deadlocking.
    """

    def _init_waiters(self) -> None:
        # the indexed admission queue (see _WaiterIndex): rank order is
        # recovered per class via bucket heaps, never by keeping a flat
        # sorted list
        self._queue = _WaiterIndex()
        self._seq = 0           # arrival counter (FIFO within a class)
        self._restart_seq = 0   # decreasing: newest restart leads its class
        # preemption (off unless a PreemptionMixin host enables it): when a
        # waiter cannot be admitted from free capacity, the admission paths
        # offer it to _preempt_admit_locked, which may evict lower-ranked
        # residents to make room (the hook is a no-op here)
        self.preempt_enabled = False
        # notifications (e.g. preemption notices to the executor/simulator)
        # buffered under the lock and delivered by _fire_deferred OUTSIDE it,
        # strictly before any admission callback fired afterwards
        self._deferred: List[Callable[[], None]] = []
        # uid -> callback for tasks admitted through the waiter path; consulted
        # by mark_dead to re-enqueue evicted tasks
        self._admit_cbs: Dict[int, AdmitCallback] = {}
        # uid -> admission epoch; bumped on eviction to fence stale task_ends
        self._epochs: Dict[int, int] = {}
        # deadline shedding (off by default — a deadline is an EDF ordering
        # hint unless the operator opts in): when True, a parked waiter whose
        # ``deadline_t`` has already passed is failed with DEADLINE_SHED at
        # the next drain instead of being admitted late. ``_clock`` supplies
        # "now" on the same timeline the deadlines were stamped with — wall
        # monotonic by default; the simulator repoints it at its virtual
        # clock.
        self.shed_expired = False
        self._clock: Callable[[], float] = time.monotonic
        # waiters skipped without a probe because the freed-device drain hint
        # proved the freed capacity cannot satisfy them (observability for
        # the heterogeneous-queue benchmarks/tests)
        self.hint_skips = 0
        # lifecycle event tracer (obs.events.attach_tracer sets it): None
        # keeps every emission site a single attribute load, so the traced-
        # off hot path pays nothing. _trace_dev_off maps shard-local device
        # indices to fleet-global ones in emitted events (sharded control
        # plane stamps each shard's base; 0 everywhere else).
        self._trace: Optional[obs.Tracer] = None
        self._trace_dev_off = 0
        # decision explainer (obs.explain.attach_explainer sets it): same
        # None-guard contract as _trace — every verdict site costs one
        # attribute load when explanation is off
        self._explain: Optional[obsx.Explainer] = None
        # online calibration store (obs.calibrate.attach_calibrator sets it):
        # same None-guard contract again — admission applies corrected
        # vectors and completions feed observations only when attached
        self._calib = None

    @staticmethod
    def _class_key(task: Task) -> Any:
        """Resource-class key for the waiter index. Feasibility-within-a-pass
        normally depends only on the resource vector; for a GROW task (a
        decode-slot delta bound to specific host residents, see
        ``Task.grow_hosts``) it also depends on WHERE the hosts live, so two
        same-vector slots with different host sets must not share a class —
        one failing its probe must not retire the other for the pass."""
        hosts = getattr(task, "grow_hosts", None)
        if hosts:
            return (task.resources, tuple(h.uid for h in hosts))
        return task.resources

    def _enqueue_locked(self, task: Task, callback: AdmitCallback, *,
                        restart: bool = False) -> _Waiter:
        if restart:
            self._restart_seq -= 1
            seq = self._restart_seq
        else:
            self._seq += 1
            seq = self._seq
        # admission rank = declared class + anti-starvation aging (the
        # preemptive layer adds age_boost per eviction); the boost is kept
        # out of task.priority so eviction decisions stay on raw classes
        w = _Waiter(task,
                    callback,
                    getattr(task, "priority", 0)
                    + getattr(task, "age_boost", 0),
                    getattr(task, "deadline_t", None), restart, seq,
                    vec=self._class_key(task))
        w.sort_key = w.key
        self._queue.add(w)
        tr = self._trace
        if tr is not None:
            tr.emit(obs.REQUEUE if restart else obs.PARK,
                    task.uid, task.name,
                    epoch=self._epochs.get(task.uid, 0))
        return w

    def _restore_waiter_locked(self, w: _Waiter) -> None:
        """Re-add a previously-popped waiter object unchanged — same seq,
        same rank, so it lands back in its exact queue position (the sharded
        control plane's steal path puts a waiter back when the target shard
        turns it down)."""
        self._queue.add(w)

    # -- host hooks ---------------------------------------------------------
    def _admit_locked(self, task: Task):  # pragma: no cover - abstract
        raise NotImplementedError

    def can_ever_fit(self, task: Task) -> bool:
        """Would ``task`` be admissible on an *empty* alive device (or, for a
        gang scheduler, an empty alive device group)? Callers use this to
        fail fast instead of waiting forever (a 20 GB task on a 16 GB fleet
        — or a 5-chip gang on a 4x4 pod with no 5-chip shape — never becomes
        feasible)."""
        return True

    def infeasible_reason(self, task: Task) -> str:
        """Human-readable explanation for a ``can_ever_fit`` failure, stamped
        on the crashed job so the submitter sees *why* instead of a bare
        crash flag."""
        return (f"infeasible placement: task {task.name or task.uid!r} can "
                f"never be admitted on the current fleet")

    def _hint_may_fit(self, task: Task, freed: Any) -> bool:
        """Drain-scan hint: could ``task`` POSSIBLY be admitted given that
        only ``freed`` (a device index, or a cell tuple for topology
        schedulers) gained capacity since the task parked? Hosts override
        with an exact-or-conservative check — returning True merely probes,
        returning False MUST be sound (a parked waiter is infeasible on
        every unchanged device, so feasibility can only arrive via the freed
        one)."""
        return True

    def _preempt_admit_locked(self, task: Task):
        """Preemption hook (no-op unless a PreemptionMixin host overrides):
        called under the lock when ``task`` cannot be admitted from free
        capacity. May evict strictly lower-ranked residents (re-enqueueing
        them via ``_requeue_evicted_locked``) and return the placement the
        eviction made possible, or None to leave the waiter parked."""
        return None

    def _forget_task_locked(self, task: Task) -> None:
        """Terminal-exit hook: ``task`` is leaving the queue for good
        without a current-epoch ``task_end`` (deadline shed, or the
        impossible-after-shrink give-up). Hosts carrying per-task
        bookkeeping (the preemption layer's ledger) drop it here."""

    # -- admission ----------------------------------------------------------
    def admit_or_enqueue(self, task: Task, callback: AdmitCallback) -> bool:
        """Try to admit ``task``; on success fire ``callback`` immediately,
        otherwise park it in the admission queue (no thread is held), ranked
        by the task's ``priority`` / ``deadline_t`` stamps. The callback fires
        exactly once per admission, possibly again after an eviction +
        re-admission. If the fleet later shrinks (``mark_dead``) to where the
        task can NEVER be admitted, the callback fires once with
        ``placement=None`` — the caller must give up, not retry. Returns True
        iff admitted immediately."""
        fired: List[Tuple[_Waiter, Any, int]] = []
        with self._lock:
            placement = self._admit_locked(task)
            if placement is None and self.preempt_enabled \
                    and not getattr(task, "grow_hosts", None):
                # (grow tasks never preempt: a slot delta is batch growth,
                # not an independent arrival — evicting a resident could
                # evict the very host batch the slot wants to join)
                # an urgent arrival may evict strictly lower-ranked residents
                # instead of parking behind them (preemptive deadline/priority
                # enforcement); evicted victims re-enter the queue at the
                # front of their class carrying their progress credit
                placement = self._preempt_admit_locked(task)
                if placement is not None:
                    # the eviction may have freed capacity beyond what this
                    # arrival consumed (a whole-gang victim's other cells,
                    # or a victim bigger than the preemptor): offer it to
                    # parked waiters NOW, like every other freeing path
                    fired = self._drain_locked()
            if placement is None:
                self._enqueue_locked(task, callback)
                return False
            self._admit_cbs[task.uid] = callback
            epoch = self._epochs.get(task.uid, 0)
        self._fire_deferred()
        callback(task, placement, epoch)
        self._fire(fired)
        return True

    def try_admit(self, task: Task, callback: AdmitCallback):
        """Admit-or-nothing: like ``admit_or_enqueue`` but never parks the
        task on failure (and never attempts preemption). Returns the
        placement on success (callback fired), None otherwise (no state
        changed). The sharded control plane uses this to probe shards for
        immediate capacity before choosing where to park."""
        with self._lock:
            placement = self._admit_locked(task)
            if placement is None:
                return None
            self._admit_cbs[task.uid] = callback
            epoch = self._epochs.get(task.uid, 0)
        self._fire_deferred()
        callback(task, placement, epoch)
        return placement

    def task_begin_blocking(self, task: Task,
                            timeout: Optional[float] = None):
        """Blocking flavour for synchronous callers (serve loop): waits on an
        event — not a sleep/retry spin — until the wakeup path admits the
        task. Returns the placement, or None on timeout (the waiter is then
        cancelled)."""
        admitted = threading.Event()
        box: Dict[str, Any] = {}

        def cb(t: Task, placement, epoch: int) -> None:
            box["placement"] = placement  # None if permanently infeasible
            admitted.set()

        self.admit_or_enqueue(task, cb)
        if not admitted.wait(timeout):
            if self.cancel_wait(task):
                return None
            admitted.wait()  # admission raced the timeout: take the device
        return box["placement"]

    # -- wakeups ------------------------------------------------------------
    # distinct failed resource vectors memoized per PREEMPTIVE drain pass;
    # beyond this many, later waiters are probed unconditionally (bounds
    # memo-compare cost on the scan path). The indexed drain needs no cap:
    # its class skip is a dict-keyed memo with O(1) lookups.
    _DRAIN_MEMO = 32

    def _drain_locked(self, freed: Any = None
                      ) -> List[Tuple[_Waiter, Any, int]]:
        """Admit every now-feasible waiter in admission-rank order (priority
        desc, EDF, arrival), keeping still-infeasible ones queued. Higher-
        ranked tasks always get first claim on freed capacity, but a too-big
        head does not block smaller tasks behind it — smaller classes are
        probed in turn, which avoids head-of-line deadlock.

        Two implementations behind one contract, selected by
        ``preempt_enabled``:

          * **indexed drain** (non-preemptive hosts): class-at-a-time over
            the waiter index — O(classes·log + admitted·log) per wakeup
            instead of O(queue). Identical admission sequence to the scan
            (see the module docstring's equivalence argument).
          * **rank-order scan** (preemptive hosts): the historical full
            scan, kept because a committed eviction changes resident state
            mid-pass and invalidates the class-skip premise. Mid-scan
            victim requeues land in the (emptied) index and survive the
            final merge.

        Both share the probe-avoidance layers: deadline shedding
        (``shed_expired``), the freed-capacity hint (``_hint_may_fit``),
        and the failed-vector memo (a failed resource class is never
        re-probed within a pass)."""
        if self.preempt_enabled:
            return self._drain_scan_locked(freed)
        return self._drain_indexed_locked(freed)

    def _drain_indexed_locked(self, freed: Any = None
                              ) -> List[Tuple[_Waiter, Any, int]]:
        fired: List[Tuple[_Waiter, Any, int]] = []
        q = self._queue
        if self.shed_expired:
            # all expired waiters shed via the deadline heap — the same set
            # the scan would shed (every live waiter with deadline < now),
            # without touching the unexpired ones; re-sorted by queue rank
            # so the shed callbacks fire in the scan's order, not the
            # heap's deadline order
            for w in sorted(q.pop_expired(self._clock()),
                            key=lambda w: w.sort_key):
                self._admit_cbs.pop(w.task.uid, None)
                self._forget_task_locked(w.task)
                tr = self._trace
                if tr is not None:
                    tr.emit(obs.SHED, w.task.uid, w.task.name,
                            epoch=self._epochs.get(w.task.uid, 0))
                ex = self._explain
                if ex is not None:
                    ex.record(w.task.uid, w.task.name, obsx.SHED,
                              reasons=({"reason": "deadline_expired",
                                        "deadline_t": w.deadline_t},))
                fired.append((w, DEADLINE_SHED,
                              self._epochs.get(w.task.uid, 0)))
        if not len(q):
            return fired
        # one entry per resource class, keyed by the class's best waiter:
        # popping the heap yields the globally best-ranked un-skipped waiter
        top: List[Tuple[tuple, Any]] = []
        for vec in q.classes():
            peek = q.peek_class(vec)
            if peek is not None:
                top.append((peek[0], vec))
        heapq.heapify(top)
        while top:
            key, vec = heapq.heappop(top)
            peek = q.peek_class(vec)
            if peek is None:
                continue
            ckey, w = peek
            if ckey != key:
                # the entry was staled by an out-of-band removal; re-rank
                heapq.heappush(top, (ckey, vec))
                continue
            if freed is not None and not self._hint_may_fit(w.task, freed):
                # the freed capacity provably cannot serve this vector, so
                # it cannot serve ANY member: the whole class is skipped
                # (each member counts as a hint skip, as in the scan)
                self.hint_skips += q.class_size(vec)
                ex = self._explain
                if ex is not None:
                    ex.skip(w.task.uid, w.task.name, _HINT_SKIP_REASONS)
                continue
            placement = self._admit_locked(w.task)
            if placement is None:
                # failed-vector memo: admissions only consume capacity, so
                # this class stays infeasible for the rest of the pass
                ex = self._explain
                if ex is not None:
                    # the class head carries the probe's rejection verdict
                    # (recorded in _admit_locked); note how many classmates
                    # were retired for the pass on its strength
                    n = q.class_size(vec) - 1
                    if n > 0:
                        ex.annotate_last(w.task.uid, "class_memo_skip", n)
                continue
            q.discard(w.task.uid)
            self._admit_cbs[w.task.uid] = w.callback
            fired.append((w, placement, self._epochs.get(w.task.uid, 0)))
            nxt = q.peek_class(vec)
            if nxt is not None:
                heapq.heappush(top, (nxt[0], vec))
        return fired

    def _drain_scan_locked(self, freed: Any = None
                           ) -> List[Tuple[_Waiter, Any, int]]:
        """Preemptive-path drain: the full rank-order scan (see
        ``_drain_locked``), run against a drained snapshot of the index."""
        fired: List[Tuple[_Waiter, Any, int]] = []
        still: List[_Waiter] = []
        failed: List[Any] = []    # ResourceVectors infeasible this pass
        # (vector, raw priority, deadline) of waiters whose PREEMPTION
        # attempt failed this pass. A later waiter is skipped only when a
        # failed entry DOMINATES it on raw eviction power — same vector and
        # (higher raw priority, or equal priority and no-later deadline) —
        # because only then is its eligible victim set provably a subset.
        # Scan order alone is NOT enough: admission rank includes age_boost
        # and restart-front-of-class, which outranks() ignores, so a
        # later-scanned waiter can hold strictly more eviction rights.
        # Keeps a deep homogeneous queue at O(1) plans per wakeup.
        pfailed: List[Tuple[Any, int, float]] = []
        now = self._clock() if self.shed_expired else None
        # scan a snapshot: a mid-scan preemption re-enqueues its victims into
        # the index (emptied here), so they survive the final merge instead
        # of being overwritten by the survivor list
        pending = self._queue.take_all_sorted()
        for w in pending:  # already sorted by rank
            if (now is not None and w.deadline_t is not None
                    and now > w.deadline_t):
                # too late to be worth running: shed instead of admitting
                self._admit_cbs.pop(w.task.uid, None)
                self._forget_task_locked(w.task)
                tr = self._trace
                if tr is not None:
                    tr.emit(obs.SHED, w.task.uid, w.task.name,
                            epoch=self._epochs.get(w.task.uid, 0))
                ex = self._explain
                if ex is not None:
                    ex.record(w.task.uid, w.task.name, obsx.SHED,
                              reasons=({"reason": "deadline_expired",
                                        "deadline_t": w.deadline_t},))
                fired.append((w, DEADLINE_SHED,
                              self._epochs.get(w.task.uid, 0)))
                continue
            placement = None
            ckey = self._class_key(w.task)
            if freed is not None and not self._hint_may_fit(w.task, freed):
                self.hint_skips += 1
                ex = self._explain
                if ex is not None:
                    ex.skip(w.task.uid, w.task.name, _HINT_SKIP_REASONS)
            elif any(f == ckey for f in failed):
                # identical resource class already failed this pass
                ex = self._explain
                if ex is not None:
                    ex.skip(w.task.uid, w.task.name, _CLASS_MEMO_REASONS)
            else:
                placement = self._admit_locked(w.task)
                if placement is None and len(failed) < self._DRAIN_MEMO:
                    failed.append(ckey)
            if placement is None and self.preempt_enabled \
                    and not getattr(w.task, "grow_hosts", None):
                tprio = getattr(w.task, "priority", 0)
                tdl = w.task.deadline_t if w.task.deadline_t is not None \
                    else math.inf
                dominated = any(
                    res == w.task.resources
                    and (prio > tprio or (prio == tprio and dl <= tdl))
                    for res, prio, dl in pfailed)
                if dominated:
                    placement = None
                    ex = self._explain
                    if ex is not None:
                        ex.skip(w.task.uid, w.task.name,
                                _PREEMPT_MEMO_REASONS)
                else:
                    # free capacity (even hinted/memoized as insufficient)
                    # cannot take this waiter — but eviction of strictly
                    # lower-ranked residents might; min-runtime maturing
                    # between drains is why this retries even when no
                    # capacity was freed
                    placement = self._preempt_admit_locked(w.task)
                if placement is None:
                    if not dominated and len(pfailed) < self._DRAIN_MEMO:
                        pfailed.append((w.task.resources, tprio, tdl))
                else:
                    # a committed eviction changes resident state (and can
                    # free net capacity beyond what the preemptor took, e.g.
                    # a whole-gang victim): the memos AND the freed-capacity
                    # hint are stale — reset them so the rest of the pass
                    # probes against reality (the hint's soundness premise,
                    # "only the freed device improved", no longer holds)
                    failed.clear()
                    pfailed.clear()
                    freed = None
            if placement is None:
                still.append(w)
            else:
                self._admit_cbs[w.task.uid] = w.callback
                fired.append((w, placement,
                              self._epochs.get(w.task.uid, 0)))
        # preemption victims re-enqueued mid-scan are already back in the
        # index; merging the survivors is an insert, not a list rebuild
        for w in still:
            self._queue.add(w)
        return fired

    def _fire_deferred(self) -> None:
        """Deliver buffered out-of-band notifications (preemption notices)
        outside the lock, before any admission callback queued after them —
        a backend always learns a task was evicted before it sees the
        re-admission."""
        with self._lock:
            pending, self._deferred = self._deferred, []
        for fn in pending:
            fn()

    def _fire(self, fired: Sequence[Tuple[_Waiter, Any, int]]) -> None:
        self._fire_deferred()
        for w, placement, epoch in fired:
            w.callback(w.task, placement, epoch)

    def notify(self) -> int:
        """Re-drive the waiter queue now (used after ``revive``; harmless any
        time). Returns the number of waiters admitted."""
        with self._lock:
            fired = self._drain_locked()
        self._fire(fired)
        return len(fired)

    # -- waiter-queue introspection / cancellation --------------------------
    def waiting_count(self) -> int:
        """Queue depth — an O(1) maintained counter, never a scan."""
        with self._lock:
            return len(self._queue)

    def queue_stats(self) -> Dict[str, Any]:
        """Waiter-queue snapshot from maintained counters — safe to
        poll at depth 1e5 without stalling admission under the lock:
        ``depth`` (total waiters), ``per_class`` (waiters per admission
        priority class, aging included), ``classes`` (distinct resource
        vectors parked), ``hint_skips`` (probe-free skips to date), and
        ``gang_front`` — the best-ranked parked multi-chip waiter as
        ``(chips, per_chip_hbm)`` or None. Everything but gang_front is
        O(1); gang_front is O(classes · log) via per-class heap peeks —
        never a sort over the waiters (the ``waiting_tasks`` trap)."""
        with self._lock:
            gang_front = None
            best = None
            for vec in self._queue.classes():
                # grow-task classes key as (vector, host uids): unwrap
                r = vec[0] if isinstance(vec, tuple) else vec
                chips = getattr(r, "chips", 1)
                if chips <= 1:
                    continue
                peek = self._queue.peek_class(vec)
                if peek is not None and (best is None or peek[0] < best):
                    best = peek[0]
                    gang_front = (chips, r.hbm_bytes // chips)
            return {
                "depth": len(self._queue),
                "per_class": self._queue.class_depth_snapshot(),
                "classes": len(self._queue.classes()),
                "hint_skips": self.hint_skips,
                "gang_front": gang_front,
            }

    def waiting_tasks(self) -> List[Task]:
        """Rank-ordered snapshot of parked tasks. Debug/test helper — this
        sorts (O(n log n)); production telemetry should use
        ``queue_stats``."""
        with self._lock:
            return [w.task for w in self._queue.sorted_waiters()]

    def cancel_wait(self, task: Task) -> bool:
        """Remove ``task`` from the admission queue, dropping its stored
        callback so a cancelled waiter leaks no wakeup state. True iff it
        was waiting (then its callback is guaranteed never to fire again).
        O(1) against the index.

        The ``_epochs`` entry is deliberately KEPT: if the waiter is an
        eviction restart, the superseded run may still be mid-kernel, and
        deleting the bumped epoch would let its late ``task_end(epoch=old)``
        pass the staleness fence. Epoch entries persist after normal
        completion too, so this leaks nothing new."""
        with self._lock:
            if self._queue.discard(task.uid) is None:
                return False
            self._admit_cbs.pop(task.uid, None)
            return True

    def cancel_all_waiters(self) -> List[Task]:
        """Drop every waiter (caller decides their fate — e.g. the simulator
        counts never-feasible ones as crashed-at-submit). Epochs are kept,
        as in ``cancel_wait``."""
        with self._lock:
            waiters = self._queue.take_all_sorted()
            for w in waiters:
                self._admit_cbs.pop(w.task.uid, None)
            return [w.task for w in waiters]

    # -- epoch fencing ------------------------------------------------------
    def admission_epoch(self, task: Task) -> int:
        with self._lock:
            return self._epochs.get(task.uid, 0)

    def adopt_epoch(self, task: Task, epoch: int) -> None:
        """Carry a task's admission epoch in from another engine (the
        sharded control plane migrating a waiter across shards): the fence
        must keep rejecting the superseded run's ``task_end`` after the
        move, so the target engine takes the max of both histories."""
        with self._lock:
            cur = self._epochs.get(task.uid, 0)
            if epoch > cur:
                self._epochs[task.uid] = epoch

    def _stale_locked(self, task: Task, epoch: Optional[int]) -> bool:
        return (epoch is not None
                and epoch != self._epochs.get(task.uid, 0))

    def _fail_impossible_locked(self) -> List[Tuple[_Waiter, Any, int]]:
        """After capacity shrinks (mark_dead), sweep out waiters that can
        never be admitted again — without this they would wait forever once
        the last task_end wakeup has fired. Returns (waiter, None, epoch)
        tuples for ``_fire``: placement None tells the caller to give up.

        Feasibility-forever depends only on the resource vector, so the
        check runs once per class, not once per waiter."""
        failed: List[Tuple[_Waiter, Any, int]] = []
        q = self._queue
        for vec in q.classes():
            peek = q.peek_class(vec)
            if peek is None or self.can_ever_fit(peek[1].task):
                continue
            while True:
                peek = q.peek_class(vec)
                if peek is None:
                    break
                w = peek[1]
                q.discard(w.task.uid)
                self._admit_cbs.pop(w.task.uid, None)
                self._forget_task_locked(w.task)
                tr = self._trace
                if tr is not None:
                    tr.emit(obs.CRASH, w.task.uid, w.task.name,
                            epoch=self._epochs.get(w.task.uid, 0),
                            data={"reason": "infeasible"})
                ex = self._explain
                if ex is not None:
                    ex.record(w.task.uid, w.task.name, obsx.CRASHED,
                              reasons=({"reason": "infeasible"},))
                failed.append((w, None, self._epochs.get(w.task.uid, 0)))
        failed.sort(key=lambda e: e[0].sort_key)  # fire in rank order
        return failed

    def _requeue_evicted_locked(self, evicted: Sequence[Task]) -> None:
        """Re-enqueue evicted waiter-path tasks at the FRONT of their
        priority class (eviction restart), bumping their epoch so the
        superseded run's ``task_end`` becomes a fenced no-op. A restart never
        jumps a *higher* priority class — it only leads its own."""
        # reversed + decreasing restart seq keeps the evicted tasks' order
        for t in reversed(evicted):
            cb = self._admit_cbs.pop(t.uid, None)
            if cb is None:
                continue  # legacy task_begin admission: caller re-drives
            self._epochs[t.uid] = self._epochs.get(t.uid, 0) + 1
            self._enqueue_locked(t, cb, restart=True)

    # -- cross-shard handoff (used by scheduler.sharded) --------------------
    def steal_best_waiter(self, pred: Callable[[Task], bool]
                          ) -> Optional[_Waiter]:
        """Pop the best-ranked waiter whose task satisfies ``pred``.
        ``pred`` must depend only on the task's resource vector (it is
        evaluated once per class, on the class's best member). Returns the
        popped ``_Waiter`` (callback and rank intact) or None. The caller
        either re-homes the waiter on another engine or hands it back via
        ``_restore_waiter_locked``/``restore_waiter``."""
        with self._lock:
            best: Optional[Tuple[tuple, _Waiter]] = None
            for vec in self._queue.classes():
                peek = self._queue.peek_class(vec)
                if peek is None or not pred(peek[1].task):
                    continue
                if best is None or peek[0] < best[0]:
                    best = peek
            if best is None:
                return None
            w = best[1]
            self._queue.discard(w.task.uid)
            self._admit_cbs.pop(w.task.uid, None)
            return w

    def restore_waiter(self, w: _Waiter) -> None:
        """Put a stolen waiter back exactly where it was (same seq/rank)."""
        with self._lock:
            self._restore_waiter_locked(w)

    # -- decision explainability (obs.explain) -------------------------------
    # cap on per-verdict reason entries: a huge fleet's rejection verdict
    # must not allocate thousands of dicts under the lock
    _REASONS_CAP = 64

    def _reject_reasons_locked(self, task: Task) -> Tuple[dict, ...]:
        """Structured per-device/per-group rejection reasons for a failed
        admission probe (the payload of a REJECTED verdict). Hosts
        override with their policy's exact decomposition."""
        return ()

    def explain_queue(self, task: Task) -> Optional[Tuple[dict, ...]]:
        """Live rejection reasons for a currently-parked task — an
        on-demand probe under the lock, for waiters whose class was
        memo-skipped and therefore carry no recorded verdict of their own.
        None when the task is not parked here."""
        with self._lock:
            if self._queue.get(task.uid) is None:
                return None
            return self._reject_reasons_locked(task)


class Scheduler(WaiterQueueMixin):
    """Base scheduler: subclasses implement ``select_device``."""

    name = "base"

    def __init__(self, num_devices: int, hbm_per_device: int = DEFAULT_HBM):
        self.devices = [DeviceState(i, total_hbm=hbm_per_device)
                        for i in range(num_devices)]
        self._lock = threading.Lock()
        self.placements: List[tuple] = []  # (task_uid, device) audit log
        # admission attempts (successful or not) — the scheduler-overhead
        # metric benchmarks/bench_executor.py compares across executors
        self.begin_attempts = 0
        # largest alive device, maintained on mark_dead/revive so
        # can_ever_fit is O(1) per submission instead of O(devices)
        self._max_alive_hbm = max(
            (d.total_hbm for d in self.devices if d.alive), default=0)
        self._init_waiters()

    def _refresh_capacity_locked(self) -> None:
        self._max_alive_hbm = max(
            (d.total_hbm for d in self.devices if d.alive), default=0)

    # -- policy hooks ------------------------------------------------------
    def select_device(self, task: Task) -> Optional[DeviceState]:
        raise NotImplementedError

    def device_feasible(self, task: Task, dev: DeviceState) -> bool:
        """Would ``select_device`` consider ``dev`` for ``task`` right now?
        Each policy states its per-device admission predicate here;
        ``select_device`` ranges over it and the drain hint consults it to
        skip waiters a freed device cannot satisfy."""
        return dev.alive

    def _hint_may_fit(self, task: Task, freed: int) -> bool:
        # sound: a parked waiter was infeasible on EVERY device, and only
        # the freed device's state improved since — so it is admissible now
        # iff the freed device itself would take it. A grow task can only
        # land next to one of its hosts, so unless the freed device hosts
        # one, the probe is skipped.
        if task.grow_hosts:
            return any(h.device == freed for h in task.grow_hosts)
        return self.device_feasible(task, self.devices[freed])

    def _admit_locked(self, task: Task) -> Optional[int]:
        # calibration correction happens at the FIRST admission probe — before
        # the grow branch, so decode-slot deltas are corrected too. apply() is
        # idempotent (it stamps probe_vec), so re-probes of a parked waiter
        # and sharded re-routing never double-correct.
        calib = self._calib
        if calib is not None and task.probe_vec is None:
            calib.apply(task)
        if task.grow_hosts:
            return self._admit_grow_locked(task)
        self.begin_attempts += 1
        dev = self.select_device(task)
        if dev is None:
            ex = self._explain
            if ex is not None:
                # lazy: the O(devices) reason walk runs once per parked
                # episode — repeat probes just bump the verdict's repeats
                ex.reject(task.uid, task.name,
                          lambda: self._reject_reasons_locked(task))
            return None
        dev.admit(task)
        task.device = dev.index
        self.placements.append((task.uid, dev.index))
        tr = self._trace
        if tr is not None:
            # reservation payload only on calibrated runs: the profiler reads
            # it as "what admission actually granted"; uncalibrated traces
            # keep the zero-payload emission (bench_obs baseline unchanged)
            tr.emit(obs.ADMIT, task.uid, task.name,
                    dev.index + self._trace_dev_off,
                    self._epochs.get(task.uid, 0),
                    data={"hbm": task.resources.hbm_bytes}
                    if calib is not None else None)
        ex = self._explain
        if ex is not None:
            ex.record(task.uid, task.name, obsx.ADMITTED,
                      device=dev.index + self._trace_dev_off)
        return dev.index

    # -- decision explainability (obs.explain) -------------------------------
    def device_verdict(self, task: Task, dev: DeviceState) -> Optional[dict]:
        """Structured rejection reason for ``task`` on ``dev`` right now, or
        None when the device is feasible. Mirrors ``device_feasible``
        check-for-check; policy subclasses decompose their own predicate."""
        if not dev.alive:
            return {"device": dev.index + self._trace_dev_off,
                    "reason": obsx.R_DEVICE_DEAD}
        if not self.device_feasible(task, dev):
            return {"device": dev.index + self._trace_dev_off,
                    "reason": obsx.R_SLOTS_FULL}
        return None

    def _reject_reasons_locked(self, task: Task) -> Tuple[dict, ...]:
        """Per-device rejection reasons for a failed admission probe (the
        payload of a REJECTED verdict). One entry per refusing device, up
        to ``_REASONS_CAP`` + a truncation marker."""
        if getattr(task, "grow_hosts", None):
            return self._grow_reject_reasons_locked(task)
        out: List[dict] = []
        omitted = 0
        cap = self._REASONS_CAP
        for dev in self.devices:
            r = self.device_verdict(task, dev)
            if r is None:
                continue
            if len(out) < cap:
                out.append(r)
            else:
                omitted += 1
        if omitted:
            out.append({"reason": "truncated", "omitted": omitted})
        return tuple(out)

    def _grow_reject_reasons_locked(self, task: Task) -> Tuple[dict, ...]:
        """Why a decode-slot delta could not grow: one entry per candidate
        host, mirroring ``_grow_feasible_locked`` check-for-check."""
        out: List[dict] = []
        off = self._trace_dev_off
        need = slots_needed(task)
        for host in task.grow_hosts:
            if host.device is None:
                out.append({"host": host.uid, "reason": obsx.R_HOST_GONE})
                continue
            dev = self.devices[host.device]
            if not dev.alive:
                out.append({"host": host.uid, "device": dev.index + off,
                            "reason": obsx.R_DEVICE_DEAD})
            elif host.uid not in dev.residents:
                out.append({"host": host.uid, "device": dev.index + off,
                            "reason": obsx.R_HOST_GONE})
            elif task.resources.hbm_bytes > dev.free_hbm:
                out.append({"host": host.uid, "device": dev.index + off,
                            "reason": obsx.R_MEMORY_SHORT,
                            "short_bytes":
                                task.resources.hbm_bytes - dev.free_hbm})
            elif host.slot_budget is not None:
                if host.grown_now >= host.slot_budget:
                    out.append({"host": host.uid, "device": dev.index + off,
                                "reason": obsx.R_GROW_BUDGET,
                                "grown_now": host.grown_now,
                                "slot_budget": host.slot_budget})
            elif dev.used_slots + need > SLOTS:
                out.append({"host": host.uid, "device": dev.index + off,
                            "reason": obsx.R_SLOTS_FULL,
                            "short_slots": dev.used_slots + need - SLOTS})
        return tuple(out)


    def _grow_feasible_locked(self, task: Task,
                              dev: DeviceState, host: Task) -> bool:
        """Hard feasibility for a slot delta on a host's device, regardless
        of the policy subclass: the slot's KV bytes must physically fit, and
        the host's row budget (``slot_budget`` — a decode loop has exactly
        max_batch physical cache rows) must have a row free. Hosts with no
        budget fall back to the device-wide compute-slot ledger — but budget
        is the right cap for serving, where co-located prefill tasks may
        legitimately oversubscribe compute slots (Alg. 3) without that
        saying anything about cache-row availability."""
        if not (dev.alive and host.uid in dev.residents
                and task.resources.hbm_bytes <= dev.free_hbm):
            return False
        if host.slot_budget is not None:
            return host.grown_now < host.slot_budget
        return dev.used_slots + slots_needed(task) <= SLOTS

    def _admit_grow_locked(self, task: Task) -> Optional[int]:
        """Admission for a resident-growth delta (``task.grow_hosts``): only
        devices currently hosting one of the host tasks are candidates —
        the delta is batch growth, its bytes live next to its batch. Among
        feasible hosts, least-loaded (fewest used slots, then most free
        HBM) wins, balancing joins across decode loops."""
        self.begin_attempts += 1
        best: Optional[Tuple[DeviceState, Task]] = None

        def rank(dev: DeviceState, host: Task) -> tuple:
            return (host.grown_now, dev.used_slots, -dev.free_hbm)

        for host in task.grow_hosts:
            if host.device is None:
                continue
            dev = self.devices[host.device]
            if not self._grow_feasible_locked(task, dev, host):
                continue
            if best is None or rank(dev, host) < rank(*best):
                best = (dev, host)
        if best is None:
            ex = self._explain
            if ex is not None:
                ex.reject(task.uid, task.name,
                          lambda: self._grow_reject_reasons_locked(task))
            return None
        dev, host = best
        dev.admit(task)
        task.device = dev.index
        task.placed_host = host
        host.grown_now += 1
        self.placements.append((task.uid, dev.index))
        tr = self._trace
        if tr is not None:
            tr.emit(obs.GROW, task.uid, task.name,
                    dev.index + self._trace_dev_off,
                    self._epochs.get(task.uid, 0),
                    data={"host": host.uid})
        ex = self._explain
        if ex is not None:
            ex.record(task.uid, task.name, obsx.GROWN,
                      device=dev.index + self._trace_dev_off,
                      data={"host": host.uid})
        return dev.index

    def can_ever_fit(self, task: Task) -> bool:
        if task.grow_hosts:
            # a grow task is feasible-forever iff some host still lives on
            # an alive device big enough to EVER hold the delta (current
            # occupancy excluded — that can drain)
            return any(
                h.device is not None
                and self.devices[h.device].alive
                and h.uid in self.devices[h.device].residents
                and task.resources.hbm_bytes <= self.devices[h.device].total_hbm
                for h in task.grow_hosts)
        # O(1): against the maintained largest-alive-device capacity
        return task.resources.hbm_bytes <= self._max_alive_hbm

    def infeasible_reason(self, task: Task) -> str:
        alive = [d for d in self.devices if d.alive]
        biggest = max((d.total_hbm for d in alive), default=0)
        return (f"infeasible placement: task {task.name or task.uid!r} needs "
                f"{task.resources.hbm_bytes / 1e9:.2f} GB HBM but the "
                f"largest of {len(alive)} alive device(s) holds "
                f"{biggest / 1e9:.2f} GB")

    # -- paper API -----------------------------------------------------------
    def task_begin(self, task: Task) -> Optional[int]:
        """Probe entry point: returns the device index or None (caller queues)."""
        with self._lock:
            return self._admit_locked(task)

    def task_end(self, task: Task, *, epoch: Optional[int] = None) -> bool:
        """Free the task's resources and re-drive the waiter queue, passing
        the freed device as the drain hint so heterogeneous queues skip
        waiters that device can't satisfy. With ``epoch``, a completion from
        an evicted (superseded) run is fenced: nothing is released and False
        is returned."""
        with self._lock:
            if self._stale_locked(task, epoch):
                return False
            freed = task.device
            if freed is not None:
                self.devices[freed].release(task)
            self._admit_cbs.pop(task.uid, None)
            calib = self._calib
            if calib is not None and freed is not None:
                calib.note_end(task, self._clock())
            tr = self._trace
            if tr is not None and freed is not None:
                # freed None = a stale end for an already-evicted run (the
                # eviction cleared task.device): nothing was released, so
                # nothing is emitted — the fresh incarnation owns the task.
                # On calibrated runs the END carries the observed memory
                # high-water, closing the reserved-vs-observed join.
                tr.emit(obs.SHRINK if task.grow_hosts else obs.END,
                        task.uid, task.name,
                        freed + self._trace_dev_off,
                        self._epochs.get(task.uid, 0),
                        data={"hw": observed_highwater(task)}
                        if calib is not None else None)
            fired = self._drain_locked(freed=freed)
        self._fire(fired)
        return True

    # -- resident growth (continuous batching; see serve.engine) -------------
    def bind_resident(self, task: Task, device_index: int) -> bool:
        """Checked PINNED admission: admit ``task`` onto a specific device
        (memory + slot checked under the lock) or refuse without queueing.
        serve.engine uses this to plant one long-lived decode-loop resident
        per device; the loop's slot joins then grow against it via
        ``task_grow``. Release is a normal ``task_end``."""
        with self._lock:
            dev = self.devices[device_index]
            if not dev.alive \
                    or task.resources.hbm_bytes > dev.free_hbm \
                    or dev.used_slots + slots_needed(task) > SLOTS:
                return False
            self.begin_attempts += 1
            dev.admit(task)
            task.device = dev.index
            self.placements.append((task.uid, dev.index))
            tr = self._trace
            if tr is not None:
                tr.emit(obs.ADMIT, task.uid, task.name,
                        dev.index + self._trace_dev_off,
                        self._epochs.get(task.uid, 0),
                        data={"bind": True})
            ex = self._explain
            if ex is not None:
                ex.record(task.uid, task.name, obsx.ADMITTED,
                          device=dev.index + self._trace_dev_off,
                          data={"bind": True})
            return True

    def task_grow(self, slot_task: Task, hosts: Sequence[Task],
                  callback: AdmitCallback) -> bool:
        """Grow a resident batch by one probed delta: ``slot_task`` (its
        ResourceVector is the slot's KV-cache bytes + per-row compute share)
        is admitted onto a device hosting one of ``hosts``, or parked in the
        SAME admission queue as everything else — so a join that would OOM
        the device waits for a retire instead of growing the batch, and the
        memory-hard guarantee covers batch growth. Returns True iff grown
        immediately; otherwise ``callback`` fires on a later drain (or with
        DEADLINE_SHED / None, exactly like ``admit_or_enqueue``)."""
        slot_task.grow_hosts = tuple(hosts)
        return self.admit_or_enqueue(slot_task, callback)

    def task_shrink(self, slot_task: Task, *,
                    epoch: Optional[int] = None) -> bool:
        """Retire a slot admitted through ``task_grow``. Alias of
        ``task_end`` (same epoch fencing, same freed-capacity drain hint) —
        named so call sites read as batch shrink, and so the symmetry
        grow/shrink ↔ begin/end is explicit."""
        return self.task_end(slot_task, epoch=epoch)

    # -- fault tolerance -----------------------------------------------------
    def mark_dead(self, device_index: int) -> List[Task]:
        """Fail a device: evict residents. Waiter-path residents re-enter the
        waiter queue with restart priority (their callback fires again on a
        surviving device); legacy ``task_begin`` residents are only returned
        for the caller to re-drive."""
        with self._lock:
            dev = self.devices[device_index]
            dev.alive = False
            self._refresh_capacity_locked()
            evicted = list(dev.residents.values())
            tr = self._trace
            if tr is not None:
                off = self._trace_dev_off
                tr.emit(obs.MARK_DEAD, device=device_index + off)
                for t in evicted:
                    tr.emit(obs.EVICT, t.uid, t.name, device_index + off,
                            self._epochs.get(t.uid, 0),
                            data={"cause": "device_dead"})
            ex = self._explain
            if ex is not None:
                off = self._trace_dev_off
                for t in evicted:
                    ex.record(t.uid, t.name, obsx.EVICTED,
                              device=device_index + off,
                              reasons=({"reason": obsx.R_DEVICE_DEAD,
                                        "device": device_index + off},))
            for t in evicted:
                dev.release(t)
                t.device = None
            self._requeue_evicted_locked(evicted)
            fired = self._drain_locked()  # waiters may fit on survivors
            fired += self._fail_impossible_locked()
        self._fire(fired)
        return evicted

    def revive(self, device_index: int) -> None:
        with self._lock:
            self.devices[device_index].alive = True
            self._refresh_capacity_locked()
            tr = self._trace
            if tr is not None:
                tr.emit(obs.REVIVE,
                        device=device_index + self._trace_dev_off)
            # only the revived device changed: hint the drain at it
            fired = self._drain_locked(freed=device_index)
        self._fire(fired)

    def alive_devices(self) -> List[DeviceState]:
        return [d for d in self.devices if d.alive]
