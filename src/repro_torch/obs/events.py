"""Lifecycle event schema + the bounded lock-light ring-buffer ``Tracer``.

Every decision the scheduler stack makes — park, admit, evict, grow,
steal, … — is one immutable ``Event`` carrying a monotonic sequence
number and a timestamp on the BACKEND's timeline (wall monotonic for the
live executor, the virtual clock for the simulator; ``Tracer.use_clock``
rebinding follows whichever one currently drives ``sched._clock``).

Design constraints, in order:

  1. **Disabled must be free.** Emission sites guard with
     ``tr = self._trace`` / ``if tr is not None`` — one attribute load on
     the hot admission path when tracing is off (the fleet-scale
     admission numbers must survive).
  2. **Enabled must be cheap and never block.** ``emit`` allocates one
     plain tuple and appends it to a ``deque(maxlen=capacity)`` — the
     ring stores raw tuples and ``events()`` materializes ``Event``s
     lazily, because the NamedTuple constructor's kwarg/default machinery
     alone costs more than the rest of the emission path combined. The
     sequence counter is ``itertools.count`` (atomic under the GIL), the
     ring append is one C call that also evicts the oldest entry — no
     lock, safe against the live backend's concurrent emitters. A
     saturated ring drops the oldest entries and counts them in
     ``dropped`` instead of stalling anyone.
  3. **Immutable events.** NamedTuple on the read side: impossible to
     mutate after the fact, trivially comparable in parity diffs, and
     field-for-field identical to the raw tuple the ring recorded.

Copy of ``src/repro/obs/events.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Callable, Deque, List, NamedTuple, Optional

# -- event kinds ------------------------------------------------------------
# One constant per lifecycle transition. String values (not ints) so dumps
# and diffs read directly; identity comparison still works because every
# emitter uses these module constants.
SUBMIT = "submit"              # task handed to the admission path
PARK = "park"                  # parked in the waiter queue
ADMIT = "admit"                # resources granted on a device
DISPATCH = "dispatch"          # live backend: handed to an execution worker
BEGIN = "begin"                # execution started
END = "end"                    # resources released on completion
EVICT = "evict"                # preempted / device-death victim
REQUEUE = "requeue"            # evicted task re-parked (restart priority)
GROW = "grow"                  # decode-slot delta admitted onto a resident
SHRINK = "shrink"              # grown delta released
GANG_RESERVE = "gang_reserve"  # k-chip group atomically reserved
GANG_RELEASE = "gang_release"  # gang group released
MARK_DEAD = "mark_dead"        # device/cell declared dead
REVIVE = "revive"              # device/cell back in service
STEAL = "steal"                # sharded: waiter stolen toward an idle pod
RESTORE = "restore"            # sharded: refused steal returned to owner
SHED = "shed"                  # parked past its deadline, failed at a drain
CRASH = "crash"                # OOM / infeasible / runner exception

ALL_KINDS = frozenset({
    SUBMIT, PARK, ADMIT, DISPATCH, BEGIN, END, EVICT, REQUEUE, GROW,
    SHRINK, GANG_RESERVE, GANG_RELEASE, MARK_DEAD, REVIVE, STEAL,
    RESTORE, SHED, CRASH,
})


class Event(NamedTuple):
    """One immutable lifecycle record.

    ``seq``    — monotonic per-tracer sequence number (decision order;
                 timestamps may tie, seq never does).
    ``t``      — backend-timeline seconds (wall monotonic or virtual).
    ``kind``   — one of the module constants above.
    ``uid``    — task uid (-1 for fleet events like mark_dead/revive).
    ``name``   — task name ("" when not task-scoped). Parity diffs compare
                 names, not uids: re-built Jobs get fresh uids per leg.
    ``device`` — GLOBAL flat device index (-1 when placement-free; sharded
                 schedulers offset shard-local indices by the shard base).
    ``epoch``  — admission epoch of the task at emission time (fences
                 stale observations exactly as the scheduler's own do).
    ``data``   — optional dict of kind-specific extras (cause, peer uid,
                 shard ids, reserved gang devices, ...).
    """
    seq: int
    t: float
    kind: str
    uid: int = -1
    name: str = ""
    device: int = -1
    epoch: int = 0
    data: Optional[dict] = None


class Tracer:
    """Bounded ring buffer of ``Event``s, lock-light and drop-counting.

    ``emit`` is safe from any thread: the sequence counter is atomic under
    the GIL and the ring is a ``deque(maxlen=capacity)`` whose C-level
    ``append`` both inserts and evicts the oldest entry in one atomic
    step. Two racing emitters may append out of sequence order (each takes
    its number, then appends); ``events()`` sorts by seq on read. When
    more than ``capacity`` events arrive the oldest are dropped and
    counted in ``dropped`` — a flight recorder keeps the most recent
    window, never blocks the scheduler, and never grows without bound.

    ``emit`` is a per-instance closure built at construction time with the
    ring's ``append``, the counter, and the clock prebound as locals: on
    the measured admission hot path every ``self.`` attribute load is a
    visible fraction of the per-event budget (see benchmarks/bench_obs).
    ``enabled`` is therefore fixed at construction — ``enabled=False``
    installs a no-op closure (callers that hold ``_trace = None`` never
    even reach that).
    """

    def __init__(self, capacity: int = 1 << 16, *,
                 clock: Optional[Callable[[], float]] = None,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self._clock: Callable[[], float] = clock or time.monotonic
        self._clock_host: Optional[Any] = None
        # ring slots hold RAW tuples (same field order as Event); they are
        # promoted to Event only on read — emit stays allocation-minimal
        self._dq: Deque[tuple] = deque(maxlen=capacity)
        self._count = itertools.count()
        self._cleared = 0                # emitted total at the last clear()
        self.emit = self._build_emit()

    # -- recording -----------------------------------------------------------
    def _build_emit(self) -> Callable[..., None]:
        """Build the instance's ``emit(kind, uid=-1, name="", device=-1,
        epoch=0, data=None)`` closure: records one event at the current
        backend time; never blocks, never raises on saturation (oldest
        entries are dropped)."""
        if not self.enabled:
            def emit_noop(kind: str, uid: int = -1, name: str = "",
                          device: int = -1, epoch: int = 0,
                          data: Optional[dict] = None) -> None:
                return None
            return emit_noop
        count = self._count
        append = self._dq.append         # clear() keeps the deque's identity
        host = self._clock_host
        clock = self._clock
        if host is not None:
            # host mode (attach_tracer): read the clock THROUGH the
            # scheduler each event — follows Simulator.reset's virtual
            # clock swap without paying a wrapping lambda per event
            def emit(kind: str, uid: int = -1, name: str = "",
                     device: int = -1, epoch: int = 0,
                     data: Optional[dict] = None) -> None:
                append((next(count), host._clock(), kind, uid, name,
                        device, epoch, data))
        else:
            def emit(kind: str, uid: int = -1, name: str = "",
                     device: int = -1, epoch: int = 0,
                     data: Optional[dict] = None) -> None:
                append((next(count), clock(), kind, uid, name, device,
                        epoch, data))
        return emit

    def use_clock(self, clock: Callable[[], float]) -> None:
        """Rebind the timestamp source to a callable (rebuilds the emit
        closure — the clock is prebound there)."""
        self._clock = clock
        self._clock_host = None
        self.emit = self._build_emit()

    def use_clock_host(self, host: Any) -> None:
        """Timestamp from ``host._clock()``, read through ``host`` on
        every event: ``attach_tracer`` binds the scheduler here so
        Simulator.reset's virtual-clock swap and Cluster-live's
        wall-clock restore are followed automatically, without a
        wrapping lambda on the emission hot path."""
        self._clock_host = host
        self._clock = lambda: host._clock()   # introspection/fallback
        self.emit = self._build_emit()

    # -- reading -------------------------------------------------------------
    @property
    def emitted(self) -> int:
        """Total events ever emitted (including dropped ones). Derived
        from the newest surviving seq so emit never pays a counter store;
        under racing emitters momentarily lower-bound (benign)."""
        dq = self._dq
        try:
            return dq[-1][0] + 1
        except IndexError:               # empty: nothing since last clear
            return self._cleared

    @property
    def dropped(self) -> int:
        """Events lost to ring eviction (0 until saturation)."""
        return max(0, self.emitted - self.capacity)

    def events(self) -> List[Event]:
        """Snapshot of the surviving window, in sequence order. Safe to
        call while emitters run (the deque is copied first; racing
        appends at worst miss the snapshot or land slightly out of
        insertion order, which the seq sort repairs)."""
        mk = Event._make
        return sorted(map(mk, list(self._dq)), key=lambda e: e.seq)

    def clear(self) -> None:
        """Drop all recorded events; sequence numbers keep counting up
        (so a post-clear window still orders against nothing stale).
        In-place: the emit closure holds the deque by identity."""
        self._cleared = self.emitted
        self._dq.clear()

    def __len__(self) -> int:
        return len(self._dq)

    def __repr__(self) -> str:
        return (f"Tracer(capacity={self.capacity}, emitted={self.emitted}, "
                f"dropped={self.dropped}, enabled={self.enabled})")


def submit_data(task: Any, job_name: str, job_uid: int) -> dict:
    """Build the SUBMIT event's data payload.

    Carries everything a counterfactual replay needs to reconstruct the
    submission (``obs.whatif``): the job identity, the task's admission
    class (priority / absolute deadline / gang label) and its full
    resource vector. Duck-typed on ``Task`` so the obs package keeps its
    no-core-imports rule; both backends call this at their (cold,
    per-task) submit sites.
    """
    r = task.resources
    return {
        "job": job_name,
        "job_uid": job_uid,
        "priority": task.priority,
        "deadline_t": task.deadline_t,
        "gang_id": task.gang_id,
        "hbm_bytes": r.hbm_bytes,
        "flops": r.flops,
        "bytes_accessed": r.bytes_accessed,
        "collective_bytes": r.collective_bytes,
        "est_seconds": r.est_seconds,
        "core_demand": r.core_demand,
        "bw_demand": r.bw_demand,
        "chips": r.chips,
    }


def attach_tracer(sched: Any, tracer: Tracer) -> Tracer:
    """Point every emission site of ``sched`` at ``tracer``.

    Works on any scheduler class: a flat/gang/preemptive scheduler gets
    ``_trace`` set directly; a ``ShardedScheduler`` fans out to every
    shard, also stamping each shard's ``_trace_dev_off`` with its global
    flat-device base so shard-local indices land as fleet-global ones in
    the event stream. The tracer's clock is late-bound through
    ``sched._clock`` so backend swaps (sim virtual time vs. live wall
    time) are followed without re-attachment.
    """
    shards = getattr(sched, "shards", None)
    if shards is not None:
        sched._trace = tracer                     # wrapper-level events
        off = 0
        for sh in shards:
            sh._trace = tracer
            sh._trace_dev_off = off
            off += len(sh.devices)
    else:
        sched._trace = tracer
    tracer.use_clock_host(sched)
    return tracer
