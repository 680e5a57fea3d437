"""Decision explainability: bounded per-task verdict rings.

The event ring (``obs/events.py``) answers *what happened*; this module
answers *why*.
Every drain/admission attempt records a structured ``Verdict`` at the
existing decision sites in ``scheduler/base.py`` / ``gang.py`` /
``preempt.py`` / ``sharded.py``: why each probed device refused
(``memory_short_bytes``, ``slots_full``, ``max_residents``,
``link_headroom``, ``grow_budget``, ``device_dead``), when a waiter was
skipped without probing (``class_memo_skip``, hint skips), which
preemption victim plans were considered and at what cost, who evicted a
task, and where it finally landed. ``JobHandle.explain()`` /
``Cluster.explain(handle)`` read the rings back in one call on both
backends.

Design constraints mirror the tracer's (see ``obs/events.py``):

  1. **Disabled must be free.** Emission sites guard with
     ``ex = self._explain`` / ``if ex is not None`` — one attribute load
     on the hot path when explanation is off.
  2. **Enabled must stay inside the tracer's budget.** The expensive part of
     a rejection verdict is the per-device reason walk (O(devices) dict
     builds). Two mitigations keep the paired bench gate at <=5%:

     * ``reject()`` takes the reasons **lazily** (a zero-arg callable)
       and COLLAPSES consecutive rejections of the same task: if the
       task's newest verdict is already a rejection, the repeat just
       bumps ``repeats`` and refreshes the timestamp — the device walk
       runs once per parked *episode*, not once per failed probe.
     * ``skip()`` treats probe-avoidance skips (class-memo / hint
       skips, which fire once per drain pass per parked class on deep
       queues) as extensions of the open parked episode: when the
       newest verdict is already a rejection or skip, the bump is two
       in-place attribute writes — no verdict construction at all.
       ``record(..., collapse=True)`` gives the same in-place bump to
       same-action/device repeats at other sites.

  3. **Bounded memory.** Each task keeps a ``deque(maxlen=per_task)``
     verdict ring (last-K wins); the task map itself is bounded at
     ``max_tasks`` by evicting the oldest-inserted task's ring (dict
     insertion order), so a serving fleet that churns millions of uids
     never grows without bound.

Copy of ``src/repro/obs/explain.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, NamedTuple, Optional, Tuple

# raw ring-entry layout (list indices; Verdict materializes on read)
_T = 1          # [0]=seq  [1]=t  [2]=uid  [3]=name
_ACTION = 4     # [4]=action  [5]=device  [6]=reasons
_DEVICE = 5     # [7]=data  [8]=repeats
_DATA = 7
_REPEATS = 8

# -- verdict actions --------------------------------------------------------
# String constants (like the event kinds) so dumps read directly.
ADMITTED = "admitted"            # placed on a device / group
REJECTED = "rejected"            # probed and refused; reasons name devices
SKIPPED = "skipped"              # not probed (class memo / freed-cap hint)
EVICTED = "evicted"              # preempted or device-death victim
SHED = "shed"                    # parked past deadline, failed at a drain
CRASHED = "crashed"              # infeasible / OOM — terminal failure
GROWN = "grown"                  # decode-slot delta admitted
PREEMPT_PLANNED = "preempt_planned"    # arrival won via eviction plan
PREEMPT_REJECTED = "preempt_rejected"  # no affordable victim plan
STOLEN = "stolen"                # sharded: moved toward an idle pod
STEAL_REFUSED = "steal_refused"  # sharded: target pod refused, restored
REHOMED = "rehomed"              # sharded: pod died, re-routed elsewhere

# rejection-reason vocabulary (the ``reason`` key of each reasons entry)
R_DEVICE_DEAD = "device_dead"
R_MEMORY_SHORT = "memory_short_bytes"
R_SLOTS_FULL = "slots_full"
R_MAX_RESIDENTS = "max_residents"
R_LINK_HEADROOM = "link_headroom"
R_GROW_BUDGET = "grow_budget"
R_HOST_GONE = "host_gone"
R_NO_FEASIBLE_GROUP = "no_feasible_group"
R_CLASS_MEMO = "class_memo_skip"
R_HINT_SKIP = "hint_skip"
R_NO_VICTIM_PLAN = "no_victim_plan"


class Verdict:
    """One structured decision record.

    ``seq``     — monotonic per-explainer sequence (decision order).
    ``t``       — backend-timeline seconds (same clock as the tracer).
    ``uid``     — task uid the verdict is about.
    ``name``    — task name (parity across backends; uids differ per leg).
    ``action``  — one of the module constants above.
    ``device``  — GLOBAL flat device index when placement-scoped, else -1.
    ``reasons`` — tuple of dicts, each with a ``reason`` key from the
                  vocabulary plus site-specific detail (``device``,
                  ``short_bytes``, ``short_slots``, ``by``, ``cost_s``…).
    ``data``    — optional dict of extras (victim plans, shard ids, …).
    ``repeats`` — how many consecutive identical outcomes this record
                  collapses (a waiter re-probed 400 times while parked
                  keeps ONE rejection verdict with ``repeats=400``).

    ``Verdict`` is the READ-side materialization: the rings store raw
    9-slot lists (same field order) and ``verdicts()``/``last()`` wrap
    them on access. On deep queues the hot explainer path is the episode
    BUMP (repeat probe of an already-parked task, skip of an
    already-explained class) and, next, the admission append — a list
    literal plus an indexed increment is ~3x cheaper than any class
    construction, which is the difference between fitting the paired
    bench's 5% budget and blowing it.
    """

    __slots__ = ("seq", "t", "uid", "name", "action", "device", "reasons",
                 "data", "repeats")

    def __init__(self, seq: int, t: float, uid: int, name: str, action: str,
                 device: int = -1, reasons: Tuple[dict, ...] = (),
                 data: Optional[dict] = None, repeats: int = 1):
        self.seq = seq
        self.t = t
        self.uid = uid
        self.name = name
        self.action = action
        self.device = device
        self.reasons = reasons
        self.data = data
        self.repeats = repeats

    def __repr__(self) -> str:
        return (f"Verdict(seq={self.seq}, t={self.t:.6f}, uid={self.uid}, "
                f"name={self.name!r}, action={self.action!r}, "
                f"device={self.device}, reasons={self.reasons!r}, "
                f"data={self.data!r}, repeats={self.repeats})")

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Verdict):
            return NotImplemented
        return all(getattr(self, f) == getattr(other, f)
                   for f in self.__slots__)

    def as_dict(self) -> Dict[str, Any]:
        return {f: getattr(self, f) for f in self.__slots__}


class Explainer:
    """Bounded per-task last-K verdict rings.

    Thread-safety matches the tracer: dict/deque mutations are single
    C-level ops under the GIL; racing recorders may interleave seqs out
    of order and ``verdicts()`` returns ring order (per-task inserts are
    single-threaded in practice — each task's decisions happen under its
    scheduler's lock).
    """

    def __init__(self, per_task: int = 16, max_tasks: int = 4096, *,
                 clock: Optional[Callable[[], float]] = None):
        if per_task < 1 or max_tasks < 1:
            raise ValueError("per_task and max_tasks must be >= 1")
        self.per_task = per_task
        self.max_tasks = max_tasks
        self._clock: Callable[[], float] = clock or time.monotonic
        self._clock_host: Optional[Any] = None
        # raw 9-slot lists (see layout above); Verdict wraps on read
        self._rings: Dict[int, Deque[list]] = {}
        self._names: Dict[int, str] = {}
        self._count = itertools.count()
        self.recorded = 0                # total verdicts (incl. collapsed)
        self.evicted_tasks = 0           # rings dropped to the task bound

    # -- clock (same late-binding contract as Tracer) ------------------------
    def _now(self) -> float:
        host = self._clock_host
        return host._clock() if host is not None else self._clock()

    def use_clock(self, clock: Callable[[], float]) -> None:
        self._clock = clock
        self._clock_host = None

    def use_clock_host(self, host: Any) -> None:
        """Timestamp from ``host._clock()`` read through ``host`` per call,
        so the simulator's virtual-clock swap is followed automatically."""
        self._clock_host = host

    # -- recording -----------------------------------------------------------
    def _ring(self, uid: int, name: str) -> Deque[list]:
        ring = self._rings.get(uid)
        if ring is None:
            if len(self._rings) >= self.max_tasks:
                old = next(iter(self._rings))    # oldest-inserted uid
                del self._rings[old]
                self._names.pop(old, None)
                self.evicted_tasks += 1
            ring = self._rings[uid] = deque(maxlen=self.per_task)
            self._names[uid] = name
        return ring

    def record(self, uid: int, name: str, action: str, *, device: int = -1,
               reasons: Tuple[dict, ...] = (), data: Optional[dict] = None,
               collapse: bool = False) -> None:
        """Append one verdict. With ``collapse=True``, a newest verdict
        with the same action and device is bumped in place (``repeats`` +
        fresh timestamp) instead of appended — keeps drain-pass skip
        noise O(1) per episode in both time and ring space."""
        self.recorded += 1
        ring = self._rings.get(uid)
        if ring is None:
            ring = self._ring(uid, name)
        # clock read inlined (record is on the admit hot path; a method
        # call per verdict is measurable at bench depth)
        host = self._clock_host
        now = host._clock() if host is not None else self._clock()
        if collapse and ring:
            last = ring[-1]
            if last[_ACTION] == action and last[_DEVICE] == device:
                last[_T] = now
                last[_REPEATS] += 1
                return
        ring.append([next(self._count), now, uid, name,
                     action, device, reasons, data, 1])

    def reject(self, uid: int, name: str,
               reasons_fn: Callable[[], Tuple[dict, ...]], *,
               device: int = -1, data: Optional[dict] = None) -> None:
        """Record a probe rejection with LAZY reasons: if the task's
        newest verdict is already a rejection, only ``repeats``/``t`` are
        bumped and ``reasons_fn`` is never called — the O(devices) reason
        walk runs once per parked episode, not once per failed probe."""
        self.recorded += 1
        ring = self._rings.get(uid)
        if ring:
            last = ring[-1]
            if last[_ACTION] == REJECTED:
                last[_T] = self._now()
                last[_REPEATS] += 1
                return
        elif ring is None:
            ring = self._ring(uid, name)
        ring.append([next(self._count), self._now(), uid, name,
                     REJECTED, device, tuple(reasons_fn()), data, 1])

    def skip(self, uid: int, name: str,
             reasons: Tuple[dict, ...] = ()) -> None:
        """Record a probe-avoidance skip (freed-capacity hint, class memo,
        preemption memo). A skip EXTENDS the open parked episode: when the
        task's newest verdict is a rejection or a prior skip, only its
        ``repeats`` counter is bumped — the structured reasons of the
        original rejection still explain why the task is parked, the
        verdict's ``t`` stays the episode's last materialized decision
        time (current state is the live ``explain_queue`` probe's job),
        and the bump is one in-place increment: this fires once per drain
        pass per parked class on deep queues, so it is the single
        hottest explainer path. Only a fresh episode (no ring, or last
        verdict was an admission/eviction) appends a SKIPPED verdict
        carrying the skip reasons."""
        self.recorded += 1
        ring = self._rings.get(uid)
        if ring:
            last = ring[-1]
            act = last[_ACTION]
            if act == SKIPPED or act == REJECTED:
                last[_REPEATS] += 1
                return
        elif ring is None:
            ring = self._ring(uid, name)
        ring.append([next(self._count), self._now(), uid, name,
                     SKIPPED, -1, reasons, None, 1])

    def annotate_last(self, uid: int, key: str, value: Any) -> None:
        """Attach ``key: value`` to the task's newest verdict's data dict
        (in place when the dict exists — O(1) on the repeat path)."""
        ring = self._rings.get(uid)
        if not ring:
            return
        v = ring[-1]
        if v[_DATA] is not None:
            v[_DATA][key] = value
        else:
            v[_DATA] = {key: value}

    # -- reading -------------------------------------------------------------
    def verdicts(self, uid: int) -> List[Verdict]:
        """The task's surviving verdict window, oldest first
        (materialized — mutating the returned Verdicts does not touch
        the ring)."""
        ring = self._rings.get(uid)
        return [Verdict(*r) for r in ring] if ring else []

    def last(self, uid: int) -> Optional[Verdict]:
        ring = self._rings.get(uid)
        return Verdict(*ring[-1]) if ring else None

    def tasks(self) -> List[int]:
        return list(self._rings)

    def clear(self) -> None:
        self._rings.clear()
        self._names.clear()

    def __len__(self) -> int:
        return len(self._rings)

    def __repr__(self) -> str:
        return (f"Explainer(per_task={self.per_task}, "
                f"tasks={len(self._rings)}, recorded={self.recorded})")


def attach_explainer(sched: Any, explainer: Explainer) -> Explainer:
    """Point every decision site of ``sched`` at ``explainer``.

    Mirrors ``attach_tracer``: a flat/gang/preemptive scheduler gets
    ``_explain`` set directly; a ``ShardedScheduler`` fans out to every
    shard and (re)stamps each shard's global ``_trace_dev_off`` device
    base — either attacher may run first, both agree on the offsets. The
    clock is late-bound through ``sched._clock`` like the tracer's.
    """
    shards = getattr(sched, "shards", None)
    if shards is not None:
        sched._explain = explainer               # wrapper-level verdicts
        off = 0
        for sh in shards:
            sh._explain = explainer
            sh._trace_dev_off = off
            off += len(sh.devices)
    else:
        sched._explain = explainer
    explainer.use_clock_host(sched)
    return explainer


def format_verdicts(verdicts: List[Verdict]) -> str:
    """Human-readable one-line-per-verdict rendering (used by
    ``examples/trace_viewer.py``'s explain epilogue and ``repro-top``)."""
    lines = []
    for v in verdicts:
        rep = f" x{v.repeats}" if v.repeats > 1 else ""
        dev = f" dev={v.device}" if v.device >= 0 else ""
        why = ""
        if v.reasons:
            parts = []
            for r in v.reasons[:4]:
                extra = {k: w for k, w in r.items()
                         if k not in ("reason", "device")}
                tag = r.get("reason", "?")
                if "device" in r:
                    tag += f"@dev{r['device']}"
                if extra:
                    tag += "(" + ", ".join(f"{k}={w}" for k, w in
                                           sorted(extra.items())) + ")"
                parts.append(tag)
            if len(v.reasons) > 4:
                parts.append(f"... +{len(v.reasons) - 4} more")
            why = "  [" + "; ".join(parts) + "]"
        lines.append(f"  t={v.t:9.4f}  {v.action:<16}{rep}{dev}{why}")
    return "\n".join(lines) if lines else "  (no verdicts recorded)"
