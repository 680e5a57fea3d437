"""Flight recorder, sim/live parity differ, and lifecycle validator.

The repo's core determinism claim — one submission trace produces the
SAME decision sequence on the virtual-clock simulator and the threaded
live executor — has so far been asserted by four hand-rolled test
harnesses that each re-derive "the decision sequence" from a different
artifact (``sched.placements``, ``preempt_log``, ``join_log``). This
module promotes the pattern to a first-class tool over the one unified
artifact every backend now produces: the ``obs.events`` stream.

  * ``decisions``/``admission_order``/``eviction_order`` project a
    stream onto a comparable decision list (task NAMES, not uids — each
    leg rebuilds its Jobs and draws fresh uids);
  * ``first_divergence`` diffs two projections and pinpoints the first
    divergent decision with context (the actual parity differ);
  * ``validate_lifecycles`` checks every task's events walk a legal path
    through the lifecycle state machine — no lost, duplicated, or
    out-of-order transitions across eviction, pod death, grow/shrink,
    and work stealing;
  * ``FlightRecorder`` dumps the tracer's ring window to disk on crash
    or drain (wired into ``Cluster``), so a failed run leaves its last
    N decisions behind for post-mortem.

Copy of ``src/repro/obs/replay.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import events as ev

# -- decision projections ----------------------------------------------------


def decisions(events: Sequence[ev.Event], *, kinds: Sequence[str],
              with_device: bool = False) -> List:
    """Project a stream onto the ordered list of decisions of the given
    kinds, keyed by task name (uids differ between legs). With
    ``with_device`` each entry is ``(name, device)`` — only for decision
    kinds whose placement is itself deterministic."""
    want = frozenset(kinds)
    if with_device:
        return [(e.name, e.device) for e in events if e.kind in want]
    return [e.name for e in events if e.kind in want]


def admission_order(events: Sequence[ev.Event],
                    with_device: bool = False) -> List:
    """Names (or (name, device)) in admission order — ADMIT and GROW both
    count: a decode-slot join is an admission decision."""
    return decisions(events, kinds=(ev.ADMIT, ev.GROW),
                     with_device=with_device)


def eviction_order(events: Sequence[ev.Event],
                   with_device: bool = False) -> List:
    """Victim names in eviction order (preemptions and device deaths)."""
    return decisions(events, kinds=(ev.EVICT,), with_device=with_device)


@dataclasses.dataclass
class Divergence:
    """First point where two decision sequences disagree."""
    index: int
    a: object          # decision in stream A at index (None: A exhausted)
    b: object          # decision in stream B at index (None: B exhausted)
    a_context: List    # up to 3 decisions of A around the divergence
    b_context: List

    def __str__(self) -> str:
        return (f"decision #{self.index} diverges: "
                f"a={self.a!r} vs b={self.b!r} "
                f"(a context {self.a_context!r}, "
                f"b context {self.b_context!r})")


def first_divergence(a: Sequence, b: Sequence) -> Optional[Divergence]:
    """Diff two decision sequences; None iff identical. The returned
    ``Divergence`` prints usefully, so tests assert ``div is None, div``
    and a failure names the exact first divergent decision."""
    n = max(len(a), len(b))
    for i in range(n):
        da = a[i] if i < len(a) else None
        db = b[i] if i < len(b) else None
        if da != db:
            lo = max(i - 1, 0)
            return Divergence(i, da, db,
                              list(a[lo:i + 2]), list(b[lo:i + 2]))
    return None


def diff_streams(events_a: Sequence[ev.Event],
                 events_b: Sequence[ev.Event], *,
                 kinds: Sequence[str] = (ev.ADMIT, ev.GROW, ev.EVICT),
                 with_device: bool = False) -> Optional[Divergence]:
    """One-call parity differ: project both streams onto the given
    decision kinds and report the first divergent decision (None iff the
    runs agree). The default kinds cover the repo's determinism claim:
    admission order (incl. slot grows) and eviction order."""
    return first_divergence(
        decisions(events_a, kinds=kinds, with_device=with_device),
        decisions(events_b, kinds=kinds, with_device=with_device))


# -- lifecycle state machine -------------------------------------------------

# State names (internal to validation; events carry only kinds).
_NEW, _SUBMITTED, _PARKED, _ADMITTED, _RUNNING = \
    "new", "submitted", "parked", "admitted", "running"
_EVICTED, _STOLEN, _DONE, _DEAD = "evicted", "stolen", "done", "dead"

# state -> {event kind -> next state}. Kinds absent from a state's row are
# illegal there. Deliberate tolerances, each mirroring real backend
# behaviour rather than papering over bugs:
#   * DEAD -> PARKED: a sharded wrapper re-homes a waiter whose shard
#     declared it infeasible after local deaths (shard emits CRASH, the
#     wrapper re-parks it on a surviving shard);
#   * DONE -> DEAD: the live executor's OOM path releases resources
#     (task_end emits END) and THEN records the crash;
#   * EVICTED + GANG_RELEASE: a gang victim's group release may trail its
#     eviction notice.
_TRANSITIONS: Dict[str, Dict[str, str]] = {
    _NEW: {ev.SUBMIT: _SUBMITTED, ev.PARK: _PARKED,
           ev.ADMIT: _ADMITTED, ev.GROW: _ADMITTED},
    _SUBMITTED: {ev.PARK: _PARKED, ev.ADMIT: _ADMITTED,
                 ev.GROW: _ADMITTED, ev.CRASH: _DEAD},
    _PARKED: {ev.ADMIT: _ADMITTED, ev.GROW: _ADMITTED,
              ev.SHED: _DEAD, ev.CRASH: _DEAD, ev.STEAL: _STOLEN},
    _STOLEN: {ev.ADMIT: _ADMITTED, ev.RESTORE: _PARKED},
    _ADMITTED: {ev.DISPATCH: _ADMITTED, ev.GANG_RESERVE: _ADMITTED,
                ev.GANG_RELEASE: _ADMITTED, ev.BEGIN: _RUNNING,
                ev.END: _DONE, ev.SHRINK: _DONE,
                ev.EVICT: _EVICTED, ev.CRASH: _DEAD},
    _RUNNING: {ev.END: _DONE, ev.SHRINK: _DONE,
               ev.GANG_RELEASE: _RUNNING, ev.EVICT: _EVICTED,
               ev.CRASH: _DEAD},
    _EVICTED: {ev.REQUEUE: _PARKED, ev.GANG_RELEASE: _EVICTED},
    _DONE: {ev.GANG_RELEASE: _DONE, ev.CRASH: _DEAD},
    _DEAD: {ev.PARK: _PARKED},
}

TERMINAL_STATES = frozenset({_DONE, _DEAD})


def validate_lifecycles(events: Sequence[ev.Event],
                        *, require_terminal: bool = False) -> List[str]:
    """Walk every task's event sub-stream through the lifecycle state
    machine. Returns a list of violations (empty == sound): an illegal
    transition means a lost, duplicated, or out-of-order event. With
    ``require_terminal``, tasks left mid-flight at the end of the window
    are violations too (use after a full drain)."""
    state: Dict[int, str] = {}
    names: Dict[int, str] = {}
    problems: List[str] = []
    last_seq = -1
    for e in events:
        if e.seq <= last_seq:
            problems.append(f"seq not strictly increasing at {e!r}")
        last_seq = e.seq
        if e.uid < 0:
            if e.kind not in (ev.MARK_DEAD, ev.REVIVE):
                problems.append(f"task-scoped kind without uid: {e!r}")
            continue
        s = state.get(e.uid, _NEW)
        names.setdefault(e.uid, e.name)
        nxt = _TRANSITIONS.get(s, {}).get(e.kind)
        if nxt is None:
            problems.append(
                f"task {names[e.uid] or e.uid!r} (uid {e.uid}): illegal "
                f"{e.kind!r} in state {s!r} (seq {e.seq})")
            continue  # stay in s: report once, keep walking
        state[e.uid] = nxt
    if require_terminal:
        for uid, s in sorted(state.items()):
            if s not in TERMINAL_STATES:
                problems.append(f"task {names.get(uid) or uid!r} "
                                f"(uid {uid}) ended mid-flight in {s!r}")
    return problems


# -- flight recorder ---------------------------------------------------------


class FlightRecorder:
    """Dump the tracer's surviving ring window to disk on notable
    moments (crash, drain) — a post-mortem of the last N decisions.
    ``dump`` is idempotent per reason unless ``always=True``.

    Each dump also carries the tracer's drop counter (how much history
    the ring already lost — the post-mortem's own error bar) and a
    metrics snapshot: the attached ``registry``'s if one was passed,
    otherwise one derived from the surviving window itself
    (``metrics_from_events``) so a dump is never metric-less."""

    def __init__(self, tracer: ev.Tracer, path: str = "flight.json",
                 registry=None):
        self.tracer = tracer
        self.path = path
        self.registry = registry
        self.dumps: List[Tuple[str, str]] = []  # (reason, path)

    def dump(self, reason: str, *, always: bool = False) -> Optional[str]:
        if not always and any(r == reason for r, _ in self.dumps):
            return None
        base, ext = os.path.splitext(self.path)
        path = f"{base}.{reason}{ext or '.json'}" \
            if len(self.dumps) or always else self.path
        events = self.tracer.events()
        if self.registry is not None:
            metrics = self.registry.snapshot()
        else:
            from repro_torch.obs.metrics import metrics_from_events
            metrics = metrics_from_events(events).snapshot()
        doc = {
            "reason": reason,
            "emitted": self.tracer.emitted,
            "dropped": self.tracer.dropped,
            "metrics": metrics,
            "events": [e._asdict() for e in events],
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        self.dumps.append((reason, path))
        return path


def load_flight(path: str) -> List[ev.Event]:
    """Load a flight-recorder dump back into ``Event`` objects."""
    with open(path) as f:
        doc = json.load(f)
    return [ev.Event(**{**d, "data": d.get("data")})
            for d in doc["events"]]
