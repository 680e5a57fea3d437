"""Counterfactual what-if replay: re-run a recorded trace under an
alternate scheduling policy and report what would have changed.

The SUBMIT events both backends emit carry the full submission context
(``obs.events.submit_data``): job identity, priority, absolute deadline,
gang label, and the complete resource vector. That makes a recorded
stream a *replayable artifact*: ``reconstruct`` rebuilds the submission
trace (arrival times, per-job task sequences, fleet faults), ``replay``
re-runs it through the discrete-event simulator under any scheduler
class / policy knobs, and ``compare`` reports the makespan /
deadline-met / p99-queueing / eviction deltas plus the FIRST divergent
decision (via ``obs.replay.diff_streams``) for each candidate policy.

Fidelity contract: a round-trip under the SAME policy (same scheduler
factory, workers, shedding and preemption settings) reproduces the
original admission/eviction sequence exactly — the property the seeded
test battery asserts on overload, gang and device-death traces. Two
scope notes:

  * fleet faults are re-injected *between* events at their recorded
    times; a task completing at exactly the fault's timestamp ordered
    after the death in the original (the scheduled-failure hook fires
    before same-instant completions) but before it in replay. Measure
    zero for real traces; avoid deadlines colliding exactly with
    injected fault times if byte-exact round-trips matter;
  * decode-slot GROW deltas (``grow_hosts``) are rebuilt as ordinary
    tasks — serving-engine traces replay with slot joins treated as
    admissions, which preserves ordering but not the grow accounting.

Everything core-side is imported lazily so the obs package stays
importable without ``repro_torch.core``.

Copy of ``src/repro/obs/whatif.py`` with its imports rewritten
to ``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import events as ev
from repro_torch.obs import metrics as mt
from repro_torch.obs import replay as rp

# ResourceVector fields carried by every enriched SUBMIT event
VEC_FIELDS = ("hbm_bytes", "flops", "bytes_accessed", "collective_bytes",
              "est_seconds", "core_demand", "bw_demand", "chips")


@dataclasses.dataclass
class SubmittedTask:
    """One task of a recorded submission (from one SUBMIT event)."""
    name: str
    t: float                       # when ITS submit fired (tasks sequence)
    priority: int
    deadline_t: Optional[float]
    gang_id: Optional[str]
    vector: Dict[str, Any]         # VEC_FIELDS -> value


@dataclasses.dataclass
class Submission:
    """One job's recorded submission: ordered tasks, arrival = first
    task's SUBMIT time (later tasks submit as their predecessors finish;
    the simulator reproduces that sequencing by itself)."""
    job: str
    job_uid: int
    t: float
    seq: int                       # first SUBMIT's seq (same-t tiebreak)
    tasks: List[SubmittedTask] = dataclasses.field(default_factory=list)

    @property
    def priority(self) -> int:
        return self.tasks[0].priority if self.tasks else 0

    @property
    def deadline_t(self) -> Optional[float]:
        return self.tasks[0].deadline_t if self.tasks else None


@dataclasses.dataclass
class FleetOp:
    """A recorded fleet fault: device death or revival."""
    t: float
    seq: int
    kind: str                      # ev.MARK_DEAD | ev.REVIVE
    device: int                    # global flat index (mark_dead routes it)


@dataclasses.dataclass
class SubmissionTrace:
    """The replayable reconstruction of a recorded stream."""
    submissions: List[Submission]
    fleet_ops: List[FleetOp]

    def timeline(self) -> List[Tuple[float, int, object]]:
        """Submissions and fleet ops merged in recorded order (t, then
        original seq — so a death and an arrival at one instant replay
        in the order they actually happened)."""
        rows: List[Tuple[float, int, object]] = \
            [(s.t, s.seq, s) for s in self.submissions]
        rows += [(op.t, op.seq, op) for op in self.fleet_ops]
        rows.sort(key=lambda r: (r[0], r[1]))
        return rows


def reconstruct(events: Sequence[ev.Event]) -> SubmissionTrace:
    """Rebuild the submission trace from a recorded stream. Requires the
    enriched SUBMIT payload (any stream recorded since the introspection
    plane); raises on bare legacy SUBMIT events rather than replaying a
    half-reconstructed workload."""
    subs: Dict[Any, Submission] = {}
    ops: List[FleetOp] = []
    for e in events:
        if e.kind == ev.SUBMIT:
            d = e.data or {}
            if "hbm_bytes" not in d:
                raise ValueError(
                    f"SUBMIT event for {e.name!r} (seq {e.seq}) lacks the "
                    f"resource-vector payload — the stream predates the "
                    f"replayable SUBMIT enrichment and cannot be "
                    f"reconstructed")
            key = d.get("job_uid", d.get("job"))
            sub = subs.get(key)
            if sub is None:
                sub = subs[key] = Submission(
                    job=d.get("job", e.name), job_uid=d.get("job_uid", -1),
                    t=e.t, seq=e.seq)
            sub.tasks.append(SubmittedTask(
                name=e.name, t=e.t,
                priority=d.get("priority", 0),
                deadline_t=d.get("deadline_t"),
                gang_id=d.get("gang_id"),
                vector={k: d[k] for k in VEC_FIELDS}))
        elif e.kind in (ev.MARK_DEAD, ev.REVIVE) and e.device >= 0:
            ops.append(FleetOp(e.t, e.seq, e.kind, e.device))
    return SubmissionTrace(sorted(subs.values(),
                                  key=lambda s: (s.t, s.seq)), ops)


def _build_job(sub: Submission, *, use_priorities: bool,
               use_deadlines: bool):
    """Rebuild a ``repro_torch.core.task.Job`` from a recorded submission,
    PRE-STAMPED with the recorded priority / absolute deadline (submit
    with both overrides None keeps the stamps — no clock re-derivation,
    so the round-trip replays the exact recorded deadline_t)."""
    from repro_torch.core.task import Job, ResourceVector, Task, UnitTask
    tasks = []
    for st in sub.tasks:
        vec = ResourceVector(**st.vector)
        tasks.append(Task(
            units=[UnitTask(fn=None,
                            memobjs=frozenset({st.name or "buf"}),
                            resources=vec, name=st.name)],
            name=st.name, gang_id=st.gang_id))
    return Job(tasks=tasks, name=sub.job,
               priority=sub.priority if use_priorities else 0,
               deadline_t=sub.deadline_t if use_deadlines else None)


@dataclasses.dataclass
class ReplayResult:
    """One counterfactual leg: the replayed stream + its headline
    metrics (same definitions the compare() deltas use)."""
    policy: str
    events: List[ev.Event]
    stats: Dict[str, float]          # Cluster.stats() of the replay
    makespan_s: float
    deadline_met: float              # fraction of deadlined jobs met
    deadline_jobs: int
    p99_queueing_s: float
    evictions: int


def replay(source, scheduler_factory: Callable[[], Any], *,
           policy: str = "replay", workers: Optional[int] = None,
           shed_late: bool = False, preempt: Optional[bool] = None,
           use_priorities: bool = True, use_deadlines: bool = True,
           trace_capacity: int = 1 << 16,
           time_limit: float = 1e7) -> ReplayResult:
    """Re-run a recorded stream (or a pre-built ``SubmissionTrace``)
    through the simulator under ``scheduler_factory()``.

    ``use_priorities=False`` flattens every job to class 0 (FIFO within
    the queue); ``use_deadlines=False`` strips deadlines (disables EDF
    ordering AND shedding). The recorded fleet faults are re-injected at
    their recorded times regardless of policy."""
    from repro_torch.core.cluster import Cluster
    trace = source if isinstance(source, SubmissionTrace) \
        else reconstruct(source)
    tracer = ev.Tracer(capacity=trace_capacity)
    cluster = Cluster(scheduler_factory(), workers=workers, backend="sim",
                      shed_late=shed_late, preempt=preempt, trace=tracer)
    for t, _seq, item in trace.timeline():
        cluster.run_until(t)
        if isinstance(item, FleetOp):
            if item.kind == ev.MARK_DEAD:
                cluster.inject_failure(item.device)
            else:
                cluster.revive(item.device)
        else:
            cluster.submit(_build_job(item, use_priorities=use_priorities,
                                      use_deadlines=use_deadlines))
    cluster._sim.drain(time_limit)
    events = tracer.events()
    met, n_dl = _deadline_met(trace, events)
    reg = mt.metrics_from_events(events)
    return ReplayResult(
        policy=policy, events=events, stats=cluster.stats(),
        makespan_s=_makespan(events),
        deadline_met=met, deadline_jobs=n_dl,
        p99_queueing_s=reg.hist("queueing_delay_s").quantile(0.99),
        evictions=reg.counter(f"events.{ev.EVICT}").snapshot())


# -- headline metrics (same definitions for recorded + replayed legs) --------

def _makespan(events: Sequence[ev.Event]) -> float:
    if not events:
        return 0.0
    ts = [e.t for e in events]
    return max(ts) - min(ts)


def _deadline_met(trace: SubmissionTrace,
                  events: Sequence[ev.Event]) -> Tuple[float, int]:
    """Fraction of deadlined jobs whose every task ENDed by the deadline.
    Matched by task NAME (uids are fresh per leg), so distinct task
    names per job make the report exact."""
    last_end: Dict[str, float] = {}
    failed: set = set()
    for e in events:
        if e.kind == ev.END:
            last_end[e.name] = e.t
        elif e.kind in (ev.SHED, ev.CRASH):
            failed.add(e.name)
    met = n = 0
    for sub in trace.submissions:
        dl = sub.deadline_t
        if dl is None:
            continue
        n += 1
        names = [st.name for st in sub.tasks]
        if any(nm in failed for nm in names):
            continue
        if all(nm in last_end and last_end[nm] <= dl + 1e-9
               for nm in names):
            met += 1
    return (met / n if n else 1.0), n


def summarize(events: Sequence[ev.Event],
              trace: Optional[SubmissionTrace] = None) -> Dict[str, float]:
    """Headline metrics of a stream (recorded or replayed): the baseline
    row of a what-if report."""
    trace = trace or reconstruct(events)
    reg = mt.metrics_from_events(events)
    met, n_dl = _deadline_met(trace, events)
    return {
        "makespan_s": _makespan(events),
        "deadline_met": met,
        "deadline_jobs": n_dl,
        "p99_queueing_s": reg.hist("queueing_delay_s").quantile(0.99),
        "evictions": reg.counter(f"events.{ev.EVICT}").snapshot(),
    }


def compare(events: Sequence[ev.Event],
            policies: Dict[str, Dict[str, Any]], *,
            scheduler_factory: Callable[[], Any],
            workers: Optional[int] = None, shed_late: bool = False,
            preempt: Optional[bool] = None,
            diff_kinds: Sequence[str] = (ev.ADMIT, ev.GROW, ev.EVICT)
            ) -> Dict[str, Any]:
    """Replay a recorded stream under each candidate policy and report,
    per policy: the headline metrics, their deltas against the recorded
    baseline, and the first decision where the counterfactual diverged
    from what actually happened (None = identical decisions).

    ``policies`` maps a display name to ``replay()`` keyword overrides,
    e.g. ``{"fifo": {"use_priorities": False, "use_deadlines": False},
    "edf": {"use_priorities": False, "use_deadlines": True}}``. The
    scheduler factory and backend knobs default to one shared setting —
    pass per-policy ``scheduler_factory``/``shed_late``/``preempt``
    overrides inside the policy dict to vary those too."""
    trace = reconstruct(events)
    base = summarize(events, trace)
    report: Dict[str, Any] = {"baseline": base, "policies": {}}
    for name, overrides in policies.items():
        kw = {"workers": workers, "shed_late": shed_late,
              "preempt": preempt, "scheduler_factory": scheduler_factory}
        kw.update(overrides)
        factory = kw.pop("scheduler_factory")
        res = replay(trace, factory, policy=name, **kw)
        div = rp.diff_streams(events, res.events, kinds=diff_kinds)
        leg = {
            "makespan_s": res.makespan_s,
            "deadline_met": res.deadline_met,
            "deadline_jobs": res.deadline_jobs,
            "p99_queueing_s": res.p99_queueing_s,
            "evictions": res.evictions,
            "delta": {
                "makespan_s": res.makespan_s - base["makespan_s"],
                "deadline_met": res.deadline_met - base["deadline_met"],
                "p99_queueing_s":
                    res.p99_queueing_s - base["p99_queueing_s"],
                "evictions": res.evictions - base["evictions"],
            },
            "first_divergence": str(div) if div is not None else None,
        }
        report["policies"][name] = leg
    return report
