"""Per-task observed-vs-predicted attribution over the lifecycle stream.

``obs.events`` records what HAPPENED (park/admit/begin/end/evict, with
timestamps on the backend's own clock); the SUBMIT event's payload records
what the probe PREDICTED (the full resource vector). Joining the two turns
the tracer into a continuous profiler, with no new instrumentation on the
hot path:

  * ``TaskProfile`` — one record per task: predicted vs observed runtime
    (error seconds / ratio), memory reserved vs observed high-water,
    the queueing-delay decomposition (parked → dispatch → execution),
    eviction/incarnation counts;
  * ``profiles_from_events`` — the pure event-stream join (works on any
    recorded window, including a flight-recorder dump);
  * ``device_occupancy`` — per-device occupancy-percent timelines: the
    demand-weighted resident load reconstructed from ADMIT/GROW and
    END/SHRINK/EVICT/CRASH windows (demand from the SUBMIT payload);
  * ``chrome_counter_records`` — Perfetto counter tracks (per-device
    occupancy %, prediction-error %) merged into the Chrome export by
    ``obs.export`` when profile counters are requested;
  * ``Profiler`` — the live wrapper over a ``Tracer`` that
    ``Cluster.profile()`` / ``JobHandle.profile()`` read through.

Observed times come from the SAME events both backends already emit —
virtual-clock BEGIN→END spans in the simulator, wall-clock spans live —
so sim and live attribution are directly comparable (the parity test
diffs them through ``obs.replay``).

Copy of ``src/repro/obs/profile.py`` with its imports rewritten
to ``repro_torch``; keep the two in step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs import events as ev

# fallback demand for residents that never passed a SUBMIT site (e.g. the
# serve engine's bind_resident decode-loop hosts): one compute slot's share
# of the scheduler's 16-slot ledger
DEFAULT_DEMAND = 1.0 / 16

_ERR_PID = 1_000_001   # synthetic process row for the prediction-error track


class TaskProfile:
    """Observed-vs-predicted attribution for one task uid."""

    __slots__ = ("uid", "name", "job", "pred_est_s", "pred_hbm", "demand",
                 "reserved_hbm", "hw_bytes", "submit_t", "park_s",
                 "dispatch_s", "exec_s", "end_t", "completed", "crashed",
                 "shed", "evictions", "incarnations", "devices", "grow",
                 "calibrated", "_park_at", "_admit_at", "_begin_at")

    def __init__(self, uid: int):
        self.uid = uid
        self.name = ""
        self.job = ""
        self.pred_est_s: Optional[float] = None   # probe estimate (SUBMIT)
        self.pred_hbm: Optional[int] = None
        self.demand: Optional[float] = None
        self.reserved_hbm: Optional[int] = None   # what admission granted
        self.hw_bytes: Optional[int] = None       # observed high-water (END)
        self.submit_t: Optional[float] = None
        self.park_s = 0.0        # parked in the waiter queue
        self.dispatch_s = 0.0    # admitted -> execution began
        self.exec_s = 0.0        # executing (sum over incarnations)
        self.end_t: Optional[float] = None
        self.completed = False
        self.crashed = False
        self.shed = False
        self.evictions = 0
        self.incarnations = 0    # ADMIT/GROW grants received
        self.devices: List[int] = []
        self.grow = False        # a decode-slot delta (GROW lifecycle)
        self.calibrated = False  # a corrected reservation was in effect
        self._park_at: Optional[float] = None
        self._admit_at: Optional[float] = None
        self._begin_at: Optional[float] = None

    # -- derived -------------------------------------------------------------
    @property
    def err_s(self) -> Optional[float]:
        """Observed minus predicted runtime (None without both sides, and
        meaningless for grow deltas, whose exec span is batch residency)."""
        if not self.completed or self.grow or self.pred_est_s is None \
                or self.exec_s <= 0.0:
            return None
        return self.exec_s - self.pred_est_s

    @property
    def err_ratio(self) -> Optional[float]:
        e = self.err_s
        if e is None or not self.pred_est_s:
            return None
        return e / self.pred_est_s

    @property
    def queueing_s(self) -> float:
        """Total pre-execution delay: parked + dispatch."""
        return self.park_s + self.dispatch_s

    @property
    def memory_violation(self) -> bool:
        """Observed high-water above the reservation — must never be True
        under a memory-safe scheduler + the calibration invariant."""
        return (self.hw_bytes is not None and self.reserved_hbm is not None
                and self.hw_bytes > self.reserved_hbm)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "uid": self.uid, "name": self.name, "job": self.job,
            "pred_est_s": self.pred_est_s, "pred_hbm": self.pred_hbm,
            "reserved_hbm": self.reserved_hbm, "hw_bytes": self.hw_bytes,
            "park_s": self.park_s, "dispatch_s": self.dispatch_s,
            "exec_s": self.exec_s, "err_s": self.err_s,
            "err_ratio": self.err_ratio, "completed": self.completed,
            "crashed": self.crashed, "shed": self.shed,
            "evictions": self.evictions, "incarnations": self.incarnations,
            "devices": list(self.devices), "grow": self.grow,
            "calibrated": self.calibrated,
            "memory_violation": self.memory_violation,
        }

    def __repr__(self) -> str:
        return (f"TaskProfile({self.name or self.uid}, "
                f"pred={self.pred_est_s}, exec={self.exec_s:.4f}s, "
                f"park={self.park_s:.4f}s, completed={self.completed})")


def format_profile(p: TaskProfile) -> str:
    """One human line per task: predicted → observed, delay decomposition,
    memory reserved vs high-water (the trace_viewer epilogue)."""
    if p.pred_est_s is not None and p.completed and not p.grow \
            and p.exec_s > 0:
        delta = f"{p.err_ratio * +100:+.1f}%" if p.err_ratio is not None \
            else "n/a"
        run = (f"predicted {p.pred_est_s:.3f}s -> observed "
               f"{p.exec_s:.3f}s ({delta})")
    elif p.completed:
        run = f"ran {p.exec_s:.3f}s"
    elif p.crashed:
        run = "crashed"
    elif p.shed:
        run = "shed"
    else:
        run = "unresolved"
    mem = ""
    if p.reserved_hbm is not None:
        hw = f"{p.hw_bytes / 1e9:.1f}" if p.hw_bytes is not None else "?"
        mem = (f", mem {p.reserved_hbm / 1e9:.1f}GB reserved / "
               f"{hw}GB high-water")
    extra = f", evictions {p.evictions}" if p.evictions else ""
    cal = " [calibrated]" if p.calibrated else ""
    return (f"{p.name or p.uid}: {run}, parked {p.park_s:.3f}s, "
            f"dispatch {p.dispatch_s:.3f}s{mem}{extra}{cal}")


# -- the event-stream join ----------------------------------------------------

def profiles_from_events(events: Any) -> Dict[int, TaskProfile]:
    """Fold a lifecycle window into per-task attribution records. Pure on
    the event list — works on a live tracer snapshot, a flight-recorder
    dump, or a replayed leg equally."""
    out: Dict[int, TaskProfile] = {}

    def get(uid: int) -> TaskProfile:
        p = out.get(uid)
        if p is None:
            p = TaskProfile(uid)
            out[uid] = p
        return p

    for e in events:
        if e.uid < 0:
            continue
        kind = e.kind
        if kind == ev.SUBMIT:
            p = get(e.uid)
            p.name = e.name or p.name
            p.submit_t = e.t
            d = e.data
            if d is not None:
                p.job = d.get("job", "")
                p.pred_est_s = d.get("est_seconds")
                p.pred_hbm = d.get("hbm_bytes")
                core = d.get("core_demand")
                bw = d.get("bw_demand")
                if core is not None:
                    p.demand = max(core, bw if bw is not None else 0.0)
        elif kind in (ev.PARK, ev.REQUEUE, ev.RESTORE):
            p = get(e.uid)
            p.name = e.name or p.name
            if p._park_at is None:
                p._park_at = e.t
        elif kind in (ev.ADMIT, ev.GROW):
            p = get(e.uid)
            p.name = e.name or p.name
            if p._park_at is not None:
                p.park_s += e.t - p._park_at
                p._park_at = None
            p._admit_at = e.t
            p.incarnations += 1
            if e.device >= 0:
                p.devices.append(e.device)
            if kind == ev.GROW:
                p.grow = True
            d = e.data
            if d is not None and "hbm" in d:
                p.reserved_hbm = d["hbm"]
                p.calibrated = True
            elif p.reserved_hbm is None:
                p.reserved_hbm = p.pred_hbm
        elif kind == ev.BEGIN:
            p = get(e.uid)
            if p._admit_at is not None:
                p.dispatch_s += e.t - p._admit_at
                p._admit_at = None
            p._begin_at = e.t
        elif kind in (ev.END, ev.SHRINK):
            p = get(e.uid)
            if p._begin_at is not None:
                p.exec_s += e.t - p._begin_at
                p._begin_at = None
            elif p._admit_at is not None:
                # no BEGIN on this lifecycle (grow deltas, bind residents):
                # the exec span is the residency window
                p.exec_s += e.t - p._admit_at
            p._admit_at = None
            p.end_t = e.t
            p.completed = True
            d = e.data
            if d is not None and "hw" in d:
                p.hw_bytes = d["hw"]
        elif kind == ev.EVICT:
            p = get(e.uid)
            if p._begin_at is not None:
                p.exec_s += e.t - p._begin_at
                p._begin_at = None
            p._admit_at = None
            p.evictions += 1
        elif kind == ev.SHED:
            get(e.uid).shed = True
        elif kind == ev.CRASH:
            p = get(e.uid)
            p.crashed = True
            if p._begin_at is not None:
                p.exec_s += e.t - p._begin_at
                p._begin_at = None
            p._admit_at = None
    return out


# -- per-device occupancy timelines ------------------------------------------

def device_occupancy(events: Any, *,
                     default_demand: float = DEFAULT_DEMAND,
                     timeline_cap: int = 4096) -> Dict[int, Dict[str, Any]]:
    """Reconstruct per-device occupancy-percent timelines from residency
    windows: a task contributes its probed ``demand`` (the dominant
    core/bandwidth share from its SUBMIT payload) from ADMIT/GROW to the
    matching END/SHRINK/EVICT/CRASH. Occupancy is capped at 1.0 — Alg. 3
    legitimately oversubscribes compute slots; the percent answers "how
    busy", not "how oversubscribed".

    Returns ``{device: {"busy_frac", "mean_occupancy", "last", "timeline"}}``
    where ``busy_frac`` is the fraction of the window with ANY resident,
    ``mean_occupancy`` the time-weighted mean demand (both in [0, 1]),
    and ``timeline`` up to ``timeline_cap`` ``(t, occupancy)`` samples."""
    demand_of: Dict[int, float] = {}
    where: Dict[int, Tuple[int, float]] = {}   # uid -> (device, demand)
    load: Dict[int, float] = {}                # device -> raw demand sum
    acc: Dict[int, Dict[str, Any]] = {}
    t0: Optional[float] = None
    t_last: Dict[int, float] = {}
    t_end: Optional[float] = None

    def dev_acc(d: int) -> Dict[str, Any]:
        a = acc.get(d)
        if a is None:
            a = {"busy_s": 0.0, "wsum": 0.0, "timeline": []}
            acc[d] = a
        return a

    def integrate(d: int, t: float) -> None:
        a = dev_acc(d)
        prev = t_last.get(d, t0 if t0 is not None else t)
        span = t - prev
        if span > 0:
            occ = min(load.get(d, 0.0), 1.0)
            a["wsum"] += occ * span
            if occ > 0:
                a["busy_s"] += span
        t_last[d] = t

    def sample(d: int, t: float) -> None:
        tl = dev_acc(d)["timeline"]
        occ = min(load.get(d, 0.0), 1.0)
        if len(tl) < timeline_cap:
            if tl and tl[-1][0] == t:
                tl[-1] = (t, occ)
            else:
                tl.append((t, occ))

    for e in events:
        if t0 is None:
            t0 = e.t
        t_end = e.t
        if e.kind == ev.SUBMIT and e.data is not None and e.uid >= 0:
            core = e.data.get("core_demand")
            bw = e.data.get("bw_demand")
            if core is not None:
                demand_of[e.uid] = max(core, bw if bw is not None else 0.0)
        elif e.kind in (ev.ADMIT, ev.GROW) and e.uid >= 0 and e.device >= 0:
            stale = where.pop(e.uid, None)
            if stale is not None:            # lost close: settle the old dev
                integrate(stale[0], e.t)
                load[stale[0]] = max(load.get(stale[0], 0.0) - stale[1], 0.0)
                sample(stale[0], e.t)
            dm = demand_of.get(e.uid, default_demand)
            integrate(e.device, e.t)
            load[e.device] = load.get(e.device, 0.0) + dm
            where[e.uid] = (e.device, dm)
            sample(e.device, e.t)
        elif e.kind in (ev.END, ev.SHRINK, ev.EVICT, ev.CRASH) \
                and e.uid in where:
            d, dm = where.pop(e.uid)
            integrate(d, e.t)
            load[d] = max(load.get(d, 0.0) - dm, 0.0)
            sample(d, e.t)
    if t_end is not None:
        for d in list(acc):
            integrate(d, t_end)
    out: Dict[int, Dict[str, Any]] = {}
    span = (t_end - t0) if t0 is not None and t_end is not None else 0.0
    for d, a in acc.items():
        out[d] = {
            "busy_frac": a["busy_s"] / span if span > 0 else 0.0,
            "mean_occupancy": a["wsum"] / span if span > 0 else 0.0,
            "last": min(load.get(d, 0.0), 1.0),
            "timeline": a["timeline"],
        }
    return out


# -- Perfetto counter tracks --------------------------------------------------

def chrome_counter_records(events: Any,
                           us: Callable[[float], float]) -> List[dict]:
    """Counter-track records for the Chrome export (``obs.export`` merges
    these when profile counters are enabled): a per-device "occupancy %"
    counter on each device's existing process row, and a fleet-wide
    "prediction error %" track (absolute observed/predicted runtime error
    per completion). ``us`` is the exporter's own timestamp converter, so
    the counters land on the same timeline as the occupancy slices."""
    out: List[dict] = []
    occ = device_occupancy(events)
    for d in sorted(occ):
        for t, frac in occ[d]["timeline"]:
            out.append({"ph": "C", "pid": d, "tid": 0,
                        "name": "occupancy %", "ts": us(t),
                        "args": {"pct": round(frac * 100.0, 1)}})
    profs = profiles_from_events(events)
    err_samples: List[Tuple[float, float]] = []
    for p in profs.values():
        r = p.err_ratio
        if r is not None and p.end_t is not None:
            err_samples.append((p.end_t, abs(r) * 100.0))
    if err_samples:
        out.append({"ph": "M", "pid": _ERR_PID, "tid": 0,
                    "name": "process_name",
                    "args": {"name": "prediction error"}})
        for t, pct in sorted(err_samples):
            out.append({"ph": "C", "pid": _ERR_PID, "tid": 0,
                        "name": "est error %", "ts": us(t),
                        "args": {"pct": round(pct, 1)}})
    return out


# -- the live wrapper ---------------------------------------------------------

class Profiler:
    """Attribution reader over a live ``Tracer`` (and optionally the
    ``CalibrationStore`` sharing its run). Recomputes from the current
    event window on demand — the tracer stays the single source of truth,
    and the profiler adds zero cost to the emission path."""

    def __init__(self, tracer: Any, store: Any = None):
        self.tracer = tracer
        self.store = store

    def profiles(self) -> Dict[int, TaskProfile]:
        return profiles_from_events(self.tracer.events())

    def by_name(self) -> Dict[str, TaskProfile]:
        """Latest profile per task name (parity-friendly: names survive
        re-submission across backends, uids do not)."""
        out: Dict[str, TaskProfile] = {}
        for p in self.profiles().values():
            if p.name:
                out[p.name] = p
        return out

    def device_occupancy(self, **kw) -> Dict[int, Dict[str, Any]]:
        return device_occupancy(self.tracer.events(), **kw)

    def summary(self) -> Dict[str, Any]:
        """Fleet-level attribution rollup (the ``Cluster.profile()``
        no-handle answer): runtime-error stats over completed tasks, the
        queueing decomposition, memory violations, per-device occupancy,
        and — when a calibration store rides along — its accuracy report."""
        profs = list(self.profiles().values())
        done = [p for p in profs if p.completed]
        errs = [abs(p.err_s) for p in done if p.err_s is not None]
        ratios = [abs(p.err_ratio) for p in done if p.err_ratio is not None]
        occ = self.device_occupancy()
        out: Dict[str, Any] = {
            "tasks": len(profs),
            "completed": len(done),
            "crashed": sum(1 for p in profs if p.crashed),
            "shed": sum(1 for p in profs if p.shed),
            "evictions": sum(p.evictions for p in profs),
            "memory_violations": sum(1 for p in profs if p.memory_violation),
            "mean_abs_err_s": sum(errs) / len(errs) if errs else 0.0,
            "mean_abs_err_ratio":
                sum(ratios) / len(ratios) if ratios else 0.0,
            "park_s": sum(p.park_s for p in profs),
            "dispatch_s": sum(p.dispatch_s for p in profs),
            "exec_s": sum(p.exec_s for p in profs),
            "device_occupancy": {
                d: {"busy_frac": o["busy_frac"],
                    "mean_occupancy": o["mean_occupancy"]}
                for d, o in occ.items()},
        }
        if self.store is not None:
            out["calibration"] = self.store.accuracy_report()
        return out
