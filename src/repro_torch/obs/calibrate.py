"""Online probe calibration: observed→predicted feedback into admission.

The scheduler is only as good as the resource vectors its probes convey,
and nothing guarantees those stay accurate: a workload whose kernels grow
(longer sequences, bigger batches) silently drifts away from the estimates
admission ranks and reserves by. This module closes the loop:

  * ``CalibrationStore`` keeps per-resource-class EWMA statistics of
    observed/predicted runtime ratio and observed memory high-water,
    keyed by the ORIGINAL probe vector — the same frozen
    ``ResourceVector`` the scheduler's waiter-class memos key by (a grow
    task's class memo adds a host-uid suffix, but that identifies
    placement, not the resource class, and is dropped here).
  * The scheduler's admission path consults the store through a
    ``_calib`` attribute with the exact ``_trace``/``_explain``
    discipline: ``None`` keeps every hook one attribute load, so the
    calibration-off hot path pays nothing (the reference's
    ``benchmarks/bench_profile.py`` gates the
    calibration-ON marginal cost at ≤5% over tracing-on).
  * At the first admission probe the store stamps ``task.probe_vec``
    (the uncorrected prediction — also the class key, so corrected
    vectors never mint new classes or feed their own statistics) and,
    once a class has enough completions, installs ``task.calibrated_vec``
    with the EWMA-scaled ``est_seconds`` and safety-margin memory. At
    ``task_end`` the store records the observation; the statistics fold
    runs in batches off the hot path (every ``fold_batch`` completions,
    at any read, or eagerly when observers are subscribed).

**The memory-safety invariant**: calibration may INFLATE a reservation
(observed high-water × (1 + mem_margin) above the probe's figure) but
NEVER shrinks one below the observed high-water. The default
(``allow_shrink=False``) never shrinks below the probe's own prediction
either; opting into shrinking (``allow_shrink=True``, for workloads whose
probes over-reserve) still floors every corrected footprint at the
class's observed ``hw_max`` — tested directly by
``tests/test_profile.py`` (the reference) and ``tests/test_torch_obs.py``.

Duck-typed on ``Task``/``ResourceVector`` (``dataclasses.replace`` on the
frozen vector) so the obs package keeps its no-core-imports rule.

Copy of ``src/repro/obs/calibrate.py`` with its imports rewritten
to ``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional


class CalObservation(NamedTuple):
    """One completed task folded into the store (the drift feed for
    ``SLOMonitor.for_calibration``)."""
    t: float                      # backend-timeline completion time
    uid: int
    name: str
    predicted_s: float            # the probe's original estimate
    observed_s: Optional[float]   # None when no begin time was stamped
    used_s: float                 # the estimate admission actually used
    hw_bytes: int                 # observed memory high-water
    reserved_bytes: int           # what admission reserved
    calibrated: bool              # was a corrected vector in effect?


class _ClassCal:
    """Mutable per-class record (one resource class = one probe vector)."""

    __slots__ = ("n_run", "n_mem", "ratio_ewma", "hw_max", "hw_ewma",
                 "violations", "err_raw_sum", "err_used_sum", "n_paired",
                 "err_uncal_sum", "n_uncal", "corrected", "dirty")

    def __init__(self) -> None:
        self.n_run = 0            # runtime observations folded in
        self.n_mem = 0            # memory observations folded in
        self.ratio_ewma = 1.0     # EWMA of observed/predicted runtime
        self.hw_max = 0           # max observed memory high-water
        self.hw_ewma = 0.0
        self.violations = 0       # observations with hw > reservation
        # paired error accounting over CALIBRATED observations only: the
        # same completions scored against the raw probe estimate and the
        # corrected one — the ≥2x accuracy gate reads these
        self.err_raw_sum = 0.0
        self.err_used_sum = 0.0
        self.n_paired = 0
        # and the uncalibrated tail (warm-up below min_samples, or a store
        # attached observe-only): raw-probe error with no correction live
        self.err_uncal_sum = 0.0
        self.n_uncal = 0
        # cached corrected vector (``dataclasses.replace`` costs µs — far
        # too hot for the per-admission path): recomputed lazily after any
        # observation dirties the class. Sound because classes are keyed
        # by VALUE — every equal-valued probe vector corrects identically.
        self.corrected: Optional[Any] = None
        self.dirty = True


class CalibrationStore:
    """Per-class EWMA calibration of probe predictions, fed by the
    scheduler's admission/completion hooks (``attach_calibrator``).

    ``alpha``        — EWMA weight of the newest runtime-ratio sample.
    ``min_samples``  — runtime corrections start after this many observed
                       completions of the class (memory inflation starts
                       at the first observation — inflating is always
                       safe; shrinking waits for ``min_samples`` too).
    ``mem_margin``   — corrected memory = observed high-water × (1+margin),
                       floored as the invariant requires.
    ``allow_shrink`` — permit corrected memory below the probe's figure
                       (never below observed high-water).
    ``max_classes``  — bound on tracked classes; overflow observations are
                       counted (``class_overflow``) and dropped.
    ``fold_batch``   — completions buffered before the statistics fold
                       runs (1 = eager). Reads always flush first, and a
                       subscribed observer forces eager folding, so the
                       deferral is visible only as bounded staleness of
                       the corrections on the admission hot path.
    """

    def __init__(self, *, alpha: float = 0.25, min_samples: int = 3,
                 mem_margin: float = 0.05, allow_shrink: bool = False,
                 max_classes: int = 4096, fold_batch: int = 16):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        if mem_margin < 0.0:
            raise ValueError("mem_margin must be >= 0")
        self.alpha = alpha
        self.min_samples = min_samples
        self.mem_margin = mem_margin
        self.allow_shrink = allow_shrink
        self.max_classes = max_classes
        # the completion hook runs under the scheduler lock on the drain
        # hot path, so it only APPENDS (task, t) to this ring; the actual
        # statistics fold runs in batches of ``fold_batch`` (or at any
        # read, or per-completion when observers are subscribed) — same
        # record-cheap/compute-on-read discipline as the Tracer, gated by
        # the reference's bench_profile at <=5% over tracing-on
        self.fold_batch = max(fold_batch, 1)
        self._pending: deque = deque()
        self._classes: Dict[Any, _ClassCal] = {}
        self._steps: Dict[int, List[float]] = {}  # dev -> [n, sum_s, ewma]
        self._lock = threading.Lock()
        self._observers: List[Callable[[CalObservation], None]] = []
        self.corrections = 0      # tasks given a calibrated_vec
        self._observations = 0    # completions folded in
        self._violations = 0      # hw > reservation, fleet-wide
        self._class_overflow = 0

    # -- admission-side hook (runs under the scheduler lock) -----------------
    def apply(self, task: Any) -> None:
        """Stamp the original probe vector and, when the class has enough
        history, install the corrected vector. Idempotent per task — the
        call sites guard on ``task.probe_vec is None`` so repeat admission
        probes of a parked waiter pay one attribute load."""
        if task.probe_vec is not None:
            return
        vec = task.resources          # calibrated_vec unset: the raw probe
        task.probe_vec = vec
        cal = self._classes.get(vec)
        if cal is None:
            return
        if cal.dirty:
            cal.corrected = self.corrected_for(vec, cal)
            cal.dirty = False
        if cal.corrected is not None:
            task.calibrated_vec = cal.corrected
            self.corrections += 1

    def corrected_for(self, vec: Any,
                      cal: Optional[_ClassCal] = None) -> Optional[Any]:
        """The corrected vector for ``vec`` given its class history, or
        None when no correction applies yet. Public so tests can check the
        never-below-high-water invariant directly."""
        if cal is None:
            self._flush()
            cal = self._classes.get(vec)
            if cal is None:
                return None
        est = vec.est_seconds
        if cal.n_run >= self.min_samples and est > 0:
            est = vec.est_seconds * cal.ratio_ewma
        hbm = vec.hbm_bytes
        if cal.n_mem > 0:
            need = int(cal.hw_max * (1.0 + self.mem_margin))
            if self.allow_shrink and cal.n_mem >= self.min_samples:
                # shrink permitted — but the floor is the INVARIANT:
                # never below the observed high-water
                hbm = max(need, cal.hw_max)
            else:
                hbm = max(vec.hbm_bytes, need)
        if est == vec.est_seconds and hbm == vec.hbm_bytes:
            return None
        return dataclasses.replace(vec, est_seconds=est, hbm_bytes=hbm)

    # -- completion-side hook (runs under the scheduler lock) ----------------
    def note_end(self, task: Any, now: float) -> None:
        """Record one completed task. The hot path only appends to the
        pending ring — completed tasks are immutable, so the fold can read
        their attributes later. Folding runs every ``fold_batch``
        completions, at any read, or immediately when observers are
        subscribed (the SLO drift stream wants timely delivery)."""
        self._pending.append((task, now))
        if self._observers or len(self._pending) >= self.fold_batch:
            self._flush()

    def _flush(self) -> None:
        """Drain the pending ring into the class statistics. Observers
        fire outside the store lock, in completion order."""
        dq = self._pending
        if not dq:
            return
        fired: List[CalObservation] = []
        with self._lock:
            while dq:
                task, now = dq.popleft()
                self._fold_one(task, now, fired)
        for ob in fired:
            for fn in self._observers:
                fn(ob)

    def _fold_one(self, task: Any, now: float,
                  fired: List[CalObservation]) -> None:
        """Fold one observation into its class (under the store lock):
        memory high-water always; runtime ratio only for tasks that
        actually began (``start_t`` stamped by the backend) and are not
        grow deltas (a decode slot's residency is batch membership, not
        predicted work)."""
        pv = task.probe_vec
        if pv is None:
            # completed without an admission probe (bind_resident loop
            # hosts): learn memory under the raw vector, skip runtime
            pv = task.resources
        tv = task.true_vec
        hw = tv.hbm_bytes if tv is not None else pv.hbm_bytes
        used = task.resources
        obs_s: Optional[float] = None
        start = task.start_t
        grow = getattr(task, "grow_hosts", None)
        self._observations += 1
        cal = self._classes.get(pv)
        if cal is None:
            if len(self._classes) >= self.max_classes:
                self._class_overflow += 1
                return
            cal = _ClassCal()
            self._classes[pv] = cal
        cal.n_mem += 1
        if hw > cal.hw_max:
            cal.hw_max = hw
        cal.hw_ewma = (float(hw) if cal.n_mem == 1 else
                       self.alpha * hw
                       + (1.0 - self.alpha) * cal.hw_ewma)
        if hw > used.hbm_bytes:
            cal.violations += 1
            self._violations += 1
        cal.dirty = True                # cached correction is now stale
        if start >= 0 and not grow and pv.est_seconds > 0:
            dur = now - start
            if dur >= 0:
                obs_s = dur
                ratio = dur / pv.est_seconds
                cal.ratio_ewma = (ratio if cal.n_run == 0 else
                                  self.alpha * ratio
                                  + (1.0 - self.alpha) * cal.ratio_ewma)
                cal.n_run += 1
                err_raw = abs(dur - pv.est_seconds)
                if task.calibrated_vec is not None:
                    cal.err_raw_sum += err_raw
                    cal.err_used_sum += abs(dur - used.est_seconds)
                    cal.n_paired += 1
                else:
                    cal.err_uncal_sum += err_raw
                    cal.n_uncal += 1
        if self._observers:
            fired.append(CalObservation(
                now, task.uid, task.name, pv.est_seconds, obs_s,
                used.est_seconds, hw, used.hbm_bytes,
                task.calibrated_vec is not None))

    # -- serving-side hook (per-decode-step TPOT attribution) ----------------
    def note_step(self, device: int, predicted_s: float,
                  observed_s: float) -> None:
        """One decode-loop step: observed inter-token gap vs the model's
        predicted step time, EWMA'd per device (serve.engine feeds this)."""
        with self._lock:
            st = self._steps.get(device)
            if st is None:
                st = [0.0, 0.0, 1.0]
                self._steps[device] = st
            st[0] += 1
            st[1] += observed_s
            if predicted_s > 0:
                r = observed_s / predicted_s
                st[2] = r if st[0] == 1 else \
                    self.alpha * r + (1.0 - self.alpha) * st[2]

    # -- observers ------------------------------------------------------------
    def on_observe(self, fn: Callable[[CalObservation], None]) -> None:
        """Subscribe to completion observations (``SLOMonitor.
        for_calibration`` wires its drift stream here)."""
        self._observers.append(fn)

    # -- reading ---------------------------------------------------------------
    # every read-side entry flushes the pending ring first, so deferred
    # folding is invisible to callers (bounded staleness exists only
    # between a completion and the next read/admission-batch boundary)

    @property
    def observations(self) -> int:
        """Completions folded in."""
        self._flush()
        return self._observations

    @property
    def violations(self) -> int:
        """Observed high-water above the reservation, fleet-wide."""
        self._flush()
        return self._violations

    @property
    def class_overflow(self) -> int:
        self._flush()
        return self._class_overflow

    def ratio_ewma(self, vec: Any) -> Optional[float]:
        self._flush()
        cal = self._classes.get(vec)
        return cal.ratio_ewma if cal is not None and cal.n_run else None

    def highwater(self, vec: Any) -> Optional[int]:
        self._flush()
        cal = self._classes.get(vec)
        return cal.hw_max if cal is not None and cal.n_mem else None

    def rows(self, limit: int = 8) -> List[Dict[str, Any]]:
        """Per-class accuracy rows for dashboards (launch.top), most
        observed classes first."""
        self._flush()
        with self._lock:
            items = sorted(self._classes.items(),
                           key=lambda kv: -(kv[1].n_run + kv[1].n_mem))
            out = []
            for vec, cal in items[:limit]:
                out.append({
                    "est_s": vec.est_seconds,
                    "hbm_gb": vec.hbm_bytes / 1e9,
                    "n": cal.n_run,
                    "ratio": cal.ratio_ewma if cal.n_run else float("nan"),
                    "hw_gb": cal.hw_max / 1e9,
                    "mae_raw_s": (cal.err_raw_sum + cal.err_uncal_sum)
                    / max(cal.n_paired + cal.n_uncal, 1),
                    "mae_used_s": (cal.err_used_sum + cal.err_uncal_sum)
                    / max(cal.n_paired + cal.n_uncal, 1),
                    "violations": cal.violations,
                })
            return out

    def accuracy_report(self) -> Dict[str, Any]:
        """The calibration scorecard: paired mean-absolute est_seconds
        error (raw probe vs corrected, over the SAME calibrated
        completions), the uncalibrated warm-up tail, memory violations
        (must stay 0 under the invariant), and serve-step attribution."""
        self._flush()
        with self._lock:
            n_paired = sum(c.n_paired for c in self._classes.values())
            raw = sum(c.err_raw_sum for c in self._classes.values())
            used = sum(c.err_used_sum for c in self._classes.values())
            n_uncal = sum(c.n_uncal for c in self._classes.values())
            uncal = sum(c.err_uncal_sum for c in self._classes.values())
            steps = {
                dev: {"steps": int(st[0]),
                      "observed_mean_s": st[1] / st[0] if st[0] else 0.0,
                      "err_ratio_ewma": st[2] - 1.0}
                for dev, st in self._steps.items()}
        mae_raw = raw / n_paired if n_paired else 0.0
        mae_used = used / n_paired if n_paired else 0.0
        return {
            "classes": len(self._classes),
            "observations": self._observations,
            "corrections": self.corrections,
            "violations": self._violations,
            "class_overflow": self._class_overflow,
            "paired": {
                "n": n_paired,
                "mae_raw_s": mae_raw,
                "mae_used_s": mae_used,
                # the acceptance-gate statistic: how many times smaller the
                # corrected estimates' error is than the raw probes', on
                # the same completions
                "improvement": (mae_raw / mae_used if mae_used > 0
                                else float("inf") if mae_raw > 0 else 1.0),
            },
            "uncalibrated": {"n": n_uncal,
                             "mae_s": uncal / n_uncal if n_uncal else 0.0},
            "serve_steps": steps,
        }

    def __repr__(self) -> str:
        return (f"CalibrationStore(classes={len(self._classes)}, "
                f"observations={self.observations}, "
                f"corrections={self.corrections}, "
                f"violations={self.violations})")


def attach_calibrator(sched: Any,
                      store: Optional[CalibrationStore] = None
                      ) -> CalibrationStore:
    """Point every calibration hook of ``sched`` at ``store`` (building a
    default one if None). Mirrors ``attach_tracer``: a flat/gang/preemptive
    scheduler gets ``_calib`` set directly; a ``ShardedScheduler`` fans out
    to every shard — all shards SHARE the store, so a class observed on one
    pod corrects admissions on every pod (the store's own lock covers the
    cross-shard writes)."""
    if store is None:
        store = CalibrationStore()
    shards = getattr(sched, "shards", None)
    if shards is not None:
        sched._calib = store           # wrapper-level discovery (dashboards)
        for sh in shards:
            sh._calib = store
    else:
        sched._calib = store
    return store


class CalibratedScheduler:
    """Ergonomic wrapper: ``CalibratedScheduler(sched)`` attaches a
    ``CalibrationStore`` and delegates everything else to the wrapped
    scheduler — drop-in wherever a scheduler is expected::

        sched = CalibratedScheduler(MGBAlg3Scheduler(8))
        cluster = Cluster(sched, backend="sim", trace=True)
        ...
        sched.store.accuracy_report()

    The mechanism lives in the scheduler's ``_calib`` hooks (so ``Cluster
    (calibrate=True)`` and ``attach_calibrator`` work on a bare
    scheduler); this class is the composition-style spelling. Attribute
    reads and writes forward to the inner scheduler, so backend wiring
    (``_clock`` repointing, ``shed_expired``, tracer attachment) lands on
    the real object.
    """

    _OWN = frozenset({"inner", "store"})

    def __init__(self, inner: Any,
                 store: Optional[CalibrationStore] = None, **store_kw):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(
            self, "store",
            store if store is not None else CalibrationStore(**store_kw))
        attach_calibrator(inner, self.store)

    def __getattr__(self, name: str) -> Any:
        return getattr(object.__getattribute__(self, "inner"), name)

    def __setattr__(self, name: str, value: Any) -> None:
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(object.__getattribute__(self, "inner"), name, value)

    def __repr__(self) -> str:
        return f"CalibratedScheduler({self.inner!r}, {self.store!r})"
