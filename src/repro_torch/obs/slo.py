"""Live SLO / degradation monitoring over the metrics plane.

The paper's headline quality claim is an execution-dilation envelope:
compiler-guided sharing keeps per-kernel slowdown within ~2.5% of the
solo roofline while sharing the chip. This module turns that number —
plus the serving-path deadline/TTFT/TPOT targets — into *live* rolling
state with alert callbacks, instead of a post-hoc notebook:

  * ``SLOMonitor`` keeps bounded rolling windows (deadline-met flags,
    TTFT/TPOT samples, per-task observed-vs-roofline slowdown) and
    computes **burn rates**: the fraction of the window violating the
    objective divided by the error budget ``1 - target``. Burn > 1
    means the window is spending budget faster than the SLO allows;
    crossing 1 upward fires the alert hook exactly once per violation
    episode (healthy -> violating transition), so an operator hears
    about a regression when it starts, not 400 times while it lasts.
  * The paper's 2.5% envelope (``SLOWDOWN_ENVELOPE``) is the default
    alert threshold for the slowdown stream: a task whose observed
    duration exceeds roofline x (1 + envelope) is a violation.
  * ``SLOMonitor.for_serving`` subscribes the monitor to a
    ``MetricsRegistry``'s ``ttft_s`` / ``tpot_s`` histograms via the
    registry's ``on_record`` observer hook — the serve engine's existing
    metric writes feed the monitor with no new instrumentation.
  * ``prometheus_text`` renders a registry snapshot (and optionally a
    monitor's status) in the Prometheus text exposition format, so a
    scrape endpoint is one ``web.Response(text=...)`` away.

Copy of ``src/repro/obs/slo.py`` with its imports rewritten
to ``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import re
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, NamedTuple, Optional

# The paper's execution-dilation envelope (§V-B: MGB keeps per-kernel
# slowdown within ~2.5% of solo) — the default degradation threshold.
SLOWDOWN_ENVELOPE = 0.025


class SLOAlert(NamedTuple):
    """One healthy->violating transition."""
    t: float
    stream: str        # "deadline" | "ttft" | "tpot" | "slowdown" | "drift"
    name: str          # task name for slowdown/drift alerts, else ""
    value: float       # the burn rate (or slowdown factor) at transition
    threshold: float   # what it crossed


class _Window:
    """Rolling boolean window: violation flags + O(1) burn rate."""

    __slots__ = ("flags", "violations", "target")

    def __init__(self, window: int, target: float):
        self.flags: Deque[bool] = deque(maxlen=window)
        self.violations = 0
        self.target = target

    def push(self, violated: bool) -> None:
        if len(self.flags) == self.flags.maxlen and self.flags[0]:
            self.violations -= 1
        self.flags.append(violated)
        if violated:
            self.violations += 1

    @property
    def rate(self) -> float:
        return self.violations / len(self.flags) if self.flags else 0.0

    @property
    def burn(self) -> float:
        """Violation rate over the error budget: > 1 = burning faster
        than the SLO allows."""
        budget = max(1.0 - self.target, 1e-9)
        return self.rate / budget


class SLOMonitor:
    """Rolling-window SLO state with edge-triggered alert callbacks.

    Feed it observations (``note_*``) from any thread; read ``status()``
    / ``alerts`` from a dashboard. All windows are bounded deques — a
    serving fleet can stream forever without growth.
    """

    def __init__(self, *, window: int = 256,
                 deadline_target: float = 0.95,
                 ttft_slo_s: Optional[float] = None,
                 tpot_slo_s: Optional[float] = None,
                 latency_target: float = 0.99,
                 slowdown_envelope: float = SLOWDOWN_ENVELOPE,
                 drift_tolerance: float = 0.25,
                 drift_target: float = 0.9,
                 on_alert: Optional[Callable[[SLOAlert], None]] = None,
                 clock: Optional[Callable[[], float]] = None):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self.ttft_slo_s = ttft_slo_s
        self.tpot_slo_s = tpot_slo_s
        self.slowdown_envelope = slowdown_envelope
        # probe-drift stream (fed by obs.calibrate via for_calibration): a
        # completion whose observed/predicted runtime ratio strays more than
        # drift_tolerance from 1 is a drift violation; the stream burning
        # past its (looser) drift_target budget means the workload has
        # drifted away from what the probes predict
        self.drift_tolerance = drift_tolerance
        self.on_alert = on_alert
        self._clock = clock or time.monotonic
        self._wins: Dict[str, _Window] = {
            "deadline": _Window(window, deadline_target),
            "ttft": _Window(window, latency_target),
            "tpot": _Window(window, latency_target),
            "slowdown": _Window(window, latency_target),
            "drift": _Window(window, drift_target),
        }
        self._violating: Dict[str, bool] = {k: False for k in self._wins}
        # per-task latest slowdown factor (observed / roofline)
        self.slowdowns: Dict[str, float] = {}
        self.alerts: List[SLOAlert] = []

    # -- observations --------------------------------------------------------
    def _push(self, stream: str, violated: bool, value: float,
              threshold: float, name: str = "") -> None:
        win = self._wins[stream]
        win.push(violated)
        burning = win.burn > 1.0
        was = self._violating[stream]
        self._violating[stream] = burning
        if burning and not was:
            alert = SLOAlert(self._clock(), stream, name,
                             value if stream == "slowdown" else win.burn,
                             threshold)
            self.alerts.append(alert)
            if self.on_alert is not None:
                self.on_alert(alert)

    def note_deadline(self, met: bool) -> None:
        """One job resolved with a deadline: did it make it?"""
        self._push("deadline", not met, 0.0, 1.0)

    def note_ttft(self, seconds: float) -> None:
        slo = self.ttft_slo_s
        self._push("ttft", slo is not None and seconds > slo,
                   seconds, slo or 0.0)

    def note_tpot(self, seconds: float) -> None:
        slo = self.tpot_slo_s
        self._push("tpot", slo is not None and seconds > slo,
                   seconds, slo or 0.0)

    def note_slowdown(self, name: str, observed_s: float,
                      roofline_s: float) -> None:
        """Observed wall duration vs the solo roofline estimate: factor
        above ``1 + envelope`` is a degradation violation (the paper's
        2.5% claim, live)."""
        factor = observed_s / roofline_s if roofline_s > 0 else 1.0
        self.note_slowdown_factor(name, factor)

    def note_slowdown_factor(self, name: str, factor: float) -> None:
        self.slowdowns[name] = factor
        limit = 1.0 + self.slowdown_envelope
        self._push("slowdown", factor > limit, factor, limit, name)

    def note_drift(self, name: str, predicted_s: float,
                   observed_s: float) -> None:
        """One completion's predicted-vs-observed runtime: a ratio straying
        more than ``drift_tolerance`` from 1 (either direction) counts as
        probe drift. Edge-triggered like every stream — the alert fires
        once when the window starts burning, i.e. when mispredictions
        become the norm rather than noise."""
        if predicted_s <= 0:
            return
        ratio = observed_s / predicted_s
        self._push("drift", abs(ratio - 1.0) > self.drift_tolerance,
                   ratio, self.drift_tolerance, name)

    # -- registry subscription ----------------------------------------------
    @classmethod
    def for_serving(cls, registry: Any, **kw) -> "SLOMonitor":
        """Build a monitor subscribed to the serving metrics a
        ``MetricsRegistry`` already collects: every ``ttft_s`` /
        ``tpot_s`` histogram record feeds the rolling windows via the
        registry's ``on_record`` hook."""
        mon = cls(**kw)
        registry.on_record("ttft_s", mon.note_ttft)
        registry.on_record("tpot_s", mon.note_tpot)
        return mon

    @classmethod
    def for_calibration(cls, store: Any, **kw) -> "SLOMonitor":
        """Build a monitor whose drift stream is fed by a
        ``CalibrationStore``: every completion observation the store
        records (via its ``on_observe`` hook) compares the ORIGINAL probe
        estimate against the observed runtime — corrected estimates are
        deliberately not used, so the alert tracks raw probe quality even
        while calibration is hiding the error from admission."""
        mon = cls(**kw)

        def feed(o: Any) -> None:
            if o.observed_s is not None:
                mon.note_drift(o.name, o.predicted_s, o.observed_s)

        store.on_observe(feed)
        return mon

    # -- reading -------------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """One dict a dashboard renders directly: per-stream window
        size, violation rate, burn rate, healthy flag; plus the worst
        current slowdown."""
        out: Dict[str, Any] = {}
        for k, w in self._wins.items():
            out[k] = {"n": len(w.flags), "rate": w.rate, "burn": w.burn,
                      "healthy": not self._violating[k]}
        worst = max(self.slowdowns.items(), key=lambda kv: kv[1],
                    default=None)
        out["worst_slowdown"] = \
            {"name": worst[0], "factor": worst[1]} if worst else None
        out["alerts"] = len(self.alerts)
        return out

    @property
    def healthy(self) -> bool:
        return not any(self._violating.values())


# -- Prometheus text exposition ----------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(name: str, prefix: str = "repro_") -> str:
    return prefix + _NAME_RE.sub("_", name)


def prometheus_text(registry: Any,
                    monitor: Optional[SLOMonitor] = None,
                    *, prefix: str = "repro_") -> str:
    """Render a ``MetricsRegistry`` snapshot (plus, optionally, an
    ``SLOMonitor``'s status) in the Prometheus text exposition format:
    counters as ``_total``, gauges bare, histograms as summaries
    (quantile-labelled samples + ``_sum``/``_count``)."""
    snap = registry.snapshot()
    lines: List[str] = []
    for name, value in snap.get("counters", {}).items():
        m = _metric_name(name, prefix)
        lines.append(f"# TYPE {m}_total counter")
        lines.append(f"{m}_total {value}")
    for name, value in snap.get("gauges", {}).items():
        m = _metric_name(name, prefix)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {value}")
    for name, h in snap.get("histograms", {}).items():
        m = _metric_name(name, prefix)
        lines.append(f"# TYPE {m} summary")
        for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            lines.append(f'{m}{{quantile="{q}"}} {h[key]}')
        lines.append(f"{m}_sum {h['mean'] * h['n']}")
        lines.append(f"{m}_count {h['n']}")
    if monitor is not None:
        st = monitor.status()
        for stream in ("deadline", "ttft", "tpot", "slowdown", "drift"):
            s = st[stream]
            m = _metric_name(f"slo_{stream}_burn", prefix)
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {s['burn']}")
            m = _metric_name(f"slo_{stream}_healthy", prefix)
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {int(s['healthy'])}")
        m = _metric_name("slo_alerts", prefix)
        lines.append(f"# TYPE {m}_total counter")
        lines.append(f"{m}_total {st['alerts']}")
    return "\n".join(lines) + "\n"
