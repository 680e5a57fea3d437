"""Log-bucketed histograms + counter/gauge registry with JSON snapshots.

Serving-path metrics (queueing delay, TTFT, TPOT, eviction cost, steal
rate) span five orders of magnitude — linear buckets would either blur
the tail or explode in count. ``Histogram`` buckets by powers of
``growth`` (default 2) from ``least`` upward: bucket *i* holds values in
``[least * growth**i, least * growth**(i+1))``, so p99 at 50 ms and p50
at 50 µs live in the same 40-bucket structure with bounded error.

``MetricsRegistry`` is the named collection point: ``hist/counter/gauge``
get-or-create, ``snapshot()`` is a plain-dict view, ``save_json`` writes
it. ``metrics_from_events`` derives the standard scheduler metrics from
an ``obs.events`` stream, so a traced run gets histograms for free.

Copy of ``src/repro/obs/metrics.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.obs import events as ev


class Histogram:
    """Log-bucketed histogram: O(1) record, bounded memory, quantiles with
    one-bucket resolution. Values below ``least`` land in bucket 0;
    values past the last bucket clamp into it (and are counted exactly in
    ``overflow``)."""

    def __init__(self, *, least: float = 1e-6, growth: float = 2.0,
                 buckets: int = 48):
        if least <= 0 or growth <= 1 or buckets < 1:
            raise ValueError("need least > 0, growth > 1, buckets >= 1")
        self.least = least
        self.growth = growth
        self._log_g = math.log(growth)
        self.counts = [0] * buckets
        self.n = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.overflow = 0
        # streaming observers (obs.slo alert hooks): called with each
        # recorded value. Empty list costs one truthiness check per record.
        self.observers: List = []

    def record(self, value: float) -> None:
        self.n += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if value < self.least:
            i = 0
        else:
            i = int(math.log(value / self.least) / self._log_g) + 1
            if i >= len(self.counts):
                i = len(self.counts) - 1
                self.overflow += 1
        self.counts[i] += 1
        obs_fns = self.observers
        if obs_fns:
            for fn in obs_fns:
                fn(value)

    def bucket_bounds(self, i: int) -> tuple:
        """(lo, hi) of bucket ``i`` (bucket 0 is [0, least))."""
        if i == 0:
            return (0.0, self.least)
        return (self.least * self.growth ** (i - 1),
                self.least * self.growth ** i)

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile (0 when
        empty) — one-bucket resolution, monotone in q."""
        if self.n == 0:
            return 0.0
        target = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return min(self.bucket_bounds(i)[1], self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def snapshot(self) -> dict:
        return {
            "n": self.n, "mean": self.mean,
            "min": self.min if self.n else 0.0,
            "max": self.max if self.n else 0.0,
            "p50": self.quantile(0.50), "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "least": self.least, "growth": self.growth,
            "overflow": self.overflow,
            # sparse encoding: most of the 48 buckets are empty
            "buckets": {i: c for i, c in enumerate(self.counts) if c},
        }


class Counter:
    """Monotone event count."""

    def __init__(self) -> None:
        self.value = 0

    def inc(self, by: int = 1) -> None:
        self.value += by

    def snapshot(self) -> int:
        return self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self) -> float:
        return self.value


class MetricsRegistry:
    """Named get-or-create collection of histograms/counters/gauges."""

    def __init__(self) -> None:
        self._hists: Dict[str, Histogram] = {}
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}

    def hist(self, name: str, **kw) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(**kw)
        return h

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def on_record(self, name: str, fn) -> None:
        """Subscribe ``fn(value)`` to every future record on histogram
        ``name`` (get-or-create) — the live-alert hook ``obs.slo`` uses
        to watch TTFT/TPOT streams without polling snapshots."""
        self.hist(name).observers.append(fn)

    def snapshot(self) -> dict:
        return {
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self._hists.items())},
            "counters": {k: c.snapshot()
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.snapshot()
                       for k, g in sorted(self._gauges.items())},
        }

    def save_json(self, path: str) -> dict:
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=1)
        return snap


def metrics_from_events(events: Sequence[ev.Event],
                        reg: Optional[MetricsRegistry] = None
                        ) -> MetricsRegistry:
    """Derive the standard scheduler metrics from a lifecycle stream:

      * ``queueing_delay_s`` — first park → first admission, per task;
      * ``eviction_cost_s``  — admission → eviction (work at risk), per
        evicted incarnation;
      * ``requeue_to_resume_s`` — eviction → re-admission;
      * counters: one per event kind, plus ``migrations`` (re-admission
        on a different device than the evicted incarnation).
    """
    reg = reg or MetricsRegistry()
    parked_at: Dict[int, float] = {}
    admitted_at: Dict[int, float] = {}
    admitted_dev: Dict[int, int] = {}
    evicted_at: Dict[int, float] = {}
    evicted_dev: Dict[int, int] = {}
    for e in events:
        reg.counter(f"events.{e.kind}").inc()
        if e.kind in (ev.PARK, ev.REQUEUE):
            parked_at.setdefault(e.uid, e.t)
        elif e.kind in (ev.ADMIT, ev.GROW):
            t_park = parked_at.pop(e.uid, None)
            if t_park is not None:
                reg.hist("queueing_delay_s").record(e.t - t_park)
            t_evict = evicted_at.pop(e.uid, None)
            if t_evict is not None:
                reg.hist("requeue_to_resume_s").record(e.t - t_evict)
                if evicted_dev.pop(e.uid, e.device) != e.device:
                    reg.counter("migrations").inc()
            admitted_at[e.uid] = e.t
            admitted_dev[e.uid] = e.device
        elif e.kind == ev.EVICT:
            t_adm = admitted_at.pop(e.uid, None)
            if t_adm is not None:
                reg.hist("eviction_cost_s").record(e.t - t_adm)
            evicted_at[e.uid] = e.t
            evicted_dev[e.uid] = admitted_dev.pop(e.uid, e.device)
    steals = reg.counter("events.steal").snapshot()
    admits = reg.counter("events.admit").snapshot()
    if admits:
        reg.gauge("steal_rate").set(steals / admits)
    return reg
