"""``repro-top``: an ASCII fleet dashboard over the scheduler surface.

Renders, from O(1)/O(devices) reads only (``queue_stats()``, the device
table, an ``SLOMonitor.status()``), the view an operator keeps open
while a fleet runs:

  * the admission queue — depth, class count, per-class depths, hint
    skips, the gang at the queue front, per-shard balance and steal
    count on a sharded control plane;
  * one row per device — ``pod{p}/dev{d}`` label on sharded/multi-pod
    fleets, an occupancy bar (OBSERVED occupancy % from the profiler's
    residency timeline on traced fleets, HBM fraction otherwise),
    used/total GB, compute slots, resident count, DEAD marker;
  * per-class prediction-accuracy rows when a calibration store is
    attached — raw vs corrected runtime error, learned EWMA ratio,
    observed memory high-water;
  * the SLO strip — per-stream burn rates (incl. the probe-drift
    stream) with a healthy/VIOLATING flag and the worst
    observed-vs-roofline slowdown against the paper's 2.5% envelope.

``Top`` wraps the renderer in a refresh loop for a live terminal;
``python -m repro_torch.launch.top --demo`` drives a small simulated workload
through it and prints the final frame (CI-safe: no TTY tricks, no
timing dependence).

Copy of ``src/repro/launch/top.py`` with its imports rewritten
to ``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional

from repro_torch.core.scheduler.base import SLOTS

_GB = 1e9


def _bar(frac: float, width: int = 20) -> str:
    frac = min(max(frac, 0.0), 1.0)
    n = int(round(frac * width))
    return "[" + "#" * n + "." * (width - n) + "]"


def _devices_per_pod(sched: Any) -> Optional[int]:
    """Pod factoring for device labels: a sharded wrapper's uniform
    shard width, or a multi-pod gang topology's pod size."""
    dpp = getattr(sched, "_shard_devs", None)
    if dpp and len(getattr(sched, "shards", ())) > 1:
        return dpp
    topo = getattr(sched, "topo", None)
    if topo is not None and getattr(topo, "pods", 1) > 1:
        return topo.rows * topo.cols
    return None


def _queue_lines(stats: Dict[str, Any]) -> List[str]:
    per_class = stats.get("per_class") or {}
    classes = ", ".join(f"p{k}:{v}" for k, v in
                        sorted(per_class.items(), reverse=True)) or "-"
    lines = [f"queue   depth={stats.get('depth', 0)} "
             f"classes={stats.get('classes', 0)} [{classes}] "
             f"hint_skips={stats.get('hint_skips', 0)}"]
    gf = stats.get("gang_front")
    if gf:
        lines.append(f"        gang_front={gf}")
    if "per_shard" in stats:
        shard = " ".join(f"s{i}:{d}" for i, d in
                         enumerate(stats["per_shard"]))
        lines.append(f"shards  {shard}  steals={stats.get('steals', 0)}")
    return lines


def _device_lines(sched: Any, width: int = 20,
                  occupancy: Optional[Dict[int, Dict[str, Any]]] = None
                  ) -> List[str]:
    """One row per device. The bar shows OBSERVED occupancy % (the
    profiler's demand-weighted residency timeline) when a traced window
    supplies one — what the chip is doing, not just what admission
    reserved; HBM stays the numeric used/total readout. Untraced fleets
    keep the historical HBM-fraction bar."""
    dpp = _devices_per_pod(sched)
    lines = []
    for i, d in enumerate(sched.devices):
        label = f"pod{i // dpp}/dev{i % dpp}" if dpp else f"dev {i}"
        used = d.used_hbm / _GB
        total = d.total_hbm / _GB
        occ = occupancy.get(i) if occupancy else None
        if occ is not None:
            frac = occ["last"]
            pct = f" occ {frac * 100:3.0f}%"
        else:
            frac = d.used_hbm / d.total_hbm if d.total_hbm else 0.0
            pct = ""
        dead = "  DEAD" if not d.alive else ""
        lines.append(
            f"{label:<12}{_bar(frac, width)}{pct} {used:5.1f}/{total:4.1f}GB "
            f"slots {d.used_slots:2d}/{SLOTS} residents "
            f"{len(d.residents)}{dead}")
    return lines


def _calib_lines(store: Any, limit: int = 4) -> List[str]:
    """Per-class prediction-accuracy rows from an attached
    ``CalibrationStore``: raw vs corrected mean absolute runtime error,
    the learned EWMA ratio, observed memory high-water."""
    rows = store.rows(limit=limit)
    if not rows:
        return []
    lines = [f"calib   classes={len(rows)} shown, "
             f"corrections={store.corrections} "
             f"violations={store.violations}"]
    for r in rows:
        ratio = f"{r['ratio']:.2f}" if r["n"] else "  - "
        lines.append(
            f"        est {r['est_s']:6.3f}s x{ratio} n={r['n']:<4d} "
            f"mae raw {r['mae_raw_s']:.3f}s -> used {r['mae_used_s']:.3f}s "
            f"hw {r['hw_gb']:.1f}/{r['hbm_gb']:.1f}GB")
    return lines


def _slo_lines(status: Dict[str, Any]) -> List[str]:
    parts = []
    for stream in ("deadline", "ttft", "tpot", "slowdown", "drift"):
        s = status.get(stream)
        if not s or not s["n"]:
            continue
        flag = "ok" if s["healthy"] else "VIOLATING"
        parts.append(f"{stream} burn={s['burn']:.2f} {flag}")
    lines = [f"slo     {'  '.join(parts) or '(no samples)'}"]
    worst = status.get("worst_slowdown")
    if worst:
        lines.append(f"        worst_slowdown {worst['name']} "
                     f"x{worst['factor']:.3f}")
    return lines


def render(sched: Any, *, slo: Optional[Any] = None,
           stats: Optional[Dict[str, Any]] = None,
           title: str = "repro-top", bar_width: int = 20) -> str:
    """One dashboard frame as a string. ``stats`` lets a caller pass
    ``Cluster.stats()`` for the footer; ``slo`` is an ``SLOMonitor``.
    On a traced scheduler the device bars switch to observed occupancy %
    (profiler residency timeline); an attached calibration store adds
    per-class prediction-accuracy rows."""
    occupancy = None
    tracer = getattr(sched, "_trace", None)
    if tracer is not None:
        from repro_torch.obs.profile import device_occupancy
        occupancy = device_occupancy(tracer.events())
    lines = [title, "=" * max(len(title), 8)]
    lines += _queue_lines(sched.queue_stats())
    lines += _device_lines(sched, bar_width, occupancy)
    store = getattr(sched, "_calib", None)
    if store is not None:
        lines += _calib_lines(store)
    if slo is not None:
        lines += _slo_lines(slo.status())
    if stats:
        lines.append(
            f"jobs    done={stats.get('completed', 0)} "
            f"crashed={stats.get('crashed', 0)} "
            f"shed={stats.get('shed', 0)} "
            f"preempted={stats.get('preemptions', 0)} "
            f"makespan={stats.get('makespan_s', 0.0):.2f}s")
    return "\n".join(lines)


class Top:
    """Minimal live loop: clear screen, render, sleep, repeat."""

    def __init__(self, sched: Any, *, slo: Optional[Any] = None,
                 stats_fn: Optional[Any] = None,
                 interval_s: float = 1.0, out=sys.stdout):
        self.sched = sched
        self.slo = slo
        self.stats_fn = stats_fn
        self.interval_s = interval_s
        self.out = out

    def frame(self) -> str:
        stats = self.stats_fn() if self.stats_fn is not None else None
        return render(self.sched, slo=self.slo, stats=stats)

    def run(self, frames: Optional[int] = None) -> None:
        n = 0
        try:
            while frames is None or n < frames:
                self.out.write("\x1b[2J\x1b[H" + self.frame() + "\n")
                self.out.flush()
                n += 1
                if frames is None or n < frames:
                    time.sleep(self.interval_s)
        except KeyboardInterrupt:
            pass


def _demo() -> str:
    """Drive a small simulated overload through the dashboard (CI-safe:
    single final frame, no sleeps, deterministic)."""
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.scheduler.preempt import PreemptiveAlg3Scheduler
    from repro_torch.core.workloads import overload_mix
    from repro_torch.obs.slo import SLOMonitor

    c = Cluster(PreemptiveAlg3Scheduler(4), workers=8, backend="sim",
                shed_late=True, trace=True, calibrate=True)
    # drift stream fed straight from the calibration store's observations
    slo = SLOMonitor.for_calibration(c.calibration, window=32)
    rows = overload_mix(11, n_urgent=8)
    for row in rows:
        c.run_until(row["t"])
        c.submit(row["job"], priority=row["priority"],
                 deadline_s=row["deadline_s"])
    c.run_until(rows[-1]["t"] + 1.0)   # mid-flight frame: queues populated
    mid = render(c.sched, slo=slo, stats=c.stats())
    c._sim.drain(1e7)
    for h in c.handles:
        if h.job.deadline_t is not None:
            slo.note_deadline(h.status.name == "DONE"
                              and h.job.finish_t <= h.job.deadline_t)
    for name, factor in c._sim.result().slowdowns.items():
        slo.note_slowdown_factor(name, factor)
    final = render(c.sched, slo=slo, stats=c.stats())
    return mid + "\n\n--- after drain ---\n\n" + final


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="ASCII scheduler dashboard")
    p.add_argument("--demo", action="store_true",
                   help="render a simulated workload and exit (CI-safe)")
    args = p.parse_args(argv)
    if args.demo:
        print(_demo())
        return 0
    p.error("repro-top needs --demo (live attach requires an embedding "
            "process: build a Top(sched, ...) around your cluster)")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
