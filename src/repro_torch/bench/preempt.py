"""Preemption benchmark: preemptive EDF vs shedding vs waiting, on an
overloaded open-arrival trace (``core.workloads.overload_mix``), on the
virtual clock.

Copy of ``benchmarks/bench_preempt.py`` (``run_trace``, ``compare``, the
report) with its imports rewritten to ``repro_torch``; keep the two in step.
The reference asserts its acceptance claims; this copy prints each as a
``PASS``/``MISS`` band line, as the port's other paper scripts do, and
returns the rows. Its live/sim parity smoke is
``tests/test_torch_preempt.py::test_live_and_sim_replay_identical_eviction_order``.

The scenario memory-binds by construction: long ~10 GB x ~20 s background
jobs saturate every 16 GB device while short ~9 GB x ~1 s urgent jobs (each
with a deadline a couple of seconds past its length) keep arriving. An
urgent arrival cannot co-reside with a background resident, so it can only
wait with no ordering (**fifo**), jump the queue and wait (**edf**), give
up once its deadline passes while parked (**edf+shed**), or evict the
min-cost background resident (**edf+preempt**: checkpoint-based, the victim
resumes at its remaining work plus a restore penalty, possibly on another
device). All four replay the same seeded trace. Reported per system:
urgent deadline-met rate, urgent turnaround p50/p99, preemptions and
migrations, background mean turnaround, and the mean kernel slowdown of
jobs never preempted (the paper's <=2.5% co-residency envelope).

    PYTHONPATH=src python -m repro_torch.bench.preempt            # full
    PYTHONPATH=src python -m repro_torch.bench.preempt --smoke    # small
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.bench import common as C
from repro_torch.core.cluster import Cluster, JobStatus
from repro_torch.core.preemption import PreemptionPolicy
from repro_torch.core.scheduler import MGBAlg3Scheduler, PreemptiveAlg3Scheduler
from repro_torch.core.workloads import overload_mix

DEVICES = 4
SIM_WORKERS = 256   # never the bottleneck — admission is the story
# eviction budget sized to the full trace: 24 urgents over 8 backgrounds
# needs ~3 evictions/job; 6 leaves headroom so immunity is a guardrail, not
# the common case
POLICY = PreemptionPolicy(min_runtime_s=0.25, budget=6, aging_step=1,
                          checkpoint_penalty_s=0.5)


def _pct(vals: List[float], q: float) -> float:
    """Nearest-rank percentile, well-defined when failed requests are
    counted as +inf."""
    if not vals:
        return float("inf")
    s = sorted(vals)
    return float(s[max(min(int(np.ceil(q / 100 * len(s))) - 1,
                           len(s) - 1), 0)])


def run_trace(rows: List[Dict], sched, *, ranked: bool = True,
              shed: bool = False, preempt: Optional[bool] = None,
              n_devices: int = DEVICES) -> Dict[str, float]:
    """Replay one submission trace on the sim backend. ``ranked=False`` is
    the FIFO baseline: priority/deadline stamps are withheld from admission
    (deadlines are still measured against)."""
    c = Cluster(sched, workers=SIM_WORKERS, backend="sim",
                shed_late=shed, preempt=preempt)
    entries = []
    for row in rows:
        c.run_until(row["t"])
        h = c.submit(row["job"],
                     priority=row["priority"] if ranked else 0,
                     deadline_s=row["deadline_s"] if ranked else None)
        entries.append((row, h))
    c.drain()   # raises on a truncated (time-limited) drain
    res = c._sim.result()

    urgent = [(r, h) for r, h in entries if r["kind"] == "urgent"]
    met = [h for r, h in urgent
           if h.status is JobStatus.DONE
           and h.job.finish_t <= r["t"] + r["deadline_s"]]
    # a shed urgent never completes: its turnaround counts as inf, so
    # shedding cannot look fast by failing the slow ones
    u_turn = [h.job.finish_t - h.job.arrival_t
              if h.status is JobStatus.DONE else float("inf")
              for _, h in urgent]
    bg_turn = [h.job.finish_t - h.job.arrival_t for r, h in entries
               if r["kind"] == "background" and h.status is JobStatus.DONE]
    untouched = {r["job"].tasks[0].name for r, _ in entries
                 if r["job"].tasks[0].preempt_count == 0}
    slows = [s for name, s in res.slowdowns.items() if name in untouched]
    return {
        "sched": sched.name + ("+shed" if shed else "")
                 + ("" if ranked else " (fifo)"),
        "n_devices": n_devices,
        "makespan_s": res.makespan,
        "completed": res.completed, "crashed": res.crashed,
        "shed": res.shed,
        "urgent_met": len(met), "urgent_total": len(urgent),
        "deadline_met_rate": len(met) / max(len(urgent), 1),
        "urgent_turn_p50_s": _pct(u_turn, 50),
        "urgent_turn_p99_s": _pct(u_turn, 99),
        "bg_mean_turnaround_s": float(np.mean(bg_turn)) if bg_turn else 0.0,
        "preemptions": getattr(sched, "preemptions", 0),
        "migrations": getattr(sched, "migrations", 0),
        "nonpreempted_slowdown_pct":
            100.0 * (float(np.mean(slows)) - 1.0) if slows else 0.0,
    }


def compare(seed: int = 0, *, n_devices: int = DEVICES,
            n_background: int = 8, n_bystander: int = 4,
            n_urgent: int = 24) -> List[Dict[str, float]]:
    """The four systems, each on a fresh materialisation of the seeded
    trace (job objects carry runtime state)."""
    def fresh() -> List[Dict]:
        return overload_mix(seed, n_background=n_background,
                            n_bystander=n_bystander, n_urgent=n_urgent)

    return [
        run_trace(fresh(), MGBAlg3Scheduler(n_devices), ranked=False,
                  n_devices=n_devices),
        run_trace(fresh(), MGBAlg3Scheduler(n_devices),
                  n_devices=n_devices),
        run_trace(fresh(), MGBAlg3Scheduler(n_devices), shed=True,
                  n_devices=n_devices),
        run_trace(fresh(),
                  PreemptiveAlg3Scheduler(n_devices, preempt_policy=POLICY),
                  preempt=True, n_devices=n_devices),
    ]


def _print_rows(rows: List[Dict[str, float]]) -> None:
    for r in rows:
        print(f"{r['sched']:>22}: met={r['urgent_met']:>2}/"
              f"{r['urgent_total']} ({100 * r['deadline_met_rate']:5.1f}%) "
              f"urgent-turn p50={r['urgent_turn_p50_s']:6.2f}s "
              f"p99={r['urgent_turn_p99_s']:6.2f}s "
              f"bg-turn={r['bg_mean_turnaround_s']:6.2f}s "
              f"shed={r['shed']:>2} preempt={r['preemptions']:>2} "
              f"migr={r['migrations']:>2} "
              f"slowdown={r['nonpreempted_slowdown_pct']:.2f}%")


def run(seed: int = 0, smoke: bool = False) -> dict:
    """The comparison with the reference's acceptance claims as band lines:
    preemptive EDF meets more deadlines than each other system (ties
    allowed on the small trace, where both ends may saturate) and no worse
    an urgent p99, evicts at least once, and keeps the untouched jobs'
    slowdown within the paper's 2.5%."""
    t0 = time.time()
    if smoke:
        rows = compare(seed, n_devices=2, n_background=3, n_bystander=2,
                       n_urgent=5)
    else:
        rows = compare(seed)
    _print_rows(rows)
    fifo, edf, shed, pre = rows
    best = max(r["deadline_met_rate"] for r in (fifo, edf, shed))
    p99 = min(r["urgent_turn_p99_s"] for r in (fifo, edf, shed))
    margin = 0.0 if smoke else 1e-9
    print(f"Preemption ({'small' if smoke else 'full'} overload trace, seed "
          f"{seed}, {rows[0]['n_devices']} devices):")
    print(C.check("deadline-met rate, preemptive EDF less the best other",
                  pre["deadline_met_rate"] - best, margin, 1.0))
    print(C.check("urgent p99 turnaround, preemptive EDF over the best "
                  "other", pre["urgent_turn_p99_s"] / p99, 0.0, 1.0))
    print(C.check("preemptions", pre["preemptions"], 1, float("inf")))
    print(C.check("non-preempted slowdown %",
                  pre["nonpreempted_slowdown_pct"], 0.0, 2.5))
    print(C.check("crashed, all systems",
                  sum(r["crashed"] for r in rows), 0, 0))
    print(f"preemptive EDF: {100 * pre['deadline_met_rate']:.0f}% deadlines "
          f"met vs {100 * edf['deadline_met_rate']:.0f}% (EDF) / "
          f"{100 * shed['deadline_met_rate']:.0f}% (shed) / "
          f"{100 * fifo['deadline_met_rate']:.0f}% (FIFO) "
          f"({time.time() - t0:.1f}s)")
    out = {"rows": rows}
    if not smoke:
        C.save_json("preempt.json", out)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the small trace on 2 devices; writes no results")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    run(args.seed, smoke=args.smoke)


if __name__ == "__main__":
    main()
