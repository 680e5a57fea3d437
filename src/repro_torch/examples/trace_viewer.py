"""Scenario: watch the scheduler think — record a small mixed trace and
write a Perfetto-loadable Chrome trace-event JSON.

A 2-device preemptive cluster on the virtual clock serves a burst of
mixed-priority jobs; mid-run one device dies (its resident is evicted,
requeued, and resumes on the survivor — a cross-device migration arc) and
later revives. The whole lifecycle lands in ``cluster.trace``:

  * per-device occupancy tracks (one slice per residency),
  * a waiter-queue-depth counter track,
  * instant markers for the death/revive,
  * a flow arrow stitching the evicted task's device-0 → device-1 arc.

The cluster runs CALIBRATED (``calibrate=True``), so the export also
carries the profiling counter tracks — per-device observed occupancy %
and the fleet prediction-error % — and the epilogue prints each job's
predicted-vs-observed attribution line (``handle.profile()``: runtime
error, parked/dispatch decomposition, memory reserved vs high-water)
alongside its decision verdicts (``handle.explain()``).

Port of ``examples/trace_viewer.py``. The run is on the virtual clock and
its output is the reference's, line for line; like every entry point of the
port it still asks for the card unless ``--device cpu``. ``--out`` names
the JSON (default ``trace_viewer.json``); open it in chrome://tracing or
https://ui.perfetto.dev.

    PYTHONPATH=src python -m repro_torch.examples.trace_viewer [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse

from repro_torch.core.cluster import Cluster
from repro_torch.core.scheduler import PreemptiveAlg3Scheduler
from repro_torch.core.task import Job, ResourceVector, Task, UnitTask
from repro_torch.examples import cli
from repro_torch.obs.explain import format_verdicts
from repro_torch.obs.export import trace_summary
from repro_torch.obs.metrics import metrics_from_events
from repro_torch.obs.profile import format_profile
from repro_torch.obs.replay import validate_lifecycles

GB = 1024**3
OUT = "trace_viewer.json"


def mk_job(name, mem_gb, est, chips=1):
    vec = ResourceVector(hbm_bytes=int(mem_gb * GB), flops=1e12,
                         bytes_accessed=1e9, est_seconds=est,
                         core_demand=0.5, bw_demand=0.5, chips=chips)
    task = Task(units=[UnitTask(fn=None, memobjs=frozenset({name}),
                                resources=vec, name=name)], name=name)
    return Job(tasks=[task], name=name)


def main(argv=None) -> dict:
    """Returns the trace's ``summary`` (``trace_summary``), the
    ``queueing_delay`` histogram, the ``migrations`` counter, and the
    printed ``profiles`` and ``verdicts`` lines."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT,
                    help=f"where to write the JSON (default {OUT})")
    args, _ = cli(argv, ap)
    out = args.out
    cluster = Cluster(PreemptiveAlg3Scheduler(2), workers=8, backend="sim",
                      trace=True, calibrate=True)
    handles = []
    # device 0 dies at t=0.5 (virtual): its resident is evicted, requeued,
    # and resumes on device 1 — the cross-device flow in the viewer
    cluster._sim._failure_pending = (0.5, 0)

    for i in range(4):
        handles.append(cluster.submit(mk_job(f"batch/{i}", mem_gb=12.0,
                                             est=1.0), priority=0))
    cluster.run_until(0.8)
    # urgent late arrivals overtake the parked backlog (EDF within class)
    handles.append(cluster.submit(mk_job("urgent/a", mem_gb=9.0, est=0.3),
                                  priority=5, deadline_s=1.0))
    handles.append(cluster.submit(mk_job("urgent/b", mem_gb=9.0, est=0.3),
                                  priority=5, deadline_s=2.0))
    # keep device 0 down long enough that the evicted resident resumes on
    # device 1 (the migration arc), then bring it back for the backlog
    cluster.run_until(3.0)
    cluster.sched.revive(0)
    cluster.drain()

    problems = validate_lifecycles(cluster.trace.events(),
                                   require_terminal=True)
    assert not problems, problems

    doc = cluster.export_trace(out)
    s = trace_summary(doc)
    print(f"wrote {out}: {s['slices']} slices on devices {s['devices']}, "
          f"{s['flows']} flow(s) ({s['cross_device_flows']} cross-device), "
          f"{s['counter_samples']} counter samples (queue depth + "
          f"occupancy % + est error %)")

    reg = metrics_from_events(cluster.trace.events())
    snap = reg.snapshot()
    qd = snap["histograms"]["queueing_delay_s"]
    migrations = snap["counters"].get("migrations", 0)
    print(f"queueing delay: n={qd['n']} p50={qd['p50']:.3f}s "
          f"p99={qd['p99']:.3f}s; migrations={migrations}")

    # what each job actually did vs what its probe predicted — runtime
    # error, the parked/dispatch decomposition, reserved vs high-water
    print("\npredicted vs observed:")
    profiles = []
    for h in handles:
        for p in h.profile().values():
            profiles.append(format_profile(p))
            print(f"  {profiles[-1]}")

    # why did each job wait / move / land where it did — the verdict
    # window every decision site recorded alongside the event stream
    print("\ndecision verdicts:")
    verdicts = []
    for h in handles:
        for name, vs in h.explain().items():
            verdicts.append((name, format_verdicts(vs)))
            print(f"  {name}:")
            for line in verdicts[-1][1].splitlines():
                print(f"    {line}")
    print("open the JSON in chrome://tracing or https://ui.perfetto.dev")
    return {"summary": s, "queueing_delay": qd, "migrations": migrations,
            "profiles": profiles, "verdicts": verdicts}


if __name__ == "__main__":
    main()
