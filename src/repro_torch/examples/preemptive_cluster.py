"""Scenario: deadline enforcement by EVICTION on a shared cluster.

A background training fleet saturates the device memory of a 4-chip node
while urgent inference requests with tight deadlines keep arriving. The
same open-arrival trace is replayed twice on the virtual clock:

  * **admission-only** (the paper's scheduler): an urgent request parks
    behind a ~20-second training job and blows its deadline;
  * **preemptive** (`PreemptiveAlg3Scheduler` + ``Cluster(preempt=True)``):
    the request evicts the min-cost background resident — the victim's
    remaining work is banked, it re-enters the queue at the front of its
    class, and it resumes (on whatever device frees first — migration is
    just requeue + placement) for remaining + checkpoint penalty.

Then a short LIVE demonstration runs the cooperative-checkpoint path: a
real executor (on the card, or the CPU) preempts a running job mid-flight,
its ``on_preempt`` hook fires (where a training task would checkpoint:
``launch.train`` saves when its runner sees ``preempted``), and the
resumed dispatch completes the job.

Port of ``examples/preemptive_cluster.py``; the sim comparison is the
reference's to the digit.

    PYTHONPATH=src python -m repro_torch.examples.preemptive_cluster [--device cpu]
"""
from __future__ import annotations

import time

from repro_torch.core.cluster import Cluster, JobStatus
from repro_torch.core.executor import ExecJob
from repro_torch.core.preemption import PreemptionPolicy
from repro_torch.core.scheduler import MGBAlg3Scheduler, PreemptiveAlg3Scheduler
from repro_torch.core.task import Job, ResourceVector, Task, UnitTask
from repro_torch.core.workloads import overload_mix
from repro_torch.examples import cli

DEVICES = 4
GB = 1024**3


def replay(sched, rows, preempt=None):
    """Replay ``overload_mix`` rows on the sim backend: (urgent deadlines
    met, urgent total, the cluster's stats)."""
    c = Cluster(sched, workers=64, backend="sim", preempt=preempt)
    entries = []
    for row in rows:
        c.run_until(row["t"])
        entries.append((row, c.submit(row["job"], priority=row["priority"],
                                      deadline_s=row["deadline_s"])))
    c.drain()
    urgent = [(r, h) for r, h in entries if r["kind"] == "urgent"]
    met = sum(1 for r, h in urgent if h.status is JobStatus.DONE
              and h.job.finish_t <= r["t"] + r["deadline_s"])
    return met, len(urgent), c.stats()


def sim_comparison() -> dict:
    """Admission-only against preemptive EDF on one seeded trace."""
    rows1 = overload_mix(0, n_background=6, n_bystander=2, n_urgent=10)
    met, total, _ = replay(MGBAlg3Scheduler(DEVICES), rows1)
    rows2 = overload_mix(0, n_background=6, n_bystander=2, n_urgent=10)
    sched = PreemptiveAlg3Scheduler(
        DEVICES, preempt_policy=PreemptionPolicy(budget=6))
    met_p, total_p, stats = replay(sched, rows2, preempt=True)
    print(f"[sim] admission-only : {met}/{total} urgent deadlines met")
    print(f"[sim] preemptive EDF : {met_p}/{total_p} urgent deadlines met "
          f"({stats['preemptions']} preemption(s), "
          f"{stats['migrations']} migration(s))")
    assert met_p > met
    return {"met": met, "total": total, "met_preemptive": met_p,
            "total_preemptive": total_p,
            "preemptions": stats["preemptions"],
            "migrations": stats["migrations"]}


def live_cooperative_checkpoint(device) -> dict:
    """One resident evicted mid-run by an urgent job on ``device``: the
    hook's and the runner's ``events``, the jobs' ``statuses`` and the
    scheduler's ``preemptions``."""
    def mk_job(name, gb, est, prio=0):
        vec = ResourceVector(hbm_bytes=int(gb * GB), flops=1e9,
                             bytes_accessed=1e9, est_seconds=est,
                             core_demand=0.4, bw_demand=0.3)
        unit = UnitTask(fn=None, memobjs=frozenset({name}), resources=vec,
                        name=name)
        return Job(tasks=[Task(units=[unit], name=name)], name=name,
                   priority=prio)

    sched = PreemptiveAlg3Scheduler(
        1, preempt_policy=PreemptionPolicy(min_runtime_s=0.0))
    c = Cluster(sched, workers=4, devices=[device])
    events = []

    bg = ExecJob(job=mk_job("train-bg", 10, 5.0), runners=[None],
                 on_preempt=lambda t: events.append(f"checkpoint({t.name})"))

    attempts = []

    def cooperative_runner(dev):
        # a cooperative task polls its job's `preempted` event between steps
        # and returns early once evicted; the resumed dispatch (attempt 2)
        # has only the checkpointed remainder left and finishes at once
        attempts.append(dev)
        if len(attempts) == 1 and bg.preempted.wait(5.0):
            events.append("stopped-early")
        else:
            events.append("finished")
    bg.runners[0] = cooperative_runner

    h_bg = c.submit(bg)
    time.sleep(0.2)
    h_urgent = c.submit(mk_job("urgent", 10, 0.05, prio=5),
                        runners=[lambda d: time.sleep(0.02)])
    h_urgent.result(timeout=30)
    c.drain()
    c.shutdown()
    statuses = [(h.job.name, h.status.value) for h in c.handles]
    print(f"[live] events: {events}; statuses: {statuses}; "
          f"{sched.preemptions} preemption(s)")
    assert h_bg.status is JobStatus.DONE
    assert any(e.startswith("checkpoint") for e in events)
    return {"events": events, "statuses": statuses,
            "preemptions": sched.preemptions}


def main(argv=None) -> dict:
    """Both sections: ``sim`` (``sim_comparison``) and ``live``
    (``live_cooperative_checkpoint``)."""
    _, device = cli(argv)
    out = {"sim": sim_comparison(),
           "live": live_cooperative_checkpoint(device)}
    print("preemptive cluster demo OK")
    return out


if __name__ == "__main__":
    main()
