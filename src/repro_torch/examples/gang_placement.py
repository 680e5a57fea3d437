"""Gang placement walkthrough: multi-chip tasks on a topology-aware cluster.

    1. build an 8-chip (1 pod, 2x4) topology and a GangScheduler over it;
    2. submit a mixed open-arrival stream — single-chip decode-style jobs
       plus chips=4 sharded-train gangs — through the same Cluster front
       door, on the virtual-clock backend;
    3. watch a gang get a CONTIGUOUS 4-chip group atomically (never 4
       independent single-chip placements) and its collectives charged on
       the group's links;
    4. re-run the same trace on the LIVE executor: the gang's unit group is
       dispatched as one bound device set (the runner receives the ordered
       list of its 4 ``torch.device``s; all 8 scheduler devices map onto
       the one card, or the CPU);
    5. deadline shedding: with shed_late=True a request that is still parked
       when its deadline passes is SHED at the next drain, not served late.

Port of ``examples/gang_placement.py``; the sim sections are the
reference's to the digit.

    PYTHONPATH=src python -m repro_torch.examples.gang_placement [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.cluster import Cluster, JobStatus
from repro_torch.core.scheduler import GangScheduler
from repro_torch.core.workloads import gang_mix, make_gang_job
from repro_torch.examples import cli


def main(argv=None) -> dict:
    """Returns the sim run's virtual ``t`` and its ``placements`` (name,
    gang chips, lead device, queueing seconds), the live gang's ``bound``
    device list, and the shedding run's ``shed_status`` and
    ``shed_stats``."""
    _, device = cli(argv)
    # --- sim backend: placement study on the virtual clock -----------------
    jobs = gang_mix(seed=0, n_singles=4, n_gangs=3, chip_choices=(2, 4),
                    probe_singles=False)
    sched = GangScheduler(pods=1, rows=2, cols=4)   # 8 chips
    with Cluster(sched, workers=16, backend="sim") as cluster:
        handles = [cluster.submit(j) for j in jobs]
        cluster.drain()
    assert all(h.status is JobStatus.DONE for h in handles)
    print("sim backend: all", len(handles), "jobs done at virtual t="
          f"{cluster.now:.1f}s")
    placements = []
    for h in handles:
        rec = h.records[-1]
        tag = (f"{rec.gang_chips}-chip group @dev{rec.device}"
               if rec.gang_chips > 1 else f"dev{rec.device}")
        print(f"  {h.job.name:>12s}: {tag}  "
              f"queue={rec.t_start - rec.t_queue:5.1f}s")
        placements.append((h.job.name, rec.gang_chips, rec.device,
                           rec.t_start - rec.t_queue))
    sim_t = cluster.now

    # --- live backend: the gang's unit group is ONE bound dispatch ---------
    bound_groups = []

    def gang_runner(devices):
        # a chips>1 task receives the ORDERED device list of its reservation
        bound_groups.append(devices if isinstance(devices, list)
                            else [devices])
        time.sleep(0.002)

    rng = np.random.default_rng(1)
    live_sched = GangScheduler(pods=1, rows=2, cols=4)
    with Cluster(live_sched, workers=8, devices=[device]) as cluster:
        gang = make_gang_job(rng, chips=4, name="train-x4")
        h = cluster.submit(gang, runners=[gang_runner])
        h.result(timeout=30)
    assert h.status is JobStatus.DONE and len(bound_groups[0]) == 4
    assert all(isinstance(d, torch.device) for d in bound_groups[0])
    print(f"\nlive backend: gang {h.job.name!r} ran as one bound group of "
          f"{len(bound_groups[0])} devices "
          f"(gang_chips={h.records[0].gang_chips})")

    # --- deadline shedding --------------------------------------------------
    shed_sched = GangScheduler(pods=1, rows=1, cols=1)
    with Cluster(shed_sched, workers=4, backend="sim",
                 shed_late=True) as cluster:
        rng = np.random.default_rng(2)
        hog = cluster.submit(make_gang_job(rng, chips=1, name="hog",
                                           per_chip_gb=(10, 12),
                                           seconds=(30, 30)))
        late = cluster.submit(make_gang_job(rng, chips=1, name="late",
                                            per_chip_gb=(10, 12)),
                              deadline_s=5.0)   # parked behind hog
        cluster.drain()
    assert hog.status is JobStatus.DONE
    assert late.status is JobStatus.SHED
    shed_stats = {k: v for k, v in cluster.stats().items()
                  if k in ('completed', 'shed')}
    print(f"\nshedding: {late.job.name!r} parked past its 5s deadline -> "
          f"{late.status.value} (never admitted late); stats: "
          f"{shed_stats}")
    print("\ngang_placement OK")
    return {"t": sim_t, "placements": placements,
            "bound": list(bound_groups[0]),
            "gang_chips": h.records[0].gang_chips,
            "shed_status": late.status.value, "shed_stats": shed_stats}


if __name__ == "__main__":
    main()
