"""Quickstart: the paper's full pipeline on a toy pair of jobs.

    1. write two independent "applications" as PyTorch computations with
       lazy buffers (device-independent, like the paper's lazy runtime);
    2. build GPU tasks (Alg. 1 merges kernels sharing buffers);
    3. probe each task's resource vector by tracing it on ``TensorSpec``s;
    4. let the MGB scheduler place them on a 2-device system (both virtual
       devices map onto the one card, or the CPU);
    5. execute for real — twice: once through the one-shot ``Executor.run``
       shim (closed batch), once through the streaming ``Cluster.submit``
       path (open arrival, the serving front door).

Port of ``examples/quickstart.py``. The probe counts what the port's trace
sees (``core/probe.py``): ``FlopCounterMode`` counts the matrix product but
no elementwise op, so probe B, ``tanh`` and a sum, has 0 flops where XLA
counts 2.62e5; on a card each vector also carries ``CUDA_UNSEEN_BYTES``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lazy
from repro_torch.core.cluster import Cluster, JobStatus
from repro_torch.core.executor import ExecJob, Executor
from repro_torch.core.probe import TensorSpec, probe_fn
from repro_torch.core.scheduler import MGBAlg3Scheduler
from repro_torch.core.task import Job, Task, UnitTask
from repro_torch.core.taskgraph import build_gpu_tasks
from repro_torch.examples import cli

N = 512


def kernel_a(x, w):
    return torch.relu(x @ w)


def kernel_b(y):
    return torch.tanh(y).sum()


def main(argv=None) -> dict:
    """Returns the probes (``probe_a``, ``probe_b``), the merged ``tasks``,
    the executor's ``stats`` and ``placements``, the streaming run's
    ``app4_records``, and ``results`` (app -> the float each computed)."""
    _, device = cli(argv)
    # --- an "application": y = relu(x @ w) summed, then a second kernel that
    # reuses y (so Alg. 1 must merge them into one GPU task) ---------------
    # lazy buffers record alloc/h2d; nothing touches a device yet
    rng = np.random.default_rng(0)
    bufs = {
        "x": lazy.LazyBuffer("x").h2d(rng.standard_normal((N, N),
                                                          dtype=np.float32)),
        "w": lazy.LazyBuffer("w").h2d(rng.standard_normal((N, N),
                                                          dtype=np.float32)),
    }

    # probes: resource vectors traced on specs (nothing allocated)
    spec = TensorSpec((N, N), torch.float32, device)
    vec_a = probe_fn(kernel_a, spec, spec)
    vec_b = probe_fn(kernel_b, spec)
    print(f"probe A: {vec_a.hbm_bytes / 1e6:.1f} MB, "
          f"{vec_a.flops:.2e} flops, demand {vec_a.demand:.2f}")
    print(f"probe B: {vec_b.hbm_bytes / 1e6:.1f} MB, "
          f"{vec_b.flops:.2e} flops, demand {vec_b.demand:.2f}")

    # Alg. 1: kernel_a writes y, kernel_b reads y -> one merged task
    units = [
        UnitTask(fn=kernel_a, memobjs=frozenset({"x", "w", "y"}),
                 resources=vec_a, name="matmul-relu"),
        UnitTask(fn=kernel_b, memobjs=frozenset({"y"}),
                 resources=vec_b, name="tanh-sum"),
    ]
    tasks = build_gpu_tasks(units)
    print(f"Alg.1 merged {len(units)} kernels into {len(tasks)} GPU task(s): "
          f"{tasks[0]}")

    # two identical applications race for 2 devices under MGB Alg. 3
    sched = MGBAlg3Scheduler(num_devices=2)
    results = {}

    def make_app(app_id):
        mybufs = {k: lazy.LazyBuffer(f"{app_id}/{k}").h2d(b.ops[-1].payload)
                  for k, b in bufs.items()}

        def runner(dev):
            arrs = lazy.kernel_launch_prepare(mybufs, dev)
            y = kernel_a(arrs["x"], arrs["w"])
            results[app_id] = float(kernel_b(y))

        unit = UnitTask(fn=None, memobjs=frozenset(mybufs), resources=vec_a,
                        name=f"{app_id}-task")
        job = Job(tasks=[Task(units=[unit], name=f"{app_id}-task")],
                  name=app_id)
        return ExecJob(job=job, runners=[runner], buffers=mybufs)

    # one-shot compatibility shim: declare the whole batch, run, report
    ex = Executor(sched, workers=2, devices=[device])
    stats = ex.run([make_app("app1"), make_app("app2")])
    print(f"executor: {stats['completed']} jobs done, "
          f"{stats['crashed']} crashed, makespan {stats['makespan_s']:.3f}s")
    print("placements (task uid -> device):", sched.placements)
    print("results:", {k: round(v, 3) for k, v in results.items()})
    assert stats["completed"] == 2 and stats["crashed"] == 0

    # streaming path: the same apps arrive one by one at a live Cluster —
    # submit returns a JobHandle immediately, work may already be in flight,
    # and priority/deadline stamps rank the admission queue
    with Cluster(MGBAlg3Scheduler(num_devices=2), workers=2,
                 devices=[device]) as cluster:
        h1 = cluster.submit(make_app("app3"), priority=1)
        h2 = cluster.submit(make_app("app4"), deadline_s=5.0)  # EDF hint
        app4 = [r.task for r in h2.result(timeout=30)]
        print(f"streaming: submitted while h1 is {h1.status.value}; "
              f"app4 records: {app4}")
        cluster.drain()
        assert h1.status is JobStatus.DONE and h2.status is JobStatus.DONE
    print("results:", {k: round(v, 3) for k, v in results.items()})
    print("quickstart OK")
    return {"probe_a": vec_a, "probe_b": vec_b, "tasks": tasks,
            "stats": stats, "placements": list(sched.placements),
            "app4_records": app4, "results": dict(results)}


if __name__ == "__main__":
    main()
