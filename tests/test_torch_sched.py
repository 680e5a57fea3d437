"""The port's scheduler copies and live loop against the JAX package.

The schedulers are copies of ``src/repro/core/scheduler/``: one seeded mixed
trace of arrivals and completions must give the same placement sequence in
both. The port's executor and ``Cluster`` run real jobs on the CPU device.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

from repro.core import scheduler as JSCH  # noqa: E402
from repro.core import task as JT  # noqa: E402
from repro_torch.core import lazy  # noqa: E402
from repro_torch.core import scheduler as TSCH  # noqa: E402
from repro_torch.core import task as TT  # noqa: E402
from repro_torch.core.cluster import Cluster, JobStatus  # noqa: E402
from repro_torch.core.executor import ExecJob, Executor  # noqa: E402

GB = 1024 ** 3
CPU = torch.device("cpu")


def _trace(seed: int, n: int = 200):
    """Seeded arrivals (memory, demand, priority, deadline) interleaved with
    completions of random residents."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        ops.append(("arrive", i, float(rng.uniform(0.5, 12.0)),
                    float(rng.uniform(0.05, 0.9)), int(rng.integers(0, 3)),
                    float(rng.uniform(1, 50)) if rng.random() < 0.5
                    else None))
        if rng.random() < 0.6:
            ops.append(("end", float(rng.random())))
    return ops


def _run(mod_sched, mod_task, cls_name: str, ops):
    sched = getattr(mod_sched, cls_name)(3)
    running = []            # admitted tasks in admission order
    index = {}              # task uid -> trace index
    seq = []

    def admit(task, placement, epoch):
        running.append(task)
        seq.append((index[task.uid], placement))

    for op in ops:
        if op[0] == "arrive":
            _, i, mem, demand, prio, deadline = op
            vec = mod_task.ResourceVector(
                hbm_bytes=int(mem * GB), flops=1e12, bytes_accessed=1e9,
                est_seconds=10.0, core_demand=demand, bw_demand=demand)
            t = mod_task.Task(units=[mod_task.UnitTask(
                fn=None, memobjs=frozenset({f"t{i}"}), resources=vec,
                name=f"t{i}")], name=f"t{i}")
            t.priority = prio
            t.deadline_t = deadline
            index[t.uid] = i
            sched.admit_or_enqueue(t, admit)
        elif running:
            victim = running.pop(int(op[1] * len(running)))
            sched.task_end(victim)
    while running:
        sched.task_end(running.pop(0))
    return seq, [(index.get(u, u), d) for u, d in sched.placements]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cls_name", ["MGBAlg3Scheduler", "MGBAlg2Scheduler"])
def test_placement_sequence_matches_jax(cls_name, seed):
    ops = _trace(seed)
    jax_seq, jax_log = _run(JSCH, JT, cls_name, ops)
    port_seq, port_log = _run(TSCH, TT, cls_name, ops)
    assert len(jax_seq) == 200
    assert port_seq == jax_seq
    assert port_log == jax_log


def _job(name, mem_gb=1.0):
    vec = TT.ResourceVector(hbm_bytes=int(mem_gb * GB), flops=1e9,
                            bytes_accessed=1e6, est_seconds=0.01)
    task = TT.Task(units=[TT.UnitTask(fn=None, memobjs=frozenset({name}),
                                      resources=vec, name=name)], name=name)
    return TT.Job(tasks=[task], name=name)


def test_live_cluster_runs_jobs_to_done_on_cpu():
    out = {}
    lock = threading.Lock()

    def runner_for(i):
        def runner(device):
            assert device == CPU
            x = torch.full((64, 64), float(i), device=device)
            with lock:
                out[i] = float((x @ x).sum())
        return runner

    sched = TSCH.MGBAlg3Scheduler(2, hbm_per_device=4 * GB)
    with Cluster(sched, workers=2, devices=[CPU]) as cluster:
        handles = [cluster.submit(_job(f"j{i}", 3.0), runners=[runner_for(i)])
                   for i in range(6)]
        for h in handles:
            h.result(timeout=60)
        cluster.drain()
        stats = cluster.stats()
    assert [h.status for h in handles] == [JobStatus.DONE] * 6
    assert stats["completed"] == 6 and stats["crashed"] == 0
    assert out == {i: 64 * 64 * 64 * float(i * i) for i in range(6)}
    # 3 GB tasks on 4 GB devices: never two on one device at once
    assert all(not d.residents and d.used_hbm == 0 for d in sched.devices)


def test_failing_runner_crashes_job_with_its_error():
    def bad(device):
        raise RuntimeError("kernel launch failed")

    with Cluster(TSCH.MGBAlg3Scheduler(1), devices=[CPU]) as cluster:
        h = cluster.submit(_job("bad"), runners=[bad])
        ok = cluster.submit(_job("ok"), runners=[lambda d: None])
        cluster.drain()
        assert cluster.stats()["crashed"] == 1
    assert h.status is JobStatus.CRASHED and ok.status is JobStatus.DONE
    assert "kernel launch failed" in h.job.error
    assert h.records[0].crashed and h.records[0].started


def test_a_job_submitted_from_a_callback_is_inside_the_drain():
    """A job's ``on_done`` runs before the job leaves the in-flight count
    (ROADMAP C17), so a job it submits, even late, is one the same drain
    waits for."""
    with Cluster(TSCH.MGBAlg3Scheduler(1), devices=[CPU]) as cluster:
        follow, submitted = [], threading.Event()

        def then(handle):
            time.sleep(0.2)
            follow.append(cluster.submit(_job("then"),
                                         runners=[lambda d: None]))
            submitted.set()

        first = cluster.submit(_job("first"), runners=[lambda d: None],
                               on_done=then)
        cluster.drain()
        after_callback = submitted.is_set()
        # the cluster shuts down only once the callback has submitted
        assert submitted.wait(30)
        assert after_callback, "the drain returned before the callback ran"
        assert first.status is JobStatus.DONE
        assert follow[0].status is JobStatus.DONE
        assert cluster.stats()["completed"] == 2


def test_never_feasible_task_crashes_at_submit():
    with Cluster(TSCH.MGBAlg3Scheduler(1, hbm_per_device=GB),
                 devices=[CPU]) as cluster:
        h = cluster.submit(_job("big", 2.0), runners=[lambda d: None])
        cluster.drain()
    assert h.status is JobStatus.CRASHED and not h.records[0].started
    assert h.job.error


def test_executor_without_devices_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default table is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor(TSCH.MGBAlg3Scheduler(1), workers=1)


def test_lazy_buffers_bind_on_the_chosen_device():
    bufs = {"a": lazy.LazyBuffer("a").alloc((2, 3), torch.float32),
            "b": lazy.LazyBuffer("b").h2d(np.arange(6, dtype=np.int32)),
            "c": lazy.LazyBuffer("c").alloc((4,), torch.float16).fill(2.5)}
    real = lazy.kernel_launch_prepare(bufs, CPU)
    assert torch.equal(real["a"], torch.zeros(2, 3))
    assert real["b"].dtype == torch.int32 and real["b"].tolist() == list(
        range(6))
    assert real["c"].dtype == torch.float16 and real["c"].tolist() == [2.5] * 4
    assert bufs["a"].nbytes == 24 and bufs["c"].nbytes == 8
    np.testing.assert_array_equal(bufs["b"].d2h(), np.arange(6))
    lazy.free_all(bufs)
    assert all(b.device is None for b in bufs.values())
