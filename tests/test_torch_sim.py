"""The port's simulator twin, baselines and sim backend against the JAX
package's: the same job sets, built from the same ``ResourceVector``
numbers, give the same ``SimResult`` and the same event stream under every
scheduler; then the reference's simulator, sim-cluster and engine tests,
run on the port (live legs on the CPU)."""
import copy
import threading
import time

import numpy as np
import pytest
from _hypothesis_fallback import given, settings, st

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

from repro.core import scheduler as JSCH  # noqa: E402
from repro.core import task as JT  # noqa: E402
from repro.core.cluster import Cluster as JaxCluster  # noqa: E402
from repro_torch.core import scheduler as TSCH  # noqa: E402
from repro_torch.core import task as TT  # noqa: E402
from repro_torch.core.cluster import Cluster, JobStatus  # noqa: E402
from repro_torch.core.executor import ExecJob  # noqa: E402
from repro_torch.core.scheduler import (  # noqa: E402
    CGScheduler, MGBAlg2Scheduler, MGBAlg3Scheduler, SAScheduler,
)
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.core.task import (  # noqa: E402
    Job, ResourceVector, Task, UnitTask,
)
from repro_torch.obs import events as ev  # noqa: E402
from repro_torch.obs.replay import (  # noqa: E402
    admission_order, decisions, diff_streams, first_divergence,
    validate_lifecycles,
)
from repro_torch.serve.engine import (  # noqa: E402
    SLO, NullModel, RequestStatus, ServeEngine,
)

GB = 1024**3
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the port against the JAX package, on the same job sets
# ---------------------------------------------------------------------------

# scheduler -> (constructor over the package's scheduler module and a
# device count, workers): the paper's SA (one worker a device), CG (a core
# ratio of 3, memory-oblivious: it crashes jobs), schedGPU's memory-only
# policy, MGB Algorithms 2 and 3, and the reference (oracle) engine of each
SCHEDULERS = {
    "SA": (lambda m, n: m.SAScheduler(n), lambda n: n),
    "CG": (lambda m, n: m.CGScheduler(n, ratio=3), lambda n: 3 * n),
    "schedGPU": (lambda m, n: m.MemOnlyScheduler(n), lambda n: 8),
    "MGB-Alg2": (lambda m, n: m.MGBAlg2Scheduler(n), lambda n: 8),
    "MGB-Alg3": (lambda m, n: m.MGBAlg3Scheduler(n), lambda n: 8),
    "Ref-Alg2": (lambda m, n: m.ReferenceAlg2Scheduler(n), lambda n: 8),
    "Ref-Alg3": (lambda m, n: m.ReferenceAlg3Scheduler(n), lambda n: 8),
}


def job_set(task_mod, seed: int, n_jobs: int):
    """Jobs of 1-3 tasks with seeded vectors in the Rodinia mixes' range
    (0.5-13 GB on 16 GB devices, demands 0.01-1, 1-40 s), priorities and
    a few deadlines; the same numbers whatever the package."""
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(n_jobs):
        tasks = []
        for k in range(int(rng.integers(1, 4))):
            vec = task_mod.ResourceVector(
                hbm_bytes=int(rng.uniform(0.5, 13.0) * GB),
                flops=float(rng.uniform(1e11, 1e13)),
                bytes_accessed=float(rng.uniform(1e9, 1e11)),
                est_seconds=float(rng.uniform(1.0, 40.0)),
                core_demand=float(rng.uniform(0.01, 1.0)),
                bw_demand=float(rng.uniform(0.01, 1.0)))
            name = f"j{i}.{k}"
            tasks.append(task_mod.Task(units=[task_mod.UnitTask(
                fn=None, memobjs=frozenset({name}), resources=vec,
                name=name)], name=name))
        job = task_mod.Job(tasks=tasks, name=f"j{i}")
        job.priority = int(rng.integers(0, 3))
        if rng.uniform() < 0.3:
            job.deadline_t = float(rng.uniform(5.0, 200.0))
        jobs.append(job)
    return jobs


def _run_both(sched_name: str, seed: int, n_dev: int, failure_at=None):
    make, workers = SCHEDULERS[sched_name]
    out = []
    for sched_mod, task_mod, cluster_cls in (
            (JSCH, JT, JaxCluster), (TSCH, TT, Cluster)):
        c = cluster_cls(make(sched_mod, n_dev), workers=workers(n_dev),
                        backend="sim", trace=True)
        sim = c._sim
        sim._failure_pending = failure_at
        for job in job_set(task_mod, seed, 14):
            c.submit(job)
        res = sim.drain()
        out.append((res, c.trace.events()))
    return out


def _assert_same_result(a, b) -> None:
    for f in ("completed", "crashed", "cancelled", "shed", "truncated"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("makespan", "throughput", "utilization"):
        assert getattr(b, f) == pytest.approx(getattr(a, f), rel=1e-12,
                                              abs=0.0), f
    for f in ("turnaround", "slowdowns", "dilations"):
        da, db = getattr(a, f), getattr(b, f)
        assert sorted(da) == sorted(db), f
        for k in da:
            assert db[k] == pytest.approx(da[k], rel=1e-12, abs=0.0), (f, k)
    assert len(a.device_busy) == len(b.device_busy)
    for x, y in zip(a.device_busy, b.device_busy):
        assert y == pytest.approx(x, rel=1e-12, abs=1e-300)


@pytest.mark.parametrize("seed,n_dev,failure_at", [
    (0, 2, None), (1, 4, None), (2, 2, (30.0, 0))])
@pytest.mark.parametrize("sched_name", sorted(SCHEDULERS))
def test_sim_result_and_stream_equal_the_jax_simulators(sched_name, seed,
                                                        n_dev, failure_at):
    (jres, jevents), (tres, tevents) = _run_both(sched_name, seed, n_dev,
                                                 failure_at)
    assert jres.completed + jres.crashed + jres.shed == 14
    _assert_same_result(jres, tres)
    kinds = (ev.ADMIT, ev.GROW, ev.EVICT)
    div = diff_streams(jevents, tevents, kinds=kinds, with_device=True)
    assert div is None, div
    # and the whole stream: every kind, task, device and virtual time
    assert [(e.kind, e.name, e.device) for e in jevents] \
        == [(e.kind, e.name, e.device) for e in tevents]
    np.testing.assert_allclose([e.t for e in tevents],
                               [e.t for e in jevents], rtol=1e-12, atol=0)
    # every lifecycle is sound, or unsound at the same places in both: the
    # reference (oracle) engine re-admits a task that a device death
    # evicted without a REQUEUE event, in the JAX package as in the copy
    problems = validate_lifecycles(jevents)
    assert len(validate_lifecycles(tevents)) == len(problems)
    assert problems == [] or sched_name.startswith("Ref-")


def test_cg_crashes_where_the_memory_safe_schedulers_do_not():
    """The job sets above reach both sides of Table II's contrast."""
    (jcg, _), (tcg, _) = _run_both("CG", 0, 2)
    assert tcg.crashed == jcg.crashed > 0
    for name in ("SA", "schedGPU", "MGB-Alg2", "MGB-Alg3"):
        (_, _), (res, _) = _run_both(name, 0, 2)
        assert res.crashed == 0 and res.completed == 14, name


# ---------------------------------------------------------------------------
# the reference's simulator tests (tests/test_simulator.py), on the port
# ---------------------------------------------------------------------------

def mk_sim_job(name, mem_gb=2.0, demand=0.4, est=5.0, n_tasks=1):
    tasks = []
    for i in range(n_tasks):
        vec = ResourceVector(hbm_bytes=int(mem_gb * GB), flops=1e12,
                             bytes_accessed=1e9, est_seconds=est,
                             core_demand=demand, bw_demand=demand)
        tasks.append(Task(units=[UnitTask(
            fn=None, memobjs=frozenset({f"{name}/{i}"}), resources=vec,
            name=f"{name}.{i}")], name=f"{name}.{i}"))
    return Job(tasks=tasks, name=name)


def test_conservation_and_makespan_sa():
    jobs = [mk_sim_job(f"j{i}", est=5.0) for i in range(4)]
    r = Simulator(SAScheduler(2), workers=2).run(jobs)
    assert r.completed == 4 and r.crashed == 0
    # 4 jobs x 5 s over 2 dedicated devices = 10 s (+ poll slack)
    assert 9.9 <= r.makespan <= 10.6


def test_sharing_beats_sa_for_low_demand():
    jobs = [mk_sim_job(f"j{i}", demand=0.2, est=5.0) for i in range(8)]
    sa = Simulator(SAScheduler(2), workers=2).run(copy.deepcopy(jobs))
    mgb = Simulator(MGBAlg3Scheduler(2), workers=8).run(copy.deepcopy(jobs))
    assert mgb.makespan < sa.makespan / 1.8
    assert mgb.completed == sa.completed == 8


def test_oversubscription_dilates_wall_not_kernels():
    jobs = [mk_sim_job(f"j{i}", demand=0.6, est=10.0) for i in range(4)]
    r = Simulator(MGBAlg3Scheduler(1), workers=4).run(jobs)
    assert r.completed == 4
    # 4 x 0.6 demand on one chip -> ~2.4x wall dilation
    assert max(r.dilations.values()) > 1.8
    # but per-kernel slowdown stays at the eta overhead (<3%)
    assert max(r.slowdowns.values()) < 1.04


def test_cg_crashes_jobs_memory_safe_do_not():
    jobs = [mk_sim_job(f"j{i}", mem_gb=9.0, est=5.0) for i in range(6)]
    cg = Simulator(CGScheduler(2, ratio=3), workers=6).run(
        copy.deepcopy(jobs))
    assert cg.crashed > 0
    for cls in (SAScheduler, MGBAlg2Scheduler, MGBAlg3Scheduler):
        r = Simulator(cls(2), workers=6).run(copy.deepcopy(jobs))
        assert r.crashed == 0 and r.completed == 6, cls.__name__


def test_multi_task_jobs_run_in_order():
    jobs = [mk_sim_job("j0", n_tasks=3, est=2.0)]
    r = Simulator(MGBAlg3Scheduler(2), workers=1).run(jobs)
    assert r.completed == 1
    t = jobs[0].tasks
    assert t[0].finish_t <= t[1].start_t + 1e-9
    assert t[1].finish_t <= t[2].start_t + 1e-9


def test_failure_injection_reschedules():
    jobs = [mk_sim_job(f"j{i}", est=5.0, demand=0.3) for i in range(4)]
    r = Simulator(MGBAlg3Scheduler(2), workers=4).run(
        jobs, failure_at=(2.0, 0))
    # all jobs complete despite losing a device mid-run
    assert r.completed == 4 and r.crashed == 0
    # everything after the failure ran on device 1
    for j in jobs:
        for t in j.tasks:
            if t.start_t >= 2.0:
                assert t.device == 1


def test_infeasible_job_counted_crashed_not_livelocked():
    jobs = [mk_sim_job("big", mem_gb=20.0)]
    r = Simulator(MGBAlg3Scheduler(1), workers=1).run(jobs)
    assert r.crashed == 1 and r.completed == 0


@given(n_jobs=st.integers(1, 12), demand=st.floats(0.05, 1.0),
       workers=st.integers(1, 12))
@settings(max_examples=30, deadline=None)
def test_property_all_feasible_jobs_complete(n_jobs, demand, workers):
    jobs = [mk_sim_job(f"j{i}", mem_gb=3.0, demand=demand, est=2.0)
            for i in range(n_jobs)]
    r = Simulator(MGBAlg3Scheduler(2), workers=workers).run(jobs)
    assert r.completed == n_jobs and r.crashed == 0
    # a job can never finish faster than its solo estimate...
    assert r.makespan >= 2.0 - 1e-9
    # ...and the batch can never take longer than fully-serial + poll slack
    assert r.makespan <= n_jobs * 2.0 * 1.2 + 1.0
    assert max(r.device_busy) >= 2.0 - 1e-9


# ---------------------------------------------------------------------------
# the reference's sim-cluster tests (tests/test_cluster.py), on the port
# ---------------------------------------------------------------------------

def mk_task(name, mem_gb=2.0, demand=0.5, est=0.005):
    vec = ResourceVector(hbm_bytes=int(mem_gb * GB), flops=1e9,
                         bytes_accessed=1e9, est_seconds=est,
                         core_demand=demand, bw_demand=demand)
    return Task(units=[UnitTask(fn=None, memobjs=frozenset({name}),
                                resources=vec, name=name)], name=name)


def mk_job(name, mem_gb=2.0, demand=0.5, est=0.005, n_tasks=1):
    tasks = [mk_task(f"{name}.{k}" if n_tasks > 1 else name, mem_gb, demand,
                     est) for k in range(n_tasks)]
    return Job(tasks=tasks, name=name)


def live_ej(name, mem_gb=2.0, demand=0.5, sleep=0.003, body=None):
    job = mk_job(name, mem_gb, demand)
    runner = body if body is not None else (
        lambda device, s=sleep: time.sleep(s))
    return ExecJob(job=job, runners=[runner])


def test_sim_submit_while_running():
    c = Cluster(MGBAlg3Scheduler(2), workers=4, backend="sim")
    h1 = c.submit(mk_job("a", est=5.0, n_tasks=2))
    assert c.step()                      # completes a.0 at t=5; a.1 starts
    assert h1.status is JobStatus.RUNNING
    assert 0.0 < c.now < 10.0
    h2 = c.submit(mk_job("b", est=1.0))  # arrives mid-flight of job a
    assert h2.job.arrival_t == c.now
    c.drain()
    assert h1.status is JobStatus.DONE and h2.status is JobStatus.DONE
    assert h2.records[0].t_start >= h2.job.arrival_t


def test_sim_result_advances_virtual_clock():
    c = Cluster(MGBAlg2Scheduler(1), workers=2, backend="sim")
    c.submit(mk_job("a", demand=1.0, est=3.0))
    h2 = c.submit(mk_job("b", demand=1.0, est=3.0))
    recs = h2.result()                  # drives the clock until b resolves
    assert h2.status is JobStatus.DONE
    assert recs[0].t_start >= 3.0 - 1e-9   # b waited for exclusive a


def test_sim_cancel_parked_waiter():
    c = Cluster(MGBAlg3Scheduler(1), workers=4, backend="sim")
    hog = c.submit(mk_job("hog", mem_gb=10.0, est=4.0))
    w = c.submit(mk_job("w", mem_gb=10.0, est=1.0))
    assert c.sched.waiting_count() == 1
    assert w.cancel() is True
    assert w.status is JobStatus.CANCELLED
    assert c.sched.waiting_count() == 0
    uid = w.job.tasks[0].uid
    assert uid not in c.sched._admit_cbs and uid not in c.sched._epochs
    r = c._sim.drain()
    assert hog.status is JobStatus.DONE
    assert r.completed == 1 and r.cancelled == 1 and r.crashed == 0


def _ordering_trace(cluster, *, est=0.01, body=None):
    """One exclusive device; jobs park while 'first' runs, then are admitted
    strictly in queue-rank order. Returns expected admission order."""
    mk = (lambda n: live_ej(n, demand=1.0, sleep=0.004, body=body)) \
        if cluster.backend == "live" else \
        (lambda n: mk_job(n, demand=1.0, est=est))
    cluster.submit(mk("first"))
    cluster.submit(mk("low-a"), priority=0)
    cluster.submit(mk("low-b"), priority=0)
    cluster.submit(mk("hi-late"), priority=5)        # overtakes low-a/low-b
    cluster.submit(mk("hi-edf-9"), priority=5, deadline_s=9.0)
    cluster.submit(mk("hi-edf-1"), priority=5, deadline_s=1.0)
    cluster.submit(mk("low-edf"), priority=0, deadline_s=3.0)
    return ["first", "hi-edf-1", "hi-edf-9", "hi-late",
            "low-edf", "low-a", "low-b"]


def test_sim_edf_and_priority_ordering():
    c = Cluster(MGBAlg2Scheduler(1), workers=8, backend="sim", trace=True)
    expected = _ordering_trace(c)
    c.drain()
    assert admission_order(c.trace.events()) == expected


def test_live_and_sim_same_admission_order_for_same_trace():
    """The two backends replay one submission trace into the same
    admission order (they share the scheduler's queue), through the
    replay differ over each backend's event stream; the live leg runs on
    the CPU."""
    live = Cluster(MGBAlg2Scheduler(1), workers=1, trace=True,
                   devices=[CPU])
    _ordering_trace(live)
    live.drain()
    live.shutdown()
    sim = Cluster(MGBAlg2Scheduler(1), workers=8, backend="sim", trace=True)
    _ordering_trace(sim)
    sim.drain()
    div = first_divergence(admission_order(live.trace.events()),
                           admission_order(sim.trace.events()))
    assert div is None, div
    assert diff_streams(live.trace.events(), sim.trace.events()) is None


def test_empty_job_finishes_immediately_sim():
    c = Cluster(MGBAlg3Scheduler(1), workers=1, backend="sim")
    h = c.submit(Job(tasks=[], name="empty"))
    assert h.status is JobStatus.DONE
    assert len(h.records) == 1 and h.records[0].device == -1
    r = c._sim.drain()
    assert r.completed == 1 and r.crashed == 0


def test_simulator_run_empty_metrics_guarded():
    r = Simulator(MGBAlg3Scheduler(2), workers=2).run([])
    assert r.completed == 0 and r.crashed == 0
    assert r.makespan == 0.0 and r.throughput == 0.0
    assert r.mean_turnaround == 0.0 and r.mean_slowdown_pct == 0.0
    assert r.utilization == 0.0
    r2 = Simulator(MGBAlg3Scheduler(2), workers=2).run(
        [Job(tasks=[], name="e")])
    assert r2.completed == 1 and r2.mean_slowdown_pct == 0.0


def test_deadline_is_ordering_hint_not_enforcement():
    c = Cluster(MGBAlg2Scheduler(1), workers=4, backend="sim")
    c.submit(mk_job("hog", demand=1.0, est=10.0))
    late = c.submit(mk_job("late", demand=1.0, est=1.0), deadline_s=0.5)
    c.drain()
    assert late.status is JobStatus.DONE          # ran anyway, late
    assert late.records[0].t_start > 0.5


def test_sim_stats_inject_failure_and_revive():
    """The sim branches of ``stats``, ``inject_failure``, ``revive`` and
    ``shutdown``: a dead device's residents re-park and finish on the
    survivor; a revived device takes work again; the counters fold every
    job once."""
    c = Cluster(MGBAlg3Scheduler(2), workers=4, backend="sim")
    hs = [c.submit(mk_job(f"j{i}", mem_gb=6.0, demand=0.3, est=5.0))
          for i in range(2)]
    c.run_until(1.0)
    assert c.now == pytest.approx(1.0)
    c.inject_failure(0)
    c.run_until(2.0)
    assert {t.device for h in hs for t in h.job.tasks} == {1}
    c.revive(0)
    late = c.submit(mk_job("late", mem_gb=9.0, demand=0.3, est=1.0))
    c.shutdown()
    assert all(h.status is JobStatus.DONE for h in hs + [late])
    assert late.job.tasks[0].device == 0
    s = c.stats()
    assert s["completed"] == 3 and s["crashed"] == 0
    assert s["makespan_s"] == pytest.approx(max(
        h.job.finish_t for h in hs + [late]))


def test_sim_drain_that_hits_the_time_limit_raises():
    c = Cluster(MGBAlg3Scheduler(1), workers=1, backend="sim")
    c.submit(mk_job("long", est=2e7, demand=1.0))
    with pytest.raises(RuntimeError, match="truncated"):
        c.drain()


def test_unknown_backend_is_refused():
    with pytest.raises(ValueError, match="unknown backend"):
        Cluster(MGBAlg3Scheduler(1), backend="replay")


# ---------------------------------------------------------------------------
# the reference's engine parity test (tests/test_serve.py), on the port
# ---------------------------------------------------------------------------

GENS = (7, 3, 5, 2, 4, 6)


def _run_engine_trace(backend):
    sched = MGBAlg3Scheduler(2, hbm_per_device=16 * GB)
    c = Cluster(sched, workers=1, backend=backend, trace=True,
                devices=[CPU, CPU] if backend == "live" else None)
    model = NullModel(prefill_s=0.01, step_s=0.01)
    eng = ServeEngine(c, model, max_batch=2,
                      slo=SLO(ttft_s=600.0, tpot_s=600.0))
    reqs = [eng.submit(prompt_len=8, gen_len=g) for g in GENS]
    eng.drain(timeout_s=120.0)
    # slot joins are GROW decisions; each leg draws fresh rids, so slot
    # names ("slot/{rid}") are mapped onto this leg's request index
    rid_to_idx = {r.rid: i for i, r in enumerate(reqs)}
    joins = [(rid_to_idx[int(name.split("/", 1)[1])], dev)
             for name, dev in decisions(c.trace.events(), kinds=(ev.GROW,),
                                        with_device=True)]
    if backend == "live":
        c.shutdown()
    return reqs, joins


def test_live_sim_slot_admission_parity():
    live_reqs, live_joins = _run_engine_trace("live")
    sim_reqs, sim_joins = _run_engine_trace("sim")
    assert all(r.status is RequestStatus.DONE for r in live_reqs + sim_reqs)
    assert all(r.n_tokens == r.gen_len for r in live_reqs + sim_reqs)
    div = first_divergence(live_joins, sim_joins)
    assert div is None, div


def test_engine_run_until_on_the_sim_backend():
    """``ServeEngine.run_until`` advances the virtual clock with decode
    ticks at the model's cadence: requests submitted at t=0 are done by a
    bounded virtual time, and the clock lands on the asked time."""
    sched = MGBAlg3Scheduler(1, hbm_per_device=8 * GB)
    c = Cluster(sched, workers=64, backend="sim")
    model = NullModel(loop_hbm=2 * GB, slot_hbm=2 * GB,
                      prefill_hbm=GB // 2, prefill_s=0.01, step_s=0.01)
    eng = ServeEngine(c, model, max_batch=2, slo=SLO(600.0, 600.0))
    reqs = [eng.submit(prompt_len=8, gen_len=5) for _ in range(8)]
    eng.run_until(0.05)
    assert c.now == pytest.approx(0.05)
    assert not all(r.status is RequestStatus.DONE for r in reqs)
    eng.run_until(5.0)
    assert c.now == pytest.approx(5.0)
    assert all(r.status is RequestStatus.DONE for r in reqs)
    assert eng.violations == 0
    eng.shutdown()
    assert sched.devices[0].used_hbm == 0


def test_live_cluster_trace_records_the_live_lifecycle():
    """``trace=True`` on the live backend: the executor and scheduler emit
    one valid lifecycle per task."""
    done = threading.Event()
    c = Cluster(MGBAlg3Scheduler(1), workers=2, trace=True, devices=[CPU])
    for i in range(4):
        c.submit(live_ej(f"j{i}", body=lambda d: done.wait(0.01)))
    c.drain()
    c.shutdown()
    events = c.trace.events()
    assert validate_lifecycles(events) == []
    assert sorted(admission_order(events)) == [f"j{i}" for i in range(4)]
    assert {e.kind for e in events} >= {ev.SUBMIT, ev.ADMIT, ev.BEGIN,
                                        ev.END}


def test_flight_recorder_dump_loads_back_the_same_stream(tmp_path):
    """``obs.replay.FlightRecorder`` writes a traced sim run's event window
    (with metrics from the copied ``obs.metrics``) and ``load_flight``
    reads back the same events."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.replay import FlightRecorder, load_flight
    c = Cluster(MGBAlg2Scheduler(1), workers=8, backend="sim", trace=True)
    _ordering_trace(c)
    c.drain()
    rec = FlightRecorder(c.trace, str(tmp_path / "flight.json"),
                         registry=MetricsRegistry())
    path = rec.dump("drain", always=True)
    assert rec.dump("drain") is None          # once per reason
    events = load_flight(path)
    assert [(e.seq, e.kind, e.name, e.device) for e in events] \
        == [(e.seq, e.kind, e.name, e.device) for e in c.trace.events()]
    assert diff_streams(events, c.trace.events()) is None
