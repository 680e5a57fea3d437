"""The port's preemption subsystem against the JAX package's: the reference's
battery (``tests/test_preempt.py``, one for one, live legs on the CPU, the
gang tests on the sim backend), parity of the preemptive schedulers' results
and event streams with the JAX package's on ``overload_mix`` and on a gang
trace, the live executor's eviction fence, and a preempted training task
that resumes from its checkpoint to the parameters of an uninterrupted
run."""
import os
import threading
import time

import numpy as np
import pytest
from _hypothesis_fallback import given, settings, st

torch = pytest.importorskip("torch")

from repro.core import scheduler as JSCH  # noqa: E402
from repro.core import task as JT  # noqa: E402
from repro.core import workloads as JW  # noqa: E402
from repro.core.cluster import Cluster as JaxCluster  # noqa: E402
from repro.core.preemption import PreemptionPolicy as JPolicy  # noqa: E402
from repro_torch.core import scheduler as TSCH  # noqa: E402
from repro_torch.core import task as TT  # noqa: E402
from repro_torch.core import workloads as TW  # noqa: E402
from repro_torch.core.cluster import Cluster, JobStatus  # noqa: E402
from repro_torch.core.executor import ExecJob  # noqa: E402
from repro_torch.core.preemption import (  # noqa: E402
    PreemptionPolicy, ProgressLedger, outranks, preemption_cost,
)
from repro_torch.core.scheduler import (  # noqa: E402
    MGBAlg3Scheduler, PreemptiveAlg2Scheduler, PreemptiveAlg3Scheduler,
    PreemptiveGangScheduler,
)
from repro_torch.core.scheduler.base import slots_needed  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.core.task import (  # noqa: E402
    Job, ResourceVector, Task, UnitTask,
)
from repro_torch.obs import events as ev  # noqa: E402
from repro_torch.obs.replay import (  # noqa: E402
    admission_order, diff_streams, eviction_order, first_divergence,
    validate_lifecycles,
)
from repro_torch.core.workloads import overload_mix  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

GB = 1024**3
CPU = torch.device("cpu")

FAST = PreemptionPolicy(min_runtime_s=0.0, budget=3, aging_step=1,
                        checkpoint_penalty_s=0.5)


def mk_task(name, gb, est, prio=0, chips=1, demand=0.5, deadline=None,
            task_mod=TT):
    vec = task_mod.ResourceVector(hbm_bytes=int(gb * GB), flops=1e9,
                                  bytes_accessed=1e9, est_seconds=est,
                                  core_demand=demand, bw_demand=0.3,
                                  chips=chips)
    return task_mod.Task(units=[task_mod.UnitTask(
        fn=None, memobjs=frozenset({name}), resources=vec, name=name)],
        name=name, priority=prio, deadline_t=deadline,
        gang_id=name if chips > 1 else None)


def mk_job(name, gb, est, prio=0, chips=1, demand=0.5, task_mod=TT):
    t = mk_task(name, gb, est, prio=prio, chips=chips, demand=demand,
                task_mod=task_mod)
    return task_mod.Job(tasks=[t], name=name, priority=prio,
                        gang_id=t.gang_id)


def assert_zeroed(sched):
    assert all(d.used_hbm == 0 and d.used_slots == 0 and not d.residents
               for d in sched.devices), \
        [(d.index, d.used_hbm, d.used_slots) for d in sched.devices]


def live_cluster(sched, workers, **kw):
    return Cluster(sched, workers=workers, devices=[CPU], **kw)


# ---------------------------------------------------------------------------
# the port against the JAX package, on the sim backend
# ---------------------------------------------------------------------------

def _assert_same_stream(jevents, tevents):
    div = diff_streams(jevents, tevents, kinds=(ev.ADMIT, ev.EVICT),
                       with_device=True)
    assert div is None, div
    assert [(e.kind, e.name, e.device) for e in jevents] \
        == [(e.kind, e.name, e.device) for e in tevents]
    np.testing.assert_allclose([e.t for e in tevents],
                               [e.t for e in jevents], rtol=1e-12, atol=0)
    assert validate_lifecycles(tevents) == validate_lifecycles(jevents) == []


def _assert_same_result(a, b):
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


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_overload_mix_under_preemptive_alg3_equals_the_jax_package(seed):
    """The same ``overload_mix`` seed, submitted at its rows' virtual times
    to each package's ``PreemptiveAlg3Scheduler`` on the sim backend: the
    same rows, ``SimResult``, event stream and eviction log."""
    out = []
    for sched_mod, wl, policy, cluster_cls in (
            (JSCH, JW, JPolicy, JaxCluster),
            (TSCH, TW, PreemptionPolicy, Cluster)):
        rows = wl.overload_mix(seed, n_background=4, n_bystander=2,
                               n_urgent=8)
        sched = sched_mod.PreemptiveAlg3Scheduler(
            2, preempt_policy=policy(min_runtime_s=0.25, budget=3,
                                     aging_step=1,
                                     checkpoint_penalty_s=0.5))
        c = cluster_cls(sched, workers=64, backend="sim", trace=True)
        for row in rows:
            c.run_until(row["t"])
            c.submit(row["job"], priority=row["priority"],
                     deadline_s=row["deadline_s"])
        c.drain()
        names = {t.uid: t.name for r in rows for t in r["job"].tasks}
        out.append(([(r["t"], r["kind"], r["job"].tasks[0].resources)
                     for r in rows], c._sim.result(), c.trace.events(),
                    [(names[v], names[p]) for v, p in sched.preempt_log],
                    c.stats()))
    (jrows, jres, jevents, jlog, _), (trows, tres, tevents, tlog, ts) = out
    assert [(t, k, dict(vars(v))) for t, k, v in trows] \
        == [(t, k, dict(vars(v))) for t, k, v in jrows]
    _assert_same_result(jres, tres)
    _assert_same_stream(jevents, tevents)
    assert tlog == jlog and tlog, "no eviction: the trace is not overloaded"
    assert ts["preemptions"] == len(tlog)


def test_gang_trace_under_preemptive_gang_equals_the_jax_package():
    """A hand-built gang trace on a 2 x 2 pod: solos and a low-priority
    4-chip gang fill it, then an urgent 2-chip gang and an urgent solo
    arrive; each package's ``PreemptiveGangScheduler`` gives the same
    result, event stream and evictions (whole reservations)."""
    out = []
    for sched_mod, task_mod, policy, cluster_cls in (
            (JSCH, JT, JPolicy, JaxCluster),
            (TSCH, TT, PreemptionPolicy, Cluster)):
        sched = sched_mod.PreemptiveGangScheduler(
            pods=1, rows=2, cols=2,
            preempt_policy=policy(min_runtime_s=0.0, budget=3, aging_step=1,
                                  checkpoint_penalty_s=0.5))
        c = cluster_cls(sched, workers=64, backend="sim", trace=True)
        trace = [(0.0, mk_job("solo-a", 12, 6.0, task_mod=task_mod)),
                 (0.0, mk_job("solo-b", 12, 8.0, task_mod=task_mod)),
                 (0.5, mk_job("gang-lo", 20, 4.0, chips=2,
                              task_mod=task_mod)),
                 (1.0, mk_job("gang-wide", 40, 5.0, chips=4,
                              task_mod=task_mod)),
                 (2.0, mk_job("gang-hi", 20, 1.0, prio=5, chips=2,
                              task_mod=task_mod)),
                 (2.5, mk_job("solo-hi", 10, 0.5, prio=5,
                              task_mod=task_mod))]
        for t, job in trace:
            c.run_until(t)
            c.submit(job)
        c.drain()
        names = {j.tasks[0].uid: j.name for _, j in trace}
        out.append((c._sim.result(), c.trace.events(),
                    [(names[v], names[p]) for v, p in sched.preempt_log]))
    (jres, jevents, jlog), (tres, tevents, tlog) = out
    _assert_same_result(jres, tres)
    _assert_same_stream(jevents, tevents)
    assert tlog == jlog and tlog
    assert tres.completed == 6 and tres.crashed == 0


# ---------------------------------------------------------------------------
# decision rule / cost model units (tests/test_preempt.py)
# ---------------------------------------------------------------------------

def test_outranks_is_strict_priority_then_edf():
    lo, hi = mk_task("lo", 1, 1), mk_task("hi", 1, 1, prio=5)
    assert outranks(hi, lo) and not outranks(lo, hi)
    assert not outranks(lo, mk_task("lo2", 1, 1))      # tie: never
    e1 = mk_task("e1", 1, 1, deadline=5.0)
    e2 = mk_task("e2", 1, 1, deadline=9.0)
    none = mk_task("none", 1, 1)
    assert outranks(e1, e2) and not outranks(e2, e1)   # EDF within class
    assert outranks(e1, none)                          # deadline beats none
    assert not outranks(none, e1)                      # none never outranks


def test_cost_model_remaining_times_memory():
    big_near_done = mk_task("big", 10, 100.0)
    small_fresh = mk_task("small", 1, 100.0)
    ledger = ProgressLedger()
    ledger.set_remaining(big_near_done.uid, 1.0)
    assert preemption_cost(big_near_done, ledger.remaining(big_near_done)) \
        < preemption_cost(small_fresh, ledger.remaining(small_fresh))


# ---------------------------------------------------------------------------
# work-conserving resume (sim timeline is exact)
# ---------------------------------------------------------------------------

def test_sim_resume_is_work_conserving():
    sched = PreemptiveAlg3Scheduler(1, preempt_policy=FAST)
    c = Cluster(sched, workers=8, backend="sim")
    h_bg = c.submit(mk_job("bg", 10, 10.0))
    c.run_until(2.0)
    h_hi = c.submit(mk_job("hi", 10, 1.0, prio=5))
    c.drain()
    assert h_hi.status is JobStatus.DONE and h_bg.status is JobStatus.DONE
    # bg ran [0,2), hi [2,3), bg resumes with 8s remaining + 0.5s penalty
    assert abs(h_hi.job.finish_t - 3.0) < 1e-6
    assert abs(h_bg.job.finish_t - 11.5) < 1e-6, h_bg.job.finish_t
    assert sched.preemptions == 1 and sched.preempt_log
    assert h_bg.job.tasks[0].preempt_count == 1
    assert len(sched.ledger) == 0    # cleared on completion
    assert c.stats()["preemptions"] == 1
    assert_zeroed(sched)


def test_sim_migration_counted_when_resumed_elsewhere():
    # dev0: bg (victim), dev1: blocker finishing right after the preemption;
    # bg's re-admission lands on the freed dev1 -> migration. The blocker
    # shares the preemptor's priority class so it can never be the victim.
    sched = PreemptiveAlg3Scheduler(2, preempt_policy=FAST)
    c = Cluster(sched, workers=8, backend="sim")
    h_bg = c.submit(mk_job("bg", 10, 10.0))
    h_blk = c.submit(mk_job("blocker", 10, 3.0, prio=5))
    c.run_until(2.0)
    h_hi = c.submit(mk_job("hi", 10, 5.0, prio=5))
    c.drain()
    assert all(h.status is JobStatus.DONE for h in (h_bg, h_blk, h_hi))
    assert sched.preemptions == 1
    assert sched.migrations == 1     # bg moved from dev0 to dev1
    assert c.stats()["migrations"] == 1
    assert_zeroed(sched)


# ---------------------------------------------------------------------------
# guardrails
# ---------------------------------------------------------------------------

def test_min_runtime_guard_blocks_fresh_victims():
    pol = PreemptionPolicy(min_runtime_s=100.0, budget=3)
    sched = PreemptiveAlg3Scheduler(1, preempt_policy=pol)
    c = Cluster(sched, workers=8, backend="sim")
    c.submit(mk_job("bg", 10, 5.0))
    c.run_until(1.0)    # resident for 1s << min_runtime
    c.submit(mk_job("hi", 10, 1.0, prio=5))
    c.drain()
    assert sched.preemptions == 0   # guard held: hi waited instead
    assert all(h.status is JobStatus.DONE for h in c.handles)
    assert_zeroed(sched)


def test_budget_makes_job_immune_after_n_evictions():
    pol = PreemptionPolicy(min_runtime_s=0.0, budget=1, aging_step=0,
                           checkpoint_penalty_s=0.1)
    sched = PreemptiveAlg3Scheduler(1, preempt_policy=pol)
    c = Cluster(sched, workers=8, backend="sim")
    h_bg = c.submit(mk_job("bg", 10, 10.0))
    c.run_until(1.0)
    c.submit(mk_job("hi1", 10, 1.0, prio=5))   # evicts bg (budget -> 0 left)
    c.run_until(3.0)                           # hi1 done, bg resumed
    c.submit(mk_job("hi2", 10, 1.0, prio=5))   # bg now immune: must wait
    c.drain()
    assert sched.preemptions == 1
    assert h_bg.job.tasks[0].preempt_count == 1
    assert all(h.status is JobStatus.DONE for h in c.handles)
    assert_zeroed(sched)


def test_starvation_aged_low_priority_job_completes_under_pressure():
    # sustained priority-3 arrivals (1.0s of work every 1.2s) over a single
    # device: the priority-0 job is evicted at most `budget` times — aging
    # promotes it a class per eviction and the spent budget then makes it
    # immune, so once re-admitted it runs to completion despite the stream
    pol = PreemptionPolicy(min_runtime_s=0.0, budget=3, aging_step=1,
                           checkpoint_penalty_s=0.1)
    sched = PreemptiveAlg3Scheduler(1, preempt_policy=pol)
    c = Cluster(sched, workers=64, backend="sim")
    h_lo = c.submit(mk_job("lo", 10, 5.0))
    for i in range(14):
        c.run_until(0.2 + 1.2 * i)
        c.submit(mk_job(f"hi{i:02d}", 10, 1.0, prio=3))
    c.drain()
    assert h_lo.status is JobStatus.DONE
    lo_task = h_lo.job.tasks[0]
    assert lo_task.preempt_count == pol.budget          # then immune
    assert lo_task.age_boost == pol.budget * pol.aging_step  # aged upwards
    assert lo_task.priority == 0   # aging never touches the raw class
    # it finished well before the arrival stream ended
    assert h_lo.job.finish_t < 0.2 + 1.2 * 13, h_lo.job.finish_t
    assert all(h.status is JobStatus.DONE for h in c.handles)
    assert_zeroed(sched)


def test_simultaneous_completion_racing_a_preemption():
    # two co-residents finish at the SAME virtual event; the first task_end's
    # drain preempts the second (done but not yet ended) for a parked urgent
    # whose min-runtime guard blocked it at arrival. The sim must tolerate
    # the eviction notice having already removed the co-completer from its
    # running set, and everything still resolves.
    pol = PreemptionPolicy(min_runtime_s=8.0, budget=3,
                           checkpoint_penalty_s=0.5)
    sched = PreemptiveAlg3Scheduler(1, preempt_policy=pol)
    c = Cluster(sched, workers=8, backend="sim")
    c.submit(mk_job("small", 1, 10.0, demand=0.3))
    c.submit(mk_job("big", 10, 10.0, demand=0.3))
    c.run_until(5.0)
    c.submit(mk_job("urgent", 9, 1.0, prio=5))
    c.drain()
    assert all(h.status is JobStatus.DONE for h in c.handles), \
        [(h.job.name, h.status) for h in c.handles]
    assert len(sched.ledger) == 0
    assert_zeroed(sched)


def test_shed_after_preemption_drops_banked_state():
    # a request that is preempted and THEN shed (deadline passed while
    # re-parked) must not leak its ledger/bookkeeping entries
    pol = PreemptionPolicy(min_runtime_s=0.0, budget=3,
                           checkpoint_penalty_s=0.5)
    sched = PreemptiveAlg3Scheduler(1, preempt_policy=pol)
    c = Cluster(sched, workers=8, backend="sim", shed_late=True)
    h_bg = c.submit(mk_job("bg", 10, 10.0), deadline_s=4.0)
    c.run_until(2.0)
    h_hi = c.submit(mk_job("hi", 10, 5.0, prio=5))   # evicts bg
    c.drain()
    assert h_hi.status is JobStatus.DONE
    assert h_bg.status is JobStatus.SHED, h_bg.status
    assert len(sched.ledger) == 0
    assert not sched._evicted_from and not sched._resident_since
    assert_zeroed(sched)


# ---------------------------------------------------------------------------
# accounting exactness through evict / rollback
# ---------------------------------------------------------------------------

def test_memory_and_slots_exact_after_eviction_and_rollback():
    sched = PreemptiveAlg3Scheduler(2, preempt_policy=FAST)
    fired = []
    for name, gb in (("a", 10.0), ("b", 12.0)):
        assert sched.admit_or_enqueue(mk_task(name, gb, 5.0),
                                      lambda *a: fired.append(a))
    # urgent arrival needs an eviction; plan trial + rollback + commit must
    # leave every untouched device byte-exact
    urgent = mk_task("urgent", 9.0, 1.0, prio=5)
    assert sched.admit_or_enqueue(urgent, lambda *a: fired.append(a))
    assert sched.preemptions == 1
    for d in sched.devices:
        foot = sum(t.resources.hbm_bytes for t in d.residents.values())
        slots = sum(slots_needed(t) for t in d.residents.values())
        assert d.used_hbm == foot and d.used_slots == slots
    victim_uid = sched.preempt_log[0][0]
    assert all(victim_uid not in d.residents for d in sched.devices)
    assert urgent.device is not None
    # failed preemption (nothing outranked) must be a no-op on state
    before = [(d.used_hbm, d.used_slots) for d in sched.devices]
    later = mk_task("later", 9.0, 1.0)
    assert not sched.admit_or_enqueue(later, lambda *a: fired.append(a))
    assert [(d.used_hbm, d.used_slots) for d in sched.devices] == before


def test_gang_victim_evicted_whole_never_partial():
    sched = PreemptiveGangScheduler(pods=1, rows=2, cols=2,
                                    preempt_policy=FAST)
    fired = []
    glo = mk_task("glo", 40, 10.0, chips=4)     # 10 GB on each of 4 chips
    assert sched.admit_or_enqueue(glo, lambda *a: fired.append(a))
    ghi = mk_task("ghi", 40, 1.0, prio=5, chips=4)
    assert sched.admit_or_enqueue(ghi, lambda *a: fired.append(a))
    assert sched.preemptions == 1
    assert glo.uid not in sched.bound
    assert all(glo.uid not in d.residents for d in sched.devices)
    assert not sched.topo.task_link_loads(glo.uid)
    assert sched.bound[ghi.uid].chips == 4
    assert all(ghi.uid in d.residents for d in sched.devices)
    for d in sched.devices:
        assert d.used_hbm == 10 * GB and d.used_slots == slots_needed(ghi)
    assert [w.uid for w in sched.waiting_tasks()] == [glo.uid]


def test_mark_dead_racing_a_preemption():
    sched = PreemptiveAlg3Scheduler(2, preempt_policy=FAST)
    admissions = []

    def cb(tag):
        return lambda t, placement, epoch: admissions.append(
            (tag, placement, epoch))

    bg = mk_task("bg", 10, 5.0)
    blocker = mk_task("blocker", 10, 5.0, prio=5)
    assert sched.admit_or_enqueue(bg, cb("bg"))
    assert sched.admit_or_enqueue(blocker, cb("blocker"))
    urgent = mk_task("urgent", 9, 1.0, prio=5)
    assert sched.admit_or_enqueue(urgent, cb("urgent"))
    assert sched.preemptions == 1
    dead = urgent.device
    old_epoch = sched.admission_epoch(urgent)
    evicted = sched.mark_dead(dead)
    assert urgent in evicted
    assert not sched.task_end(urgent, epoch=old_epoch)
    assert not sched.devices[dead].residents
    live_dev = sched.devices[1 - dead]
    assert live_dev.used_hbm == sum(t.resources.hbm_bytes
                                    for t in live_dev.residents.values())
    waiting = [t.uid for t in sched.waiting_tasks()]
    assert waiting[0] == urgent.uid and bg.uid in waiting
    assert sched.task_end(blocker)
    assert sched.task_end(urgent)
    assert sched.task_end(bg)
    assert not sched.waiting_tasks()
    assert_zeroed(sched)


# ---------------------------------------------------------------------------
# no lost / duplicated tasks across preempt -> resume (property battery)
# ---------------------------------------------------------------------------

@settings(max_examples=8, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_no_lost_or_duplicated_tasks_sim(seed):
    rows = overload_mix(seed, n_background=3, n_bystander=2, n_urgent=5)
    sched = PreemptiveAlg3Scheduler(2, preempt_policy=FAST)
    c = Cluster(sched, workers=64, backend="sim")
    handles = []
    for row in rows:
        c.run_until(row["t"])
        handles.append(c.submit(row["job"], priority=row["priority"],
                                deadline_s=row["deadline_s"]))
    c.drain()
    res = c._sim.result()
    assert not res.truncated
    assert all(h.status is JobStatus.DONE for h in handles), \
        [(h.job.name, h.status) for h in handles]
    assert res.completed == len(handles)
    done_names = [r.task for r in c._sim.records if not r.crashed]
    assert sorted(done_names) == sorted({r["job"].tasks[0].name
                                         for r in rows})
    assert len(sched.ledger) == 0
    assert_zeroed(sched)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_no_lost_tasks_with_gangs_and_device_failure(seed):
    sched = PreemptiveGangScheduler(pods=1, rows=1, cols=2,
                                    preempt_policy=FAST)
    sim = Simulator(sched, workers=64)
    jobs = [mk_job("solo-a", 12, 6.0), mk_job("solo-b", 12, 6.0),
            mk_job("gang-lo", 20, 4.0, chips=2)]
    states = [sim.submit(j) for j in jobs[:2]]
    sim.run_until(1.0)
    states.append(sim.submit(jobs[2]))           # parks behind the solos
    sim.run_until(2.0)
    hi = mk_job("gang-hi", 20, 1.0, prio=5, chips=2)
    states.append(sim.submit(hi))                # preempts both solos
    sim._failure_pending = (2.5 + (seed % 5) * 0.2, 0)  # kill chip 0
    res = sim.drain()
    assert not res.truncated
    resolved = [s for s in states if s.done]
    assert len(resolved) == len(states), [s.job.name for s in states
                                          if not s.done]
    done_names = [r.task for r in sim.records if not r.crashed]
    assert len(done_names) == len(set(done_names))
    assert all(not d.residents for d in sched.devices)


# ---------------------------------------------------------------------------
# live backend (on the CPU): cooperative checkpoint, resume, parity with sim
# ---------------------------------------------------------------------------

def _parity_jobs():
    return (mk_job("bg-small", 10.0, 5.0), mk_job("bg-big", 10.5, 30.0),
            mk_job("urgent", 9.0, 1.0, prio=5))


def test_live_and_sim_replay_identical_eviction_order():
    pol = PreemptionPolicy(min_runtime_s=0.0, budget=3,
                           checkpoint_penalty_s=0.2)

    s_sched = PreemptiveAlg3Scheduler(2, preempt_policy=pol)
    sim = Cluster(s_sched, workers=8, backend="sim", trace=True)
    s_jobs = _parity_jobs()
    hs = [sim.submit(s_jobs[0]), sim.submit(s_jobs[1])]
    sim.run_until(2.0)
    hs.append(sim.submit(s_jobs[2]))
    sim.drain()
    sim_victims = eviction_order(sim.trace.events())
    sim_order = admission_order(sim.trace.events())

    # live leg: the backgrounds are cooperative runners that block until
    # preempted (first attempt) and return promptly when re-dispatched
    l_sched = PreemptiveAlg3Scheduler(2, preempt_policy=pol)
    live = live_cluster(l_sched, 4, trace=True)
    l_jobs = _parity_jobs()
    release = threading.Event()
    checkpoints = []

    def cooperative(attempts):
        box = []

        def runner(device):
            attempts.append(device)
            if len(attempts) == 1:
                while not box[0].preempted.wait(0.01):
                    if release.is_set():
                        return
        return box, runner

    box_s, run_s = cooperative(small_attempts := [])
    box_b, run_b = cooperative(big_attempts := [])
    ej_s = ExecJob(job=l_jobs[0], runners=[run_s],
                   on_preempt=lambda t: checkpoints.append(t.name))
    ej_b = ExecJob(job=l_jobs[1], runners=[run_b])
    box_s.append(ej_s)
    box_b.append(ej_b)
    hl = [live.submit(ej_s), live.submit(ej_b)]
    time.sleep(0.2)
    hl.append(live.submit(l_jobs[2], runners=[lambda d: time.sleep(0.01)]))
    hl[2].result(timeout=30)
    release.set()
    live.drain()
    live.shutdown()
    assert all(h.status is JobStatus.DONE for h in hl), \
        [(h.job.name, h.status) for h in hl]
    live_victims = eviction_order(live.trace.events())
    live_order = admission_order(live.trace.events())
    assert sim_victims == live_victims == ["bg-small"]
    div = first_divergence(sim_order, live_order)
    assert div is None, div
    assert checkpoints == ["bg-small"]     # the eviction notice fired
    assert len(small_attempts) == 2        # evicted, then resumed
    assert len(big_attempts) == 1          # untouched
    assert_zeroed(l_sched)


def test_live_preempted_while_queued_for_pool_not_duplicated():
    # eviction between admission and pool pickup: the stale _Ready must be
    # dropped (epoch fence) and the job still completes exactly once
    pol = PreemptionPolicy(min_runtime_s=0.0, budget=3)
    sched = PreemptiveAlg3Scheduler(1, preempt_policy=pol)
    c = live_cluster(sched, 2)
    runs = []
    bg = mk_job("bg", 10, 1.0)
    ej = ExecJob(job=bg, runners=[lambda d: runs.append("bg")])
    h_bg = c.submit(ej)
    h_hi = c.submit(mk_job("hi", 10, 1.0, prio=5),
                    runners=[lambda d: runs.append("hi")])
    c.drain()
    c.shutdown()
    assert h_bg.status is JobStatus.DONE and h_hi.status is JobStatus.DONE
    assert runs.count("hi") == 1
    assert runs.count("bg") >= 1           # may legitimately re-run
    assert len([r for r in h_bg.records if not r.crashed]) == 1
    assert_zeroed(sched)


# ---------------------------------------------------------------------------
# front-end plumbing
# ---------------------------------------------------------------------------

def test_cluster_preempt_flag_validation():
    with pytest.raises(ValueError, match="preemption-capable"):
        Cluster(MGBAlg3Scheduler(2), workers=2, backend="sim", preempt=True)
    sched = PreemptiveAlg3Scheduler(2, preempt_policy=FAST)
    Cluster(sched, workers=2, backend="sim", preempt=False)
    assert sched.preempt_enabled is False
    sched2 = PreemptiveAlg3Scheduler(2, preempt_policy=FAST)
    Cluster(sched2, workers=2, backend="sim")
    assert sched2.preempt_enabled is True


def test_preempt_disabled_capable_scheduler_never_evicts():
    sched = PreemptiveAlg3Scheduler(1, preempt_policy=FAST)
    c = Cluster(sched, workers=8, backend="sim", preempt=False)
    c.submit(mk_job("bg", 10, 5.0))
    c.run_until(1.0)
    c.submit(mk_job("hi", 10, 1.0, prio=5))
    c.drain()
    assert sched.preemptions == 0
    assert all(h.status is JobStatus.DONE for h in c.handles)


def test_preemptive_alg2_respects_slot_hardness():
    sched = PreemptiveAlg2Scheduler(1, preempt_policy=FAST)
    fired = []
    big = mk_task("big", 2, 5.0, demand=1.0)
    assert sched.admit_or_enqueue(big, lambda *a: fired.append(a))
    hi = mk_task("hi", 2, 1.0, prio=5, demand=1.0)
    assert sched.admit_or_enqueue(hi, lambda *a: fired.append(a))
    assert sched.preemptions == 1
    d = sched.devices[0]
    assert d.used_slots == slots_needed(hi)
    assert list(d.residents) == [hi.uid]


# ---------------------------------------------------------------------------
# Simulator.drain truncation is explicit
# ---------------------------------------------------------------------------

def test_drain_time_limit_sets_truncated_flag():
    sched = MGBAlg3Scheduler(1)
    sim = Simulator(sched, workers=4)
    sim.submit(mk_job("long", 1, 100.0))
    res = sim.drain(time_limit=1.0)
    assert res.truncated
    assert sim.pending()
    res2 = sim.drain()
    assert res2.completed == 1


def test_cluster_drain_raises_on_truncation():
    sched = MGBAlg3Scheduler(1)
    c = Cluster(sched, workers=4, backend="sim")
    for i in range(3):   # 10 GB each: they serialize on the 16 GB device
        c.submit(mk_job(f"epic{i}", 10, 6e6))
    with pytest.raises(RuntimeError, match="truncated"):
        c.drain()


# ---------------------------------------------------------------------------
# the port's eviction fence (ROADMAP C14)
# ---------------------------------------------------------------------------

def test_fence_holds_the_preemptors_begin_until_the_victim_returns():
    """A cooperative victim that takes its time to return (a checkpoint
    being written) holds back the preemptor's BEGIN on its device: the
    eviction and the preemptor's ADMIT come at once, as in the reference,
    but BEGIN waits for the victim's runner to return. The victim resumes
    after the preemptor and the job completes once."""
    pol = PreemptionPolicy(min_runtime_s=0.0, budget=3)
    sched = PreemptiveAlg3Scheduler(1, preempt_policy=pol)
    c = live_cluster(sched, 2, trace=True)
    marks = {}
    started = threading.Event()
    box = []

    def victim(device):
        if "victim_exit" in marks:
            marks["victim_resumed"] = time.monotonic()
            return
        started.set()
        box[0].preempted.wait(30)
        marks["noticed"] = time.monotonic()
        time.sleep(0.3)                # the eviction's own work
        marks["victim_exit"] = time.monotonic()

    def urgent(device):
        marks["urgent_begin"] = time.monotonic()

    ej = ExecJob(job=mk_job("bg", 10, 10.0), runners=[victim])
    box.append(ej)
    h_bg = c.submit(ej)
    assert started.wait(30)
    h_hi = c.submit(mk_job("hi", 10, 1.0, prio=5), runners=[urgent])
    c.drain()
    c.shutdown()
    assert h_bg.status is JobStatus.DONE and h_hi.status is JobStatus.DONE
    assert sched.preemptions == 1
    assert marks["victim_exit"] <= marks["urgent_begin"] \
        <= marks["victim_resumed"]
    assert marks["urgent_begin"] - marks["noticed"] >= 0.25
    events = c.trace.events()
    # the scheduler's decisions are the reference's: ADMIT hi, EVICT bg at
    # once; only hi's BEGIN moved past the victim's exit
    kinds = [(e.kind, e.name) for e in events
             if e.kind in (ev.ADMIT, ev.EVICT, ev.BEGIN)]
    assert kinds[:4] == [(ev.ADMIT, "bg"), (ev.BEGIN, "bg"),
                         (ev.ADMIT, "hi"), (ev.EVICT, "bg")]
    t_admit_hi = next(e.t for e in events
                      if e.kind == ev.ADMIT and e.name == "hi")
    t_begin_hi = next(e.t for e in events
                      if e.kind == ev.BEGIN and e.name == "hi")
    assert t_begin_hi - t_admit_hi >= 0.25
    assert len([r for r in h_bg.records if not r.crashed]) == 1
    assert_zeroed(sched)


def test_fence_leaves_other_devices_alone():
    """An evicted attempt holds back only the devices it holds: a task
    admitted on another device begins while the victim is still
    returning."""
    pol = PreemptionPolicy(min_runtime_s=0.0, budget=3)
    sched = PreemptiveAlg3Scheduler(2, preempt_policy=pol)
    c = live_cluster(sched, 3)
    marks = {}
    started = threading.Event()
    box = []

    def victim(device):
        if "victim_exit" in marks:
            return
        started.set()
        box[0].preempted.wait(30)
        time.sleep(0.5)
        marks["victim_exit"] = time.monotonic()

    # the blocker fills device 1 with the preemptor's class: never a victim
    blocker_go = threading.Event()
    ej = ExecJob(job=mk_job("bg", 10, 10.0), runners=[victim])
    box.append(ej)
    c.submit(ej)
    assert started.wait(30)
    c.submit(mk_job("blocker", 8, 1.0, prio=5),
             runners=[lambda d: blocker_go.wait(30)])
    c.submit(mk_job("hi", 10, 1.0, prio=5),
             runners=[lambda d: marks.setdefault("hi", time.monotonic())])
    time.sleep(0.1)
    # a task that fits beside the blocker on device 1 only (8 + 7 GB of
    # 16; 10 + 7 on device 0 do not fit) begins there while the victim on
    # device 0 is still returning
    c.submit(mk_job("small", 7, 1.0, prio=5),
             runners=[lambda d: marks.setdefault("small", time.monotonic())])
    time.sleep(0.2)
    blocker_go.set()
    c.drain()
    c.shutdown()
    assert sched.preemptions == 1
    assert marks["small"] < marks["victim_exit"] <= marks["hi"]
    assert_zeroed(sched)


# ---------------------------------------------------------------------------
# a preempted training task resumes to the uninterrupted run
# ---------------------------------------------------------------------------

def _preempted_training(device, ckpt_dir, steps=5, at=2, arch="gemma2-9b"):
    """``launch.train``'s task on one device under a preemptive Algorithm 3
    whose memory holds the training task or a synthetic urgent task, not
    both; the urgent task arrives once step ``at`` has finished, from the
    step hook, and evicts the training task, which saves step ``at`` and
    resumes from it once the urgent task is done. Returns (the run's
    result, the scheduler, the urgent task's handle, marks, the cluster,
    the run)."""
    from repro_torch.launch import train as LT
    dev = torch.device(device)
    marks = {}
    box = {}

    def on_step(k):
        if k == at and "urgent" not in box:
            box["urgent"] = cluster.submit(urgent, priority=5,
                                           deadline_s=60.0)

    run = LT.train_job(arch, steps=steps, batch=2, seq=64, device=dev,
                       ckpt_dir=ckpt_dir, ckpt_every=100, lr=1e-3,
                       log_every=100, on_step=on_step, keep_state=True)
    hbm = 2 * run.vec.hbm_bytes
    urgent_vec = ResourceVector(hbm_bytes=hbm - run.vec.hbm_bytes // 2,
                                flops=1e9, bytes_accessed=1e9,
                                est_seconds=0.1, core_demand=0.5,
                                bw_demand=0.3)
    urgent = ExecJob(job=Job(tasks=[Task(units=[UnitTask(
        fn=None, memobjs=frozenset({"urgent"}), resources=urgent_vec,
        name="urgent")], name="urgent")], name="urgent"),
        runners=[lambda d: marks.setdefault("urgent_begin",
                                            time.monotonic())])
    sched = PreemptiveAlg3Scheduler(
        1, hbm_per_device=hbm,
        preempt_policy=PreemptionPolicy(min_runtime_s=0.0))
    cluster = Cluster(sched, workers=2, devices=[dev], trace=True)
    t0 = time.time()
    h = cluster.submit(run.ej)
    cluster.drain()
    cluster.shutdown()
    run.close()
    out = run.result(h.status, h.job.error, time.time() - t0)
    return out, sched, box["urgent"], marks, cluster, run


def _assert_resumed_equals_uninterrupted(device, tmp_path):
    from repro_torch.launch.train import train
    got, sched, urgent, marks, cluster, _ = _preempted_training(
        device, str(tmp_path))
    assert got["status"] == "done" and urgent.status is JobStatus.DONE
    assert sched.preemptions == 1
    assert eviction_order(cluster.trace.events()) == ["train"]
    a1, a2 = got["attempts"]
    assert a1["start"] == 0 and a1["evicted_at"] == 2 and a2["start"] == 2
    assert len(got["notices"]) == 1
    # the urgent task began only after the evicted attempt had returned
    assert a1["t_exit"] <= marks["urgent_begin"]
    # uninterrupted: alone under a preemptive scheduler of its own, at a
    # priority and with a deadline (nothing outranks it)
    want = train("gemma2-9b", steps=5, batch=2, seq=64, device=device,
                 lr=1e-3, log_every=100, keep_state=True,
                 scheduler=PreemptiveAlg3Scheduler(1), priority=3,
                 deadline_s=600.0)
    assert want["attempts"] == [dict(want["attempts"][0], start=0)]
    assert got["losses"] == want["losses"]
    assert got["grad_norms"] == want["grad_norms"]
    for g, w in zip(tree_leaves((got["params"], got["opt_state"])),
                    tree_leaves((want["params"], want["opt_state"]))):
        assert (torch.equal(g, w) if isinstance(g, torch.Tensor)
                else g == w)


def test_preempted_training_resumes_to_the_uninterrupted_run(tmp_path):
    """Reduced gemma2-9b, 5 steps on the CPU, evicted after step 2 by an
    urgent task that does not fit beside it: the second attempt restores
    step 2 from the checkpoint the eviction saved, and its losses,
    grad norms, parameters and moments equal an uninterrupted run's bit
    for bit."""
    _assert_resumed_equals_uninterrupted("cpu", tmp_path)


@pytest.mark.gpu
def test_preempted_training_resumes_to_the_uninterrupted_run_on_card(
        tmp_path):
    """The same on the card: the hand kernels and their backward kernels
    are deterministic, so the resumed run repeats the uninterrupted one
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels run there")
    _assert_resumed_equals_uninterrupted("cuda", tmp_path)


def test_resumed_training_takes_its_own_step_not_a_later_one_on_disk(
        tmp_path):
    """The checkpoint directory already holds a later committed step (9)
    from an older run with another seed: the evicted run resumes from the
    step its eviction saved (2), not the newest on disk, and still equals
    the uninterrupted run."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as CK
    cfg = get_arch("gemma2-9b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(1))
    opt = adamw.init_state(adamw.AdamWConfig(
        moment_dtype=cfg.optimizer_moment_dtype), params)
    CK.save(str(tmp_path), 9, {"params": params, "opt": opt})
    assert CK.latest_step(str(tmp_path)) == 9
    _assert_resumed_equals_uninterrupted("cpu", tmp_path)


def test_evicted_training_without_a_checkpoint_dir_uses_a_temporary_one():
    """With no ``ckpt_dir`` an eviction checkpoints under a temporary
    directory that the run removes when it closes."""
    out, sched, _, _, _, run = _preempted_training("cpu", None, steps=3,
                                                   at=1)
    assert out["status"] == "done" and sched.preemptions == 1
    assert [a["start"] for a in out["attempts"]] == [0, 1]
    assert run.tmp_dir is None and run.ckpt is not None
    assert not os.path.exists(run.ckpt.ckpt_dir)


# ---------------------------------------------------------------------------
# static serving under preemption (launch/serve.py --preempt, batch_job)
# ---------------------------------------------------------------------------

def _two_batches(cfg, prompt_len=16):
    """The prompts of ``serve``'s first two batches of 4 (seed 0)."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.integers(0, cfg.vocab, (4, prompt_len),
                                          dtype=np.int64))
            for _ in range(2)]


def test_static_serving_preempts_an_earlier_batch_and_serves_it_again():
    """Two static batches (``batch_job``) of reduced gemma2-9b on a CPU
    device that holds one, under the preemptive Algorithm 3: the second,
    submitted as the first begins with the earlier deadline, outranks it
    (EDF within the class) and evicts it; the first is requeued and served
    again from its prompt. Both batches' tokens equal ``serve``'s for the
    same prompts."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve as LS
    plain = LS.serve("gemma2-9b", requests=8, batch=4, prompt_len=16,
                     gen_len=8, device="cpu")
    cfg = get_arch("gemma2-9b").reduced()
    first, second = (LS.batch_job(cfg, p, gen_len=8,
                                  param_dtype=torch.float32, device="cpu",
                                  name=f"req{i}")
                     for i, p in enumerate(_two_batches(cfg)))
    sched = PreemptiveAlg3Scheduler(
        1, hbm_per_device=first.vec.hbm_bytes * 3 // 2, preempt_policy=FAST)
    c = live_cluster(sched, 2, preempt=True, trace=True)
    inner, box = first.ej.runners[0], {}

    def runner(d):
        if not box:  # the second batch arrives as the first begins
            box["h"] = c.submit(second.ej, deadline_s=1.0)
        inner(d)

    first.ej.runners[0] = runner
    h = c.submit(first.ej, deadline_s=100.0)
    c.drain()
    stats = c.stats()
    c.shutdown()
    assert h.status is JobStatus.DONE and box["h"].status is JobStatus.DONE
    assert stats["preemptions"] == 1 and stats["migrations"] == 0
    assert eviction_order(c.trace.events()) == ["req0"]
    assert admission_order(c.trace.events()) == ["req0", "req1", "req0"]
    assert first.result["attempts"] == 2 and second.result["attempts"] == 1
    np.testing.assert_array_equal(first.result["tokens"],
                                  plain["generated"][0])
    np.testing.assert_array_equal(second.result["tokens"],
                                  plain["generated"][1])


def test_serve_preempt_serves_an_evicted_batch_again_from_its_prompt(
        monkeypatch):
    """``serve(preempt=True)``: its static runner is cooperative. With the
    second batch given the earlier deadline (a cluster that sets it on
    submit) it evicts the first, which is requeued and served again from
    its prompt; the tokens equal a serve without preemption, and the result
    counts the preemption."""
    from repro_torch.launch import serve as LS
    kw = dict(requests=8, batch=4, prompt_len=16, gen_len=8,
              device="cpu")
    plain = LS.serve("gemma2-9b", **kw)
    one = plain["probe"].hbm_bytes
    # one batch's memory, and no residency guard (the second batch arrives
    # right after the first)
    monkeypatch.setattr(LS, "serving_devices",
                        lambda n, d: ([CPU], one + one // 2))
    monkeypatch.setattr(LS, "PreemptiveAlg3Scheduler",
                        lambda *a, **kw: PreemptiveAlg3Scheduler(
                            *a, preempt_policy=FAST, **kw))

    class SecondFirst(Cluster):
        def submit(self, ej, **kw):
            if ej.job.name == "req1":
                kw["deadline_s"] = 1.0
            return super().submit(ej, **kw)

    monkeypatch.setattr(LS, "Cluster", SecondFirst)
    res = LS.serve("gemma2-9b", **kw, preempt=True, deadline_s=100.0)
    assert res["completed"] == 2 and res["crashed"] == 0
    assert res["preemptions"] == 1 and res["migrations"] == 0
    assert res["tokens_generated"] == plain["tokens_generated"]
    for got, want in zip(res["generated"], plain["generated"]):
        np.testing.assert_array_equal(got, want)


def test_a_cooperative_decoder_stops_between_steps():
    """``GreedyDecoder.generate(stop=...)`` asks before each step and
    returns None once told to stop, launching no further step."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import init_params
    from repro_torch.serve.decode import GreedyDecoder, decode_buffers
    cfg = get_arch("gemma2-9b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    dec = GreedyDecoder(cfg, params, decode_buffers(cfg, 2, 16,
                                                    torch.float32, CPU))
    dec.load(dec.cache, torch.zeros(2, dtype=torch.int32), 0)
    asked = []
    assert dec.generate(5, stop=lambda: asked.append(1) or len(asked) > 3) \
        is None
    assert len(asked) == 4 and int(dec.pos) == 3
    dec.load(dec.cache, torch.zeros(2, dtype=torch.int32), 0)
    assert dec.generate(5, stop=lambda: False).shape == (2, 5)


def test_a_batch_job_brings_its_weights_and_serves_the_batch():
    """``batch_job`` on the CPU: its runner makes the weights from the
    seed, and its tokens equal ``serve``'s for the same prompts; its probe
    charges the weights and covers the static probe (on this tiny config
    the prefill's peak is the larger; the decoder's buffers and a step
    come after it)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve as LS
    from repro_torch.models.model import init_params
    plain = LS.serve("gemma2-9b", requests=4, batch=4, prompt_len=16,
                     gen_len=8, device="cpu")
    cfg = get_arch("gemma2-9b").reduced()
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16),
                                           dtype=np.int64))
    bj = LS.batch_job(cfg, tokens, gen_len=8, param_dtype=torch.float32,
                      device="cpu", name="urgent")
    c = live_cluster(MGBAlg3Scheduler(1), 1)
    h = c.submit(bj.ej, priority=5, deadline_s=60.0)
    c.drain()
    c.shutdown()
    assert h.status is JobStatus.DONE and bj.result["attempts"] == 1
    np.testing.assert_array_equal(bj.result["tokens"], plain["generated"][0])
    weights = sum(p.numel() * p.element_size() for p in tree_leaves(
        init_params(cfg, None, torch.float32, torch.device("meta"))))
    assert bj.vec.hbm_bytes >= plain["probe"].hbm_bytes >= weights
    # the decode step is traced too
    assert bj.vec.flops > plain["probe"].flops


@pytest.mark.parametrize("smoke", [True, False])
def test_preempt_bench_equals_the_reference_benchmark(smoke, monkeypatch):
    """``repro_torch.bench.preempt``'s four systems give the reference
    benchmark's rows on the same seeded trace, and every band line
    passes."""
    import importlib
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ref = importlib.import_module("benchmarks.bench_preempt")
    from repro_torch.bench import preempt as TP
    kw = (dict(n_devices=2, n_background=3, n_bystander=2, n_urgent=5)
          if smoke else {})
    assert TP.compare(0, **kw) == ref.compare(0, **kw)
    fifo, edf, shed, pre = TP.run(0, smoke=True)["rows"] if smoke \
        else TP.compare(0)
    assert pre["preemptions"] > 0 and pre["nonpreempted_slowdown_pct"] <= 2.5
    for other in (fifo, edf, shed):
        assert pre["deadline_met_rate"] >= other["deadline_met_rate"]
        assert pre["urgent_turn_p99_s"] <= other["urgent_turn_p99_s"]


# ---------------------------------------------------------------------------
# the polling baseline and the closed-batch shim (the reference's
# tests/test_executor_async.py, on the CPU)
# ---------------------------------------------------------------------------

def test_run_empty_returns_zeroed_metrics_on_both_executors():
    from repro_torch.core.executor import Executor, PollingExecutor
    for cls in (Executor, PollingExecutor):
        stats = cls(MGBAlg3Scheduler(2), workers=2, devices=[CPU]).run([])
        assert stats["completed"] == 0 and stats["crashed"] == 0
        assert stats["makespan_s"] == 0.0
        assert stats["mean_turnaround_s"] == 0.0


def test_event_and_polling_executors_agree_on_outcome():
    """Ten 3 GB jobs on two 16 GB CPU devices: the event-driven engine and
    the polling baseline complete all of them, and a job that can never
    fit crashes on the polling path with ``OOMError``'s record."""
    from repro_torch.core.executor import Executor, PollingExecutor

    def jobs():
        return [ExecJob(job=mk_job(f"j{i}", 3.0, 1.0),
                        runners=[lambda d: time.sleep(0.001)])
                for i in range(10)]
    ev_stats = Executor(MGBAlg3Scheduler(2), workers=4,
                        devices=[CPU]).run(jobs())
    po = PollingExecutor(MGBAlg3Scheduler(2), workers=4, devices=[CPU])
    po_stats = po.run(jobs())
    assert ev_stats["completed"] == po_stats["completed"] == 10
    assert ev_stats["crashed"] == po_stats["crashed"] == 0
    assert po_stats["sched_attempts"] >= 10
    big = ExecJob(job=mk_job("huge", 40.0, 1.0), runners=[lambda d: None])
    stats = PollingExecutor(MGBAlg3Scheduler(1), workers=1,
                            devices=[CPU]).run([big])
    assert stats["crashed"] == 1 and big.job.crashed


def test_a_held_back_write_commits_on_wait(tmp_path):
    """``AsyncCheckpointer.save(..., start=False)`` copies the state and
    holds its write back (an evicted task leaves it to its next attempt);
    ``commit()`` starts it, ``wait()`` commits it too, and a later save
    commits it first."""
    from repro_torch.train import checkpoint as CK
    state = {"w": torch.arange(6.0), "step": 3}
    ck = CK.AsyncCheckpointer(str(tmp_path / "a"))
    ck.save(3, state, start=False)
    state["w"].add_(1.0)        # the copy was taken at save
    assert CK.latest_step(ck.ckpt_dir) is None
    ck.wait()
    assert CK.latest_step(ck.ckpt_dir) == 3 and ck.last_committed == 3
    _, back = CK.restore(ck.ckpt_dir, {"w": torch.zeros(6), "step": 0})
    assert torch.equal(back["w"], torch.arange(6.0)) and back["step"] == 3
    ck2 = CK.AsyncCheckpointer(str(tmp_path / "b"), keep=5)
    ck2.save(4, state, start=False)
    ck2.save(5, state)
    ck2.wait()
    assert CK.latest_step(ck2.ckpt_dir) == 5
    assert CK.restore(ck2.ckpt_dir, {"w": torch.zeros(6), "step": 0},
                      step=4)[0] == 4
    ck3 = CK.AsyncCheckpointer(str(tmp_path / "c"))
    ck3.save(6, state, start=False)
    ck3.commit()
    ck3.wait()
    assert ck3.last_committed == 6 == CK.latest_step(ck3.ckpt_dir)


def test_a_checkpointer_restores_its_last_save_from_the_host_copy(tmp_path):
    """``AsyncCheckpointer.restore_into`` copies the last save's host copy
    into a state in place, committed or not, whatever the directory holds;
    a state of another shape is refused."""
    from repro_torch.train import checkpoint as CK
    ck = CK.AsyncCheckpointer(str(tmp_path))
    assert ck.saved_step is None
    with pytest.raises(FileNotFoundError):
        ck.restore_into({"w": torch.zeros(6), "step": 0})
    CK.save(str(tmp_path), 9, {"w": torch.full((6,), 9.0), "step": 9})
    state = {"w": torch.arange(6.0), "step": 3}
    ck.save(3, state, start=False)
    state["w"].add_(1.0)
    into = {"w": torch.zeros(6), "step": 0}
    w = into["w"]
    step, back = ck.restore_into(into)
    assert step == 3 == ck.saved_step and back["step"] == 3
    assert back["w"] is w and torch.equal(w, torch.arange(6.0))
    assert CK.latest_step(str(tmp_path)) == 9      # the write still held
    with pytest.raises(ValueError):
        ck.restore_into({"w": torch.zeros(5), "step": 0})
    ck.wait()
