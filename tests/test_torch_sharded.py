"""The port's sharded control plane and gang workloads against the JAX
package's: ``ShardedScheduler`` (one gang engine per pod, cross-pod work
stealing, re-homing after pod death, placement translation) and
``SliceScheduler`` driven with the same task streams in both packages, on
the scheduler surface and on the sim backend; the observability fan-outs
to the shards (tracer, explainer, calibration store); and ``gang_mix`` /
``split_gangs``, which must draw the same vectors for the same seeds.

Mirrors ``tests/test_sched_scale.py`` (the sharded battery),
``tests/test_introspection.py`` (explainer fan-out, steal verdicts) and
``tests/test_profile.py`` (calibrator fan-out)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

from repro.core import scheduler as JSCH  # noqa: E402
from repro.core import task as JT  # noqa: E402
from repro.core import workloads as JW  # noqa: E402
from repro.core.cluster import Cluster as JaxCluster  # noqa: E402
from repro.obs import calibrate as jcal  # noqa: E402
from repro.obs import events as jev  # noqa: E402
from repro.obs import explain as jobsx  # noqa: E402
from repro_torch.core import scheduler as TSCH  # noqa: E402
from repro_torch.core import task as TT  # noqa: E402
from repro_torch.core import workloads as TW  # noqa: E402
from repro_torch.core.cluster import Cluster, JobStatus  # noqa: E402
from repro_torch.core.scheduler.base import DEADLINE_SHED  # noqa: E402
from repro_torch.obs import calibrate as tcal  # noqa: E402
from repro_torch.obs import events as tev  # noqa: E402
from repro_torch.obs import explain as tobsx  # noqa: E402
from repro_torch.obs.replay import diff_streams  # noqa: E402

GB = 1024**3
# (scheduler module, task module, cluster class, obs events, obs explain,
#  obs calibrate) of each package
JAX = (JSCH, JT, JaxCluster, jev, jobsx, jcal)
PORT = (TSCH, TT, Cluster, tev, tobsx, tcal)


def mk_task(task_mod, name, mem_gb=2.0, demand=0.5, chips=1, est=10.0):
    vec = task_mod.ResourceVector(hbm_bytes=int(mem_gb * GB), flops=1e12,
                                  bytes_accessed=1e9, est_seconds=est,
                                  core_demand=demand, bw_demand=demand,
                                  chips=chips)
    unit = task_mod.UnitTask(fn=None, memobjs=frozenset({f"{name}/ws"}),
                             resources=vec, name=name)
    return task_mod.Task(units=[unit], name=name,
                         gang_id=name if chips > 1 else None)


def _collector():
    """Admission log (task, flat placement): a gang shard's
    ``GangReservation`` is reduced to its globally translated ``lead``."""
    admitted = []

    def cb(t, placement, epoch):
        if placement is not None and placement is not DEADLINE_SHED \
                and not isinstance(placement, int):
            placement = placement.lead
        admitted.append((t, placement))
    return admitted, cb


def _state(sched, admitted):
    """What the two packages must agree on after a scenario."""
    return {"admitted": [(t.name, p if isinstance(p, int) else str(p))
                         for t, p in admitted],
            "steals": sched.steals, "rehomes": sched.rehomes,
            "waiting": sched.waiting_count(),
            "queue_stats": sched.queue_stats(),
            "used_hbm": [d.used_hbm for d in sched.devices],
            "alive": [d.alive for d in sched.devices]}


# ---------------------------------------------------------------------------
# scenarios of tests/test_sched_scale.py, each run on one package
# ---------------------------------------------------------------------------

def _no_task_lost(pkg):
    sched_mod, task_mod = pkg[:2]
    sched = sched_mod.ShardedScheduler(pods=2, rows=2, cols=2)
    admitted, cb = _collector()
    tasks = [mk_task(task_mod, f"t{i}", mem_gb=8.0) for i in range(30)]
    for t in tasks:
        sched.admit_or_enqueue(t, cb)
    guard = 0
    while len(admitted) < len(tasks):
        guard += 1
        assert guard < 200, f"stalled at {len(admitted)}/{len(tasks)}"
        t, _ = admitted[guard - 1]
        sched.task_end(t)
    assert sorted(t.name for t, _ in admitted) \
        == sorted(t.name for t in tasks)
    assert len({t.uid for t, _ in admitted}) == len(tasks)
    assert sched.waiting_count() == 0
    return _state(sched, admitted)


def _steals(pkg):
    sched_mod, task_mod = pkg[:2]
    sched = sched_mod.ShardedScheduler(pods=2, rows=2, cols=2)
    admitted, cb = _collector()
    n_dev = len(sched.devices)
    for i in range(n_dev + 10):                 # fill fleet + park 10
        sched.admit_or_enqueue(mk_task(task_mod, f"t{i}", mem_gb=16.0), cb)
    assert sched.waiting_count() == 10
    ended = set()
    guard = 0
    while sched.waiting_count() and guard < 100:
        guard += 1
        vic = next(t for t, p in admitted if p < 4 and t.uid not in ended)
        ended.add(vic.uid)
        sched.task_end(vic)
    assert sched.waiting_count() == 0
    assert sched.steals > 0
    assert len(admitted) == n_dev + 10
    qs = sched.queue_stats()
    assert qs["steals"] == sched.steals and qs["depth"] == 0
    return _state(sched, admitted)


def _pod_death(pkg):
    sched_mod, task_mod = pkg[:2]
    sched = sched_mod.ShardedScheduler(pods=2, rows=2, cols=2)
    admitted, cb = _collector()
    for i in range(8):                          # exactly fill both shards
        sched.admit_or_enqueue(mk_task(task_mod, f"t{i}", mem_gb=16.0), cb)
    assert len(admitted) == 8 and sched.waiting_count() == 0
    sched.admit_or_enqueue(mk_task(task_mod, "parked", mem_gb=16.0), cb)
    evicted = []
    for d in range(4):                          # shard 0's global indices
        evicted.extend(sched.mark_dead(d))
    assert len(evicted) == 4
    assert sched.waiting_count() == 5
    assert sched.rehomes >= 4
    ended = set()
    guard = 0
    while sched.waiting_count() and guard < 20:
        guard += 1
        vic = next(t for t, p in admitted if p >= 4 and t.uid not in ended)
        ended.add(vic.uid)
        sched.task_end(vic)
    assert sched.waiting_count() == 0
    post_death = admitted[8:]
    assert {t.name for t, _ in post_death} \
        == {t.name for t in evicted} | {"parked"}
    assert all(isinstance(p, int) and p >= 4 for _, p in post_death)
    out = _state(sched, admitted)
    out["evicted"] = [t.name for t in evicted]
    return out


def _placement_translation(pkg):
    sched_mod, task_mod = pkg[:2]
    sched = sched_mod.ShardedScheduler(pods=2, rows=2, cols=2)
    admitted, cb = _collector()
    for i in range(8):
        sched.admit_or_enqueue(mk_task(task_mod, f"t{i}", mem_gb=16.0), cb)
    assert sorted(p for _, p in admitted) == list(range(8))
    assert len(sched.devices) == 8
    return _state(sched, admitted)


def _gangs_and_singles(pkg):
    """Gangs of 2 and 4 chips between singles, with completions that
    free whole pods: gang reservations translate to flat indices, and
    ports of steals follow the same admissions in both packages."""
    sched_mod, task_mod = pkg[:2]
    sched = sched_mod.ShardedScheduler(pods=2, rows=2, cols=2)
    admitted, cb = _collector()
    stream = [("s0", 6.0, 1), ("g0", 24.0, 2), ("s1", 12.0, 1),
              ("g1", 40.0, 4), ("s2", 14.0, 1), ("g2", 30.0, 2),
              ("s3", 3.0, 1), ("g3", 50.0, 4), ("s4", 15.0, 1)]
    for name, gb, chips in stream:
        sched.admit_or_enqueue(mk_task(task_mod, name, mem_gb=gb,
                                       chips=chips), cb)
    guard = 0
    while sched.waiting_count() and guard < 50:
        t, _ = admitted[guard]
        guard += 1
        sched.task_end(t)
    assert sched.waiting_count() == 0
    assert sorted(t.name for t, _ in admitted) == sorted(n for n, *_ in
                                                          stream)
    return _state(sched, admitted)


def _spanning_gang(pkg):
    sched_mod, task_mod, cluster_cls = pkg[:3]
    sched = sched_mod.ShardedScheduler(pods=2, rows=2, cols=2)
    wide = mk_task(task_mod, "wide", mem_gb=8.0 * 8, chips=8)
    assert not sched.can_ever_fit(wide)
    reason = sched.infeasible_reason(wide)
    assert "pod" in reason
    c = cluster_cls(sched_mod.ShardedScheduler(pods=2, rows=2, cols=2),
                    workers=2, backend="sim")
    h = c.submit(task_mod.Job(tasks=[mk_task(task_mod, "wide2", mem_gb=64.0,
                                             chips=8, est=1.0)],
                              name="wide2"))
    c.drain()
    return {"reason": reason, "status": h.status.value,
            "error": str(h.job.error)}


def _slice(pkg):
    """``SliceScheduler`` (the gang engine at Alg. 3, pod defaults) on a
    small grid: admissions of gangs and singles as flat lead indices."""
    sched_mod, task_mod = pkg[:2]
    sched = sched_mod.SliceScheduler(pods=1, rows=2, cols=4)
    admitted, cb = _collector()
    for name, gb, chips in [("a", 20.0, 4), ("b", 8.0, 1), ("c", 30.0, 2),
                            ("d", 60.0, 4), ("e", 2.0, 1)]:
        sched.admit_or_enqueue(mk_task(task_mod, name, mem_gb=gb,
                                       chips=chips), cb)
    first = [(t.name, p) for t, p in admitted]
    for t, _ in list(admitted):
        sched.task_end(t)
    assert sched.name == "MGB-slice"
    return {"first": first, "all": [(t.name, p) for t, p in admitted],
            "waiting": sched.waiting_count(),
            "used_hbm": [d.used_hbm for d in sched.devices]}


SCENARIOS = {"no_task_lost": _no_task_lost, "steals": _steals,
             "pod_death": _pod_death,
             "placement_translation": _placement_translation,
             "gangs_and_singles": _gangs_and_singles,
             "spanning_gang": _spanning_gang, "slice": _slice}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_sharded_scenario_equals_the_jax_package(scenario):
    """Each scenario of the reference battery holds on the port, and the
    admission log, flat placements, ``steals``, ``rehomes`` and
    ``queue_stats()`` equal the JAX package's."""
    run = SCENARIOS[scenario]
    assert run(PORT) == run(JAX)


# ---------------------------------------------------------------------------
# the sim backend: a gang trace under the sharded scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_gang_mix_on_the_sim_backend_equals_the_jax_package(seed):
    """``gang_mix`` (synthetic singles) through each package's
    ``ShardedScheduler`` on the sim backend, with a pod death part way:
    the same ``SimResult``, event stream, steals and re-homes."""
    out = []
    for pkg, wl in ((JAX, JW), (PORT, TW)):
        sched_mod, _, cluster_cls = pkg[:3]
        sched = sched_mod.ShardedScheduler(pods=2, rows=2, cols=2)
        c = cluster_cls(sched, workers=64, backend="sim", trace=True)
        for job in wl.gang_mix(seed, probe_singles=False, n_singles=10,
                               n_gangs=6):
            c.submit(job)
        c.run_until(12.0)
        c.inject_failure(1)
        c.drain()
        out.append((c._sim.result(), c.trace.events(), sched.steals,
                    sched.rehomes, c.stats()))
    (jres, jevents, jst, jre, jstats), (tres, tevents, tst, tre, tstats) = out
    for f in ("completed", "crashed", "cancelled", "shed"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert tres.makespan == pytest.approx(jres.makespan, rel=1e-12, abs=0)
    assert sorted(tres.turnaround) == sorted(jres.turnaround)
    for k, v in jres.turnaround.items():
        assert tres.turnaround[k] == pytest.approx(v, rel=1e-12, abs=0)
    assert diff_streams(jevents, tevents, with_device=True) is None
    assert [(e.kind, e.name, e.device) for e in tevents] \
        == [(e.kind, e.name, e.device) for e in jevents]
    assert (tst, tre) == (jst, jre)
    assert tstats["completed"] == jstats["completed"] > 0


# ---------------------------------------------------------------------------
# observability fan-out to the shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_attach_explainer_and_tracer_fan_out_to_shards(pkg):
    sched_mod, events, explain = pkg[0], pkg[3], pkg[4]
    sched = sched_mod.ShardedScheduler(pods=2, rows=2, cols=2)
    ex = explain.attach_explainer(sched, explain.Explainer())
    assert sched._explain is ex
    assert all(sh._explain is ex for sh in sched.shards)
    assert [sh._trace_dev_off for sh in sched.shards] == [0, 4]
    tr = events.attach_tracer(sched, events.Tracer())
    assert sched._trace is tr and all(sh._trace is tr for sh in sched.shards)


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_attach_calibrator_fans_out_to_shards(pkg):
    sched_mod, calibrate = pkg[0], pkg[5]
    sched = sched_mod.ShardedScheduler(pods=2, rows=2, cols=2)
    store = calibrate.attach_calibrator(sched)
    assert sched._calib is store
    assert all(sh._calib is store for sh in sched.shards)


def _steal_verdicts(pkg):
    sched_mod, task_mod, _, events, explain = pkg[:5]
    sched = sched_mod.ShardedScheduler(pods=2, rows=2, cols=2)
    tracer = events.attach_tracer(sched, events.Tracer())
    ex = explain.attach_explainer(sched, explain.Explainer())
    placed, cb = _collector()
    for i in range(8):
        assert sched.admit_or_enqueue(mk_task(task_mod, f"s{i}",
                                              mem_gb=16.0), cb)
    gang = mk_task(task_mod, "gang", mem_gb=16.0, chips=2)
    sched.admit_or_enqueue(gang, cb)
    si = sched._owner[gang.uid]
    other = 1 - si
    on_other = [t for t, p in placed if p // 4 == other]
    # one free cell on the other shard: the 2-chip steal is refused
    sched.task_end(on_other[0])
    acts = [v.action for v in ex.verdicts(gang.uid)]
    assert explain.STEAL_REFUSED in acts and explain.STOLEN not in acts
    # a second free cell there: the steal goes through
    sched.task_end(on_other[1])
    acts = [v.action for v in ex.verdicts(gang.uid)]
    return {"actions": acts, "steals": sched.steals,
            "placed": [(t.name, p) for t, p in placed],
            "kinds": [(e.kind, e.name, e.device) for e in tracer.events()]}


def test_steal_verdicts_equal_the_jax_package():
    """``tests/test_introspection.py``'s steal refusal and success: the
    explainer's verdicts and the tracer's stream equal the reference's."""
    port, ref = _steal_verdicts(PORT), _steal_verdicts(JAX)
    assert port == ref
    assert port["steals"] >= 1


# ---------------------------------------------------------------------------
# gang workloads
# ---------------------------------------------------------------------------

def _vecs(jobs):
    return [(j.name, j.gang_id, j.priority,
             [(t.name, t.gang_id, dict(vars(t.resources)),
               sorted(u.memobjs for u in t.units)) for t in j.tasks])
            for j in jobs]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_gang_mix_and_split_gangs_equal_the_jax_package(seed):
    """Same seed, same jobs: ``gang_mix(probe_singles=False)`` and its
    chips-oblivious ``split_gangs`` view give the JAX package's names,
    vectors and memory objects."""
    jj = JW.gang_mix(seed, probe_singles=False)
    tj = TW.gang_mix(seed, probe_singles=False)
    assert _vecs(tj) == _vecs(jj)
    assert any(t.resources.chips > 1 for j in tj for t in j.tasks)
    assert _vecs(TW.split_gangs(tj)) == _vecs(JW.split_gangs(jj))
    assert (TW._PEAK_FLOPS, TW._HBM_BW, TW._ICI_BW) \
        == (JW._PEAK_FLOPS, JW._HBM_BW, JW._ICI_BW)


def test_make_gang_job_and_split_refusal_equal_the_jax_package():
    jj = JW.make_gang_job(np.random.default_rng(5), chips=4, name="g")
    tj = TW.make_gang_job(np.random.default_rng(5), chips=4, name="g")
    assert _vecs([tj]) == _vecs([jj])
    two = TT.Job(tasks=tj.tasks + [mk_task(TT, "x", chips=2)], name="two")
    with pytest.raises(ValueError, match="2 tasks"):
        TW.split_gangs([two])


def test_gang_mix_probes_its_singles_with_the_ports_probe():
    """``probe_singles=True`` draws the same families and footprints as
    the reference and probes them with the port's probe on the CPU."""
    jobs = TW.gang_mix(2, n_singles=3, n_gangs=2, device="cpu")
    singles = [j for j in jobs if j.tasks[0].resources.chips == 1]
    assert len(singles) == 3 and len(jobs) == 5
    assert all(j.tasks[0].resources.hbm_bytes > GB for j in singles)
    assert all(j.name.startswith("single") for j in singles)
    with pytest.raises(ValueError, match="2 tasks"):
        TW.split_gangs([TT.Job(tasks=[mk_task(TT, "a", chips=2),
                                      mk_task(TT, "b", chips=2)],
                               name="ab")])


def test_sharded_cluster_live_on_the_cpu():
    """The live backend under the port's ``ShardedScheduler``: a gang and
    singles on a 1 x 1 x 2 fleet of CPU devices run to DONE."""
    devs = [torch.device("cpu")] * 2
    sched = TSCH.ShardedScheduler(pods=1, rows=1, cols=2)
    c = Cluster(sched, workers=2, devices=devs)
    ran = []
    hs = [c.submit(TT.Job(tasks=[mk_task(TT, f"s{i}", mem_gb=4.0)],
                          name=f"s{i}"),
                   runners=[lambda device, i=i: ran.append(i)])
          for i in range(3)]
    g = mk_task(TT, "g", mem_gb=8.0, chips=2)
    hs.append(c.submit(TT.Job(tasks=[g], name="g", gang_id="g"),
                       runners=[lambda device: ran.append("g")]))
    c.drain()
    c.shutdown()
    assert all(h.status is JobStatus.DONE for h in hs)
    assert sorted(map(str, ran)) == ["0", "1", "2", "g"]
