"""The port's observability plane against the JAX package's, and its own
surface: trace export, per-task profiles, online probe calibration, SLO
monitoring, what-if replay and the ``top`` dashboard (copies of
``src/repro/obs/{export,profile,calibrate,slo,whatif}.py`` and
``src/repro/launch/top.py``) driven on the sim backend with the same seeds
in both packages; the port's ``Cluster`` surface (``explain=``,
``calibrate=``, ``metrics=``, ``flight_path=``, ``explain``, ``profile``,
``export_trace``) on the live backend with torch runners on the CPU;
``serve(..., trace_path=)``; and the executor's measured high-water on a
card (ROADMAP C16: the CPU path is the reference's, a lone attempt on a
card is measured, a shared one is not)."""
import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

from repro.core import scheduler as JSCH  # noqa: E402
from repro.core import workloads as JW  # noqa: E402
from repro.core.cluster import Cluster as JaxCluster  # noqa: E402
from repro.launch import top as jtop  # noqa: E402
from repro.obs import calibrate as jcal  # noqa: E402
from repro.obs import export as jexp  # noqa: E402
from repro.obs import metrics as jmet  # noqa: E402
from repro.obs import profile as jprof  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro.obs import whatif as jwif  # noqa: E402
from repro_torch.core import scheduler as TSCH  # noqa: E402
from repro_torch.core import workloads as TW  # noqa: E402
from repro_torch.core.cluster import Cluster, JobStatus  # noqa: E402
from repro_torch.core.executor import ExecJob  # noqa: E402
from repro_torch.core.preemption import PreemptionPolicy  # noqa: E402
from repro_torch.core.scheduler import MGBAlg3Scheduler  # noqa: E402
from repro_torch.core.task import (  # noqa: E402
    Job, ResourceVector, Task, UnitTask, observed_highwater,
)
from repro_torch.launch import top as ttop  # noqa: E402
from repro_torch.obs import calibrate as tcal  # noqa: E402
from repro_torch.obs import events as ev  # noqa: E402
from repro_torch.obs import explain as tx  # noqa: E402
from repro_torch.obs import export as texp  # noqa: E402
from repro_torch.obs import metrics as tmet  # noqa: E402
from repro_torch.obs import profile as tprof  # noqa: E402
from repro_torch.obs import slo as tslo  # noqa: E402
from repro_torch.obs import whatif as twif  # noqa: E402
from repro_torch.obs.replay import validate_lifecycles  # noqa: E402

GB = 1024**3
MiB = 1 << 20
CPU = torch.device("cpu")

# (scheduler module, workloads module, cluster class) of each package
JAX = (JSCH, JW, JaxCluster)
PORT = (TSCH, TW, Cluster)


def _policy(sched_mod):
    """The preemption policy class of ``sched_mod``'s package."""
    if sched_mod is JSCH:
        from repro.core.preemption import PreemptionPolicy as P
        return P
    return PreemptionPolicy


def overload_run(pkg, seed: int):
    """``overload_mix(seed)`` (shrunk) submitted at its rows' virtual times
    to the package's ``PreemptiveAlg3Scheduler`` on two sim devices:
    returns (cluster, event window)."""
    sched_mod, wl, cluster_cls = pkg
    sched = sched_mod.PreemptiveAlg3Scheduler(
        2, preempt_policy=_policy(sched_mod)(
            min_runtime_s=0.25, budget=3, aging_step=1,
            checkpoint_penalty_s=0.5))
    c = cluster_cls(sched, workers=64, backend="sim", trace=True)
    for row in wl.overload_mix(seed, n_background=4, n_bystander=2,
                               n_urgent=8):
        c.run_until(row["t"])
        c.submit(row["job"], priority=row["priority"],
                 deadline_s=row["deadline_s"])
    c.drain()
    return c, c.trace.events()


def drifting_run(pkg, seed: int, n_jobs: int = 120, **store_kw):
    """One calibrated sim pass of ``drifting_mix(seed)`` on eight devices,
    as the reference's ``benchmarks/bench_profile.py`` runs it."""
    sched_mod, wl, cluster_cls = pkg
    store = (jcal if pkg is JAX else tcal).CalibrationStore(**store_kw)
    c = cluster_cls(sched_mod.MGBAlg3Scheduler(8), backend="sim", trace=True,
                    calibrate=store)
    for row in wl.drifting_mix(seed, n_jobs=n_jobs):
        c.run_until(row["t"])
        c.submit(row["job"])
    c.drain()
    return c, store


def by_name(profs):
    """Profiles keyed by task name (uids are fresh per package)."""
    out = {}
    for p in profs.values():
        d = p.as_dict()
        d.pop("uid")
        out[p.name] = d
    return out


# ---------------------------------------------------------------------------
# the port against the JAX package, on the sim backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("counters", [False, True])
def test_chrome_trace_equals_the_jax_package(seed, counters):
    """The same ``overload_mix`` seed in both packages: ``to_chrome_trace``
    gives the same JSON (slice names, devices, timestamps, flows, the
    waiter counter and, with ``profile_counters``, the occupancy and
    prediction-error tracks) up to the packages' own task uids, and
    ``trace_summary`` and ``validate_chrome_trace`` agree."""
    docs = []
    for pkg, exp in ((JAX, jexp), (PORT, texp)):
        _, events = overload_run(pkg, seed)
        doc = exp.to_chrome_trace(events, profile_counters=counters)
        # uids number tasks per process: map each to its order of first
        # appearance so the two documents compare by position
        uids = {}
        for e in events:
            if e.uid >= 0:
                uids.setdefault(e.uid, len(uids))
        docs.append((_renumber(doc, uids), exp.trace_summary(doc),
                     exp.validate_chrome_trace(doc)))
    (jdoc, jsum, jval), (tdoc, tsum, tval) = docs
    assert tdoc == jdoc
    assert tsum == jsum and tsum["slices"] > 0 and tsum["flows"] > 0
    assert tval == jval == []


def _renumber(doc, uids):
    out = []
    for r in doc["traceEvents"]:
        r = dict(r)
        for k in ("tid", "id"):
            if k in r and r.get("cat") in ("occupancy", "task-flow"):
                r[k] = uids[r[k]]
        if "args" in r and "uid" in r["args"]:
            r["args"] = dict(r["args"], uid=uids[r["args"]["uid"]])
        out.append(r)
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_profiles_and_occupancy_equal_the_jax_package(seed):
    """``profiles_from_events`` and ``device_occupancy`` of the same
    ``overload_mix`` run give the same records in both packages (keyed by
    task name; uids differ), and ``Profiler.summary`` the same rollup."""
    out = []
    for pkg, prof in ((JAX, jprof), (PORT, tprof)):
        c, events = overload_run(pkg, seed)
        out.append((by_name(prof.profiles_from_events(events)),
                    prof.device_occupancy(events),
                    prof.Profiler(c.trace).summary()))
    (jp, jo, js), (tp, to, ts) = out
    assert tp == jp and len(tp) == 14
    assert any(p["evictions"] for p in tp.values())
    assert to == jo and set(to) == {0, 1}
    assert ts == js


@pytest.mark.parametrize("seed", [0, 1])
def test_calibrated_drifting_mix_equals_the_jax_package(seed):
    """A calibrated sim pass over ``drifting_mix(seed)``: the same
    ``accuracy_report()`` (and per-class rows) in both packages, and the
    port meets the reference benchmark's gates (``benchmarks/
    bench_profile.py``: improvement >= 2x, no memory violation, the
    profiler's summary memory-clean too)."""
    (jc, jstore), (tc, tstore) = drifting_run(JAX, seed), \
        drifting_run(PORT, seed)
    rep = tstore.accuracy_report()
    assert rep == jstore.accuracy_report()
    assert tstore.rows(limit=8) == jstore.rows(limit=8)
    assert rep["violations"] == 0 and rep["corrections"] > 0
    assert rep["paired"]["n"] > 0 and rep["paired"]["improvement"] >= 2.0
    summary = tc.profile()
    assert summary["memory_violations"] == 0
    assert summary["completed"] == summary["tasks"] == 120
    assert summary["calibration"] == rep
    assert validate_lifecycles(tc.trace.events(), require_terminal=True) \
        == []


def test_drifting_mix_rows_equal_the_jax_package():
    """``drifting_mix`` draws the same rows: arrival times, kinds, the
    predicted vectors (one per class) and each task's drifted truth."""
    for seed in (0, 5):
        rows = [wl.drifting_mix(seed, n_jobs=40) for wl in (JW, TW)]
        for j, t in zip(*rows):
            assert (t["t"], t["kind"], t["priority"], t["deadline_s"]) \
                == (j["t"], j["kind"], j["priority"], j["deadline_s"])
            jt, tt = j["job"].tasks[0], t["job"].tasks[0]
            assert tt.name == jt.name
            assert dataclasses.asdict(tt.resources) \
                == dataclasses.asdict(jt.resources)
            assert dataclasses.asdict(tt.true_vec) \
                == dataclasses.asdict(jt.true_vec)


def _slo_feed(slo_mod, met_mod):
    """One sequence of notes into a package's monitor and registry."""
    reg = met_mod.MetricsRegistry()
    mon = slo_mod.SLOMonitor.for_serving(
        reg, window=16, ttft_slo_s=0.5, tpot_slo_s=0.05,
        clock=iter(range(10_000)).__next__)
    rng = np.random.default_rng(0)
    for i in range(40):
        reg.hist("ttft_s").record(float(rng.uniform(0.1, 1.0)))
        reg.hist("tpot_s").record(float(rng.uniform(0.01, 0.08)))
        mon.note_deadline(bool(i % 3))
        mon.note_slowdown(f"t{i % 5}", float(rng.uniform(1.0, 1.06)), 1.0)
        mon.note_drift(f"t{i % 5}", 1.0, float(rng.uniform(0.5, 2.0)))
    reg.counter("requests").inc(40)
    reg.gauge("queue_depth").set(3)
    return mon, reg


def test_slo_monitor_and_prometheus_text_equal_the_jax_package():
    """The same notes into each package's ``SLOMonitor`` (fed by its
    ``MetricsRegistry`` through ``for_serving``): the same status, alerts
    and Prometheus text."""
    (jm, jr), (tm, tr) = _slo_feed(jslo, jmet), _slo_feed(tslo, tmet)
    assert tm.status() == jm.status()
    assert [tuple(a) for a in tm.alerts] == [tuple(a) for a in jm.alerts]
    assert tm.alerts, "no alert fired: the feed is too tame"
    text = tslo.prometheus_text(tr, tm)
    assert text == jslo.prometheus_text(jr, jm)
    assert "repro_slo_drift_burn" in text and "repro_ttft_s_count 40" in text


def test_slo_for_calibration_alerts_on_drift_like_the_jax_package():
    """``SLOMonitor.for_calibration`` on a calibrated ``drifting_mix``
    run: the drift stream fires the same alerts in both packages."""
    out = []
    for pkg, slo in ((JAX, jslo), (PORT, tslo)):
        sched_mod, wl, cluster_cls = pkg
        c = cluster_cls(sched_mod.MGBAlg3Scheduler(8), backend="sim",
                        trace=True, calibrate=True)
        mon = slo.SLOMonitor.for_calibration(c.calibration, window=16,
                                             clock=lambda: 0.0)
        for row in wl.drifting_mix(2, n_jobs=60):
            c.run_until(row["t"])
            c.submit(row["job"])
        c.drain()
        out.append((mon.status(), [tuple(a) for a in mon.alerts]))
    assert out[0] == out[1]
    assert out[1][1] and out[1][1][0][1] == "drift"


@pytest.mark.parametrize("seed", [0, 4])
def test_whatif_equals_the_jax_package(seed):
    """``whatif.reconstruct`` / ``replay`` / ``compare`` of the same
    recorded ``overload_mix`` run: the same submission trace, the same
    replayed headline metrics and the same report (FIFO and EDF against
    the recorded preemptive run), and a same-policy replay reproduces the
    recorded admissions and evictions exactly."""
    out = []
    for pkg, wif in ((JAX, jwif), (PORT, twif)):
        sched_mod = pkg[0]
        _, events = overload_run(pkg, seed)
        trace = wif.reconstruct(events)

        def factory(sched_mod=sched_mod):
            return sched_mod.PreemptiveAlg3Scheduler(
                2, preempt_policy=_policy(sched_mod)(
                    min_runtime_s=0.25, budget=3, aging_step=1,
                    checkpoint_penalty_s=0.5))

        same = wif.replay(trace, factory, workers=64)
        report = wif.compare(
            events, {"fifo": {"use_priorities": False,
                              "use_deadlines": False},
                     "edf": {"use_priorities": False},
                     "mgb": {"scheduler_factory":
                             lambda m=sched_mod: m.MGBAlg3Scheduler(2)}},
            scheduler_factory=factory, workers=64)
        out.append(([(s.job, s.t, [(x.name, x.priority, x.deadline_t,
                                     x.vector) for x in s.tasks])
                     for s in trace.submissions],
                    (same.makespan_s, same.deadline_met, same.deadline_jobs,
                     same.p99_queueing_s, same.evictions),
                    report, wif.summarize(events),
                    wif.compare(events, {"same": {}},
                                scheduler_factory=factory, workers=64)))
    assert out[1][:4] == out[0][:4]
    assert out[1][4] == out[0][4]
    assert out[1][4]["policies"]["same"]["first_divergence"] is None
    assert out[1][2]["policies"]["fifo"]["first_divergence"] is not None


def test_top_demo_frame_equals_the_jax_package(capsys):
    """``python -m repro_torch.launch.top --demo`` prints the reference's
    frames: the same queue, device bars, calibration rows and SLO strip
    over the same simulated overload."""
    assert ttop.main(["--demo"]) == 0
    frame = capsys.readouterr().out
    assert frame == jtop._demo() + "\n"
    assert "--- after drain ---" in frame and "calib" in frame


def test_top_renders_a_traced_calibrated_scheduler_like_the_jax_package():
    """``render`` of a traced, calibrated scheduler after a
    ``drifting_mix`` run (observed-occupancy bars, per-class rows) equals
    the reference's; a bare scheduler shows neither."""
    frames = []
    for pkg, top in ((JAX, jtop), (PORT, ttop)):
        c, _ = drifting_run(pkg, 1, n_jobs=16, min_samples=1)
        frames.append(top.render(c.sched, stats=c.stats()))
    assert frames[1] == frames[0]
    assert " occ " in frames[1] and "mae raw" in frames[1]
    bare = ttop.render(MGBAlg3Scheduler(2))
    assert " occ " not in bare and "calib" not in bare


# ---------------------------------------------------------------------------
# the port's Cluster surface
# ---------------------------------------------------------------------------

def vec(gb: float, est: float) -> ResourceVector:
    return ResourceVector(hbm_bytes=int(gb * GB), flops=1e9,
                          bytes_accessed=1e9, est_seconds=est,
                          core_demand=0.5, bw_demand=0.5)


def task(name: str, v: ResourceVector) -> Task:
    return Task(units=[UnitTask(fn=None, memobjs=frozenset({name}),
                                resources=v, name=name)], name=name)


def matmul_job(name: str, v: ResourceVector, n: int = 64) -> ExecJob:
    """One task whose runner multiplies two seeded n x n matrices on its
    device and checks the product against numpy's."""
    def runner(device):
        rng = np.random.default_rng(len(name))
        a, b = (rng.standard_normal((n, n), dtype=np.float32)
                for _ in range(2))
        got = torch.from_numpy(a).to(device) @ torch.from_numpy(b).to(device)
        np.testing.assert_allclose(got.cpu().numpy(), a @ b, rtol=1e-4,
                                   atol=1e-4)
    return ExecJob(job=Job(tasks=[task(name, v)], name=name),
                   runners=[runner])


def test_live_cluster_explains_profiles_and_exports_on_the_cpu(tmp_path):
    """A live ``Cluster(calibrate=True, trace=True, flight_path=...)`` over
    torch runners on the CPU: two classes, each run four times, one
    scheduler device that holds three at a time. ``explain`` names each
    task's placement, ``profile`` gives every task its prediction,
    reservation and observation (the probe's bytes as its high-water: the
    reference's behaviour off a card), the store corrects later tasks of a
    class, ``export_trace`` validates with the profiling counters on, and
    the flight recorder's drain dump loads."""
    flight = tmp_path / "flight.json"
    # fold_batch=1: each completion is folded before the next admission
    c = Cluster(MGBAlg3Scheduler(1, hbm_per_device=10 * GB), workers=2,
                devices=[CPU], trace=True,
                calibrate=tcal.CalibrationStore(fold_batch=1),
                metrics=tmet.MetricsRegistry(), flight_path=str(flight))
    assert c.explainer is not None and c.calibration is not None
    classes = {"a": vec(3.0, 0.002), "b": vec(2.0, 0.001)}
    handles = []
    for wave in range(4):
        for k, v in classes.items():
            handles.append(c.submit(matmul_job(f"{k}{wave}", v)))
        c.drain()
    c.shutdown()
    assert all(h.status is JobStatus.DONE for h in handles)
    for h in handles:
        (verdicts,) = h.explain().values()
        assert verdicts and verdicts[-1].action == tx.ADMITTED, verdicts
        (p,) = h.profile().values()
        assert p.completed and p.exec_s > 0
        assert p.pred_est_s == h.job.tasks[0].probe_vec.est_seconds
        assert p.hw_bytes == h.job.tasks[0].probe_vec.hbm_bytes
        assert not p.memory_violation
    rep = c.calibration.accuracy_report()
    assert rep["classes"] == 2 and rep["observations"] == 8
    assert rep["violations"] == 0 and rep["corrections"] > 0
    # after one completion a class's memory is its high-water x 1.05
    last = handles[-1].job.tasks[0]
    assert last.calibrated_vec is not None
    assert last.resources.hbm_bytes == int(2 * GB * 1.05)
    summary = c.profile()
    assert summary["completed"] == 8 and summary["memory_violations"] == 0
    assert summary["calibration"] == rep
    doc = c.export_trace(str(tmp_path / "trace.json"))
    assert texp.validate_chrome_trace(doc) == []
    assert json.load(open(tmp_path / "trace.json")) == doc
    names = {r["name"] for r in doc["traceEvents"] if r.get("ph") == "C"}
    assert "occupancy %" in names and "est error %" in names
    assert [r for r, _ in c.flight.dumps] == ["drain"] * 4
    dump = json.load(open(c.flight.dumps[-1][1]))
    assert dump["reason"] == "drain"
    assert len(dump["events"]) == len(c.trace.events())


def test_cluster_explains_a_parked_job_and_requires_what_it_reads():
    """On the sim backend: a job that cannot fit beside a resident is
    explained with a live rejection while it is parked; ``profile`` and
    ``export_trace`` need ``trace=``, ``explain`` needs ``explain=``, and
    ``explain=False`` on a traced cluster leaves the explainer off."""
    c = Cluster(MGBAlg3Scheduler(1), workers=4, backend="sim", trace=True)
    c.submit(Job(tasks=[task("big", vec(12.0, 1.0))], name="big"))
    h = c.submit(Job(tasks=[task("next", vec(12.0, 1.0))], name="next"))
    c.run_until(0.5)
    assert h.status is JobStatus.QUEUED
    (verdicts,) = h.explain().values()
    assert verdicts[-1].action == tx.REJECTED and verdicts[-1].data["live"]
    c.drain()
    (verdicts,) = h.explain().values()
    assert verdicts[-1].action == tx.ADMITTED
    bare = Cluster(MGBAlg3Scheduler(1), backend="sim")
    hb = bare.submit(Job(tasks=[task("x", vec(1.0, 0.1))], name="x"))
    bare.drain()
    for fn in (bare.profile, hb.profile, hb.explain,
               lambda: bare.export_trace("unused.json")):
        with pytest.raises(RuntimeError):
            fn()
    assert Cluster(MGBAlg3Scheduler(1), backend="sim", trace=True,
                   explain=False).explainer is None


def test_a_calibrated_scheduler_is_discovered_not_attached_twice():
    """``Cluster`` over a ``CalibratedScheduler`` reads the wrapper's store
    (no second store), and a ``CalibrationStore`` passed as ``calibrate=``
    is the one attached."""
    sched = tcal.CalibratedScheduler(MGBAlg3Scheduler(2), min_samples=1,
                                     fold_batch=1)
    c = Cluster(sched, backend="sim", trace=True)
    assert c.calibration is sched.store and sched.inner._calib is sched.store
    for row in TW.drifting_mix(2, n_jobs=12):
        c.run_until(row["t"])
        c.submit(row["job"])
    c.drain()
    assert sched.store.observations == 12 and sched.store.corrections > 0
    store = tcal.CalibrationStore()
    c2 = Cluster(MGBAlg3Scheduler(1), backend="sim", calibrate=store)
    assert c2.calibration is store and c2.sched._calib is store
    assert Cluster(MGBAlg3Scheduler(1), backend="sim").calibration is None


def test_a_crash_dumps_the_flight_recorder(tmp_path):
    """A runner that raises crashes its job; the flight recorder dumps the
    window at the crash (once) and again at the drain."""
    def bad(device):
        raise ValueError("boom")

    c = Cluster(MGBAlg3Scheduler(1), workers=1, devices=[CPU], trace=True,
                flight_path=str(tmp_path / "f.json"))
    h = c.submit(ExecJob(job=Job(tasks=[task("bad", vec(1.0, 0.1))],
                                 name="bad"), runners=[bad]))
    c.drain()
    c.shutdown()
    assert h.status is JobStatus.CRASHED
    assert [r for r, _ in c.flight.dumps] == ["crash", "drain"]
    crash = json.load(open(c.flight.dumps[0][1]))
    assert any(e["kind"] == ev.CRASH for e in crash["events"])


@pytest.mark.parametrize("continuous", [False, True])
def test_serve_writes_a_trace_that_validates(tmp_path, continuous):
    """``serve(..., trace_path=)`` and ``serve_continuous(...,
    trace_path=)`` on the CPU: every request served, and the trace file
    holds one occupancy slice per served batch (static) or the prefills
    and the loop's slot joins (continuous), valid Chrome JSON."""
    from repro_torch.launch import serve as LS
    path = tmp_path / "t.json"
    if continuous:
        res = LS.serve_continuous("gemma2-9b", requests=4, batch=2,
                                  prompt_len=8, gen_len=4, device="cpu",
                                  trace_path=str(path))
        assert res["done"] == 4
    else:
        res = LS.serve("gemma2-9b", requests=8, batch=4, prompt_len=8,
                       gen_len=4, device="cpu", trace_path=str(path))
        assert res["completed"] == 2
    doc = json.load(open(path))
    assert texp.validate_chrome_trace(doc) == []
    slices = texp.trace_summary(doc)["slices"]
    assert slices == 2 if not continuous else slices >= 4


# ---------------------------------------------------------------------------
# the observed high-water (ROADMAP C16)
# ---------------------------------------------------------------------------

def test_the_cpu_path_takes_the_probes_bytes_as_the_high_water():
    """On the CPU the executor measures nothing: ``true_vec`` stays None and
    the END event's high-water is the probe's bytes, as on the reference's
    live backend (``observed_highwater``)."""
    c = Cluster(MGBAlg3Scheduler(1), workers=1, devices=[CPU], trace=True,
                calibrate=True)
    h = c.submit(matmul_job("alone", vec(1.5, 0.001)))
    c.drain()
    c.shutdown()
    t = h.job.tasks[0]
    assert h.status is JobStatus.DONE and t.true_vec is None
    assert observed_highwater(t) == t.probe_vec.hbm_bytes == int(1.5 * GB)
    (end,) = [e for e in c.trace.events() if e.kind == ev.END]
    assert end.data == {"hw": int(1.5 * GB)}


def _alloc_job(name, v, nbytes, gate=None):
    """A task that allocates ``nbytes`` on its device, optionally meets
    another task's runner at ``gate`` (a barrier) while holding them, and
    frees them."""
    def runner(device):
        x = torch.empty(nbytes, dtype=torch.uint8, device=device)
        x.fill_(1)
        if gate is not None:
            gate.wait(timeout=60)
        torch.cuda.current_stream(device).synchronize()
        del x
    return ExecJob(job=Job(tasks=[task(name, v)], name=name),
                   runners=[runner])


@pytest.mark.gpu
def test_a_lone_attempt_on_a_card_is_measured_and_a_shared_one_is_not():
    """On a card with a calibration store: a task alone on the card gets a
    ``true_vec`` whose bytes cover what it allocated and stay within its
    reservation, and whose seconds are its run; two tasks that overlap on
    the card (they meet at a barrier inside their runners) get none; a
    lone task on an uncalibrated cluster gets none either."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    c = Cluster(MGBAlg3Scheduler(1, hbm_per_device=8 * GB), workers=2,
                devices=[dev], trace=True, calibrate=True)
    lone = c.submit(_alloc_job("lone", vec(1.0, 0.01), 256 * MiB))
    c.drain()
    gate = threading.Barrier(2)
    shared = [c.submit(_alloc_job(f"shared{i}", vec(1.0, 0.01), 64 * MiB,
                                  gate)) for i in range(2)]
    c.drain()
    c.shutdown()
    assert all(h.status is JobStatus.DONE for h in [lone] + shared)
    t = lone.job.tasks[0]
    assert t.true_vec is not None
    assert 256 * MiB <= t.true_vec.hbm_bytes <= t.resources.hbm_bytes
    (rec,) = lone.records
    assert 0 < t.true_vec.est_seconds <= rec.t_end - rec.t_start
    assert t.true_vec.flops == t.probe_vec.flops
    (end,) = [e for e in c.trace.events()
              if e.kind == ev.END and e.name == "lone"]
    assert end.data["hw"] == t.true_vec.hbm_bytes
    assert all(h.job.tasks[0].true_vec is None for h in shared)
    assert c.calibration.violations == 0
    plain = Cluster(MGBAlg3Scheduler(1, hbm_per_device=8 * GB), workers=1,
                    devices=[dev])
    h = plain.submit(_alloc_job("plain", vec(1.0, 0.01), 64 * MiB))
    plain.drain()
    plain.shutdown()
    assert h.status is JobStatus.DONE and h.job.tasks[0].true_vec is None
