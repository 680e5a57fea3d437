"""The port's examples (``repro_torch.examples``) against the reference's
``examples/*.py``, on the same inputs, on the CPU.

  * quickstart: the four results within 1e-5 relative of the JAX
    example's (f32 sums of 262144 terms in another order), placements on
    both devices, probe A's flops within 1% of XLA's; probe B's flops are
    0 (``FlopCounterMode`` counts no elementwise op; XLA counts 2.62e5,
    ROADMAP C27) and the probes' bytes are printed beside XLA's (C21);
  * gang_placement, preemptive_cluster, trace_viewer: the sim sections'
    output equals the JAX example's, line for line; the live sections'
    figures equal it too;
  * shared_cluster: the train jobs, started from the JAX example's weights
    carried over by ``convert``, end their 3 steps at the jitted JAX
    runner's losses and parameters (``tests/test_torch_train.py``'s
    tolerances), the prefill jobs' logits match the JAX prefill's within
    2e-3 (``tests/test_torch_model.py``'s), and ``main`` runs whole;
  * train_100m: the reference's example raises on one device (ROADMAP
    C26); the port's lm-100m at full width and 2 of its 12 layers,
    trained through ``launch.train.train`` from the JAX ``init_params``
    carried over, matches the unsharded jitted JAX step; its ``main``
    trains, checkpoints and resumes.
"""
import ast
import dataclasses
import importlib.util
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src.named_sharding import DuplicateSpecError  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipe  # noqa: E402
from repro.models.model import init_params as jax_init  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.serve.decode import make_prefill_step as jax_prefill  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.registry import get_arch as port_arch  # noqa: E402
from repro_torch.core.executor import Executor  # noqa: E402
from repro_torch.core.scheduler import MGBAlg3Scheduler  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    gang_placement, preemptive_cluster, quickstart, shared_cluster,
    trace_viewer, train_100m,
)
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CPU = ["--device", "cpu"]


def _reference(name):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_example_{name}", os.path.join(ROOT, "examples",
                                                   f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params_close(got, want, lr):
    """``tests/test_torch_train.py``'s parameter tolerance: every element
    within lr, all but 1e-3 of them within 1e-2 lr."""
    errs = torch.cat([(g.float() - w.float()).abs().flatten()
                      for g, w in zip(tree_leaves(got), tree_leaves(want))])
    assert float(errs.max()) <= lr
    assert int((errs > 1e-2 * lr).sum()) <= 1e-3 * errs.numel()


def _metrics_close(got, want):
    """Loss within 1e-4, grad norm within 1e-4 relative, step for step."""
    assert len(got) == len(want)
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= 1e-4
        assert abs(gn - wn) <= 1e-4 * wn


# -- quickstart --------------------------------------------------------------
def test_quickstart_matches_the_reference(capsys):
    _reference("quickstart").main()
    ref = capsys.readouterr().out
    got = quickstart.main(CPU)
    out = capsys.readouterr().out
    want = ast.literal_eval(ref.splitlines()[-2].split("results: ", 1)[1])
    assert set(got["results"]) == set(want) == {"app1", "app2", "app3",
                                                "app4"}
    for app, v in want.items():
        assert abs(got["results"][app] - v) <= 1e-5 * abs(v)
    assert {d for _, d in got["placements"]} == {0, 1}
    assert got["stats"]["completed"] == 2 and got["stats"]["crashed"] == 0
    assert got["app4_records"] == ["app4-task"]
    assert len(got["tasks"]) == 1 and len(got["tasks"][0].units) == 2
    xla = {k: re.search(rf"probe {k}: ([\d.]+) MB, ([\d.e+-]+) flops",
                        ref).groups() for k in "AB"}
    assert abs(got["probe_a"].flops - float(xla["A"][1])) \
        <= 0.01 * float(xla["A"][1])
    # C27: the port's trace counts no elementwise op's flops
    assert got["probe_b"].flops == 0 and float(xla["B"][1]) > 0
    print(f"probe A: port {got['probe_a'].hbm_bytes / 1e6:.1f} MB, "
          f"{got['probe_a'].flops:.3e} flops; XLA {xla['A'][0]} MB, "
          f"{xla['A'][1]} flops. probe B: port "
          f"{got['probe_b'].hbm_bytes / 1e6:.1f} MB, "
          f"{got['probe_b'].flops:.3e} flops; XLA {xla['B'][0]} MB, "
          f"{xla['B'][1]} flops")
    assert out.strip().endswith("quickstart OK")


@pytest.mark.gpu
def test_quickstart_on_the_card_equals_the_cpu_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = quickstart.main(CPU)["results"]
    card = quickstart.main([])["results"]
    assert set(card) == set(cpu)
    for app, v in cpu.items():
        assert abs(card[app] - v) <= 1e-4 * abs(v)


# -- the sim examples --------------------------------------------------------
def test_gang_placement_prints_the_references_figures(capsys):
    _reference("gang_placement").main()
    ref = capsys.readouterr().out
    got = gang_placement.main(CPU)
    assert capsys.readouterr().out == ref
    assert f"{got['t']:.1f}" == "39.9"
    assert got["bound"] == [torch.device("cpu")] * 4
    assert got["gang_chips"] == 4
    assert got["shed_status"] == "shed"
    assert got["shed_stats"] == {"completed": 1, "shed": 1}
    assert ("gang002x4", 4, 0) in [p[:3] for p in got["placements"]]


def _live_figures(line):
    m = re.match(r"\[live\] events: (.*); statuses: (.*); (\d+) "
                 r"preemption\(s\)$", line)
    events, statuses, n = m.groups()
    # the hook (scheduler's notify thread) and the runner race for the
    # first entry, in both packages
    return sorted(ast.literal_eval(events)), ast.literal_eval(statuses), \
        int(n)


def test_preemptive_cluster_prints_the_references_figures(capsys):
    ref_mod = _reference("preemptive_cluster")
    ref_mod.sim_comparison()
    ref_mod.live_cooperative_checkpoint()
    ref = capsys.readouterr().out.splitlines()
    got = preemptive_cluster.main(CPU)
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ref[:2]
    assert _live_figures(out[2]) == _live_figures(ref[2])
    assert out[3] == "preemptive cluster demo OK"
    assert got["sim"] == {"met": 0, "total": 10, "met_preemptive": 10,
                          "total_preemptive": 10, "preemptions": 11,
                          "migrations": 3}
    assert sorted(got["live"]["events"]) == [
        "checkpoint(train-bg)", "finished", "stopped-early"]
    assert got["live"]["preemptions"] == 1


def test_trace_viewer_prints_the_references_lines(capsys, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    _reference("trace_viewer").main()
    ref = capsys.readouterr().out
    got = trace_viewer.main(CPU + ["--out", "port.json"])
    out = capsys.readouterr().out
    # a verdict names its preemptor by task uid, a count each package
    # keeps on across the tests of a process
    assert re.sub(r"by=\d+", "by=#", out) == re.sub(
        r"by=\d+", "by=#",
        ref.replace("wrote trace_viewer.json", "wrote port.json"))
    assert got["summary"]["flows"] == 2
    assert got["summary"]["cross_device_flows"] == 1
    assert got["migrations"] == 1 and got["queueing_delay"]["n"] == 5
    assert len(got["profiles"]) == 6 and len(got["verdicts"]) == 6
    for line in got["profiles"]:
        assert f"  {line}\n" in ref
    assert (tmp_path / "port.json").exists()


@pytest.mark.parametrize("name", ["quickstart", "gang_placement",
                                  "preemptive_cluster", "trace_viewer",
                                  "shared_cluster", "train_100m"])
def test_an_example_needs_a_card_unless_the_cpu_is_asked_for(name,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


# -- shared_cluster ----------------------------------------------------------
def _jax_batch(cfg, seed, labels):
    """The reference example's batch for seed ``seed``."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (shared_cluster.BATCH,
                                      shared_cluster.SEQ), np.int32)
    batch = {"tokens": jnp.asarray(tok)}
    if labels:
        batch["labels"] = jnp.roll(batch["tokens"], -1, axis=1)
    if cfg.embedding_frontend_stub:
        batch["embeds"] = jnp.asarray(rng.standard_normal(
            (shared_cluster.BATCH, shared_cluster.SEQ, cfg.d_model),
            np.float32))
    return batch


def test_shared_cluster_builds_the_references_six_jobs():
    jobs = shared_cluster.build_jobs(torch.device("cpu"))
    assert [j.ej.job.name for j in jobs] == [
        "train-gemma2-9b-0", "train-qwen1.5-32b-1", "serve-mixtral-8x7b-0",
        "serve-falcon-mamba-7b-1", "serve-zamba2-2.7b-2",
        "serve-musicgen-large-3"]
    assert all(j.ej.job.tasks[0].resources.hbm_bytes > 0 for j in jobs)


@pytest.mark.parametrize("arch,idx", [("gemma2-9b", 0), ("qwen1.5-32b", 1)])
def test_shared_cluster_train_job_matches_the_jitted_jax_runner(arch, idx):
    """The JAX example's runner (3 jitted steps of ``make_train_step(cfg,
    AdamWConfig(), attn_impl="flash_jnp")`` from ``init_params(cfg,
    PRNGKey(idx))``) against the port's job on the carried weights, run
    through the executor."""
    cfg, tcfg = get_arch(arch).reduced(), port_arch(arch).reduced()
    params = jax_init(cfg, jax.random.PRNGKey(idx))
    opt_cfg = JA.AdamWConfig()
    state = JA.init_state(opt_cfg, params)
    tparams = convert.params_from_jax(_np(params), tcfg, "cpu")
    step = jax.jit(jax_step(cfg, opt_cfg, attn_impl="flash_jnp"))
    batch = _jax_batch(cfg, idx, labels=True)
    want = []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    job = shared_cluster.make_train_job(arch, idx, torch.device("cpu"),
                                        params=tparams)
    stats = Executor(MGBAlg3Scheduler(2), workers=1,
                     devices=["cpu"]).run([job.ej])
    assert stats["completed"] == 1 and stats["crashed"] == 0
    _metrics_close(list(zip(job.out["losses"], job.out["grad_norms"])),
                   want)
    _params_close(job.out["params"],
                  convert.params_from_jax(_np(params), tcfg, "cpu"),
                  opt_cfg.lr)


@pytest.mark.parametrize("arch,idx", [("mixtral-8x7b", 0),
                                      ("falcon-mamba-7b", 1),
                                      ("zamba2-2.7b", 2),
                                      ("musicgen-large", 3)])
def test_shared_cluster_prefill_job_matches_jax(arch, idx):
    """The JAX example's prefill (``flash_jnp``, weights from
    ``PRNGKey(100 + idx)``, musicgen-large on its ``embeds``) against the
    port's job on the carried weights."""
    cfg, tcfg = get_arch(arch).reduced(), port_arch(arch).reduced()
    params = jax_init(cfg, jax.random.PRNGKey(100 + idx))
    batch = _jax_batch(cfg, 100 + idx, labels=False)
    assert ("embeds" in batch) == (arch == "musicgen-large")
    want, _ = jax_prefill(cfg, attn_impl="flash_jnp")(params, batch)
    job = shared_cluster.make_serve_job(
        arch, idx, torch.device("cpu"),
        params=convert.params_from_jax(_np(params), tcfg, "cpu"))
    job.ej.runners[0](torch.device("cpu"))
    got = job.out["logits"]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_shared_cluster_runs_end_to_end_on_the_cpu():
    res = shared_cluster.main(CPU)
    assert res["mgb"]["completed"] == 6 and res["mgb"]["crashed"] == 0
    assert res["sa"]["completed"] == 6 and res["sa"]["crashed"] == 0
    assert res["fault"]["completed"] + res["fault"]["crashed"] == 6
    assert sum(res["per_device"].values()) == 6
    fleet = res["fleet"]
    assert fleet["done"] == 64 and fleet["background"] == "done"
    assert fleet["stats"]["completed"] == 65
    assert fleet["stats"]["crashed"] == 0


# -- train_100m --------------------------------------------------------------
def test_reference_train_100m_raises_on_one_device(tmp_path, monkeypatch):
    """ROADMAP C26: the reference's launcher builds a (1, 1) mesh, and its
    step fails in the embedding gather (C2)."""
    ref = _reference("train_100m")
    monkeypatch.setitem(JR.ARCHS, ref.CONFIG_100M.name, ref.CONFIG_100M)
    monkeypatch.setattr("sys.argv", [
        "train_100m.py", "--steps", "2", "--batch", "2", "--seq", "32",
        "--ckpt-dir", str(tmp_path)])
    with pytest.raises(DuplicateSpecError):
        ref.main()


def test_lm_100m_config_is_the_references():
    ref = _reference("train_100m")
    assert dataclasses.asdict(train_100m.CONFIG_100M) \
        == dataclasses.asdict(ref.CONFIG_100M)
    assert train_100m.CONFIG_100M.param_count() == \
        ref.CONFIG_100M.param_count()
    assert round(train_100m.CONFIG_100M.param_count() / 1e6) == 115


def test_lm_100m_trains_as_the_unsharded_jax_step(tmp_path, monkeypatch):
    """lm-100m at its full width and 2 of its 12 layers, batch 2 x 32, 3
    steps through ``launch.train.train`` itself: the JAX ``init_params(
    PRNGKey(0))`` and AdamW state are saved by the reference's checkpoint
    module at step 0, read through ``convert.train_state_from_jax_leaves``
    and saved in the port's layout, from which ``train(resume=True)``
    starts. Against ``jax.jit(make_train_step(...))`` unsharded, with the
    launcher's AdamW settings, on the same ``TokenPipeline`` batches
    (tolerances: ``tests/test_torch_train.py``)."""
    steps, batch, seq, lr = 3, 2, 32, 1e-3
    cfg = dataclasses.replace(_reference("train_100m").CONFIG_100M,
                              n_layers=2)
    monkeypatch.setitem(TR.ARCHS, "lm-100m", train_100m.CONFIG_100M)
    tcfg = dataclasses.replace(train_100m.CONFIG_100M, n_layers=2)
    opt_cfg = JA.AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5 + 1),
                             total_steps=steps,
                             moment_dtype=cfg.optimizer_moment_dtype)
    params = jax_init(cfg, jax.random.PRNGKey(0))
    state = JA.init_state(opt_cfg, params)
    JCK.save(str(tmp_path / "jax"), 0, {"params": params, "opt": state})
    at, leaves, manifest = CK.restore_leaves(str(tmp_path / "jax"))
    CK.save(str(tmp_path / "port"), at, convert.train_state_from_jax_leaves(
        leaves, manifest["dtypes"], tcfg, "cpu"))
    del leaves

    step = jax.jit(jax_step(cfg, opt_cfg, attn_impl="flash"))
    pipe = JPipe(cfg, ShapeConfig("train", seq, batch, "train"), seed=0,
                 batch_override=batch, seq_override=seq)
    want = []
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
        params, state, m = step(params, state, b)
        want.append((float(m["loss"]), float(m["grad_norm"])))

    res = LT.train("lm-100m", steps=steps, batch=batch, seq=seq,
                   reduced=False, n_layers=2, device="cpu",
                   ckpt_dir=str(tmp_path / "port"), ckpt_every=50,
                   resume=True, lr=lr, keep_state=True)
    assert res["start_step"] == 0 and res["reduced"] == [
        "depth 12 -> 2 layers"]
    _metrics_close(list(zip(res["losses"], res["grad_norms"])), want)
    _params_close(res["params"],
                  convert.params_from_jax(_np(params), tcfg, "cpu"), lr)


def test_train_100m_main_trains_checkpoints_and_resumes(tmp_path,
                                                        monkeypatch):
    monkeypatch.setitem(TR.ARCHS, "lm-100m", train_100m.CONFIG_100M)
    args = CPU + ["--steps", "4", "--batch", "2", "--seq", "32",
                  "--ckpt-dir", str(tmp_path)]
    res = train_100m.main(args)
    assert res["n_layers"] == 12 and res["reduced"] == []
    assert len(res["losses"]) == 4 and res["losses"][-1] < res["losses"][0]
    assert CK.latest_step(str(tmp_path)) == 4
    again = train_100m.main(args + ["--resume"])
    assert again["start_step"] == 4 and again["losses"] == []
    assert again["status"] == "done"
