"""The port's train_100m example (``repro_torch.examples.train_100m``)
against the reference's ``examples/train_100m.py``, on the CPU: the
reference's example raises on one device (ROADMAP C26); the port's lm-100m
at full width and 2 of its 12 layers, trained through
``launch.train.train`` from the JAX ``init_params`` carried over, matches
the unsharded jitted JAX step; its ``main`` trains, checkpoints and
resumes.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src.named_sharding import DuplicateSpecError  # noqa: E402

from _examples import CPU, _metrics_close, _reference  # noqa: E402
from _train import _np, _params_close  # noqa: E402
from repro.configs import registry as JR  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipe  # noqa: E402
from repro.models.model import init_params as jax_init  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.examples import train_100m  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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
