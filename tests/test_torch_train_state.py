"""The port's optimizer (``repro_torch.optim``), data pipeline, straggler
detector, checkpoints (``train/checkpoint.py``, a JAX checkpoint read
through ``convert``) and launcher (``launch/train.py``) against the JAX
package, on the CPU. Tolerances: ``tests/test_torch_train.py``'s docstring.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from _train import B, S, _np, _opt, _port_run, _start  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipe  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs.registry import get_arch as port_arch  # noqa: E402
from repro_torch.core.probe import trace_counts  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline, to_device  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    abstract_train_state, make_train_step,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _random_tree(rng, dtype):
    """The same random tree in the reference's layout (layers stacked on
    [2]) and the port's: a matrix, a 1-d leaf outside the layers (no
    decay) and per-layer 1-d and 2-d leaves (decayed, as the reference's
    stacked leaves are)."""
    jt = {"embed": rng.standard_normal((8, 4), dtype=np.float32),
          "final_norm": rng.standard_normal(4, dtype=np.float32),
          "layers": {"norm": rng.standard_normal((2, 4), dtype=np.float32),
                     "w": rng.standard_normal((2, 4, 3), dtype=np.float32)}}
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), jt)

    def port(tree):
        t = {k: torch.from_numpy(np.array(tree[k], np.float32)).to(
            getattr(torch, dtype)) for k in ("embed", "final_norm")}
        t["layers"] = [{k: torch.from_numpy(np.array(v[i], np.float32))
                        .to(getattr(torch, dtype))
                        for k, v in tree["layers"].items()} for i in (0, 1)]
        return t
    return jt, port


@pytest.mark.parametrize("param_dtype,moment_dtype",
                         [("float32", "float32"), ("float32", "bfloat16"),
                          ("bfloat16", "bfloat16")])
def test_apply_updates_matches_reference(param_dtype, moment_dtype):
    """AdamW on random trees and gradients, 4 steps with clipping,
    warmup and cosine: parameters within 1e-6 (f32) or one bf16 rounding,
    moments likewise; the final norm (1-d, outside the layers) is not
    decayed, the layers' 1-d leaves are, as in the reference."""
    rng = np.random.default_rng(0)
    jp, port = _random_tree(rng, param_dtype)
    tp = port(jp)
    jcfg = JA.AdamWConfig(lr=0.1, warmup_steps=2, total_steps=6,
                          clip_norm=0.5, moment_dtype=moment_dtype)
    tcfg = TA.AdamWConfig(lr=0.1, warmup_steps=2, total_steps=6,
                          clip_norm=0.5, moment_dtype=moment_dtype)
    js, ts = JA.init_state(jcfg, jp), TA.init_state(tcfg, tp)
    tol = 1e-6 if param_dtype == "float32" else 1e-2
    mtol = 1e-6 if moment_dtype == "float32" else 1e-2
    for i in range(4):
        jg = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape,
                                                      dtype=np.float32),
                                  a.dtype), jp)
        tg = port(jg)
        jp, js, jm = JA.apply_updates(jcfg, jp, jg, js)
        tp, ts, tm = TA.apply_updates(tcfg, tp, tg, ts)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-5 * float(jm["grad_norm"])
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
    for g, w in zip(tree_leaves(tp), tree_leaves(port(jp))):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
    for key in ("mu", "nu"):
        for g, w in zip(tree_leaves(ts[key]), tree_leaves(port(js[key]))):
            torch.testing.assert_close(g.float(), w.float(), rtol=mtol,
                                       atol=mtol * 1e-2)
    assert ts["step"] == int(js["step"]) == 4
    assert TA.reference_rank(tp) == [2, 1, 2, 3, 2, 3]


def test_apply_updates_keeps_at_most_two_temporaries():
    """The update's transient memory: with f32 parameters and moments one
    temporary the size of a leaf, with bf16 ones two (traced on fake
    tensors by the probe's live-bytes counter)."""
    for dtype, moments, most in (("float32", "float32", 1),
                                 ("bfloat16", "bfloat16", 2)):
        params = {"w": torch.zeros(256, 256, dtype=getattr(torch, dtype))}
        cfg = TA.AdamWConfig(moment_dtype=moments)
        state = TA.init_state(cfg, params)
        grads = {"w": torch.zeros(256, 256, dtype=getattr(torch, dtype))}
        counts = trace_counts(lambda p, g, s: TA.apply_updates(cfg, p, g, s),
                              params, grads, state)
        assert counts["peak_live_bytes"] <= most * 256 * 256 * 4 + 4096


def test_pipeline_batches_equal_the_references():
    for arch in ("gemma2-9b", "musicgen-large"):
        cfg = get_arch(arch).reduced()
        want = JPipe(cfg, ShapeConfig("t", 64, 3, "train"), seed=5)
        got = TokenPipeline(port_arch(arch).reduced(),
                            TShape("t", 64, 3, "train"), seed=5)
        for step in (0, 1, 7):
            w, g = want.batch_at(step), got.batch_at(step)
            assert set(w) == set(g)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("slow_host,factor", [(None, 1.0), (2, 3.0),
                                              (0, 1.4)])
def test_straggler_detector_matches_the_references(slow_host, factor):
    from repro.train.straggler import StragglerDetector as JDet
    from repro_torch.train.straggler import StragglerDetector
    rng = np.random.default_rng(3)
    want, got = JDet(n_hosts=4, window=8), StragglerDetector(4, window=8)
    for step in range(12):
        for h in range(4):
            s = float(rng.uniform(0.9, 1.1)) * (factor if h == slow_host
                                                else 1.0)
            want.record_step(h, s)
            got.record_step(h, s)
        assert {h: dataclasses.astuple(v) for h, v in got.report().items()} \
            == {h: dataclasses.astuple(v) for h, v in want.report().items()}
    assert got.stragglers() == want.stragglers() == (
        [slow_host] if factor > 1.5 else [])


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """4 steps uninterrupted equal 2 steps, ``save``, a fresh state (other
    weights) restored from the checkpoint, and 2 more: losses bit-equal."""
    arch = "gemma2-9b"
    _, full_m, full_p, _ = _port_run(arch, None, steps=4)
    _, tcfg, _, _, params, state = _start(arch)
    step = make_train_step(tcfg, _opt(TA))
    pipe = TokenPipeline(tcfg, TShape("t", S, B, "train"), seed=0)
    losses = []
    for i in range(2):
        params, state, m = step(params, state,
                                to_device(pipe.batch_at(i), "cpu"))
        losses.append(float(m["loss"]))
    CK.save(str(tmp_path), 2, {"params": params, "opt": state})
    fresh = TM.init_params(tcfg, torch.Generator().manual_seed(9))
    like = {"params": fresh, "opt": TA.init_state(_opt(TA), fresh)}
    start, restored = CK.restore(str(tmp_path), like)
    assert start == 2 == CK.latest_step(str(tmp_path))
    params, state = restored["params"], restored["opt"]
    for i in range(start, 4):
        params, state, m = step(params, state,
                                to_device(pipe.batch_at(i), "cpu"))
        losses.append(float(m["loss"]))
    assert losses == [m[0] for m in full_m]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(full_p)))


def test_checkpoint_keeps_bf16_bits_and_the_references_layout(tmp_path):
    p = {"a": torch.randn(5, 3).to(torch.bfloat16), "b": [torch.arange(4)]}
    state = {"params": p, "opt": {"step": 7}}
    CK.save(str(tmp_path), 7, state)
    step, leaves, manifest = CK.restore_leaves(str(tmp_path))
    assert step == 7 and manifest["dtypes"] == ["bfloat16", "int64", "int32"]
    assert leaves[0].dtype == np.uint16
    like = {"params": {"a": torch.zeros(5, 3, dtype=torch.bfloat16),
                       "b": [torch.zeros(4, dtype=torch.int64)]},
            "opt": {"step": 0}}
    _, back = CK.restore(str(tmp_path), like)
    assert torch.equal(back["params"]["a"], p["a"])
    assert back["opt"]["step"] == 7
    CK.save(str(tmp_path), 8, state)
    CK.prune(str(tmp_path), keep=1)
    assert CK.latest_step(str(tmp_path)) == 8
    assert sorted(x.name for x in tmp_path.iterdir()) == ["step_00000008"]


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "zamba2-2.7b"])
def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, arch):
    """A checkpoint the reference's ``train/checkpoint.save`` wrote (after
    one JAX step) is read through ``convert`` into the port's state, equal
    leaf for leaf to the converted tree, and the port trains on from it
    (the hybrid's groups stacked on [G] and [G, k-1] there)."""
    cfg, tcfg, params, state, _, _ = _start(arch)
    step = jax.jit(jax_step(cfg, _opt(JA), attn_impl="flash"))
    pipe = JPipe(cfg, ShapeConfig("t", S, B, "train"), seed=0)
    params, state, _ = step(params, state,
                            {k: jnp.asarray(v)
                             for k, v in pipe.batch_at(0).items()})
    JCK.save(str(tmp_path), 1, {"params": params, "opt": state})
    at, leaves, manifest = CK.restore_leaves(str(tmp_path))
    got = convert.train_state_from_jax_leaves(leaves, manifest["dtypes"],
                                              tcfg, "cpu")
    want_p = convert.params_from_jax(_np(params), tcfg, "cpu")
    want_o = convert.opt_state_from_jax(_np(state), tcfg, "cpu")
    assert at == 1 and got["opt"]["step"] == want_o["step"] == 1
    for g, w in zip(tree_leaves((got["params"], got["opt"]["mu"],
                                 got["opt"]["nu"])),
                    tree_leaves((want_p, want_o["mu"], want_o["nu"]))):
        assert torch.equal(g, w)
    tstep = make_train_step(tcfg, _opt(TA))
    tpipe = TokenPipeline(tcfg, TShape("t", S, B, "train"), seed=0)
    _, opt, m = tstep(got["params"], got["opt"],
                      to_device(tpipe.batch_at(1), "cpu"))
    assert np.isfinite(float(m["loss"])) and opt["step"] == 2


def test_abstract_train_state_allocates_nothing():
    cfg = port_arch("gemma2-9b")  # full width: 9.24e9 parameters
    params, opt = abstract_train_state(cfg, TA.AdamWConfig(), torch.float32)
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(params))
    d, f, v, hd = 3584, 14336, 256000, 256
    per_layer = d * (16 + 8 + 8) * hd + 16 * hd * d + 3 * d * f + 2 * d
    assert n == v * d + 42 * per_layer + d == 9_241_404_928
    assert opt["step"] == 0
    assert all(s.dtype == torch.float32 for s in tree_leaves(opt["mu"]))


def test_train_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.train("gemma2-9b", steps=1, device=None)


def test_train_on_cpu_runs_reduced_gemma2_as_one_task(tmp_path):
    res = LT.train("gemma2-9b", steps=3, batch=2, seq=64, device="cpu",
                   ckpt_dir=str(tmp_path), ckpt_every=2)
    losses = res["losses"]
    assert res["status"] == "done" and len(losses) == 3
    assert all(np.isfinite(losses)) and losses[-1] <= losses[0] * 1.01
    assert res["reduced"] == ["reduced() widths"]
    assert res["probe"].hbm_bytes > 0 and res["probe"].flops > 0
    assert CK.latest_step(str(tmp_path)) == 3
    again = LT.train("gemma2-9b", steps=4, batch=2, seq=64, device="cpu",
                     ckpt_dir=str(tmp_path), resume=True)
    assert again["start_step"] == 3 and len(again["losses"]) == 1


def test_train_cuts_depth_at_full_width_and_reports_it():
    with pytest.raises(ValueError, match="layers"):
        LT.train("gemma2-9b", reduced=False, n_layers=50, device="cpu")
