"""The port's training path (``repro_torch.optim``, ``train``, ``data``,
``launch.train``, ``models.model.loss_fn``) against the JAX package, on the
same weights and optimizer state (moved over with ``repro_torch.convert``)
and the same ``TokenPipeline`` batches.

The JAX train step is ``jax.jit(make_train_step(cfg, opt, attn_impl=
"flash"))`` unsharded: the reference's sharded path fails on the installed
jax (ROADMAP C2). Tolerances, each with its reason:

  * loss within 1e-4 and grad norm within 1e-4 relative: f32 sums taken in
    another order (measured: 2e-6 and 2e-7);
  * moments within 1e-4 of their largest magnitude (measured: 3e-5 and
    7e-6);
  * parameters relative to the learning rate: AdamW's first steps move an
    element by about lr * sign(g), so an element whose gradient is a
    rounding error's size can move by up to ~lr the other way. Every
    element stays within lr of the reference and all but 1e-3 of them
    within 1e-2 lr, counted over the whole tree (measured over 3 steps: at
    most 0.16 lr, and a handful of elements beyond 1e-2 lr: near-zero
    gradients, mostly of the zero-initialised QKV biases).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves, tree_map  # noqa: E402

from repro.configs.base import ShapeConfig  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipe  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs.registry import get_arch as port_arch  # noqa: E402
from repro_torch.core.probe import trace_counts  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline, to_device  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    abstract_train_state, make_train_step,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# softcaps + window; QKV bias; Mamba-1 (the scan's backward); MoE, 4
# experts top-2 with a window (the grouped matmul's backward, the aux loss);
# the zamba2 hybrid (Mamba-2's SSD and the scan across chunks, a shared
# block whose gradient sums over groups)
ARCHS = ["gemma2-9b", "qwen1.5-32b", "falcon-mamba-7b", "mixtral-8x7b",
         "zamba2-2.7b"]
LR = 1e-3
B, S, STEPS = 2, 128, 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _opt(mod):
    return mod.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)


def _start(arch, policy=None):
    """Reduced configs of both packages, the JAX parameters and AdamW
    state, and the same state in the port."""
    cfg, tcfg = get_arch(arch).reduced(), port_arch(arch).reduced()
    if policy:
        tcfg = dataclasses.replace(tcfg, remat_policy=policy)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    state = JA.init_state(_opt(JA), params)
    return (cfg, tcfg, params, state,
            convert.params_from_jax(_np(params), tcfg, "cpu"),
            convert.opt_state_from_jax(_np(state), tcfg, "cpu"))


_JAX_RUNS = {}


def _jax_run(arch):
    """The reference's 3 steps: per-step (loss, grad norm), final state."""
    if arch not in _JAX_RUNS:
        cfg, _, params, state, _, _ = _start(arch)
        step = jax.jit(jax_step(cfg, _opt(JA), attn_impl="flash"))
        pipe = JPipe(cfg, ShapeConfig("t", S, B, "train"), seed=0)
        metrics = []
        for i in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
            params, state, m = step(params, state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        _JAX_RUNS[arch] = (metrics, _np(params), _np(state))
    return _JAX_RUNS[arch]


def _port_run(arch, policy, micro=None, steps=STEPS):
    _, tcfg, _, _, params, state = _start(arch, policy)
    step = make_train_step(tcfg, _opt(TA), num_microbatches=micro)
    pipe = TokenPipeline(tcfg, TShape("t", S, B, "train"), seed=0)
    metrics = []
    for i in range(steps):
        params, state, m = step(params, state,
                                to_device(pipe.batch_at(i), "cpu"))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return tcfg, metrics, params, state


def _params_close(got, want, lr=LR):
    errs = torch.cat([(g.float() - w.float()).abs().flatten()
                      for g, w in zip(tree_leaves(got), tree_leaves(want))])
    assert float(errs.max()) <= lr
    assert int((errs > 1e-2 * lr).sum()) <= 1e-3 * errs.numel()


def _moments_close(got, want):
    for key in ("mu", "nu"):
        for g, w in zip(tree_leaves(got[key]), tree_leaves(want[key])):
            scale = float(w.abs().max())
            torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)
    assert got["step"] == want["step"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    cfg, tcfg, params, _, tparams, _ = _start(arch)
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                            dtype=np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    want = float(JM.loss_fn(params, cfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()}))
    got = TM.loss_fn(tparams, tcfg, to_device(batch, "cpu"))
    assert abs(float(got) - want) <= 1e-5
    # chunked (64-position chunks, here 2) equals one chunk; the loss adds
    # 0.01 x the MoE aux loss (0 without experts)
    hidden, aux = TM.forward(tparams, tcfg, to_device(batch, "cpu"))
    labels = torch.from_numpy(batch["labels"])
    one = TM.chunked_softmax_xent(tcfg, tparams, hidden, labels, chunk=S)
    two = TM.chunked_softmax_xent(tcfg, tparams, hidden, labels, chunk=64)
    assert abs(float(one) - float(two)) <= 1e-5
    assert abs(float(one) + 0.01 * float(aux) - float(got)) <= 1e-6


@pytest.mark.parametrize("policy", ["nothing", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jitted_jax_step(arch, policy):
    """3 steps of the port's train step against the unsharded jitted JAX
    step from one state on the same batches (tolerances: module
    docstring). Under ``full`` every layer is checkpointed and recomputed
    in the backward, with the same numbers."""
    want_m, want_p, want_s = _jax_run(arch)
    tcfg, got_m, params, state = _port_run(arch, policy)
    for (gl, gn), (wl, wn) in zip(got_m, want_m):
        assert abs(gl - wl) <= 1e-4
        assert abs(gn - wn) <= 1e-4 * wn
    _params_close(params, convert.params_from_jax(want_p, tcfg, "cpu"))
    _moments_close(state, convert.opt_state_from_jax(want_s, tcfg, "cpu"))


def test_remat_full_equals_nothing_exactly():
    """Recomputing a layer in the backward repeats its arithmetic."""
    _, m_a, p_a, _ = _port_run("gemma2-9b", "nothing", steps=2)
    _, m_b, p_b, _ = _port_run("gemma2-9b", "full", steps=2)
    assert m_a == m_b
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p_a),
                                                 tree_leaves(p_b)))


_JAX_DOTS = {}


def _jax_dots_run(arch):
    """The reference's 3 steps with every layer under ``"dots"``
    (``checkpoint_dots_with_no_batch_dims``)."""
    if arch not in _JAX_DOTS:
        cfg, _, params, state, _, _ = _start(arch)
        cfg = dataclasses.replace(cfg, remat_policy="dots")
        step = jax.jit(jax_step(cfg, _opt(JA), attn_impl="flash"))
        pipe = JPipe(cfg, ShapeConfig("t", S, B, "train"), seed=0)
        metrics = []
        for i in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
            params, state, m = step(params, state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        _JAX_DOTS[arch] = (metrics, _np(params), _np(state))
    return _JAX_DOTS[arch]


@pytest.mark.parametrize("arch", ["gemma2-9b", "falcon-mamba-7b",
                                  "mixtral-8x7b"])
def test_remat_dots_matches_jitted_jax_dots_step(arch):
    """``remat_policy="dots"`` (the matrix products' outputs saved, the
    rest recomputed) trains in parity with the jitted JAX step under
    ``"dots"`` (the module's tolerances), and repeats the port's
    ``"nothing"`` and ``"full"`` steps exactly: recomputing a layer's
    other ops repeats their arithmetic."""
    want_m, want_p, want_s = _jax_dots_run(arch)
    tcfg, got_m, params, state = _port_run(arch, "dots")
    for (gl, gn), (wl, wn) in zip(got_m, want_m):
        assert abs(gl - wl) <= 1e-4
        assert abs(gn - wn) <= 1e-4 * wn
    _params_close(params, convert.params_from_jax(want_p, tcfg, "cpu"))
    _moments_close(state, convert.opt_state_from_jax(want_s, tcfg, "cpu"))
    for policy in ("nothing", "full"):
        _, m_o, p_o, s_o = _port_run(arch, policy)
        assert m_o == got_m, policy
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p_o),
                                                     tree_leaves(params)))
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(s_o["mu"]), tree_leaves(state["mu"])))


@pytest.mark.parametrize("arch", ["gemma2-9b", "falcon-mamba-7b",
                                  "mixtral-8x7b"])
def test_probe_of_dots_lies_between_full_and_nothing(arch):
    """The probe traces the selective checkpoint as it runs: under
    ``"dots"`` a step keeps each layer's matrix products besides its input,
    so its live peak lies above ``"full"``'s and below ``"nothing"``'s,
    and it recomputes less than ``"full"`` (fewer flops)."""
    cfg = port_arch(arch).reduced()
    opt = TA.AdamWConfig()
    params, opts = abstract_train_state(cfg, opt, torch.float32)
    batch = input_specs(cfg, TShape("t", 256, 4, "train"))
    counts = {p: trace_counts(make_train_step(
        dataclasses.replace(cfg, remat_policy=p), opt), params, opts, batch)
        for p in ("nothing", "dots", "full")}
    peak = {p: c["peak_live_bytes"] for p, c in counts.items()}
    assert peak["full"] < peak["dots"] < peak["nothing"], peak
    assert counts["nothing"]["hbm_bytes"] > counts["dots"]["hbm_bytes"] \
        > counts["full"]["hbm_bytes"]
    assert counts["nothing"]["flops"] <= counts["dots"]["flops"] \
        < counts["full"]["flops"]


# bf16 training: parameters and their gradients in bf16, the moments in
# f32. Both packages round each update to bf16, so an element whose f32
# value lies near a rounding boundary lands one bf16 unit apart, and one
# whose gradient is a rounding error's size may move up to ~lr a step the
# other way. Measured over 3 steps of reduced gemma2-9b, batch 4 in 2
# microbatches, every layer under "dots": losses within 3.1e-3, grad norms
# within 2.0e-4 relative, moments within 1.3e-2 of their largest magnitude,
# 0.17% of the parameters beyond lr + 2^-8 |w| of the reference (at most
# 3.5 times it). Tolerances (chip_smoke's [train-reduced] holds the card to
# the same, 10x where absolute):
BF16_TOL = {"loss": 1e-2, "grad_norm": 1e-3, "moments": 5e-2,
            "far": 1e-2, "max": 2 * STEPS * LR}


def bf16_params_close(got, want, lr=LR, steps=STEPS):
    """Every element within 2 * steps * lr + 2^-7 |w| of the reference,
    all but ``BF16_TOL["far"]`` of them within lr + 2^-8 |w|."""
    g = torch.cat([x.float().flatten() for x in tree_leaves(got)])
    w = torch.cat([x.float().flatten() for x in tree_leaves(want)])
    d = (g - w).abs()
    assert bool((d <= 2 * steps * lr + 2 ** -7 * w.abs()).all()), \
        float(d.max())
    far = int((d > lr + 2 ** -8 * w.abs()).sum())
    assert far <= BF16_TOL["far"] * d.numel(), (far, d.numel())


def test_bf16_microbatched_dots_matches_jitted_jax_step():
    """bf16 parameters, a batch of 4 in 2 microbatches and every layer
    under ``"dots"``: 3 steps of the port against the jitted JAX step
    with the same options from the same bf16 state (``BF16_TOL``)."""
    arch = "gemma2-9b"
    cfg = dataclasses.replace(get_arch(arch).reduced(), remat_policy="dots")
    tcfg = dataclasses.replace(port_arch(arch).reduced(),
                               remat_policy="dots")
    params = JM.init_params(cfg, jax.random.PRNGKey(0),
                            param_dtype=jnp.bfloat16)
    state = JA.init_state(_opt(JA), params)
    tparams = convert.params_from_jax(_np(params), tcfg, "cpu")
    tstate = convert.opt_state_from_jax(_np(state), tcfg, "cpu")
    assert {p.dtype for p in tree_leaves(tparams)} == {torch.bfloat16}
    assert {m.dtype for m in tree_leaves(tstate["mu"])} == {torch.float32}
    jstep = jax.jit(jax_step(cfg, _opt(JA), attn_impl="flash",
                             num_microbatches=2))
    tstep = make_train_step(tcfg, _opt(TA), num_microbatches=2)
    jpipe = JPipe(cfg, ShapeConfig("t", S, 4, "train"), seed=0)
    tpipe = TokenPipeline(tcfg, TShape("t", S, 4, "train"), seed=0)
    for i in range(STEPS):
        params, state, m = jstep(params, state, {
            k: jnp.asarray(v) for k, v in jpipe.batch_at(i).items()})
        tparams, tstate, tm = tstep(tparams, tstate,
                                    to_device(tpipe.batch_at(i), "cpu"))
        assert abs(float(tm["loss"]) - float(m["loss"])) \
            <= BF16_TOL["loss"]
        assert abs(float(tm["grad_norm"]) - float(m["grad_norm"])) \
            <= BF16_TOL["grad_norm"] * float(m["grad_norm"])
    assert {p.dtype for p in tree_leaves(tparams)} == {torch.bfloat16}
    bf16_params_close(tparams, convert.params_from_jax(_np(params), tcfg,
                                                       "cpu"))
    want = convert.opt_state_from_jax(_np(state), tcfg, "cpu")
    for key in ("mu", "nu"):
        for g, w in zip(tree_leaves(tstate[key]), tree_leaves(want[key])):
            scale = float(w.abs().max())
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=BF16_TOL["moments"] * scale)
    assert tstate["step"] == STEPS


# the MoE aux loss is a product of batch means (token fractions times
# router probabilities), so a batch's is not the mean of its halves': the
# microbatch identity holds for the families without one
@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "mixtral-8x7b"])
def test_two_microbatches_equal_one_batch(arch):
    """Gradients of two microbatches of a batch's rows, summed in f32
    accumulators and halved, are the batch's gradients within f32
    round-off: the same loss and grad norm, and the same update
    (parameters relative to lr, as against JAX)."""
    _, one_m, one_p, one_s = _port_run(arch, None, steps=1)
    _, two_m, two_p, two_s = _port_run(arch, None, micro=2, steps=1)
    assert abs(one_m[0][0] - two_m[0][0]) <= 1e-6 * one_m[0][0]
    assert abs(one_m[0][1] - two_m[0][1]) <= 1e-5 * one_m[0][1]
    _params_close(two_p, one_p)
    _moments_close(two_s, one_s)


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


def test_probe_of_a_train_step_counts_the_backward():
    """The probe traces the whole step on fake tensors: its flops are at
    least 2.5x the forward's for the same batch (backward and, under
    ``full``, the recompute) and its memory covers the arguments (weights,
    moments, batch) plus a gradient per weight."""
    cfg = dataclasses.replace(port_arch("gemma2-9b").reduced(),
                              remat_policy="full")
    opt = TA.AdamWConfig()
    params, opts = abstract_train_state(cfg, opt, torch.float32)
    batch = input_specs(cfg, TShape("t", 256, 4, "train"))
    step = trace_counts(make_train_step(cfg, opt), params, opts, batch)
    fwd = trace_counts(lambda p, b: TM.loss_fn(p, cfg, b), params, batch)
    assert step["flops"] >= 2.5 * fwd["flops"]
    weights = sum(4 * int(np.prod(s.shape)) for s in tree_leaves(params))
    assert step["arg_bytes"] >= 3 * weights  # weights and two moments
    assert step["hbm_bytes"] >= step["arg_bytes"] + weights
    nothing = trace_counts(
        make_train_step(dataclasses.replace(cfg, remat_policy="nothing"),
                        opt), params, opts, batch)
    # remat keeps only each layer's input: a lower live peak
    assert step["peak_live_bytes"] < nothing["peak_live_bytes"]
    assert step["flops"] > nothing["flops"]


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



@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "mixtral-8x7b",
                                  "zamba2-2.7b"])
def test_probe_of_ssm_and_moe_train_steps_counts_the_backward(arch):
    """The probe of a train step of the families whose layers run the scan
    and the grouped matmul traces their backward ops (fakes and flop
    formulas): under ``full`` its flops are at least 2.5x the forward's
    (chip_smoke's check on the card), and its memory covers the weights,
    both moments and a gradient per weight."""
    cfg = dataclasses.replace(port_arch(arch).reduced(), remat_policy="full")
    opt = TA.AdamWConfig()
    params, opts = abstract_train_state(cfg, opt, torch.float32)
    batch = input_specs(cfg, TShape("t", 256, 4, "train"))
    step = trace_counts(make_train_step(cfg, opt), params, opts, batch)
    fwd = trace_counts(lambda p, b: TM.loss_fn(p, cfg, b), params, batch)
    assert step["flops"] >= 2.5 * fwd["flops"]
    weights = sum(4 * int(np.prod(s.shape)) for s in tree_leaves(params))
    assert step["hbm_bytes"] >= 4 * weights


# ---------------------------------------------------------------------------
# the zamba2 hybrid
# ---------------------------------------------------------------------------

def test_hybrid_shared_block_gradient_sums_its_groups():
    """Every group runs the one shared attention + MLP block, so the loss's
    gradient of each shared weight is the sum over groups of the gradient
    each group's use gives: the forward rebuilt with a copy of the shared
    block per group gives per-group gradients that add up to the port's."""
    _, tcfg, *_, params, _ = _start("zamba2-2.7b")
    tcfg = dataclasses.replace(tcfg, remat_policy="full")
    tok = np.random.default_rng(3).integers(0, tcfg.vocab, (B, S),
                                            dtype=np.int32)
    batch = to_device({"tokens": tok, "labels": np.roll(tok, -1, 1)}, "cpu")
    shared = tree_leaves(params["shared"])
    with torch.enable_grad():
        for t in shared:
            t.requires_grad_(True)
        whole = torch.autograd.grad(TM.loss_fn(params, tcfg, batch), shared)
        for t in shared:
            t.requires_grad_(False)
    g, _ = TM.hybrid_groups(tcfg)
    copies = [tree_map(
        lambda t: t.clone().requires_grad_(True), params["shared"])
        for _ in range(g)]
    with torch.enable_grad():
        x = TM.embed_tokens(tcfg, params, batch)
        positions = torch.arange(S)
        for gi, gp in enumerate(params["groups"]):
            x = TM._hybrid_group(gp, copies[gi], x, tcfg, gi, positions,
                                 "flash_kernel", None)
        hidden = TL.rms_norm(x, params["final_norm"])
        loss = TM.chunked_softmax_xent(tcfg, params, hidden, batch["labels"])
        per_group = torch.autograd.grad(
            loss, [t for c in copies for t in tree_leaves(c)])
    n = len(shared)
    assert len(per_group) == g * n
    for i, w in enumerate(whole):
        parts = [per_group[gi * n + i] for gi in range(g)]
        assert all(float(p.abs().max()) > 0 for p in parts)
        torch.testing.assert_close(sum(parts), w, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))


def test_reference_rank_of_the_hybrid_tree_is_the_references():
    """``reference_rank`` (one rank for each list that holds a leaf) gives
    each leaf of the port's hybrid tree the rank of its leaf in the
    reference's (``groups`` on [G], ``mamba`` and ``norm_m`` on [G, k-1],
    ``shared`` unstacked), so AdamW decays the same leaves (C9); and the
    other families' ranks are those of their stacked [L] leaves."""
    from torch.utils._pytree import tree_flatten_with_path
    for arch in ARCHS:
        cfg, tcfg, params, _, tparams, _ = _start(arch)
        ranks = {tuple(k.key for k in path): leaf.ndim for path, leaf in
                 jax.tree_util.tree_flatten_with_path(params)[0]}
        paths = [tuple(k.key for k in path if hasattr(k, "key"))
                 for path, _ in tree_flatten_with_path(tparams)[0]]
        got = TA.reference_rank(tparams)
        assert len(got) == len(paths)
        assert [ranks[p] for p in paths] == got, arch
    _, tcfg, *_, tparams, _ = _start("zamba2-2.7b")
    rank = dict(zip((tuple(k.key for k in path if hasattr(k, "key"))
                     for path, _ in tree_flatten_with_path(tparams)[0]),
                    TA.reference_rank(tparams)))
    # the per-head dt_bias, A_log, D and the group norms are decayed there
    assert rank[("groups", "mamba", "dt_bias")] == 3
    assert rank[("groups", "norm_m")] == 3
    assert rank[("groups", "norm_attn")] == 2
    assert rank[("final_norm",)] == 1


def test_hybrid_microbatches_compose_with_group_remat():
    """zamba2's training options together (reduced widths): every group
    under ``remat_policy="full"`` and a batch of 4 in 2 microbatches, 3
    steps against the jitted JAX step with the same options (the module's
    tolerances)."""
    arch = "zamba2-2.7b"
    cfg = dataclasses.replace(get_arch(arch).reduced(), remat_policy="full")
    tcfg = dataclasses.replace(port_arch(arch).reduced(),
                               remat_policy="full")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    state = JA.init_state(_opt(JA), params)
    tparams = convert.params_from_jax(_np(params), tcfg, "cpu")
    tstate = convert.opt_state_from_jax(_np(state), tcfg, "cpu")
    jstep = jax.jit(jax_step(cfg, _opt(JA), attn_impl="flash",
                             num_microbatches=2))
    tstep = make_train_step(tcfg, _opt(TA), num_microbatches=2)
    jpipe = JPipe(cfg, ShapeConfig("t", S, 4, "train"), seed=0)
    tpipe = TokenPipeline(tcfg, TShape("t", S, 4, "train"), seed=0)
    for i in range(STEPS):
        params, state, m = jstep(params, state, {
            k: jnp.asarray(v) for k, v in jpipe.batch_at(i).items()})
        tparams, tstate, tm = tstep(tparams, tstate,
                                    to_device(tpipe.batch_at(i), "cpu"))
        assert abs(float(tm["loss"]) - float(m["loss"])) <= 1e-4
        assert abs(float(tm["grad_norm"]) - float(m["grad_norm"])) \
            <= 1e-4 * float(m["grad_norm"])
    _params_close(tparams, convert.params_from_jax(_np(params), tcfg, "cpu"))
    _moments_close(tstate, convert.opt_state_from_jax(_np(state), tcfg,
                                                      "cpu"))
