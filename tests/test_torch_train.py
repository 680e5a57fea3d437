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

This file holds the loss and the train step against JAX (f32 under
``"nothing"`` and ``"full"``, bf16 in microbatches under ``"dots"``);
``tests/test_torch_train_remat.py`` the remat policies, microbatches, the
probe of a train step and the zamba2 hybrid; ``tests/test_torch_train_
state.py`` the optimizer, the data pipeline, the straggler detector,
checkpoints and the launcher. Their helpers are ``tests/_train.py``; the
split lets xdist spread the training tests over its workers.
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

from _train import (  # noqa: E402
    ARCHS, B, LR, S, STEPS, _moments_close, _np, _opt, _params_close,
    _port_run, _start,
)
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipe  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs.registry import get_arch as port_arch  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline, to_device  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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
