"""The port's remat policies, microbatches, the probe of a train step and
the zamba2 hybrid's training against the JAX package, on the same weights
and optimizer state (``tests/_train.py``) and the same ``TokenPipeline``
batches: ``"dots"`` against the jitted JAX step under ``"dots"``, two
microbatches against one batch, the probe's flops and live peak under each
policy, and the hybrid's shared block, its ranks and its microbatches
under group remat. Tolerances: ``tests/test_torch_train.py``'s docstring.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves, tree_map  # noqa: E402

from _train import (  # noqa: E402
    ARCHS, B, S, STEPS, _moments_close, _np, _opt, _params_close, _port_run,
    _start,
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
from repro_torch.core.probe import trace_counts  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline, to_device  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    abstract_train_state, make_train_step,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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
