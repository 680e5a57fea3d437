"""The port's MoE path (``kernels/moe_gmm`` and its backward, ``models/moe``)
against the JAX package, on the same numpy inputs made from a seed; the
moe family of ``models/model`` and ``models/decode``, ring KV caches and
serving mixtral are ``tests/test_torch_moe_model.py``'s.

On the CPU the grouped-matmul wrapper takes its plain version. The Pallas
kernel no longer runs on the installed jax (``pl.load`` is gone), so it is
held against ``kernels/ref.py::moe_gmm_ref`` within 1e-4 in f32, as
``tests/test_kernels.py:134-135``, and 2e-2 in bf16. ``moe_apply`` matches
the reference's within 1e-5 in f32 and 2e-2 in bf16, with the routes
(top-k choices and capacity drops) checked equal first: top-k routing is
discontinuous.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs.registry import get_arch  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_arch as port_arch  # noqa: E402
from repro_torch.kernels import moe_gmm as MG  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the grouped matmul
# ---------------------------------------------------------------------------

def _gmm_inputs(t, groups, d=64, f=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d), dtype=np.float32)
    w = rng.standard_normal((len(groups), d, f), dtype=np.float32)
    return x, w, np.asarray(groups, np.int32)


# tests/test_kernels.py:123-124, then sizes that straddle any row tile and
# all rows in one expert
@pytest.mark.parametrize("groups", [
    (128, 256, 0, 128), (512, 0, 0, 0), (128, 128, 128, 128),
    (5, 130, 1, 120), (0, 0, 77, 0), (1, 1, 1, 1, 1, 1, 1, 1)])
def test_gmm_plain_matches_ref(groups):
    x, w, gs = _gmm_inputs(sum(groups), groups)
    want = R.moe_gmm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    got = MG.moe_gmm_plain(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(gs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_gmm_plain_bf16_matches_ref():
    """tests/test_kernels.py:138-148, with groups off the row tile."""
    x, w, gs = _gmm_inputs(256, (100, 156))
    xb, wb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    want = R.moe_gmm_ref(xb, wb, jnp.asarray(gs))
    got = MG.moe_gmm_plain(convert.to_torch(np.asarray(xb)),
                           convert.to_torch(np.asarray(wb)),
                           torch.from_numpy(gs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(convert.to_numpy(got),
                               np.asarray(want, np.float32), **_tol("bfloat16"))


def test_gmm_plain_zeroes_rows_past_the_groups():
    """Rows past sum(group_sizes) are the MoE layer's dropped slots: zeros
    (the reference's gather clamps them onto the last expert)."""
    groups = (3, 0, 40, 9)
    x, w, gs = _gmm_inputs(70, groups)
    n = sum(groups)
    want = R.moe_gmm_ref(jnp.asarray(x[:n]), jnp.asarray(w), jnp.asarray(gs))
    got = MG.moe_gmm_plain(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(gs)).numpy()
    np.testing.assert_allclose(got[:n], np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert (got[n:] == 0).all()


def test_gmm_wrapper_takes_plain_on_cpu_with_fake_shapes_and_flops():
    x, w, gs = (torch.from_numpy(a) for a in _gmm_inputs(40, (10, 30)))
    before = MG.LAUNCHES.value
    with FlopCounterMode(display=False) as fc:
        out = MG.moe_gmm(x, w, gs)
    assert MG.LAUNCHES.value == before  # the plain version is no launch
    torch.testing.assert_close(out, MG.moe_gmm_plain(x, w, gs))
    assert fc.get_total_flops() == 2 * 40 * 64 * 128
    mode = FakeTensorMode()
    fx, fw, fgs = (mode.from_tensor(t) for t in (x.bfloat16(), w.bfloat16(),
                                                  gs))
    with mode:
        fake = MG.moe_gmm(fx, fw, fgs)
    assert fake.shape == (40, 128) and fake.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the gated grouped matmul: act(x @ wi[e]) * (x @ wg[e]) in one launch
# ---------------------------------------------------------------------------

GATED_ACTS = ["silu_gated", "gelu_gated"]
# (t, groups): tiles that straddle experts, empty groups, rows past the groups
GATED_CASES = [(256, (5, 130, 1, 120)), (77, (0, 0, 77, 0)),
               (70, (3, 0, 40, 9))]


def _jax_gated(x, wi, wg, groups, act):
    """The JAX package's gated expert FFN (``models/moe.py:78-81``:
    ``jax.nn.silu`` or ``jax.nn.gelu``, tanh by default) one expert at a
    time, on its rows; zeros past the groups."""
    actfn = jax.nn.silu if act == "silu_gated" else jax.nn.gelu
    out = np.zeros((x.shape[0], wi.shape[2]), np.float32)
    off = 0
    for e, n in enumerate(groups):
        rows = x[off:off + n]
        out[off:off + n] = np.asarray(actfn(rows @ wi[e]) * (rows @ wg[e]),
                                      np.float32)
        off += n
    return out


@pytest.mark.parametrize("case", GATED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", GATED_ACTS)
def test_gmm_gated_plain_matches_jax(act, dtype, case):
    """f32 within 1e-5; bf16 within 2e-2, the port rounding once where the
    reference rounds the two products and the activation."""
    t, groups = case
    rng = np.random.default_rng(7)
    x = rng.standard_normal((t, 64), dtype=np.float32)
    wi, wg = (rng.standard_normal((len(groups), 64, 96), dtype=np.float32)
              / 8 for _ in range(2))
    jx, jwi, jwg = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, wi, wg))
    want = _jax_gated(jx, jwi, jwg, groups, act)
    got = MG.moe_gmm_gated_plain(
        *(convert.to_torch(np.asarray(a)) for a in (jx, jwi, jwg)),
        torch.tensor(groups, dtype=torch.int32), act)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    np.testing.assert_allclose(convert.to_numpy(got).astype(np.float32),
                               want, **_tol(dtype))
    assert (convert.to_numpy(got)[sum(groups):] == 0).all()


def test_gmm_gated_wrapper_takes_plain_on_cpu_with_fake_shapes_and_flops():
    """On the CPU the gated op is its plain version (no launch); its fake
    keeps the shape and dtype, and the flop count is 4·T·D·F, the two
    products ``moe_gmm`` would count, so the probe's total is unchanged."""
    x, w, gs = (torch.from_numpy(a) for a in _gmm_inputs(40, (10, 30)))
    wg = w.flip(0).contiguous()
    before = (MG.LAUNCHES.value, MG.GATED_LAUNCHES.value)
    with FlopCounterMode(display=False) as fc:
        out = MG.moe_gmm_gated(x, w, wg, gs, "silu_gated")
    assert (MG.LAUNCHES.value, MG.GATED_LAUNCHES.value) == before
    torch.testing.assert_close(
        out, MG.moe_gmm_gated_plain(x, w, wg, gs, "silu_gated"))
    assert fc.get_total_flops() == 4 * 40 * 64 * 128
    mode = FakeTensorMode()
    fx, fw, fwg, fgs = (mode.from_tensor(t) for t in (
        x.bfloat16(), w.bfloat16(), wg.bfloat16(), gs))
    with mode:
        fake = MG.moe_gmm_gated(fx, fw, fwg, fgs, "gelu_gated")
    assert fake.shape == (40, 128) and fake.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown act"):
        MG.moe_gmm_gated(x, w, wg, gs, "relu_gated")


@pytest.mark.parametrize("args, route", [
    ((torch.float32, 8192, 4096, 14336, 8, True), "f32"),
    ((torch.float32, 8, 4096, 14336, 8, True), "f32"),
    ((torch.bfloat16, 8192, 4096, 14336, 8, True), "wgmma"),  # prefill
    ((torch.bfloat16, 8192, 14336, 4096, 8, True), "wgmma"),
    ((torch.bfloat16, 8, 4096, 14336, 8, True), "small"),     # decode
    ((torch.bfloat16, 128, 64, 64, 8, True), "small"),        # 16 rows an expert
    ((torch.bfloat16, 129, 64, 64, 8, True), "wgmma"),
    ((torch.bfloat16, 40, 128, 264, 2, True), "wgmma"),       # T below 64
    ((torch.bfloat16, 392, 200, 328, 4, True), "wgmma"),      # widths off 64
    ((torch.bfloat16, 8192, 4100, 14336, 8, True), "small"),  # d off 8
    ((torch.bfloat16, 8192, 4096, 14340, 8, True), "small"),  # f off 8
    ((torch.bfloat16, 8192, 4096, 14336, 8, False), "small"),  # unaligned
    ((torch.bfloat16, 8192, 0, 14336, 8, True), "small")])
def test_gmm_route_by_shape_and_alignment(args, route):
    assert MG.gmm_route(*args) == route


def test_expert_ffn_makes_two_gmm_calls_a_layer(monkeypatch):
    """A gated layer is one ``moe_gmm_gated`` (wi, wg) and one ``moe_gmm``
    (wo); squared relu is two ``moe_gmm``: 2 launches a layer on the card."""
    calls = []

    def counted(name, fn):
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    monkeypatch.setattr(TMOE, "moe_gmm", counted("moe_gmm", TMOE.moe_gmm))
    monkeypatch.setattr(TMOE, "moe_gmm_gated",
                        counted("moe_gmm_gated", TMOE.moe_gmm_gated))
    cfg, p, x, tp, tx, tcfg = _moe_layer()
    rows = tx.reshape(-1, tx.shape[-1])
    gs = torch.tensor([40, 30, 0, 50], dtype=torch.int32)
    for act, want in [("silu_gated", ["moe_gmm_gated", "moe_gmm"]),
                      ("gelu_gated", ["moe_gmm_gated", "moe_gmm"]),
                      ("squared_relu", ["moe_gmm", "moe_gmm"])]:
        calls.clear()
        out = TMOE.expert_ffn(tp, rows, gs, act)
        assert calls == want, act
        assert out.shape == rows.shape and (out[120:] == 0).all()


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe_layer(act="silu_gated", dtype="float32", bias=0.0, s=64, seed=0):
    """Reduced mixtral's MoE (4 experts top-2, d 128, f 256): JAX params in
    ``dtype`` and the port's copy, x [2, s, 128]; ``bias`` is added to the
    router's column of expert 0 and to x, so every token chooses expert 0
    and its queue overflows the capacity."""
    cfg = dataclasses.replace(get_arch("mixtral-8x7b").reduced(),
                              mlp_act=act)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    p = JM._moe_params(jax.random.PRNGKey(seed), cfg, (), jdt)
    if bias:
        p["router"] = p["router"].at[:, 0].add(jnp.asarray(bias, jdt))
    rng = np.random.default_rng(seed + 1)
    x = jnp.asarray(rng.standard_normal((2, s, cfg.d_model),
                                        dtype=np.float32) + bias, jdt)
    tp = {k: convert.to_torch(np.asarray(v)) for k, v in p.items()}
    tcfg = port_arch("mixtral-8x7b").reduced().moe
    return cfg, p, x, tp, convert.to_torch(np.asarray(x)), tcfg


def _jax_routes(p, x, cfg, group_size):
    """The reference's (indices [g,s,k], kept [g,s,k]) for x."""
    b, s, d = x.shape
    gs = min(group_size, s)
    xg = x.reshape(b * (s // gs), gs, d)
    logits = jnp.einsum("gsd,de->gse", xg, p["router"].astype(x.dtype))
    weights, indices, _ = JMOE.router_topk(logits, cfg.top_k)
    cap = JMOE.capacity(cfg, gs)
    combine = JMOE.combine_tensor(indices, weights, cfg.num_experts, cap)
    chosen = jnp.take_along_axis(combine.sum(-1), indices, axis=-1)
    return np.asarray(indices), np.asarray(chosen > 0)


def _port_routes(tp, tx, tcfg, group_size):
    b, s, d = tx.shape
    gs = min(group_size, s)
    _, idx, keep, _ = TMOE.route(tp, tx.reshape(b * (s // gs), gs, d), tcfg)
    return idx.numpy(), keep.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu_gated", "gelu_gated", "squared_relu"])
def test_moe_apply_matches_jax(act, dtype):
    cfg, p, x, tp, tx, tcfg = _moe_layer(act, dtype)
    ji, jk = _jax_routes(p, x, cfg.moe, 512)
    ti, tk = _port_routes(tp, tx, tcfg, 512)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tk, jk)
    out, aux = JMOE.moe_apply(p, x, cfg.moe, act)
    tout, taux = TMOE.moe_apply(tp, tx, tcfg, act)
    assert tout.dtype == tx.dtype and taux.dtype == torch.float32
    np.testing.assert_allclose(convert.to_numpy(tout),
                               np.asarray(out, np.float32), **_tol(dtype))
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)


@pytest.mark.parametrize("group_size", [512, 32])
def test_moe_apply_drops_the_slots_jax_drops(group_size):
    """A router biased to expert 0 overfills its queue: the same slots are
    dropped (24 of 128 a group of 64 tokens, capacity 40; 8 of 64 a group
    of 32, capacity 24), and the outputs and aux agree."""
    cfg, p, x, tp, tx, tcfg = _moe_layer(bias=0.5)
    ji, jk = _jax_routes(p, x, cfg.moe, group_size)
    ti, tk = _port_routes(tp, tx, tcfg, group_size)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tk, jk)
    assert 1 - tk.mean() == (24 / 128 if group_size == 512 else 8 / 64)
    out, aux = JMOE.moe_apply(p, x, cfg.moe, cfg.mlp_act,
                              group_size=group_size)
    tout, taux = TMOE.moe_apply(tp, tx, tcfg, cfg.mlp_act,
                                group_size=group_size)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), **_tol("f32"))
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)


def test_moe_capacity_and_groups():
    tcfg = port_arch("mixtral-8x7b").moe
    assert TMOE.capacity(tcfg, 512) == 160   # prefill groups of 512
    assert TMOE.capacity(tcfg, 1) == 8       # decode: one token a group
    cfg, p, x, tp, tx, small = _moe_layer(s=48)
    with pytest.raises(ValueError, match="group size"):
        TMOE.moe_apply(tp, tx, small, cfg.mlp_act, group_size=32)


# ---------------------------------------------------------------------------
# the CUDA kernel itself (runs on the card only)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_gmm_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a")
    cases = [(512, (128, 256, 0, 128)), (70, (3, 0, 40, 9)),
             (8, (1, 2, 0, 1, 3, 0, 1, 0)), (300, (0, 0, 300, 0)),
             (0, (0, 0))]
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for t, groups in cases:
            x, w, gs = (torch.from_numpy(a).cuda()
                        for a in _gmm_inputs(t, groups, d=72, f=136))
            x, w = x.to(dtype), w.to(dtype)
            before = MG.LAUNCHES.value
            out = MG.moe_gmm(x, w, gs)
            torch.cuda.synchronize()
            assert MG.LAUNCHES.value == before + (t > 0)
            torch.testing.assert_close(out.float(),
                                       MG.moe_gmm_plain(x, w, gs).float(),
                                       atol=tol, rtol=tol)
    with pytest.raises(ValueError):
        MG.moe_gmm(x[:, ::2], w, gs)


@pytest.mark.gpu
def test_cuda_gated_gmm_and_wgmma_route_match_plain_on_card():
    """The gated kernel (both acts) and the plain product on every route
    the operands allow, forced, against the plain versions: straddling
    tiles, an empty expert, rows past the groups (exactly zero), T below
    64, widths multiples of 8 but not of 64, and widths off 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a")
    cases = [(300, (5, 130, 1, 120), 72, 136), (40, (17, 0, 20), 128, 264),
             (392, (130, 70, 128, 60), 200, 328), (512, (0, 512), 64, 64),
             (77, (13, 0, 33, 31), 50, 70)]
    for t, groups, d, f in cases:
        rng = np.random.default_rng(t)
        x = torch.from_numpy(rng.standard_normal((t, d), dtype=np.float32))
        wi, wg = (torch.from_numpy(rng.standard_normal(
            (len(groups), d, f), dtype=np.float32) / d ** 0.5)
            for _ in range(2))
        gs = torch.tensor(groups, dtype=torch.int32).cuda()
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            cx, cwi, cwg = (a.to("cuda", dtype) for a in (x, wi, wg))
            routes = ["f32"] if dtype == torch.float32 else \
                ["small"] + (["wgmma"] if d % 8 == 0 and f % 8 == 0 else [])
            for route in routes:
                for act in (None, *GATED_ACTS):
                    before = MG.GATED_LAUNCHES.value
                    if act is None:
                        out = MG._launch(cx, cwi, gs, route=route)
                        want = MG.moe_gmm_plain(cx, cwi, gs)
                    else:
                        out = MG._launch(cx, cwi, gs, wg=cwg, act=act,
                                         route=route)
                        want = MG.moe_gmm_gated_plain(cx, cwi, cwg, gs, act)
                    torch.cuda.synchronize()
                    assert MG.GATED_LAUNCHES.value == before + (act is not None)
                    torch.testing.assert_close(out.float(), want.float(),
                                               atol=tol, rtol=tol)
                    assert (out[sum(groups):] == 0).all()


# ---------------------------------------------------------------------------
# the grouped matmul's backward
# ---------------------------------------------------------------------------

# (t, groups): empty groups, one-row groups, groups that straddle any row
# tile, and rows past the groups (the layer's dropped slots)
GMM_BWD_CASES = [(256, (5, 130, 1, 120)), (77, (0, 0, 77, 0)),
                 (8, (1, 1, 1, 1, 1, 1, 1, 1)), (70, (3, 0, 40, 9)),
                 (200, (64, 0, 1, 100))]


def _jax_gmm_vjp(x, ws, groups, act, dy):
    """``jax.vjp`` of the reference's ``moe_gmm_ref`` (plain) or of its
    gated composition ``act(moe_gmm_ref(x, wi)) * moe_gmm_ref(x, wg)``
    (``jax.nn.silu``, or ``jax.nn.gelu``: tanh by default, as the
    reference's MoE layer). Rows past the groups go to an extra zero
    expert, so they give zeros as the port's dropped slots do (the
    reference's gather would clamp them onto the last expert)."""
    t = x.shape[0]
    gs = jnp.asarray(list(groups) + [t - sum(groups)], jnp.int32)

    def gmm(xx, w):
        return R.moe_gmm_ref(xx, jnp.concatenate([w, jnp.zeros_like(w[:1])]),
                             gs)

    if act is None:
        fn = gmm
    else:
        actfn = jax.nn.silu if act == "silu_gated" else jax.nn.gelu

        def fn(xx, wi, wg):
            return actfn(gmm(xx, wi)) * gmm(xx, wg)
    _, vjp = jax.vjp(fn, x, *ws)
    return [np.asarray(g, np.float32) for g in vjp(dy)]


@pytest.mark.parametrize("case", GMM_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "silu_gated", "gelu_gated"])
def test_gmm_bwd_plain_matches_jax_vjp(act, dtype, case):
    """The plain backward (``moe_gmm_bwd_plain``, ``moe_gmm_gated_bwd_plain``)
    and the ops' CPU backward through ``register_autograd`` against
    ``jax.vjp`` of the reference: dx, dw (dwi, dwg) within 1e-5 of each
    one's largest magnitude in f32 (sums in another order); in bf16 the
    port computes in f32 from the bf16 values and rounds each gradient
    once, so it is held within 2e-2 to the reference's vjp of the same
    bf16 values taken in f32 (the reference's own bf16 arithmetic rounds
    every intermediate, and on a cancelling element of dw that alone moves
    it by 10%). dx is 0 past the groups and an empty group's dw is 0."""
    t, groups = case
    rng = np.random.default_rng(11)
    n_w = 1 if act is None else 2
    x = rng.standard_normal((t, 48), dtype=np.float32)
    ws = [rng.standard_normal((len(groups), 48, 40), dtype=np.float32) / 7
          for _ in range(n_w)]
    dy = rng.standard_normal((t, 40), dtype=np.float32)
    jdt = getattr(jnp, dtype)
    jx, jdy, *jws = (jnp.asarray(a, jdt) for a in (x, dy, *ws))
    want = _jax_gmm_vjp(jx.astype(jnp.float32),
                        [w.astype(jnp.float32) for w in jws], groups, act,
                        jdy.astype(jnp.float32))
    tx, tdy, *tws = (convert.to_torch(np.asarray(a)) for a in (jx, jdy, *jws))
    gs = torch.tensor(groups, dtype=torch.int32)
    if act is None:
        plain = MG.moe_gmm_bwd_plain(tdy, tx, tws[0], gs)
    else:
        plain = MG.moe_gmm_gated_bwd_plain(tdy, tx, *tws, gs, act)[:3]
    leaves = [t_.clone().requires_grad_(True) for t_ in (tx, *tws)]
    before = MG.BWD_LAUNCHES.value
    out = MG.moe_gmm(leaves[0], leaves[1], gs) if act is None else \
        MG.moe_gmm_gated(*leaves, gs, act)
    grads = torch.autograd.grad(out, leaves, tdy)
    assert MG.BWD_LAUNCHES.value == before  # CPU tensors: the plain version
    rel = 2e-2 if dtype == "bfloat16" else 1e-5
    for got in (plain, grads):
        for g, w in zip(got, want):
            assert g.dtype == tx.dtype
            np.testing.assert_allclose(
                convert.to_numpy(g).astype(np.float32), w, rtol=rel,
                atol=rel * max(float(np.abs(w).max()), 1.0))
        assert (convert.to_numpy(got[0])[sum(groups):] == 0).all()
        for e, size in enumerate(groups):
            if size == 0:
                assert all((convert.to_numpy(g[e]) == 0).all()
                           for g in got[1:])


def test_gmm_bwd_fake_shapes_and_flops():
    """The backward ops' fakes keep shapes and dtypes (the gated one's
    dpre, its pre-activations' f32 gradients, charged to a probe) and
    count two products (plain) or six (gated: the pair recomputed)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    x, w, dy = torch.zeros(40, 8), torch.zeros(3, 8, 6), torch.zeros(40, 6)
    gs = torch.tensor([10, 0, 20], dtype=torch.int32)
    with FakeTensorMode(allow_non_fake_inputs=True):
        dx, dw = torch.ops.repro_torch.moe_gmm_bwd(dy, x, w, gs)
        dx2, dwi, dwg, dpre = torch.ops.repro_torch.moe_gmm_gated_bwd(
            dy, x, w, w, gs, "silu_gated")
    assert dx.shape == dx2.shape == x.shape
    assert dw.shape == dwi.shape == dwg.shape == w.shape
    assert dpre.shape == (2, 40, 6) and dpre.dtype == torch.float32
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.moe_gmm_bwd(dy, x, w, gs)
    assert fc.get_total_flops() == 4 * 40 * 8 * 6
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.moe_gmm_gated_bwd(dy, x, w, w, gs, "gelu_gated")
    assert fc.get_total_flops() == 12 * 40 * 8 * 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_bwd_fake_scratch_is_the_routes_dtype(dtype):
    """The gated backward's fake returns dpre in the dtype each route
    allocates (``dpre_dtype``): f32 for f32 inputs, bf16 for bf16 ones on
    either bf16 route, the tensor cores' and the CUDA cores' (widths off 8,
    no rows), so a probe charges what the card allocates; the plain version
    (the CPU path) returns the same dtype."""
    assert MG.dpre_dtype(dtype) == dtype
    gs = torch.tensor([10, 0, 20], dtype=torch.int32)
    for t, d, f in [(40, 8, 16), (40, 6, 10), (0, 8, 16)]:
        routes = {MG.gmm_bwd_route(dtype, t, d, f, True)}
        x, w, dy = (torch.zeros(s, dtype=dtype)
                    for s in ((t, d), (3, d, f), (t, f)))
        with FakeTensorMode(allow_non_fake_inputs=True):
            dpre = torch.ops.repro_torch.moe_gmm_gated_bwd(
                dy, x, w, w, gs, "silu_gated")[3]
        assert dpre.dtype == dtype and dpre.shape == (2, t, f), routes
        plain = MG.moe_gmm_gated_bwd_plain(dy, x, w, w, gs, "silu_gated")[3]
        assert plain.dtype == dtype and plain.shape == (2, t, f)


@pytest.mark.parametrize("aligned", [True, False])
def test_gmm_bwd_route_by_dtype_shape_and_alignment(aligned):
    """The backward's route: f32 on the CUDA cores always; bf16 on the
    tensor cores where TMA takes the operands (widths multiples of 8 above
    0, at least one row, 16-byte aligned pointers), else on the CUDA
    cores. ``ROUTES``/``BWD_ROUTES`` give the C side's route numbers."""
    bf16 = torch.bfloat16
    assert MG.gmm_bwd_route(torch.float32, 8192, 4096, 14336,
                            aligned) == "f32"
    want = "wgmma" if aligned else "cuda_cores"
    assert MG.gmm_bwd_route(bf16, 8192, 4096, 14336, aligned) == want
    assert MG.gmm_bwd_route(bf16, 1, 8, 8, aligned) == want
    for t, d, f in [(77, 50, 70), (200, 72, 132), (0, 64, 64), (5, 0, 8),
                    (5, 8, 0)]:
        assert MG.gmm_bwd_route(bf16, t, d, f, aligned) == "cuda_cores"
    assert MG.BWD_ROUTES == {"f32": 0, "cuda_cores": 0, "wgmma": 1}


# (dtype, t, d, f, e, aligned) -> the forward's route, as before the
# backward got its own routes: float32 always "f32"; bf16 "wgmma" where TMA
# takes the operands and more than 16 rows an expert on average
@pytest.mark.parametrize("args,route", [
    ((torch.float32, 8192, 4096, 14336, 8, True), "f32"),
    ((torch.float32, 7, 5, 3, 2, False), "f32"),
    ((torch.bfloat16, 8192, 4096, 14336, 8, True), "wgmma"),
    ((torch.bfloat16, 8, 4096, 14336, 8, True), "small"),
    ((torch.bfloat16, 129, 64, 64, 8, True), "wgmma"),
    ((torch.bfloat16, 128, 64, 64, 8, True), "small"),
    ((torch.bfloat16, 8192, 4096, 14336, 8, False), "small"),
    ((torch.bfloat16, 8192, 4092, 14336, 8, True), "small"),
    ((torch.bfloat16, 8192, 0, 14336, 8, True), "small")])
def test_gmm_forward_route_is_unchanged_for_every_dtype(args, route):
    assert MG.gmm_route(*args) == route


def _round_grad(t):
    """Identity whose gradient is rounded to bf16 on its way back."""
    class RoundGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a.view_as(a)

        @staticmethod
        def backward(ctx, g):
            return g.to(torch.bfloat16).to(g.dtype)
    return RoundGrad.apply(t)


@pytest.mark.parametrize("case", GMM_BWD_CASES)
@pytest.mark.parametrize("act", ["silu_gated", "gelu_gated"])
def test_gmm_gated_bwd_bf16_roundings_within_card_tolerance(act, case):
    """The bf16 gated backward rounds da and dg to bf16 before its products
    (the tensor cores take bf16 operands), and the plain version emulates
    it: its dx, dwi, dwg are within the card checks' bf16 tolerance (2e-2,
    of each gradient's largest magnitude, as the other bf16 checks against
    the reference) of ``jax.vjp`` of the reference's composition in bf16,
    whose autodiff holds these gradients in bf16 too. The emulation equals
    autograd through the plain f32 forward with the pre-activations'
    gradients rounded to bf16, and the rounding moves the result: the
    check is not vacuous."""
    t, groups = case
    rng = np.random.default_rng(5)
    x = rng.standard_normal((t, 48), dtype=np.float32)
    ws = [rng.standard_normal((len(groups), 48, 40), dtype=np.float32) / 7
          for _ in range(2)]
    dy = rng.standard_normal((t, 40), dtype=np.float32)
    jx, jdy, *jws = (jnp.asarray(a, jnp.bfloat16) for a in (x, dy, *ws))
    want = _jax_gmm_vjp(jx, jws, groups, act, jdy)
    tx, tdy, *tws = (convert.to_torch(np.asarray(a)) for a in (jx, jdy, *jws))
    gs = torch.tensor(groups, dtype=torch.int32)
    got = MG.moe_gmm_gated_bwd_plain(tdy, tx, *tws, gs, act)
    assert got[3].dtype == torch.bfloat16
    for g, w in zip(got[:3], want):
        np.testing.assert_allclose(
            convert.to_numpy(g).astype(np.float32), w, rtol=2e-2,
            atol=2e-2 * max(float(np.abs(w).max()), 1.0))
    # the same roundings through autograd of the plain forward in f32
    leaves = [v.float().requires_grad_(True) for v in (tx, *tws)]
    a = _round_grad(MG.moe_gmm_plain(leaves[0], leaves[1], gs))
    g = _round_grad(MG.moe_gmm_plain(leaves[0], leaves[2], gs))
    ref = torch.autograd.grad(MG.gated_act(a, act) * g, leaves, tdy.float())
    unrounded = MG.moe_gmm_gated_bwd_plain(tdy.float(), *(v.float() for v in
                                                          (tx, *tws)),
                                           gs, act)
    moved = 0.0
    for gb, r, u in zip(got[:3], ref, unrounded[:3]):
        torch.testing.assert_close(gb, r.to(torch.bfloat16), rtol=1e-2,
                                   atol=1e-2 * float(r.abs().max()))
        moved = max(moved, float((r - u).abs().max()))
    assert moved > 0.0


@pytest.mark.parametrize("act", ["silu_gated", "squared_relu"])
def test_moe_apply_gradients_reach_the_router_as_jax(act):
    """Autograd through the port's MoE layer (grouped matmuls with their
    backward ops, the dispatch's gathers, the combine weights and the aux
    loss) against ``jax.vjp`` of the reference's dense dispatch, f32: the
    gradients of x, the router and every expert weight of ``out + 0.01
    aux`` within 1e-4 of each one's largest magnitude, the router's
    nonzero."""
    cfg, p, x, tp, tx, tcfg = _moe_layer(act)
    dy = np.random.default_rng(9).standard_normal(x.shape, dtype=np.float32)

    def loss(xx, pp):
        out, aux = JMOE.moe_apply(pp, xx, cfg.moe, act)
        return jnp.sum(out * dy) + 0.01 * aux
    want_x, want_p = jax.grad(loss, argnums=(0, 1))(x, p)
    names = sorted(tp)
    leaves = [tx.clone().requires_grad_(True)] + [
        tp[k].clone().requires_grad_(True) for k in names]
    out, aux = TMOE.moe_apply(dict(zip(names, leaves[1:])), leaves[0], tcfg,
                              act)
    grads = torch.autograd.grad(
        (out * torch.from_numpy(dy)).sum() + 0.01 * aux, leaves)
    for name, g, w in zip(["x"] + names, grads,
                          [want_x] + [want_p[k] for k in names]):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=name)
    assert float(grads[1 + names.index("router")].abs().max()) > 0


@pytest.mark.gpu
def test_cuda_gmm_bwd_matches_plain_on_card():
    """The backward kernels (plain and gated, f32 and bf16, on the route
    the op picks and on each route forced) against the plain backward
    (bf16 atol = rtol = 2e-2, f32 1e-4), the same bits on two calls, dx
    zero past the groups, one counted launch a call. The gated pair's
    dpre is held against the plain version's; in bf16 both round it, and
    an element at a rounding boundary may round one bf16 unit apart, which
    dw carries times x, so there dx, dwi and dwg are held against the plain
    products of the kernels' own dpre
    (``moe_gmm_gated_bwd_products_plain``): the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for t, d, f, groups in [(1024, 512, 1024, (300, 0, 1, 129, 200, 77)),
                            (200, 72, 136, (0, 64, 1, 100)),
                            (4, 64, 64, (1, 1, 1, 1)), (0, 64, 64, (0, 0))]:
        gs = torch.tensor(groups, dtype=torch.int32, device=dev)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x, dy = (torch.randn(s, generator=gen, device=dev).to(dtype)
                     for s in ((t, d), (t, f)))
            ws = [(torch.randn(len(groups), d, f, generator=gen, device=dev)
                   / d ** 0.5).to(dtype) for _ in range(2)]
            # the op's pick, then each route forced
            routes = [None] + (["f32"] if dtype == torch.float32 else sorted(
                {"cuda_cores", MG.gmm_bwd_route(dtype, t, d, f, True)}))
            for act, route in [(a, r) for a in (None, "silu_gated",
                                                 "gelu_gated")
                               for r in routes]:
                before = MG.BWD_LAUNCHES.value
                if act is None:
                    def call():
                        if route:
                            return MG._launch_bwd(dy, x, ws[0], gs,
                                                  route=route)
                        return torch.ops.repro_torch.moe_gmm_bwd(
                            dy, x, ws[0], gs)
                    want = MG.moe_gmm_bwd_plain(dy, x, ws[0], gs)
                else:
                    def call():
                        if route:
                            return MG._launch_bwd(dy, x, ws[0], gs,
                                                  wg=ws[1], act=act,
                                                  route=route)
                        return torch.ops.repro_torch.moe_gmm_gated_bwd(
                            dy, x, *ws, gs, act)
                    want = MG.moe_gmm_gated_bwd_plain(dy, x, *ws, gs, act)
                got, again = call(), call()
                torch.cuda.synchronize()
                assert MG.BWD_LAUNCHES.value == before + 2
                if act is not None:
                    torch.testing.assert_close(got[3].float(),
                                               want[3].float(), rtol=tol,
                                               atol=tol)
                    if dtype == torch.bfloat16:
                        want = MG.moe_gmm_gated_bwd_products_plain(
                            got[3], x, *ws, gs)
                for g, w, g2 in zip(got, want, again):
                    torch.testing.assert_close(g.float(), w.float(),
                                               rtol=tol, atol=tol)
                    assert torch.equal(g, g2)
                assert torch.equal(got[-1], again[-1])
                assert not bool(got[0][sum(groups):].ne(0).any())
