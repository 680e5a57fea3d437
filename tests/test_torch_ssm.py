"""The port's Mamba-1 path (``kernels/mamba_scan``, ``models/ssm``, the ssm
family of ``models/model`` and ``models/decode``, serving falcon-mamba)
against the JAX package, on the same numpy inputs made from a seed.

On the CPU the scan wrapper takes its plain version. The Pallas scan no
longer runs on the installed jax (``pl.load`` is gone), so the scan is held
against ``kernels/ref.py::mamba_scan_ref`` (zero h0) and the model's own
``_scan_chunked``, within 1e-5 as ``tests/test_kernels.py:114-116``. Blocks:
f32 within 1e-4, bf16 within 2e-2. The reduced falcon-mamba (4 layers,
d_model 128, chunk 32) runs at S = 64, a multiple of the reference's chunk;
hidden states and logits within 2e-3 as the dense model's tests, greedy
tokens equal. Its decode caches are f32 here: on a bf16 cache with f32
weights the reference's decode promotes the conv state to f32 (a new array)
while the port writes it back in place in the cache's dtype.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.serve import decode as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_arch as port_arch  # noqa: E402
from repro_torch.core import probe as P  # noqa: E402
from repro_torch.kernels import mamba_scan as SC  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.serve import decode as TS  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "falcon-mamba-7b"
B, S, GEN = 2, 64, 8


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _scan_inputs(shape, seed=0):
    """a = exp(-|randn|) and b = randn, as ``tests/test_kernels.py:108``."""
    rng = np.random.default_rng(seed)
    a = np.exp(-np.abs(rng.standard_normal(shape, dtype=np.float32)))
    return a, rng.standard_normal(shape, dtype=np.float32)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

# tests/test_kernels.py:103-104, then S = 1, S = 7 and E*N = 15
SCAN_SHAPES = [(1, 64, 128, 16), (2, 128, 256, 16), (2, 96, 128, 64),
               (2, 1, 8, 4), (1, 7, 5, 3)]


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_scan_matches_ref(shape, fn):
    a, b = _scan_inputs(shape)
    scan = SC.mamba_scan_plain if fn == "plain" else SC.mamba_scan
    h_all, h_last = scan(torch.from_numpy(a), torch.from_numpy(b))
    ra, rl = R.mamba_scan_ref(jnp.asarray(a), jnp.asarray(b),
                              jnp.zeros((shape[0],) + shape[2:]))
    np.testing.assert_allclose(h_all.numpy(), np.asarray(ra), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(rl), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", SCAN_SHAPES[:3])
def test_scan_matches_chunked_scan_of_the_model(shape):
    a, b = _scan_inputs(shape, seed=1)
    h_all, h_last = SC.mamba_scan(torch.from_numpy(a), torch.from_numpy(b))
    ra, rl = JSSM._scan_chunked(jnp.asarray(a), jnp.asarray(b),
                                jnp.zeros((shape[0],) + shape[2:]), 32)
    np.testing.assert_allclose(h_all.numpy(), np.asarray(ra), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(rl), rtol=1e-5,
                               atol=1e-5)


def test_scan_wrapper_takes_plain_on_cpu_and_counts_flops():
    from torch.utils.flop_counter import FlopCounterMode
    a, b = (torch.from_numpy(t) for t in _scan_inputs((2, 9, 6, 4)))
    before = SC.LAUNCHES.value
    with FlopCounterMode(display=False) as fc:
        h_all, h_last = SC.mamba_scan(a, b)
    assert SC.LAUNCHES.value == before  # no kernel launch for a CPU tensor
    want_all, want_last = SC.mamba_scan_plain(a, b)
    assert torch.equal(h_all, want_all) and torch.equal(h_last, want_last)
    assert fc.get_total_flops() == 2 * a.numel()


# ---------------------------------------------------------------------------
# the Mamba-1 block
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _block(dtype: str):
    """Reduced falcon-mamba's SSM config and one layer's JAX parameters."""
    cfg = get_arch(ARCH).reduced()
    p = JM._mamba1_params(jax.random.PRNGKey(3), cfg, (), getattr(jnp, dtype))
    tp = {k: convert.to_torch(np.asarray(v)) for k, v in p.items()}
    return cfg, p, tp


def _x(shape, dtype, seed=5):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32), getattr(jnp, dtype))
    return x, convert.to_torch(np.asarray(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(dtype):
    _, p, tp = _block(dtype)
    x, tx = _x((B, 40, p["conv_w"].shape[0]), dtype)
    want = JSSM.causal_conv1d(x, p["conv_w"], p["conv_b"])
    got = TSSM.causal_conv1d(tx, tp["conv_w"], tp["conv_b"])
    np.testing.assert_allclose(convert.to_numpy(got),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_step_matches_jax_and_shifts_state_in_place(dtype):
    _, p, tp = _block(dtype)
    e = p["conv_w"].shape[0]
    x, tx = _x((B, e), dtype)
    st, tst = _x((B, 3, e), dtype, seed=6)
    want, want_st = JSSM.conv1d_step(x, st, p["conv_w"], p["conv_b"])
    got = TSSM.conv1d_step(tx, tst, tp["conv_w"], tp["conv_b"])
    np.testing.assert_allclose(convert.to_numpy(got),
                               np.asarray(want, np.float32), **_tol(dtype))
    np.testing.assert_array_equal(convert.to_numpy(tst),
                                  np.asarray(want_st, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_apply_matches_jax(dtype):
    cfg, p, tp = _block(dtype)
    x, tx = _x((B, S, cfg.d_model), dtype)
    want, wst = JSSM.mamba1_apply(p, x, cfg.ssm, chunk=cfg.ssm.chunk,
                                  return_state=True)
    got, gst = TSSM.mamba1_apply(tp, tx, cfg.ssm, return_state=True)
    assert got.dtype == tx.dtype and gst["ssm"].dtype == torch.float32
    np.testing.assert_allclose(convert.to_numpy(got),
                               np.asarray(want, np.float32), **_tol(dtype))
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(convert.to_numpy(gst[key]),
                                   np.asarray(wst[key], np.float32),
                                   **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_decode_step_matches_jax_in_place(dtype):
    cfg, p, tp = _block(dtype)
    e = p["conv_w"].shape[0]
    x, tx = _x((B, cfg.d_model), dtype)
    conv, tconv = _x((B, 3, e), dtype, seed=7)
    rng = np.random.default_rng(8)
    ssm = rng.standard_normal((B, e, cfg.ssm.state_dim), dtype=np.float32)
    state = {"conv": tconv, "ssm": torch.from_numpy(ssm.copy())}
    want, wst = JSSM.mamba1_decode_step(
        p, x, {"conv": conv, "ssm": jnp.asarray(ssm)}, cfg.ssm)
    got = TSSM.mamba1_decode_step(tp, tx, state, cfg.ssm)
    np.testing.assert_allclose(convert.to_numpy(got),
                               np.asarray(want, np.float32), **_tol(dtype))
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(convert.to_numpy(state[key]),
                                   np.asarray(wst[key], np.float32),
                                   **_tol(dtype))


# ---------------------------------------------------------------------------
# reduced falcon-mamba: forward, prefill, decode, greedy tokens
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model():
    cfg, tcfg = get_arch(ARCH).reduced(), port_arch(ARCH).reduced()
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                            dtype=np.int32)
    jl, jc = JS.make_prefill_step(cfg)(params, {"tokens": jnp.asarray(tok)})
    tl, tc = TS.make_prefill_step(tcfg)(tparams,
                                        {"tokens": torch.from_numpy(tok)})
    return cfg, tcfg, params, tparams, tok, (jl, jc), (tl, tc)


def _f32_caches():
    """(JAX cache, port cache): the prefill states in f32 decode caches."""
    cfg, tcfg, *_, (_, jc), (_, tc) = _model()
    jcache = JD.cache_insert(JD.init_cache(cfg, B, S + GEN, jnp.float32),
                             jc, 0)
    tcache = TD.cache_insert(
        TD.init_cache(tcfg, B, S + GEN, torch.float32, device="cpu"),
        {k: v.clone() for k, v in tc.items()}, 0)
    return jcache, tcache


def test_forward_hidden_matches_jax():
    cfg, tcfg, params, tparams, tok, *_ = _model()
    h, _ = JM.forward(params, cfg, {"tokens": jnp.asarray(tok)})
    th, _ = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(th.numpy(), np.asarray(h), rtol=2e-3,
                               atol=2e-3)


def test_prefill_logits_and_state_cache_match_jax():
    cfg, tcfg, *_, (jl, jc), (tl, tc) = _model()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                               atol=2e-3)
    assert set(tc) == set(jc) == {"conv", "ssm"}
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(convert.to_numpy(tc[key]),
                                   np.asarray(jc[key], np.float32),
                                   rtol=2e-3, atol=2e-3)
    want = TD.init_cache(tcfg, B, S, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in want.items()} == {
        "conv": (tc["conv"].shape, torch.bfloat16),
        "ssm": (tc["ssm"].shape, torch.float32)}


def test_decode_step_matches_jax_and_updates_cache_in_place():
    cfg, tcfg, params, tparams, _, (jl, _), _ = _model()
    jcache, tcache = _f32_caches()
    ssm_buf = tcache["ssm"]
    nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    l2, jcache = JD.decode_step(params, cfg, jcache, jnp.asarray(nxt),
                                jnp.asarray(S, jnp.int32))
    t2, tcache = TD.decode_step(tparams, tcfg, tcache,
                                torch.from_numpy(nxt.copy()), S)
    assert tcache["ssm"] is ssm_buf
    np.testing.assert_allclose(t2.numpy(), np.asarray(l2), rtol=2e-3,
                               atol=2e-3)
    for key in jcache:
        np.testing.assert_allclose(convert.to_numpy(tcache[key]),
                                   np.asarray(jcache[key], np.float32),
                                   rtol=2e-3, atol=2e-3)


def test_greedy_tokens_match_jax():
    cfg, tcfg, params, tparams, _, (jl, _), _ = _model()
    jcache, tcache = _f32_caches()
    first = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    jt, _ = JS.greedy_generate(cfg, params, jcache, jnp.asarray(first), S,
                               GEN)
    tt, _ = TS.greedy_generate(tcfg, tparams, tcache,
                               torch.from_numpy(first.copy()), S, GEN)
    assert tt.shape == (B, GEN) and tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_cache_from_jax_keeps_the_layout():
    _, _, *_, (_, jc), (_, tc) = _model()
    moved = convert.cache_from_jax(jax.tree_util.tree_map(np.asarray, jc))
    for key in jc:
        assert moved[key].shape == tc[key].shape
        np.testing.assert_array_equal(moved[key].numpy(), np.asarray(jc[key]))


def test_probe_flops_count_the_scan():
    """Probe FLOPs = matmuls + 2·B·S·E·N per layer for the scan (its flop
    formula) + the last token's logits, exactly."""
    _, tcfg, _, tparams, tok, *_ = _model()
    tv = P.probe_fn(TS.make_prefill_step(tcfg), tparams,
                    {"tokens": torch.from_numpy(tok)})
    d, n = tcfg.d_model, tcfg.ssm.state_dim
    e, r = tcfg.ssm.expand * d, d // 16
    per_token = 2 * (d * 2 * e + e * (r + 2 * n) + r * e + e * n + e * d)
    scan = 2 * B * S * e * n
    want = (per_token * B * S + scan) * tcfg.n_layers + 2 * B * d * tcfg.vocab
    assert tv.flops == want


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serve_falcon_mamba_on_cpu_completes_every_batch():
    res = serve(ARCH, device="cpu")
    assert res["arch"] == "falcon-mamba-7b-reduced"
    assert res["batches"] == 4 and res["completed"] == 4
    assert res["crashed"] == 0 and res["errors"] == []
    assert res["tokens_generated"] == 16 * 32
    assert res["probe"].hbm_bytes > 0 and res["probe"].flops > 0
    assert [g.shape for g in res["generated"]] == [(4, 32)] * 4


def test_serve_falcon_mamba_f32_decodes_like_jax(monkeypatch):
    """serve() at f32 on the JAX model's weights: each batch's tokens and
    its final decode states (the pool worker's decoder's, read after each
    batch) equal JAX prefill + ``greedy_generate`` on the same prompt. The
    prefill states go to decode as they are, in f32."""
    import repro_torch.launch.serve as LS
    cfg, tcfg, params, tparams, *_ = _model()
    monkeypatch.setattr(LS, "init_params", lambda *a, **k: tparams)
    states = []
    decode = LS.GreedyDecoder.generate

    def generate(self, num_steps, **kw):  # kw: the runner's stop check
        out = decode(self, num_steps, **kw)
        states.append({k: v.clone() for k, v in self.cache.items()})
        return out

    monkeypatch.setattr(LS.GreedyDecoder, "generate", generate)
    res = serve(ARCH, requests=2 * B, batch=B, prompt_len=S, gen_len=GEN,
                device="cpu")
    assert res["completed"] == 2 and res["errors"] == []
    rng = np.random.default_rng(0)  # serve()'s prompts, made from its seed
    prefill = JS.make_prefill_step(cfg)
    for got, state in zip(res["generated"], states):
        tok = rng.integers(0, cfg.vocab, (B, S), dtype=np.int64)
        logits, cache = prefill(params, {"tokens": jnp.asarray(tok,
                                                              jnp.int32)})
        first = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out, cache = JS.greedy_generate(cfg, params, cache, first, S, GEN - 1)
        np.testing.assert_array_equal(
            got, np.concatenate([np.asarray(first)[:, None],
                                 np.asarray(out)], axis=1))
        assert state["conv"].dtype == state["ssm"].dtype == torch.float32
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(state[key].numpy(),
                                       np.asarray(cache[key]), rtol=1e-4,
                                       atol=1e-4)


# ---------------------------------------------------------------------------
# the CUDA kernel itself (runs on the card only)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_scan_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a")
    for shape in [(2, 128, 256, 16), (1, 1, 8, 4), (1, 7, 5, 3),
                  (3, 33, 17, 64), (4, 256, 8192, 16)]:
        a, b = (torch.from_numpy(t).cuda() for t in _scan_inputs(shape))
        before = SC.LAUNCHES.value
        h_all, h_last = SC.mamba_scan(a, b)
        torch.cuda.synchronize()
        assert SC.LAUNCHES.value == before + 1
        want_all, want_last = SC.mamba_scan_plain(a, b)
        torch.testing.assert_close(h_all, want_all, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(h_last, want_last, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError):
        SC.mamba_scan(a[:, ::2], b[:, ::2])


# ---------------------------------------------------------------------------
# the scan's backward
# ---------------------------------------------------------------------------

# S a multiple of the chunk handed to the reference's _scan_chunked (16)
SCAN_BWD_SHAPES = [(1, 64, 128, 16), (2, 32, 96, 4), (2, 16, 5, 3)]


@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES)
def test_scan_bwd_plain_matches_jax_vjp(shape):
    """The plain reverse scan (``mamba_scan_bwd_plain``, fed the forward's
    h_all) and the op's CPU backward through ``register_autograd``, given
    gradients of both h_all and h_last, against ``jax.vjp`` of the
    reference's ``_scan_chunked`` from a zero state: f32, within 1e-5 of
    the reference's largest magnitude (sums in another order)."""
    a, b = _scan_inputs(shape, seed=2)
    rng = np.random.default_rng(4)
    dh = rng.standard_normal(shape, dtype=np.float32)
    dl = rng.standard_normal((shape[0],) + shape[2:], dtype=np.float32)
    h0 = jnp.zeros((shape[0],) + shape[2:], jnp.float32)
    _, vjp = jax.vjp(lambda x, y: JSSM._scan_chunked(x, y, h0, 16),
                     jnp.asarray(a), jnp.asarray(b))
    want = [np.asarray(g) for g in vjp((jnp.asarray(dh), jnp.asarray(dl)))]
    ta, tb, tdh, tdl = (torch.from_numpy(t) for t in (a, b, dh, dl))
    h_all, _ = SC.mamba_scan_plain(ta, tb)
    before = SC.BWD_LAUNCHES.value
    plain = SC.mamba_scan_bwd_plain(ta, h_all, tdh, tdl)
    leaves = [ta.clone().requires_grad_(True), tb.clone().requires_grad_(True)]
    grads = torch.autograd.grad(SC.mamba_scan(*leaves), leaves, (tdh, tdl))
    assert SC.BWD_LAUNCHES.value == before  # CPU tensors: the plain version
    for got in (plain, grads):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()))
    assert (plain[0][:, 0] == 0).all()  # h_{-1} = 0


def test_scan_bwd_equals_autograd_of_the_plain_scan_and_gradchecks():
    """The plain backward is autograd through ``mamba_scan_plain``, the
    same arithmetic to the bit in f32; the op's backward passes
    ``gradcheck`` in f64, also when only h_all is used (dh_last None)."""
    a, b = (torch.from_numpy(t) for t in _scan_inputs((2, 9, 3, 4), seed=6))
    dh, dl = torch.randn(2, 9, 3, 4), torch.randn(2, 3, 4)
    leaves = [a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    ref = torch.autograd.grad(SC.mamba_scan_plain(*leaves), leaves, (dh, dl))
    h_all, _ = SC.mamba_scan_plain(a, b)
    for g, w in zip(SC.mamba_scan_bwd_plain(a, h_all, dh, dl), ref):
        assert torch.equal(g, w)
    a64, b64 = (t.double().requires_grad_(True) for t in (a, b))
    assert torch.autograd.gradcheck(SC.mamba_scan, (a64, b64))
    assert torch.autograd.gradcheck(lambda x, y: SC.mamba_scan(x, y)[0],
                                    (a64, b64))


def test_scan_bwd_fake_shapes_and_flops():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode():
        a = torch.empty(2, 5, 3, 4)
        da, db = torch.ops.repro_torch.mamba_scan_bwd(a, a, a, a[:, 0])
        assert da.shape == db.shape == a.shape
    a = torch.zeros(2, 5, 3, 4)
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.mamba_scan_bwd(a, a, a, a[:, 0])
    assert fc.get_total_flops() == 3 * a.numel()


@pytest.mark.parametrize("policy", ["nothing", "full"])
def test_mamba1_apply_gradients_match_jax_vjp(policy):
    """Autograd through the port's Mamba-1 block (the scan's backward op,
    ``a`` made by an in-place exp and the names ``del``eted after the scan)
    against ``jax.vjp`` of the reference's block, f32: gradients of x and
    of every parameter within 1e-4 of each one's largest magnitude; under
    ``full`` the block is a checkpoint recomputed in the backward."""
    from repro_torch.models.model import _remat
    cfg, p, tp = _block("float32")
    x, tx = _x((B, S, cfg.d_model), "float32")
    dy = np.random.default_rng(8).standard_normal((B, S, cfg.d_model),
                                                  dtype=np.float32)
    _, vjp = jax.vjp(lambda xx, pp: JSSM.mamba1_apply(
        pp, xx, cfg.ssm, chunk=cfg.ssm.chunk), x, p)
    want_x, want_p = vjp(jnp.asarray(dy))
    names = sorted(tp)
    leaves = [tx.clone().requires_grad_(True)] + [
        tp[k].clone().requires_grad_(True) for k in names]
    tcfg = port_arch(ARCH).reduced()
    block = _remat(lambda xx, *ps: TSSM.mamba1_apply(
        dict(zip(names, ps)), xx, tcfg.ssm), policy)
    grads = torch.autograd.grad(block(*leaves), leaves, torch.from_numpy(dy))
    for g, w in zip(grads, [want_x] + [want_p[k] for k in names]):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.gpu
def test_cuda_scan_bwd_matches_plain_on_card():
    """The reverse-scan kernel against the plain backward and autograd
    through the plain scan (f32, 1e-4), the same bits on two calls, one
    launch a call; edge cases and a falcon-mamba-7b training slice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a")
    for shape in [(1, 1, 8, 4), (1, 7, 5, 3), (3, 33, 17, 64),
                  (2, 256, 8192, 16)]:
        a, b = (torch.from_numpy(t).cuda() for t in _scan_inputs(shape))
        dh = torch.randn(shape, device="cuda")
        dl = torch.randn(shape[:1] + shape[2:], device="cuda")
        h_all, _ = SC.mamba_scan(a, b)
        before = SC.BWD_LAUNCHES.value
        got = torch.ops.repro_torch.mamba_scan_bwd(a, h_all, dh, dl)
        again = torch.ops.repro_torch.mamba_scan_bwd(a, h_all, dh, dl)
        torch.cuda.synchronize()
        assert SC.BWD_LAUNCHES.value == before + 2
        want = SC.mamba_scan_bwd_plain(a, h_all, dh, dl)
        leaves = [a.clone().requires_grad_(True),
                  b.clone().requires_grad_(True)]
        ref = torch.autograd.grad(SC.mamba_scan_plain(*leaves), leaves,
                                  (dh, dl))
        for g, w, r, g2 in zip(got, want, ref, again):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
            assert torch.equal(g, g2)
