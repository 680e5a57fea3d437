"""The port's backward kernels (``repro_torch.kernels``) against
``jax.vjp`` of the JAX package's functions, the rows that see no key
(ROADMAP C10), and the head dims 80 and 192 and RMSNorm's wide rows (the
forward kernels: ``tests/test_torch_kernels.py``, whose docstring gives
the routes and tolerances).

On the CPU each wrapper takes its kernel's plain PyTorch version; these tests
hold that version against the JAX references on the same numpy inputs. The
CUDA kernels run only on the card: the ``gpu`` tests skip here.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# backward: flash attention and RMSNorm against jax.vjp of the reference
# ---------------------------------------------------------------------------

# (b, hq, hkv, s, d, softcap, window): f32; GQA 4/2; softcap 50; window 0
# and a window shorter than S; S = 600, ragged against the reference's
# 512-key blocks
BWD_CASES = [(2, 2, 2, 128, 32, 0.0, 0), (1, 4, 2, 128, 32, 0.0, 0),
             (1, 4, 2, 96, 64, 50.0, 0), (1, 4, 2, 128, 32, 0.0, 40),
             (1, 4, 2, 600, 32, 50.0, 0), (1, 2, 1, 600, 32, 50.0, 200)]


def _bwd_inputs(case, seed=0):
    b, hq, hkv, s, d, cap, win = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(shape, dtype=np.float32)
                   for shape in ((b, hq, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d), (b, hq, s, d)))
    return q, k, v, do


def _jax_flash_vjp(q, k, v, do, cap, win):
    out, vjp = jax.vjp(lambda a, b, c: JL.flash_attention_cvjp(
        a, b, c, causal=True, window=win, logit_softcap=cap),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want, rel=1e-5):
    """Within ``rel`` of the reference's largest magnitude, elementwise:
    f32 sums taken in another order (einsum blocks, the GQA fold)."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_plain_matches_jax_vjp(case):
    """The port's plain backward (from the plain forward's o and lse) and
    the op's CPU backward through ``register_autograd`` against ``jax.vjp``
    of the reference's custom-VJP flash attention, f32, 1e-5 relative."""
    b, hq, hkv, s, d, cap, win = case
    q, k, v, do = _bwd_inputs(case)
    want_o, want = _jax_flash_vjp(q, k, v, do, cap, win)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = FA.flash_attention_lse_plain(tq, tk, tv, causal=True,
                                          window=win, logit_softcap=cap)
    _close(o.numpy(), want_o)
    plain = FA.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                         causal=True, window=win,
                                         logit_softcap=cap)
    for g, w in zip(plain, want):
        _close(g.numpy(), w)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    before = FA.BWD_LAUNCHES.value
    out = FA.flash_attention(*leaves, window=win, logit_softcap=cap)
    grads = torch.autograd.grad(out, leaves, tdo)
    assert FA.BWD_LAUNCHES.value == before  # CPU tensors: the plain version
    _close(out.detach().numpy(), want_o)
    for g, w in zip(grads, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("cap,win", [(0.0, 0), (5.0, 3)])
def test_flash_op_passes_gradcheck(cap, win):
    """``torch.autograd.gradcheck`` of the differentiable flash op in f64 at
    a tiny GQA shape: its backward (the plain recompute backward on the
    CPU) against finite differences."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 9, 8, dtype=torch.float64, generator=gen)
    k = torch.randn(1, 2, 9, 8, dtype=torch.float64, generator=gen)
    v = torch.randn(1, 2, 9, 8, dtype=torch.float64, generator=gen)
    args = [t.requires_grad_(True) for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: FA.flash_attention(a, b, c, window=win,
                                           logit_softcap=cap), args)


def test_flash_uses_the_lse_op_only_under_autograd():
    """Without grad (the serving paths) the forward op runs and writes no
    lse; under autograd the differentiable op; both give one output."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 16, 32),
                                                    dtype=np.float32))
               for _ in range(3))
    plain = FA.flash_attention(q, k, v)
    assert plain.grad_fn is None
    with torch.no_grad():
        assert torch.equal(FA.flash_attention(q.requires_grad_(True), k, v),
                           plain)
    out = FA.flash_attention(q, k, v)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), plain.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_flash_bwd_flop_formula_is_five_products():
    from torch.utils.flop_counter import FlopCounterMode
    q = torch.zeros(2, 4, 10, 32)
    k = torch.zeros(2, 2, 10, 32)
    pairs = FA.visible_pairs(10, 10, causal=True, window=3)
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.flash_attention_bwd(q, k, k, q, q[..., 0], q,
                                                  True, 3, 0.0)
    assert fc.get_total_flops() == 10 * 2 * 4 * pairs * 32


def _tc_bwd_emulated(q, k, v, o, lse, do, *, window, cap):
    """The bf16 tensor-core backward's arithmetic in plain PyTorch: f32
    products of the bf16 inputs, P and dS rounded to bf16 where they feed
    dV = P^T dO, dK = dS^T Q and dQ = dS K, f32 accumulation, each output
    rounded to bf16 once."""
    bf16 = torch.bfloat16
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    kr, vr = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * scale
    dcap = torch.ones_like(s)
    if cap:
        t = torch.tanh(s / cap)
        s, dcap = cap * t, 1.0 - t * t
    mask = FA.visible_mask(sq, sk, causal=True, window=window)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros(()))
    delta = (dof * o.float()).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    ds = p * dcap * (dp - delta[..., None])
    pb, dsb = p.to(bf16).float(), ds.to(bf16).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", dsb, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dsb, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", pb, dof)
    fold = (lambda x: x.reshape(b, hkv, g, sk, d).sum(2).to(bf16))
    return dq.to(bf16), fold(dk), fold(dv)


# (b, hq, hkv, s, d, softcap, window): gemma2-9b's training case cut to
# S 256 and 4 / 2 heads (D 256, softcap 50), and D 128 with a window
@pytest.mark.parametrize("case", [(1, 4, 2, 256, 256, 50.0, 0),
                                  (1, 4, 2, 256, 256, 50.0, 96),
                                  (2, 4, 2, 200, 128, 0.0, 64)])
def test_flash_bwd_tensor_core_roundings_within_card_tolerance(case):
    """The bf16 route rounds P and dS to bf16 before its three products
    (the tensor cores take bf16 operands): emulated here, its dq, dk, dv are
    within the card checks' bf16 tolerance (atol = rtol = 2e-2, as
    ``chip_smoke.compare`` and the gpu test hold the kernel) of
    ``flash_attention_bwd_plain`` in f32 on the same bf16 inputs."""
    b, hq, hkv, s, d, cap, win = case
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                   .to(torch.bfloat16)
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                                 (b, hq, s, d)))
    o, lse = FA.flash_attention_lse_plain(q, k, v, causal=True, window=win,
                                          logit_softcap=cap)
    got = _tc_bwd_emulated(q, k, v, o, lse, do, window=win, cap=cap)
    want = FA.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(),
        causal=True, window=win, logit_softcap=cap)
    for g, w in zip(got, want):
        err = (g.float() - w).abs()
        assert bool((err <= 2e-2 + 2e-2 * w.abs()).all()), float(err.max())
        # the roundings move the result: the check is not vacuous
        assert float(err.max()) > 0.0


@pytest.mark.parametrize("shape", [(8, 256), (4, 96, 256), (1000, 512),
                                   (3, 100)])
def test_rmsnorm_bwd_matches_jax_vjp(shape):
    """The plain backward and the op's CPU backward against ``jax.vjp`` of
    the reference's ``layers.rms_norm``, f32, 1e-5 relative."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape, dtype=np.float32)
    sc = rng.standard_normal(shape[-1:], dtype=np.float32) * 0.1
    dy = rng.standard_normal(shape, dtype=np.float32)
    _, vjp = jax.vjp(JL.rms_norm, jnp.asarray(x), jnp.asarray(sc))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    tx, tsc, tdy = (torch.from_numpy(a) for a in (x, sc, dy))
    for g, w in zip(RN.rmsnorm_bwd_plain(tx, tsc, tdy), want):
        _close(g.numpy(), w)
    leaves = [tx.clone().requires_grad_(True),
              tsc.clone().requires_grad_(True)]
    before = RN.BWD_LAUNCHES.value
    grads = torch.autograd.grad(RN.rmsnorm(*leaves), leaves, tdy)
    assert RN.BWD_LAUNCHES.value == before
    for g, w in zip(grads, want):
        _close(g.numpy(), w)


def test_rmsnorm_op_passes_gradcheck():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 16, dtype=torch.float64, generator=gen)
    sc = torch.randn(16, dtype=torch.float64, generator=gen) * 0.1
    assert torch.autograd.gradcheck(
        RN.rmsnorm, (x.requires_grad_(True), sc.requires_grad_(True)))


# ---------------------------------------------------------------------------
# rows that see no key (ROADMAP C10): o = 0, lse = +inf, no gradient
# ---------------------------------------------------------------------------

# (b, hq, hkv, sq, sk) and the window: top-left causal with Sq > Sk, so the
# rows from Sk + window - 1 = 81 on see no key (48 of 129)
C10_SHAPE, C10_WINDOW = (2, 2, 1, 129, 65), 17


def _c10_inputs(d, seed=5):
    """q, k, v, dO of the C10 shape at head dim d, numpy f32."""
    b, hq, hkv, sq, sk = C10_SHAPE
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in
            ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d))]


def _c10_sees():
    sq, sk = C10_SHAPE[3:]
    sees = FA.visible_mask(sq, sk, causal=True, window=C10_WINDOW).any(-1)
    assert int((~sees).sum()) == sq - (sk + C10_WINDOW - 1) == 48
    return sees


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_rows_that_see_no_key(d, dtype):
    """The plain forward, the plain forward with lse and the plain backward
    give exactly the rows that ``visible_mask`` says see no key o = 0, lse =
    +inf and no gradient: dQ is 0 there and those rows' dO moves nothing.
    The plain backward equals autograd through the plain forward on every
    output (f32 within 1e-5 of the largest magnitude, f64 within 1e-10)."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _c10_inputs(d))
    sees = _c10_sees()
    kw = dict(causal=True, window=C10_WINDOW, logit_softcap=0.0)
    o = FA.flash_attention_plain(q, k, v, **kw)
    o_lse, lse = FA.flash_attention_lse_plain(q, k, v, **kw)
    for out in (o, o_lse):
        assert not bool(out[:, :, ~sees].any())
        assert bool((out[:, :, sees].abs().amax(-1) > 0).all())
    assert bool((lse[:, :, ~sees] == math.inf).all())
    assert bool(torch.isfinite(lse[:, :, sees]).all())
    rel = 1e-10 if dtype == torch.float64 else 1e-5
    _close(o_lse.numpy(), o.numpy(), rel)
    grads = FA.flash_attention_bwd_plain(q, k, v, o_lse, lse, do, **kw)
    assert not bool(grads[0][:, :, ~sees].any())
    quiet = FA.flash_attention_bwd_plain(q, k, v, o_lse, lse,
                                         do * sees[:, None].to(dtype), **kw)
    for g, w in zip(grads, quiet):
        assert torch.equal(g, w)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(FA.flash_attention_plain(*leaves, **kw),
                              leaves, do)
    for g, w in zip(grads, ref):
        assert bool(torch.isfinite(g).all())
        _close(g.numpy(), w.numpy(), rel)


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_rows_that_see_no_key_depart_from_jax(d):
    """Against the JAX package on the same numpy inputs: on the rows that
    see a key the port's forward equals ``naive_attention`` and, through the
    op's CPU backward, its dq, dk, dv equal ``jax.vjp`` of
    ``flash_attention_cvjp`` given the no-key rows' dO as zeros (f32, 1e-5
    of the largest magnitude). On the no-key rows the port gives zeros and
    passes no gradient, where ``naive_attention`` gives V's mean."""
    q, k, v, do = _c10_inputs(d)
    sees = _c10_sees()
    g = C10_SHAPE[1] // C10_SHAPE[2]
    want_o = np.asarray(JL.naive_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=C10_WINDOW))
    np.testing.assert_allclose(
        want_o[:, :, ~sees.numpy()],
        np.broadcast_to(np.repeat(v.mean(axis=2, keepdims=True), g, axis=1),
                        want_o[:, :, ~sees.numpy()].shape),
        rtol=1e-5, atol=1e-5)
    _, want = _jax_flash_vjp(q, k, v, do * sees.numpy()[:, None], 0.0,
                             C10_WINDOW)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = FA.flash_attention(*leaves, window=C10_WINDOW)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    got_o = out.detach().numpy()
    assert not got_o[:, :, ~sees.numpy()].any()
    _close(got_o[:, :, sees.numpy()], want_o[:, :, sees.numpy()])
    for gr, w in zip(grads, want):
        _close(gr.numpy(), w)


@pytest.mark.gpu
def test_backward_rows_that_see_no_key_on_card():
    """ROADMAP C10, settled: with top-left causal, Sq > Sk and a window, the
    rows from Sk + window - 1 on see no key. On both routes and at every head
    dim the card's forward gives them o = 0 and lse = +inf and equals the
    plain forward with lse (o, and lse on the other rows); the card's
    backward, fed its own route's o and lse, equals the plain backward fed
    the same (dq, dk, dv; bf16 atol = rtol = 2e-2, f32 1e-4) and gives
    those rows dq = 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, hq, hkv, sq, sk = C10_SHAPE
    win = C10_WINDOW
    kw = dict(causal=True, window=win, logit_softcap=0.0)
    sees = _c10_sees().to(dev)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for d in FA.HEAD_DIMS:
            q, do = (torch.randn(b, hq, sq, d, generator=gen, device=dev)
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn(b, hkv, sk, d, generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            o, lse = torch.ops.repro_torch.flash_attention_lse(
                q, k, v, True, win, 0.0)
            want_o, want_lse = FA.flash_attention_lse_plain(q, k, v, **kw)
            assert not bool(o[:, :, ~sees].any())
            assert bool((lse[:, :, ~sees] == math.inf).all())
            torch.testing.assert_close(o.float(), want_o.float(), rtol=tol,
                                       atol=tol)
            torch.testing.assert_close(lse[:, :, sees], want_lse[:, :, sees],
                                       rtol=tol, atol=tol)
            got = torch.ops.repro_torch.flash_attention_bwd(
                q, k, v, o, lse, do, True, win, 0.0)
            want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
            for g, w in zip(got, want):
                assert bool(torch.isfinite(g).all())
                torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                           atol=tol)
            assert not bool(got[0][:, :, ~sees].any())


@pytest.mark.gpu
def test_rmsnorm_bwd_kernel_matches_plain_on_card():
    """RMSNorm's backward kernel against the plain backward in both dtypes
    at the train path's rows [4096, 3584], a ragged row count, d = 100 (the
    scalar path) and a 3-d input; dscale the same bits on two calls (bf16
    atol = rtol = 2e-2, f32 1e-4, as chip_smoke holds it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in [(4096, 3584), (4097, 3584), (7, 100), (3, 5, 128)]:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x, dy = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for _ in range(2))
            sc = (torch.randn(shape[-1:], generator=gen, device=dev) * 0.1) \
                .to(dtype)
            got = torch.ops.repro_torch.rmsnorm_bwd(x, sc, dy, 1e-5)
            again = torch.ops.repro_torch.rmsnorm_bwd(x, sc, dy, 1e-5)
            want = RN.rmsnorm_bwd_plain(x, sc, dy)
            for g, w in zip(got, want):
                assert g.shape == w.shape and g.dtype == w.dtype
                torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                           atol=tol)
            assert torch.equal(got[1], again[1])


@pytest.mark.gpu
def test_rmsnorm_kernel_matches_plain_on_card():
    """RMSNorm's forward kernel against its plain version for the four x /
    scale dtype pairs at every row class it takes its own way: prefill rows
    (zamba2-2.7b's [4096, 2560] and a ragged count, gemma2-9b's [4000,
    3584]), decode and loop rows ([4, 2560], [8, 5120]), nemotron-4-340b's
    [4096, 18432] (staged in shared memory), narrow rows ([1000, 512], a
    warp a row), d = 100 (the scalar path in bf16), a 3-d input, and an
    input whose pointer is off 16 bytes (the scalar path); two calls give
    the same bits (bf16 atol = rtol = 2e-2, f32 1e-4, as chip_smoke holds
    it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(4096, 2560), (4097, 2560), (4, 2560), (8, 5120),
              (4000, 3584), (4096, 18432), (1000, 512), (7, 100),
              (3, 5, 128), "off 16 bytes"]
    for shape in shapes:
        for xt, st in [(torch.float32, torch.float32),
                       (torch.float32, torch.bfloat16),
                       (torch.bfloat16, torch.float32),
                       (torch.bfloat16, torch.bfloat16)]:
            tol = 1e-4 if xt == torch.float32 else 2e-2
            if shape == "off 16 bytes":
                flat = torch.randn(64 * 2560 + 1, generator=gen, device=dev)
                x = flat.to(xt)[1:].view(64, 2560)
                assert x.is_contiguous() and x.data_ptr() % 16 != 0
            else:
                x = torch.randn(shape, generator=gen, device=dev).to(xt)
            sc = (torch.randn(x.shape[-1:], generator=gen, device=dev)
                  * 0.1).to(st)
            got = RN.rmsnorm(x, sc)
            again = RN.rmsnorm(x, sc)
            want = RN.rmsnorm_plain(x, sc)
            assert got.shape == x.shape and got.dtype == xt
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            assert torch.equal(got, again)


@pytest.mark.gpu
def test_backward_kernels_match_plain_on_card():
    """Both routes of the flash backward (f32 on the CUDA cores, bf16 on the
    tensor cores) at every head dim, with GQA, softcaps, windows and ragged
    Sq / Sk tails, against the plain backward, and the same bits on two
    calls; then RMSNorm's backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for (b, hq, hkv, sq, sk, d, cap, win) in [
                (1, 4, 2, 300, 300, 256, 50.0, 0),
                (2, 4, 2, 200, 200, 128, 0.0, 64),
                (1, 4, 2, 100, 300, 64, 0.0, 33),
                (2, 4, 4, 77, 77, 32, 0.0, 0),
                (1, 2, 1, 130, 90, 128, 20.0, 0),
                (1, 4, 2, 96, 96, 256, 0.0, 40)]:
            q, do = (torch.randn(b, hq, sq, d, generator=gen, device=dev)
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn(b, hkv, sk, d, generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            o, lse = torch.ops.repro_torch.flash_attention_lse(
                q, k, v, True, win, cap)
            got = torch.ops.repro_torch.flash_attention_bwd(
                q, k, v, o, lse, do, True, win, cap)
            again = torch.ops.repro_torch.flash_attention_bwd(
                q, k, v, o, lse, do, True, win, cap)
            want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                window=win, logit_softcap=cap)
            for g, w, g2 in zip(got, want, again):
                torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                           atol=tol)
                assert torch.equal(g, g2)
        x = torch.randn(1000, 3584, generator=gen, device=dev).to(dtype)
        sc = (torch.randn(3584, generator=gen, device=dev) * 0.1).to(dtype)
        dy = torch.randn(1000, 3584, generator=gen, device=dev).to(dtype)
        got = torch.ops.repro_torch.rmsnorm_bwd(x, sc, dy, 1e-5)
        want = RN.rmsnorm_bwd_plain(x, sc, dy)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=tol, atol=tol)
        torch.testing.assert_close(got[1].float(), want[1].float(),
                                   rtol=tol, atol=tol * 100)
        assert torch.equal(got[1], torch.ops.repro_torch.rmsnorm_bwd(
            x, sc, dy, 1e-5)[1])


# ---------------------------------------------------------------------------
# head dims 80 (zamba2-2.7b) and 192 (nemotron-4-340b); wide RMSNorm rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [80, 192])
@pytest.mark.parametrize("cap,win", [(0.0, 0), (50.0, 40)])
def test_flash_new_head_dims_match_reference(d, cap, win):
    """The head dims the kernels now take, through the wrapper on the CPU
    (its plain versions): the forward against ``ref.flash_attention_ref``
    and the op's backward against ``jax.vjp`` of the reference's custom
    VJP (``layers.py:242``), f32, 1e-5 of the largest magnitude; GQA 4 / 2,
    ragged S = 100."""
    case = (1, 4, 2, 100, d, cap, win)
    q, k, v, do = _bwd_inputs(case, seed=3)
    ref = np.asarray(R.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=win,
        logit_softcap=cap), np.float32)
    _, want = _jax_flash_vjp(q, k, v, do, cap, win)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = FA.flash_attention(*leaves, window=win, logit_softcap=cap)
    _close(out.detach().numpy(), ref)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(grads, want):
        _close(g.numpy(), w)


def test_rmsnorm_bwd_matches_jax_vjp_at_nemotron_width():
    """RMSNorm's plain backward and the op's CPU backward at nemotron-4-
    340b's d_model (18432, past the register path of the card's kernel)
    against ``jax.vjp`` of ``layers.rms_norm``, f32, 1e-5 relative; the
    forward against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((6, 18432), dtype=np.float32)
    sc = rng.standard_normal(18432, dtype=np.float32) * 0.1
    dy = rng.standard_normal((6, 18432), dtype=np.float32)
    out, vjp = jax.vjp(JL.rms_norm, jnp.asarray(x), jnp.asarray(sc))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    tx, tsc, tdy = (torch.from_numpy(a) for a in (x, sc, dy))
    np.testing.assert_allclose(RN.rmsnorm_plain(tx, tsc).numpy(),
                               np.asarray(ops.rmsnorm(jnp.asarray(x),
                                                      jnp.asarray(sc),
                                                      interpret=True)),
                               rtol=2e-5, atol=2e-5)
    for g, w in zip(RN.rmsnorm_bwd_plain(tx, tsc, tdy), want):
        _close(g.numpy(), w)
    leaves = [tx.clone().requires_grad_(True),
              tsc.clone().requires_grad_(True)]
    for g, w in zip(torch.autograd.grad(RN.rmsnorm(*leaves), leaves, tdy),
                    want):
        _close(g.numpy(), w)


@pytest.mark.gpu
def test_new_head_dims_and_wide_rows_on_card():
    """Flash at D = 80 and 192 on both routes (forward with lse and
    backward) against the plain versions, the backward the same bits on
    two calls; RMSNorm forward and backward at d = 18432 in both dtypes
    (f32's backward on the wide path) and at 40000, dscale the same bits
    on two calls (bf16 atol = rtol = 2e-2, f32 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for (b, hq, hkv, sq, sk, d, cap, win) in [
                (1, 4, 4, 300, 300, 80, 0.0, 0),
                (2, 4, 2, 200, 333, 80, 50.0, 64),
                (1, 8, 2, 300, 300, 192, 0.0, 0),
                (2, 2, 1, 129, 65, 192, 20.0, 17)]:
            q, do = (torch.randn(b, hq, sq, d, generator=gen, device=dev)
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn(b, hkv, sk, d, generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            kw = dict(causal=True, window=win, logit_softcap=cap)
            o, lse = torch.ops.repro_torch.flash_attention_lse(
                q, k, v, True, win, cap)
            want_o, want_lse = FA.flash_attention_lse_plain(q, k, v, **kw)
            torch.testing.assert_close(o.float(), want_o.float(), rtol=tol,
                                       atol=tol)
            seen = torch.isfinite(want_lse)
            torch.testing.assert_close(lse[seen], want_lse[seen], rtol=tol,
                                       atol=tol)
            got = torch.ops.repro_torch.flash_attention_bwd(
                q, k, v, o, lse, do, True, win, cap)
            again = torch.ops.repro_torch.flash_attention_bwd(
                q, k, v, o, lse, do, True, win, cap)
            want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
            for g, w, g2 in zip(got, want, again):
                torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                           atol=tol)
                assert torch.equal(g, g2)
        for shape in [(512, 18432), (9, 40000)]:
            x, dy = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for _ in range(2))
            sc = (torch.randn(shape[-1:], generator=gen, device=dev) * 0.1) \
                .to(dtype)
            torch.testing.assert_close(RN.rmsnorm(x, sc).float(),
                                       RN.rmsnorm_plain(x, sc).float(),
                                       rtol=tol, atol=tol)
            got = torch.ops.repro_torch.rmsnorm_bwd(x, sc, dy, 1e-5)
            again = torch.ops.repro_torch.rmsnorm_bwd(x, sc, dy, 1e-5)
            for g, w in zip(got, RN.rmsnorm_bwd_plain(x, sc, dy)):
                torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                           atol=tol)
            assert torch.equal(got[1], again[1])
