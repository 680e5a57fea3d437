"""The port's kernels (``repro_torch.kernels``) against the JAX package.

On the CPU each wrapper takes its kernel's plain PyTorch version; these tests
hold that version against the JAX references on the same numpy inputs, with
the tolerances of ``tests/test_kernels.py:14-16``. RMSNorm is also checked
against the Pallas kernel itself in interpret mode (it runs on the installed
jax); the Pallas flash kernel does not (``pl.load`` is gone), so flash is
checked against ``kernels/ref.py`` and ``layers.flash_attention_jnp``. The
CUDA kernels run only on the card: the ``gpu`` tests skip here.
"""
import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a JAX array and a torch tensor (bf16 bit-equal)."""
    a = jnp.asarray(rng.standard_normal(shape, dtype=np.float32) * scale,
                    getattr(jnp, dtype))
    return a, to_torch(np.asarray(a))


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 256), (4, 96, 256), (2, 3, 5, 128),
                                   (1000, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(42)
    x, tx = _pair(rng, shape, dtype)
    sc, tsc = _pair(rng, shape[-1:], dtype, 0.1)
    want = np.asarray(ops.rmsnorm(x, sc, interpret=True), np.float32)
    np.testing.assert_allclose(to_numpy(RN.rmsnorm_plain(tx, tsc)), want,
                               **_tol(dtype))
    np.testing.assert_allclose(
        want, np.asarray(R.rmsnorm_ref(x, sc), np.float32), **_tol(dtype))


def test_rmsnorm_wrapper_takes_plain_on_cpu():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 64), dtype=np.float32))
    sc = torch.from_numpy(rng.standard_normal(64, dtype=np.float32))
    before = RN.LAUNCHES.value
    out = RN.rmsnorm(x, sc)
    assert torch.equal(out, RN.rmsnorm_plain(x, sc))
    assert RN.LAUNCHES.value == before  # no kernel launch for a CPU tensor


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

ATTN_SHAPES = [
    # (b, hq, hkv, sq, sk, d): tests/test_kernels.py:23-29, plus a ragged
    # length and gemma2's head dim
    (2, 4, 2, 128, 128, 64),
    (1, 8, 1, 256, 256, 32),
    (2, 2, 2, 128, 384, 64),
    (1, 4, 4, 512, 512, 128),
    (2, 4, 2, 100, 100, 64),
    (1, 4, 2, 100, 100, 256),
]


def _qkv(shape, dtype, seed=42, scale=1.0):
    b, hq, hkv, sq, sk, d = shape
    rng = np.random.default_rng(seed)
    return [_pair(rng, s, dtype, scale) for s in
            ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def _check_flash(shape, dtype, *, window=0, cap=0.0, scale=1.0):
    (q, tq), (k, tk), (v, tv) = _qkv(shape, dtype, scale=scale)
    got = to_numpy(FA.flash_attention(tq, tk, tv, window=window,
                                      logit_softcap=cap))
    ref = np.asarray(R.flash_attention_ref(q, k, v, window=window,
                                           logit_softcap=cap), np.float32)
    jnp_flash = np.asarray(JL.flash_attention_jnp(
        q, k, v, window=window, logit_softcap=cap), np.float32)
    np.testing.assert_allclose(got, ref, **_tol(dtype))
    np.testing.assert_allclose(got, jnp_flash, **_tol(dtype))


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_shapes(shape, dtype):
    _check_flash(shape, dtype)


@pytest.mark.parametrize("window", [32, 96, 128])
def test_flash_plain_window(window):
    _check_flash((1, 2, 2, 256, 256, 64), "float32", window=window)


@pytest.mark.parametrize("cap", [20.0, 50.0])
def test_flash_plain_softcap(cap):
    _check_flash((1, 2, 2, 128, 128, 64), "float32", cap=cap, scale=3.0)


def test_flash_gemma2_layer_shape_ragged():
    """gemma2's GQA group, softcap and window together at a ragged length."""
    _check_flash((1, 4, 2, 100, 100, 256), "float32", window=64, cap=50.0)


def test_flash_flop_formula_counts_visible_pairs():
    from torch.utils.flop_counter import FlopCounterMode
    (_, tq), (_, tk), (_, tv) = _qkv((1, 4, 2, 100, 100, 32), "float32")
    for window in (0, 16):
        mask = FA.visible_mask(100, 100, causal=True, window=window)
        with FlopCounterMode(display=False) as fc:
            FA.flash_attention(tq, tk, tv, window=window)
        assert fc.get_total_flops() == 4 * 1 * 4 * 32 * int(mask.sum())
        assert FA.visible_pairs(100, 100, causal=True, window=window) \
            == int(mask.sum())


def test_flash_tma_strides_fill_size_one_dims():
    """A dim of size 1 passes the stride it would have if dense (TMA checks
    every stride, and a view may give a size-1 dim any stride); other dims
    keep their own, as the einsum views of the model's q, k, v have."""
    base = torch.zeros(3, 10, 4, 64)                  # [B, S, H, D] buffer
    q = base.transpose(1, 2)                          # [B, H, S, D] view
    assert FA.tma_strides(q) == (2560, 64, 256)
    one = torch.zeros(1, 10, 1, 64).transpose(1, 2)   # B = H = 1
    assert FA.tma_strides(one) == (640, 640, 64)
    assert FA.tma_strides(torch.zeros(2, 3, 1, 32)) == (96, 32, 32)


def test_flash_tma_layout_raises_on_bad_stride():
    """The bf16 route never copies: a sequence stride off 8 elements (16
    bytes) raises with the offending operand named."""
    q = torch.zeros(1, 2, 10, 68, dtype=torch.bfloat16)[..., :64]
    k = torch.zeros(1, 2, 10, 64, dtype=torch.bfloat16)
    FA.check_tma_layout(k, k, k, [FA.tma_strides(k)] * 3)
    with pytest.raises(ValueError, match="q needs"):
        FA.check_tma_layout(q, k, k, [FA.tma_strides(t) for t in (q, k, k)])
    odd = torch.zeros(1, 2, 10, 66, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="v needs"):
        FA.check_tma_layout(k, k, odd, [FA.tma_strides(t) for t in (k, k, odd)])


# ---------------------------------------------------------------------------
# building and binding the CUDA sources
# ---------------------------------------------------------------------------

def test_build_target_covers_headers(tmp_path):
    """An edit to a header in csrc (the Hopper helpers in hopper.cuh) gives
    every source a new library name, so the next load rebuilds it."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = {n: build._target(n, csrc) for n in build.SOURCES}
    assert before == {n: build._target(n, csrc) for n in build.SOURCES}
    assert before["flash_attention"] == build._target("flash_attention")
    header = csrc / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: build._target(n, csrc) for n in build.SOURCES}
    assert all(after[n] != before[n] for n in build.SOURCES)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build._target("rmsnorm", csrc) != after["rmsnorm"]


_CTYPE_OF = {"pointer": ctypes.c_void_p, "long long": ctypes.c_longlong,
             "int": ctypes.c_int, "float": ctypes.c_float}


def _c_params(source: str, symbol: str) -> list:
    """The parameter kinds of ``extern "C" int symbol(...)`` in a source."""
    m = re.search(r'extern\s+"C"\s+int\s+' + symbol + r'\s*\(([^)]*)\)',
                  source)
    assert m, f"no extern \"C\" int {symbol}(...)"
    kinds = []
    for param in m.group(1).split(","):
        words = param.replace("*", " * ").split()
        if "*" in words:
            kinds.append("pointer")
        else:
            kinds.append(" ".join(w for w in words[:-1] if w != "const"))
    return kinds


def test_build_sources_are_every_cu_file():
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) \
        == sorted(build.SOURCES)


@pytest.mark.parametrize("name", build.SOURCES)
def test_ctypes_argtypes_match_c_signature(name):
    """Every ``extern "C"`` function of a source (the forward's
    ``repro_<name>`` and any other, such as a backward) against its ctypes
    signature in the wrapper's ``ENTRY_POINTS``: the same count,
    ``c_void_p`` for every pointer and the stream, ``c_longlong`` for every
    ``long long``, ``c_int`` and ``c_float`` for ints and floats. A mismatch
    would otherwise show only as a crash on the card."""
    import importlib
    module = importlib.import_module(f"repro_torch.kernels.{name}")
    source = (build.CSRC / f"{name}.cu").read_text()
    symbols = re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(', source)
    assert f"repro_{name}" in symbols
    assert sorted(symbols) == sorted(module.ENTRY_POINTS)
    assert module.ENTRY_POINTS[f"repro_{name}"] is module._ARGTYPES
    for symbol in symbols:
        kinds = _c_params(source, symbol)
        argtypes = module.ENTRY_POINTS[symbol]
        assert len(kinds) == len(argtypes), symbol
        for i, (kind, argtype) in enumerate(zip(kinds, argtypes)):
            assert kind in _CTYPE_OF, f"{symbol} parameter {i}: {kind!r}"
            assert argtype is _CTYPE_OF[kind], \
                f"{symbol} parameter {i} is {kind} in C but {argtype}"


def test_ctypes_argtypes_match_gated_gmm_signature():
    """The same check for the grouped matmul's second entry point, the
    gated variant (``moe_gmm._GATED_ARGTYPES``)."""
    from repro_torch.kernels import moe_gmm as MG
    kinds = _c_params((build.CSRC / "moe_gmm.cu").read_text(),
                      "repro_moe_gmm_gated")
    assert len(kinds) == len(MG._GATED_ARGTYPES)
    for i, (kind, argtype) in enumerate(zip(kinds, MG._GATED_ARGTYPES)):
        assert argtype is _CTYPE_OF[kind], \
            f"parameter {i} is {kind} in C but {argtype} in _GATED_ARGTYPES"


# ---------------------------------------------------------------------------
# the CUDA kernels themselves (run on the card only)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = torch.randn(1000, 512, generator=gen, device=dev).to(dtype)
        sc = (torch.randn(512, generator=gen, device=dev) * 0.1).to(dtype)
        torch.testing.assert_close(RN.rmsnorm(x, sc).float(),
                                   RN.rmsnorm_plain(x, sc).float(),
                                   atol=tol, rtol=tol)
        q = torch.randn(1, 4, 100, 256, generator=gen, device=dev).to(dtype)
        k = torch.randn(1, 2, 100, 256, generator=gen, device=dev).to(dtype)
        v = torch.randn(1, 2, 100, 256, generator=gen, device=dev).to(dtype)
        kw = dict(window=64, logit_softcap=50.0)
        torch.testing.assert_close(
            FA.flash_attention(q, k, v, **kw).float(),
            FA.flash_attention_plain(q, k, v, **kw).float(),
            atol=tol, rtol=tol)
    # the bf16 tensor-core route at D = 128 and 256: ragged lengths, GQA,
    # windows below, at and above a K tile, softcap on scores scaled up, and
    # q, k, v as [B, S, H, D] buffers seen as [B, H, S, D]
    for (b, hq, hkv, s, d), window, cap in [
            ((2, 8, 2, 1000, 128), 0, 0.0), ((1, 4, 4, 100, 128), 96, 0.0),
            ((1, 8, 2, 300, 128), 128, 20.0), ((2, 4, 2, 1000, 256), 0, 50.0),
            ((1, 8, 4, 300, 256), 32, 50.0), ((1, 4, 1, 200, 256), 64, 0.0)]:
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
                   .mul(3.0 if cap and i < 2 else 1.0).to(torch.bfloat16)
                   .transpose(1, 2) for i, h in enumerate((hq, hkv, hkv)))
        kw = dict(window=window, logit_softcap=cap)
        torch.testing.assert_close(
            FA.flash_attention(q, k, v, **kw).float(),
            FA.flash_attention_plain(q, k, v, **kw).float(),
            atol=2e-2, rtol=2e-2)


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


@pytest.mark.gpu
def test_backward_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for (b, hq, hkv, s, d, cap, win) in [(1, 4, 2, 300, 256, 50.0, 0),
                                             (2, 4, 2, 200, 128, 0.0, 64)]:
            q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                           .to(dtype) for shape in
                           ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                            (b, hq, s, d)))
            o, lse = torch.ops.repro_torch.flash_attention_lse(
                q, k, v, True, win, cap)
            got = torch.ops.repro_torch.flash_attention_bwd(
                q, k, v, o, lse, do, True, win, cap)
            want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                window=win, logit_softcap=cap)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                           atol=tol)
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
