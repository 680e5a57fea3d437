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
import math
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

# then the main paths' widths at a few rows: zamba2-2.7b's 2560 and its gated
# norm's 5120, gemma2-9b's 3584, falcon-mamba-7b's and mixtral-8x7b's 4096,
# nemotron-4-340b's 18432 (each a row shape the card kernel takes its own way)
@pytest.mark.parametrize("shape", [(8, 256), (4, 96, 256), (2, 3, 5, 128),
                                   (1000, 512), (4, 2560), (8, 5120),
                                   (5, 3584), (2, 4096), (3, 18432)])
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


@pytest.mark.parametrize("symbol,argtypes", [
    ("repro_moe_gmm_bwd", "_BWD_ARGTYPES"),
    ("repro_moe_gmm_gated_bwd", "_GATED_BWD_ARGTYPES")])
def test_ctypes_argtypes_match_gmm_bwd_signatures(symbol, argtypes):
    """The grouped matmul's backward entry points against their ctypes
    signatures, parameter by parameter, now that each takes the route (the
    CUDA cores or the tensor cores) after the dtype: every pointer (the
    gated one's bf16 or f32 scratch among them) a ``c_void_p``, every int a
    ``c_int``, and the route where the wrapper passes it."""
    from repro_torch.kernels import moe_gmm as MG
    source = (build.CSRC / "moe_gmm.cu").read_text()
    kinds = _c_params(source, symbol)
    types = getattr(MG, argtypes)
    assert MG.ENTRY_POINTS[symbol] is types
    assert len(kinds) == len(types)
    for i, (kind, argtype) in enumerate(zip(kinds, types)):
        assert argtype is _CTYPE_OF[kind], \
            f"parameter {i} is {kind} in C but {argtype} in {argtypes}"
    m = re.search(r'extern\s+"C"\s+int\s+' + symbol + r'\s*\(([^)]*)\)',
                  source)
    names = [p.replace("*", " ").split()[-1] for p in m.group(1).split(",")]
    assert names[names.index("dtype") + 1] == "route"
    assert names[-1] == "stream"
    if symbol == "repro_moe_gmm_gated_bwd":
        assert names[names.index("route") + 1] == "act"
        assert names.index("scratch") == 5


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
