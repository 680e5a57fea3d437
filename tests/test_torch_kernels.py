"""The port's kernels (``repro_torch.kernels``) against the JAX package.

On the CPU each wrapper takes its kernel's plain PyTorch version; these tests
hold that version against the JAX references on the same numpy inputs, with
the tolerances of ``tests/test_kernels.py:14-16``. RMSNorm is also checked
against the Pallas kernel itself in interpret mode (it runs on the installed
jax); the Pallas flash kernel does not (``pl.load`` is gone), so flash is
checked against ``kernels/ref.py`` and ``layers.flash_attention_jnp``. The
CUDA kernels run only on the card: the ``gpu`` tests skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
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
