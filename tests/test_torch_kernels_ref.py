"""The port's mirrors of the reference's kernel surface: ``kernels/ops.py``
(the four public wrappers, by name and keyword) and ``kernels/ref.py`` (the
four oracles), against ``src/repro/kernels/ref.py`` on the same numpy
inputs made from a seed.

On the CPU each ``ops`` wrapper takes its kernel's plain version. Tolerances
as the kernels' own tests: f32 within 1e-5 (the scan, RMSNorm, the grouped
matmul) or 1e-4 (attention, a softmax), bf16 within 2e-2. Attention runs
with every row seeing a key (Sq = Sk), where the port's rows that see none
give 0 and the reference's V's mean (ROADMAP C10).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as R  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import mamba_scan as SC  # noqa: E402
from repro_torch.kernels import moe_gmm as MG  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False


def _pair(shape, dtype="float32", seed=0, scale=1.0):
    """The same random array as a jnp array and a torch tensor."""
    a = jnp.asarray(scale * np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32), getattr(jnp, dtype))
    return a, convert.to_torch(np.asarray(a))


def _tol(dtype, f32=1e-5):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=f32, atol=f32)


def _launches():
    return (FA.LAUNCHES.value, RN.LAUNCHES.value, SC.LAUNCHES.value,
            MG.LAUNCHES.value)


# (B, Hq, Hkv, S, D, causal, window, softcap): GQA, MHA at zamba2's head
# dim, a window, gemma2's softcap
ATTN_CASES = [(2, 4, 2, 48, 32, True, 0, 0.0),
              (1, 4, 4, 40, 80, True, 0, 0.0),
              (1, 2, 1, 64, 64, True, 16, 0.0),
              (2, 2, 2, 33, 32, True, 8, 50.0),
              (1, 2, 2, 24, 32, False, 0, 0.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_wrapper_and_oracle_match_the_references(case,
                                                                 dtype):
    b, hq, hkv, s, d, causal, window, cap = case
    q, tq = _pair((b, hq, s, d), dtype, 1)
    k, tk = _pair((b, hkv, s, d), dtype, 2)
    v, tv = _pair((b, hkv, s, d), dtype, 3)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    want = np.asarray(R.flash_attention_ref(q, k, v, **kw), np.float32)
    before = _launches()
    # the Pallas tiling arguments are taken and ignored
    got = ops.flash_attention(tq, tk, tv, block_q=64, block_k=32,
                              interpret=True, **kw)
    oracle = ref.flash_attention_ref(tq, tk, tv, **kw)
    assert _launches() == before  # CPU tensors: the plain version
    assert got.dtype == oracle.dtype == tq.dtype
    for out in (got, oracle):
        np.testing.assert_allclose(convert.to_numpy(out), want,
                                   **_tol(dtype, 1e-4))
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(tq, tk, tv, q_offset=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 128), (2, 7, 5120), (3, 100)])
def test_rmsnorm_wrapper_and_oracle_match_the_references(shape, dtype):
    x, tx = _pair(shape, dtype, 4)
    sc, tsc = _pair(shape[-1:], dtype, 5, 0.1)
    for eps in (1e-5, 1e-6):
        want = np.asarray(R.rmsnorm_ref(x, sc, eps), np.float32)
        got = ops.rmsnorm(tx, tsc, eps=eps, interpret=False)
        oracle = ref.rmsnorm_ref(tx, tsc, eps)
        assert got.dtype == oracle.dtype == tx.dtype
        for out in (got, oracle):
            np.testing.assert_allclose(convert.to_numpy(out), want,
                                       **_tol(dtype))


def _scan_inputs(shape, seed=0):
    """a = exp(-|randn|) and b = randn, as ``tests/test_kernels.py:108``."""
    rng = np.random.default_rng(seed)
    a = np.exp(-np.abs(rng.standard_normal(shape, dtype=np.float32)))
    return a, rng.standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("shape", [(1, 64, 128, 16), (2, 4, 96, 64),
                                   (2, 1, 8, 4), (1, 7, 5, 3)])
def test_mamba_scan_wrapper_matches_the_references_from_zero(shape):
    a, b = _scan_inputs(shape)
    h0 = jnp.zeros((shape[0],) + shape[2:], jnp.float32)
    want_all, want_last = R.mamba_scan_ref(jnp.asarray(a), jnp.asarray(b), h0)
    for chunk in (16, 64):  # the Pallas chunk: taken and ignored
        h_all, h_last = ops.mamba_scan(torch.from_numpy(a),
                                       torch.from_numpy(b), chunk=chunk)
        np.testing.assert_allclose(h_all.numpy(), np.asarray(want_all),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(want_last),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 64, 128, 16), (2, 4, 96, 64),
                                   (2, 1, 8, 4), (1, 7, 5, 3)])
def test_mamba_scan_oracle_matches_the_references_from_any_state(shape):
    """``mamba_scan_ref`` takes the reference's h0, here not zero; from a
    zero h0 it is the kernel's plain version (which fuses each step's
    multiply-add: within f32 rounding)."""
    a, b = _scan_inputs(shape, seed=1)
    h0 = np.random.default_rng(2).standard_normal(
        (shape[0],) + shape[2:], dtype=np.float32)
    want_all, want_last = R.mamba_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(h0))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    h_all, h_last = ref.mamba_scan_ref(ta, tb, torch.from_numpy(h0))
    np.testing.assert_allclose(h_all.numpy(), np.asarray(want_all),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(want_last),
                               rtol=1e-5, atol=1e-5)
    zero = ref.mamba_scan_ref(ta, tb, torch.zeros_like(ta[:, 0]))
    for z, p in zip(zero, SC.mamba_scan_plain(ta, tb)):
        torch.testing.assert_close(z, p, rtol=1e-6, atol=1e-6)


# (T, D, F, group sizes summing to T): an empty expert, one row, one expert
GMM_CASES = [(64, 32, 48, [10, 0, 30, 24]), (5, 16, 8, [1, 1, 3]),
             (40, 24, 40, [40]), (96, 64, 32, [0, 0, 96, 0])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GMM_CASES)
def test_moe_gmm_wrapper_and_oracle_match_the_references(case, dtype):
    t, d, f, sizes = case
    x, tx = _pair((t, d), dtype, 6)
    w, tw = _pair((len(sizes), d, f), dtype, 7, d ** -0.5)
    gs = np.asarray(sizes, np.int32)
    want = np.asarray(R.moe_gmm_ref(x, w, jnp.asarray(gs)), np.float32)
    got = ops.moe_gmm(tx, tw, torch.from_numpy(gs), interpret=None)
    oracle = ref.moe_gmm_ref(tx, tw, torch.from_numpy(gs))
    assert got.shape == oracle.shape == (t, f)
    for out in (got, oracle):
        np.testing.assert_allclose(convert.to_numpy(out), want,
                                   **_tol(dtype))


def test_moe_gmm_oracle_clamps_rows_past_the_groups_as_jax():
    """Past ``sum(group_sizes)`` the reference's gather clamps to the last
    expert; the oracle does the same, where the kernel (and its plain
    version) writes zeros there."""
    x, tx = _pair((12, 8), "float32", 8)
    w, tw = _pair((3, 8, 4), "float32", 9)
    gs = np.asarray([3, 2, 4], np.int32)  # rows 9-11 belong to no group
    want = np.asarray(R.moe_gmm_ref(x, w, jnp.asarray(gs)))
    oracle = ref.moe_gmm_ref(tx, tw, torch.from_numpy(gs))
    np.testing.assert_allclose(oracle.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = MG.moe_gmm_plain(tx, tw, torch.from_numpy(gs))
    assert not plain[9:].any()
    torch.testing.assert_close(plain[:9], oracle[:9])


@pytest.mark.gpu
def test_ops_launch_the_kernels_on_card():
    """On CUDA tensors each ``ops`` wrapper launches its hand kernel once
    and agrees with the ``ref`` oracle on the same tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    dev = torch.device("cuda")
    _, q = _pair((2, 4, 64, 80), "bfloat16", 1)
    _, k = _pair((2, 2, 64, 80), "bfloat16", 2)
    _, v = _pair((2, 2, 64, 80), "bfloat16", 3)
    q, k, v = q.to(dev), k.to(dev), v.to(dev)
    before = _launches()
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               ref.flash_attention_ref(q, k, v),
                               atol=2e-2, rtol=2e-2)
    x = torch.randn(64, 5120, device=dev)
    sc = 0.1 * torch.randn(5120, device=dev)
    torch.testing.assert_close(ops.rmsnorm(x, sc), ref.rmsnorm_ref(x, sc),
                               atol=1e-5, rtol=1e-5)
    a, b = (torch.from_numpy(t).to(dev)
            for t in _scan_inputs((2, 4, 640, 64)))
    got = ops.mamba_scan(a, b)
    want = ref.mamba_scan_ref(a, b, torch.zeros_like(a[:, 0]))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    xg = torch.randn(64, 32, device=dev)
    wg = torch.randn(4, 32, 48, device=dev) * 32 ** -0.5
    gs = torch.tensor([10, 0, 30, 24], dtype=torch.int32)  # on the host
    torch.testing.assert_close(ops.moe_gmm(xg, wg, gs),
                               ref.moe_gmm_ref(xg, wg, gs.to(dev)),
                               atol=1e-4, rtol=1e-4)
    torch.cuda.synchronize()
    assert _launches() == tuple(n + 1 for n in before)
