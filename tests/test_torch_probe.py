"""The port's probe (``repro_torch.core.probe``) against the JAX package's.

The port traces the prefill on fake tensors; the reference reads XLA's
compiled artifact. Both run the naive attention here: the reference's
``flash_jnp`` pads the key axis to its 512-wide block, which inflates XLA's
temp buffers at S = 100 and is an artifact of that implementation. The band
is the ±25% ``core/workloads.py:157`` accepts for a probed footprint. FLOPs
are held to an analytic count of the matmuls and the visible attention pairs
(XLA counts each ``scan`` body once, so its number is no reference).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch  # noqa: E402
from repro.core.probe import probe_fn as jax_probe_fn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import decode as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_arch as port_arch  # noqa: E402
from repro_torch.core import probe as P  # noqa: E402
from repro_torch.kernels.flash_attention import visible_pairs  # noqa: E402
from repro_torch.models.model import _layer_window  # noqa: E402
from repro_torch.serve import decode as TS  # noqa: E402

B, S = 2, 100
ARCHS = ["gemma2-9b", "llama3-405b"]


def _setup(arch):
    cfg, tcfg = get_arch(arch).reduced(), port_arch(arch).reduced()
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                            dtype=np.int32)
    return cfg, tcfg, params, tparams, tok


def _analytic_flops(cfg, b, s):
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    h, kv = cfg.n_heads, cfg.n_kv_heads
    n_mlp = 3 if cfg.mlp_act.endswith("gated") else 2
    per_token = 2 * (d * h * hd + 2 * d * kv * hd + h * hd * d
                     + n_mlp * d * f)
    attn = sum(4 * b * h * hd * visible_pairs(
        s, s, causal=True, window=_layer_window(cfg, i))
        for i in range(cfg.n_layers))
    logits = 2 * b * d * cfg.vocab        # last token only
    return per_token * b * s * cfg.n_layers + attn + logits


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_hbm_within_band_of_jax(arch):
    cfg, tcfg, params, tparams, tok = _setup(arch)
    jv = jax_probe_fn(jax.jit(JS.make_prefill_step(cfg, attn_impl="naive")),
                      params, {"tokens": jnp.asarray(tok)})
    tv = P.probe_fn(TS.make_prefill_step(tcfg, attn_impl="naive"), tparams,
                    {"tokens": torch.from_numpy(tok)})
    assert 0.75 <= tv.hbm_bytes / jv.hbm_bytes <= 1.25, \
        (tv.hbm_bytes, jv.hbm_bytes)


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_flops_match_analytic_count(arch):
    _, tcfg, _, tparams, tok = _setup(arch)
    tv = P.probe_fn(TS.make_prefill_step(tcfg), tparams,
                    {"tokens": torch.from_numpy(tok)})
    want = _analytic_flops(tcfg, B, S)
    assert abs(tv.flops / want - 1.0) <= 0.05, (tv.flops, want)


def test_probe_counts_arguments_and_peak_live_bytes():
    """hbm = argument bytes + the peak of bytes the step allocates and
    still holds: two 1 MiB temporaries live at once, then freed."""
    x = torch.zeros(256, 1024)  # 1 MiB

    def step(a):
        t1 = a + 1
        t2 = t1 * 2
        del t1
        return t2.sum()

    c = P.trace_counts(step, x)
    assert c["arg_bytes"] == 2 ** 20
    assert c["peak_live_bytes"] == 2 * 2 ** 20
    assert c["hbm_bytes"] == 3 * 2 ** 20
    assert c["flops"] == 0


def test_probe_is_cached_by_shape_signature():
    calls = []

    def step(a):
        calls.append(1)
        return a @ a

    P.probe_fn(step, torch.zeros(8, 8))
    P.probe_fn(step, torch.ones(8, 8))
    assert len(calls) == 1
    P.probe_fn(step, torch.zeros(16, 16))
    assert len(calls) == 2


def test_vector_arithmetic_uses_h100_peaks():
    v = P.vector_from_counts(hbm_bytes=10, flops=989e12,
                             bytes_accessed=3.35e12 / 2)
    assert v.est_seconds == pytest.approx(1.0)
    assert v.core_demand == pytest.approx(1.0)
    assert v.bw_demand == pytest.approx(0.5)
    assert P.PEAK_FLOPS == 989e12 and P.HBM_BW == 3.35e12
