"""The port's dense model, prefill and decode against the JAX package, on the
same weights (moved over with ``repro_torch.convert``) and the same prompts.

Tolerances: hidden states and logits within 2e-3 (``tests/test_kernels.py``
:165-167), int8 cache codes within one step (rounding at a tie may differ by
one ulp of f32 upstream of ``round``) and scales within bf16 rounding,
greedy tokens equal. Decode runs over the prefill cache padded to S + 32
positions, as the continuous engine sizes it.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import decode as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_arch as port_arch  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import decode as TS  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, S, PAD, GEN = 2, 100, 32, 8
# qwen1.5-32b: QKV bias; internvl2-76b and musicgen-large: the vlm and audio
# stacks, served on tokens here (their frontends are stubs)
ARCHS = ["gemma2-9b", "llama3-405b", "qwen1.5-32b", "internvl2-76b",
         "musicgen-large"]


@functools.lru_cache(maxsize=None)
def _setup(arch: str, kv: str = ""):
    cfg, tcfg = get_arch(arch).reduced(), port_arch(arch).reduced()
    if kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
        tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                            dtype=np.int32)
    return cfg, tcfg, params, tparams, tok


@functools.lru_cache(maxsize=None)
def _prefills(arch: str, kv: str = ""):
    cfg, tcfg, params, tparams, tok = _setup(arch, kv)
    jl, jc = JS.make_prefill_step(cfg, attn_impl="flash_jnp")(
        params, {"tokens": jnp.asarray(tok)})
    tl, tc = TS.make_prefill_step(tcfg)(tparams,
                                        {"tokens": torch.from_numpy(tok)})
    return jl, jc, tl, tc


def _padded(arch: str, kv: str = ""):
    """(JAX cache, port cache), both padded to S + PAD positions."""
    cfg, tcfg = _setup(arch, kv)[:2]
    _, jc, _, tc = _prefills(arch, kv)
    jpad = JD.cache_insert(JD.init_cache(cfg, B, S + PAD), jc, 0)
    tpad = TD.cache_insert(TD.init_cache(tcfg, B, S + PAD, device="cpu"),
                           {k: v.clone() for k, v in tc.items()}, 0)
    return jpad, tpad


@pytest.mark.parametrize("attn_impl", TM.ATTN_IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_jax(arch, attn_impl):
    cfg, tcfg, params, tparams, tok = _setup(arch)
    h, _ = JM.forward(params, cfg, {"tokens": jnp.asarray(tok)},
                      attn_impl="naive")
    th, _ = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(tok)},
                       attn_impl=attn_impl)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch):
    jl, _, tl, _ = _prefills(arch)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch,kv", [("gemma2-9b", ""),
                                     ("llama3-405b", "int8")])
def test_int8_prefill_cache_matches_jax(arch, kv):
    _, jc, _, tc = _prefills(arch, kv)
    assert set(tc) == {"k", "v", "k_s", "v_s"} == set(jc)
    for name in ("k", "v"):
        assert tc[name].dtype == torch.int8
        diff = np.abs(tc[name].numpy().astype(np.int32)
                      - np.asarray(jc[name]).astype(np.int32))
        assert diff.max() <= 1, (name, diff.max())
        ts = convert.to_numpy(tc[name + "_s"])
        js = np.asarray(jc[name + "_s"], np.float32)
        np.testing.assert_allclose(ts, js, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_on_padded_cache_matches_jax(arch):
    cfg, tcfg, params, tparams, _ = _setup(arch)
    jl, _, tl, _ = _prefills(arch)
    jpad, tpad = _padded(arch)
    nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    assert (nxt == torch.argmax(tl, -1).numpy()).all()
    l2, jpad = JD.decode_step(params, cfg, jpad, jnp.asarray(nxt),
                              jnp.asarray(S, jnp.int32))
    t2, tpad = TD.decode_step(tparams, tcfg, tpad, torch.from_numpy(nxt.copy()), S)
    np.testing.assert_allclose(t2.numpy(), np.asarray(l2), rtol=2e-3,
                               atol=2e-3)
    for key in jpad:
        np.testing.assert_allclose(
            convert.to_numpy(tpad[key]).astype(np.float32),
            np.asarray(jpad[key], np.float32), rtol=2e-2, atol=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(arch):
    cfg, tcfg, params, tparams, _ = _setup(arch)
    jl, _, tl, _ = _prefills(arch)
    jpad, tpad = _padded(arch)
    first = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    jt, _ = JS.greedy_generate(cfg, params, jpad, jnp.asarray(first), S, GEN)
    tt, _ = TS.greedy_generate(tcfg, tparams, tpad,
                               torch.from_numpy(first.copy()), S, GEN)
    assert tt.shape == (B, GEN) and tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_jax_static_serve_cache_overwrites_last_prompt_slot():
    """The JAX static serve path decodes over the prompt-deep prefill cache
    (``src/repro/launch/serve.py:106-111``): with Smax = S, decode writes at
    min(pos, Smax - 1) = S - 1, so the first step overwrites the last prompt
    token's KV. The padded cache the port decodes over keeps it."""
    cfg, _, params, _, _ = _setup("gemma2-9b")
    jl, jc, _, _ = _prefills("gemma2-9b")
    jpad, _ = _padded("gemma2-9b")
    nxt = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    pos = jnp.asarray(S, jnp.int32)
    l_deep, deep = JD.decode_step(params, cfg, jc, nxt, pos)
    l_pad, pad = JD.decode_step(params, cfg, jpad, nxt, pos)
    slot_before = np.asarray(jc["k"][:, :, :, S - 1])
    assert not np.array_equal(np.asarray(deep["k"][:, :, :, S - 1]),
                              slot_before)
    np.testing.assert_array_equal(np.asarray(pad["k"][:, :, :, S - 1]),
                                  slot_before)
    assert float(jnp.abs(l_deep - l_pad).max()) > 1e-3


def test_convert_round_trips_bf16_bits():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)),
                    jnp.bfloat16)
    t = convert.to_torch(np.asarray(a))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(),
        np.asarray(a).view(np.int16))


def test_unported_families_raise():
    """Every family of the registry is ported; a family the port does not
    know raises."""
    cfg = dataclasses.replace(port_arch("gemma2-9b").reduced(),
                              family="rwkv")
    with pytest.raises(NotImplementedError):
        TM.init_params(cfg, torch.Generator().manual_seed(0))
