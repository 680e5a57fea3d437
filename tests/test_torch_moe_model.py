"""The port's moe family of ``models/model`` and ``models/decode``, ring KV
caches and serving mixtral, against the JAX package, on the same numpy
inputs made from a seed (the kernel and ``models/moe`` are
``tests/test_torch_moe.py``'s; the split lets xdist spread the MoE tests
over its workers). Top-k routing is discontinuous, so whole models are
compared in f32, where the routes agree. Reduced mixtral (4 experts top-2,
window 64) runs at S = 100, past its window, so its prefill hands over a
rotated ring; reduced dbrx (4 experts top-2, int8 KV cache, no window)
decodes over its prefill cache padded to S + 32 positions, as
``tests/test_torch_model.py``. Hidden states and logits within 2e-3 as the
dense model's tests, greedy tokens equal.
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
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import decode as TS  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, S, PAD, GEN = 2, 100, 32, 8


# ---------------------------------------------------------------------------
# reduced mixtral (ring cache) and dbrx (int8 cache): prefill and decode
# ---------------------------------------------------------------------------

MODELS = ["mixtral-8x7b", "dbrx-132b"]


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg, tcfg = get_arch(arch).reduced(), port_arch(arch).reduced()
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (B, S),
                                            dtype=np.int32)
    jl, jc = JS.make_prefill_step(cfg, attn_impl="flash_jnp")(
        params, {"tokens": jnp.asarray(tok)})
    tl, tc = TS.make_prefill_step(tcfg)(tparams,
                                        {"tokens": torch.from_numpy(tok)})
    return cfg, tcfg, params, tparams, tok, (jl, jc), (tl, tc)


def _decode_caches(arch):
    """(JAX cache, port cache) to decode over: a ring as the prefill hands
    it over; otherwise the prefill cache padded to S + PAD positions."""
    cfg, tcfg, *_, (_, jc), (_, tc) = _model(arch)
    tc = {k: v.clone() for k, v in tc.items()}
    if TD.uses_ring(tcfg):
        return jc, TS.decode_cache(tcfg, tc, S + PAD)
    return (JD.cache_insert(JD.init_cache(cfg, B, S + PAD), jc, 0),
            TS.decode_cache(tcfg, tc, S + PAD))


@pytest.mark.parametrize("arch", MODELS)
def test_forward_hidden_and_aux_match_jax(arch):
    cfg, tcfg, params, tparams, tok, *_ = _model(arch)
    h, aux = JM.forward(params, cfg, {"tokens": jnp.asarray(tok)},
                        attn_impl="naive")
    th, taux = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(th.numpy(), np.asarray(h), rtol=2e-3,
                               atol=2e-3)
    assert float(aux) > 0
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)


@pytest.mark.parametrize("arch", MODELS)
def test_prefill_logits_and_cache_match_jax(arch):
    cfg, tcfg, *_, (jl, jc), (tl, tc) = _model(arch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                               atol=2e-3)
    assert set(tc) == set(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        got = convert.to_numpy(tc[key]).astype(np.float32)
        want = np.asarray(jc[key], np.float32)
        if tc[key].dtype == torch.int8:  # a code may round the other way
            assert np.abs(got - want).max() <= 1, key
        else:
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    if arch == "mixtral-8x7b":  # S = 100 past the window: a rotated ring
        assert tc["k"].shape[3] == tcfg.sliding_window == 64


@pytest.mark.parametrize("arch", MODELS)
def test_decode_step_matches_jax(arch):
    cfg, tcfg, params, tparams, _, (jl, _), _ = _model(arch)
    jcache, tcache = _decode_caches(arch)
    kbuf = tcache["k"]
    nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    l2, jcache = JD.decode_step(params, cfg, jcache, jnp.asarray(nxt),
                                jnp.asarray(S, jnp.int32))
    t2, tcache = TD.decode_step(tparams, tcfg, tcache,
                                torch.from_numpy(nxt.copy()), S)
    assert tcache["k"] is kbuf  # written in place
    np.testing.assert_allclose(t2.numpy(), np.asarray(l2), rtol=2e-3,
                               atol=2e-3)
    for key in jcache:
        np.testing.assert_allclose(
            convert.to_numpy(tcache[key]).astype(np.float32),
            np.asarray(jcache[key], np.float32), rtol=2e-2, atol=1)


@pytest.mark.parametrize("arch", MODELS)
def test_greedy_tokens_match_jax(arch):
    cfg, tcfg, params, tparams, _, (jl, _), _ = _model(arch)
    jcache, tcache = _decode_caches(arch)
    first = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    jt, _ = JS.greedy_generate(cfg, params, jcache, jnp.asarray(first), S,
                               GEN)
    tt, _ = TS.greedy_generate(tcfg, tparams, tcache,
                               torch.from_numpy(first.copy()), S, GEN)
    assert tt.shape == (B, GEN) and tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_params_from_jax_unstacks_the_experts():
    cfg, tcfg, params, tparams, *_ = _model("mixtral-8x7b")
    lp = tparams["layers"][1]
    assert set(lp) == {"norm1", "norm2", "attn", "moe"}
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    assert {k: tuple(v.shape) for k, v in lp["moe"].items()} == {
        "router": (d, e), "wi": (e, d, f), "wg": (e, d, f), "wo": (e, f, d)}
    np.testing.assert_array_equal(lp["moe"]["wo"].numpy(),
                                  np.asarray(params["layers"]["moe"]["wo"][1]))
    init = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in init["layers"][0]["moe"].items()} == \
        {k: v.shape for k, v in lp["moe"].items()}


# ---------------------------------------------------------------------------
# the ring hand-off (tests/test_serve.py:68-99)
# ---------------------------------------------------------------------------

def _ring_cfgs(moe: bool):
    """Reduced mixtral, 2 layers, window 8; ``moe=False`` drops the experts
    as the reference's ring test does: a prefill group of S tokens has a
    capacity and one token alone never drops, so only the dense model's
    prefill and token-by-token decode compute the same function."""
    kw = dict(n_layers=2, sliding_window=8)
    if not moe:
        kw["moe"] = None
        kw["family"] = "dense"
    return (dataclasses.replace(get_arch("mixtral-8x7b").reduced(), **kw),
            dataclasses.replace(port_arch("mixtral-8x7b").reduced(), **kw))


@pytest.mark.parametrize("s", [13, 5, 8])  # > window, < window, ==
def test_ring_prefill_cache_matches_jax_slot_for_slot(s):
    cfg, tcfg = _ring_cfgs(moe=True)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    tok = np.random.default_rng(s).integers(0, cfg.vocab, (1, s),
                                            dtype=np.int32)
    jl, jc = JS.make_prefill_step(cfg, attn_impl="naive")(
        params, {"tokens": jnp.asarray(tok)})
    tl, tc = TS.make_prefill_step(tcfg)(tparams,
                                        {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                               atol=2e-3)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert tc[key].shape[3] == 8
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-5, atol=1e-5)
    assert TS.decode_cache(tcfg, tc, s + 4) is tc


@pytest.mark.parametrize("s", [13, 5, 8])
def test_ring_prefill_then_decode_equals_pure_decode(s):
    """The reference's own check (``tests/test_serve.py:79-99``) on the
    port: decoding on from the prefill's ring equals decoding every token
    from an empty ring."""
    _, tcfg = _ring_cfgs(moe=False)
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(s).integers(
        0, tcfg.vocab, (1, s), dtype=np.int64))
    logits_p, cache_p = TS.make_prefill_step(tcfg)(params, {"tokens": tok})
    cache_r = TD.init_cache(tcfg, 1, s + 4, torch.float32, device="cpu")
    assert cache_r["k"].shape[3] == 8  # min(max_seq, window)
    for i in range(s):
        lg, cache_r = TD.decode_step(params, tcfg, cache_r, tok[:, i], i)
    nxt_p, nxt_r = torch.argmax(logits_p, -1), torch.argmax(lg, -1)
    assert torch.equal(nxt_p, nxt_r)
    for j in range(3):
        lp, cache_p = TD.decode_step(params, tcfg, cache_p, nxt_p, s + j)
        lr, cache_r = TD.decode_step(params, tcfg, cache_r, nxt_r, s + j)
        assert float((lp - lr).abs().max()) < 1e-4, (s, j)
        nxt_p, nxt_r = torch.argmax(lp, -1), torch.argmax(lr, -1)
        assert torch.equal(nxt_p, nxt_r)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serve_mixtral_f32_on_cpu_generates_what_jax_does(monkeypatch):
    """serve() at f32 on the JAX model's weights: each batch's tokens equal
    JAX prefill + ``greedy_generate`` on the same prompt, both decoding on
    the prefill's ring (the reference's static serve path)."""
    import repro_torch.launch.serve as LS
    s, gen = 80, 6  # past the window of 64: the ring wraps while decoding
    cfg, _, params, tparams, *_ = _model("mixtral-8x7b")
    monkeypatch.setattr(LS, "init_params", lambda *a, **k: tparams)
    res = serve("mixtral-8x7b", requests=2 * B, batch=B, prompt_len=s,
                gen_len=gen, device="cpu", param_dtype=torch.float32)
    assert res["completed"] == 2 and res["errors"] == []
    assert res["n_layers"] == res["published_layers"] == 4
    rng = np.random.default_rng(0)  # serve()'s prompts, made from its seed
    prefill = JS.make_prefill_step(cfg, attn_impl="flash_jnp")
    for got in res["generated"]:
        tok = rng.integers(0, cfg.vocab, (B, s), dtype=np.int64)
        logits, cache = prefill(params, {"tokens": jnp.asarray(tok,
                                                              jnp.int32)})
        first = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out, _ = JS.greedy_generate(cfg, params, cache, first, s, gen - 1)
        np.testing.assert_array_equal(
            got, np.concatenate([np.asarray(first)[:, None],
                                 np.asarray(out)], axis=1))


def test_serve_cuts_the_depth():
    res = serve("dbrx-132b", device="cpu", requests=2, batch=2,
                prompt_len=16, gen_len=3, n_layers=2)
    assert res["completed"] == 1 and res["errors"] == []
    assert (res["n_layers"], res["published_layers"]) == (2, 4)
    with pytest.raises(ValueError, match="n_layers"):
        serve("dbrx-132b", device="cpu", n_layers=5)
