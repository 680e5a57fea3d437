"""The port's continuous-batching engine (``serve/engine.py``) and the
per-row decode it runs on (``models/decode.py``, ``models/model.py``)
against the JAX package, on the same weights (moved over with
``repro_torch.convert``) and the same prompts.

Tolerances: logits within rtol = atol = 2e-3 (``tests/test_torch_model.py``);
updated caches as ``test_decode_step_on_padded_cache_matches_jax`` (int8
codes within one step, bf16 within its rounding); cache surgery exactly
equal; tokens per request equal.
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
from repro.core.cluster import Cluster as JaxCluster  # noqa: E402
from repro.core.scheduler import MGBAlg3Scheduler as JaxMGB  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import decode as JS  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_arch as port_arch  # noqa: E402
from repro_torch.core import probe as P  # noqa: E402
from repro_torch.core.cluster import Cluster  # noqa: E402
from repro_torch.core.scheduler import MGBAlg3Scheduler  # noqa: E402
from repro_torch.core.scheduler.base import DEFAULT_HBM  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    pool_reserve, serve_continuous)
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.serve import decode as TS  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GB = 1 << 30
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _setup(arch: str, kv: str = "", layers: int = 0):
    cfg, tcfg = get_arch(arch).reduced(), port_arch(arch).reduced()
    if kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
        tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        tcfg = dataclasses.replace(tcfg, n_layers=layers)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    return cfg, tcfg, params, tparams


def _random_cache(jcache, seed: int):
    """Numpy contents for every leaf of a cache layout: int8 codes, positive
    scales, normal values (bf16-representable, so both sides hold the same
    numbers)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in jcache.items():
        if t.dtype == jnp.int8:
            out[key] = rng.integers(-127, 128, t.shape, dtype=np.int8)
        else:
            x = rng.standard_normal(t.shape, dtype=np.float32)
            if key.endswith("_s"):
                x = np.abs(x) / 127.0 + 1e-3
            out[key] = np.asarray(jnp.asarray(x, t.dtype), np.float32) \
                if t.dtype == jnp.bfloat16 else x.astype(np.float32)
    return out


def _pair(jcache, arrays):
    """(JAX cache, port cache) holding ``arrays`` in the layout's dtypes."""
    j = {k: jnp.asarray(arrays[k], jcache[k].dtype) for k in jcache}
    t = {k: convert.to_torch(np.asarray(j[k])).clone() for k in j}
    return j, t


def _assert_cache_equal(tcache, jcache):
    assert set(tcache) == set(jcache)
    for key in jcache:
        np.testing.assert_array_equal(
            convert.to_numpy(tcache[key]).astype(np.float32),
            np.asarray(jcache[key], np.float32), err_msg=key)


# --------------------------------------------------------------------------
# per-row decode positions
# --------------------------------------------------------------------------

# (arch, kv cache dtype, per-row positions, cache depth, cache dtype)
PER_ROW = {
    "gemma2-int8": ("gemma2-9b", "", [5, 37, 90], 96, jnp.bfloat16),
    "llama3-bf16": ("llama3-405b", "bfloat16", [0, 17, 40], 48,
                    jnp.bfloat16),
    "mixtral-ring": ("mixtral-8x7b", "", [10, 70, 130], 200, jnp.bfloat16),
    "falcon-mamba-ssm": ("falcon-mamba-7b", "", [3, 64, 200], 8,
                         jnp.float32),
}


@pytest.mark.parametrize("case", sorted(PER_ROW))
def test_decode_step_per_row_positions_matches_jax(case):
    arch, kv, positions, depth, dtype = PER_ROW[case]
    cfg, tcfg, params, tparams = _setup(arch, kv)
    b = len(positions)
    jcache, tcache = _pair(JD.init_cache(cfg, b, depth, dtype),
                           _random_cache(JD.init_cache(cfg, b, depth, dtype),
                                         1))
    if TD.uses_ring(tcfg):
        assert tcache["k"].shape[3] == cfg.sliding_window < max(positions)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, b, dtype=np.int32)
    pos = np.asarray(positions, np.int32)
    jl, jcache = JD.decode_step(params, cfg, jcache, jnp.asarray(tok),
                                jnp.asarray(pos))
    tl, tcache = TD.decode_step(tparams, tcfg, tcache,
                                torch.from_numpy(tok.copy()),
                                torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3,
                               atol=2e-3)
    for key in jcache:
        np.testing.assert_allclose(
            convert.to_numpy(tcache[key]).astype(np.float32),
            np.asarray(jcache[key], np.float32), rtol=2e-2, atol=1,
            err_msg=key)


def test_decode_step_position_vector_equals_scalar_for_equal_rows():
    """A [B] vector of one position gives the scalar path's logits and
    cache exactly (the scatter writes the same slots as the slice)."""
    _, tcfg, _, tparams = _setup("gemma2-9b")
    cfg = _setup("gemma2-9b")[0]
    arrays = _random_cache(JD.init_cache(cfg, 2, 32), 3)
    _, a = _pair(JD.init_cache(cfg, 2, 32), arrays)
    _, c = _pair(JD.init_cache(cfg, 2, 32), arrays)
    tok = torch.tensor([3, 9], dtype=torch.int32)
    la, a = TD.decode_step(tparams, tcfg, a, tok, 20)
    lc, c = TD.decode_step(tparams, tcfg, c, tok,
                           torch.tensor([20, 20], dtype=torch.int32))
    assert torch.equal(la, lc)
    for key in a:
        assert torch.equal(a[key], c[key]), key


# --------------------------------------------------------------------------
# slot-wise cache surgery
# --------------------------------------------------------------------------

SURGERY = {"gemma2-int8": ("gemma2-9b", ""),
           "llama3-bf16": ("llama3-405b", "bfloat16"),
           "falcon-mamba-ssm": ("falcon-mamba-7b", "")}


@pytest.mark.parametrize("case", sorted(SURGERY))
def test_cache_surgery_matches_jax_exactly(case):
    cfg, tcfg = _setup(*SURGERY[case])[:2]
    layout = JD.init_cache(cfg, 3, 24)
    jres, tres = _pair(layout, _random_cache(layout, 4))
    short = JD.init_cache(cfg, 1, 10)  # a prompt-deep row (ssm: states)
    jrow, trow = _pair(short, _random_cache(short, 5))
    assert TD.cache_rows(tres) == JD.cache_rows(jres) == 3
    _assert_cache_equal(TD.cache_extract(tres, 2), JD.cache_extract(jres, 2))
    jres = JD.cache_insert(jres, jrow, 1)
    tres = TD.cache_insert(tres, trow, 1)
    _assert_cache_equal(tres, jres)
    jres = JD.cache_clear_row(jres, 0)
    tres = TD.cache_clear_row(tres, 0)
    _assert_cache_equal(tres, jres)
    extracted = TD.cache_extract(tres, 1)
    TD.cache_clear_row(tres, 1)
    _assert_cache_equal(extracted, JD.cache_extract(jres, 1))


def test_cache_insert_refuses_a_longer_row():
    _, tcfg = _setup("llama3-405b", "bfloat16")[:2]
    res = TD.init_cache(tcfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        TD.cache_insert(res, TD.init_cache(tcfg, 1, 9, device="cpu"), 0)


# --------------------------------------------------------------------------
# the engine against the JAX engine
# --------------------------------------------------------------------------

# (arch, kv, prompt lengths, gen lengths, max_seq); mixtral's max_seq is
# past its reduced window (64), so its loop is a full ring and positions
# wrap, and the JAX engine can adopt its prefill ring; falcon-mamba's
# prompts are multiples of the reference's scan chunk (32)
ENGINE = {
    "gemma2-int8": ("gemma2-9b", "", (6, 9, 4), (5, 3, 1), 24),
    "llama3-bf16": ("llama3-405b", "bfloat16", (7, 3, 12), (4, 6, 2), 24),
    "mixtral-ring": ("mixtral-8x7b", "", (60, 50, 40), (9, 5, 1), 72),
    "falcon-mamba-ssm": ("falcon-mamba-7b", "", (32, 64, 32), (5, 3, 2),
                         72),
}


def _jax_engine_tokens(cfg, params, prompts, gens, max_seq):
    model = JE.JaxModel(cfg, params, max_batch=2, max_seq=max_seq,
                        attn_impl="naive")
    c = JaxCluster(JaxMGB(1, hbm_per_device=64 * GB), workers=2)
    eng = JE.ServeEngine(c, model, max_batch=2, slo=JE.SLO(600.0, 600.0))
    reqs = [eng.submit(prompt=jnp.asarray(p, jnp.int32), gen_len=g)
            for p, g in zip(prompts, gens)]
    eng.drain(timeout_s=300.0)
    eng.shutdown()
    c.shutdown()
    assert all(r.status is JE.RequestStatus.DONE for r in reqs)
    return [r.tokens for r in reqs]


def _port_engine(tcfg, tparams, prompts, gens, max_seq):
    sched = MGBAlg3Scheduler(1, hbm_per_device=64 * GB)
    c = Cluster(sched, workers=2, devices=[CPU])
    model = TE.TorchModel(tcfg, tparams, max_batch=2, max_seq=max_seq)
    eng = TE.ServeEngine(c, model, max_batch=2, slo=TE.SLO(600.0, 600.0))
    reqs = [eng.submit(prompt=torch.from_numpy(p.astype(np.int64)),
                       gen_len=g) for p, g in zip(prompts, gens)]
    eng.drain(timeout_s=300.0)
    m = eng.metrics()
    eng.shutdown()
    c.shutdown()
    assert sched.devices[0].used_hbm == 0
    return reqs, m


@pytest.mark.parametrize("case", sorted(ENGINE))
def test_engine_tokens_equal_the_jax_engine(case):
    arch, kv, lens, gens, max_seq = ENGINE[case]
    cfg, tcfg, params, tparams = _setup(arch, kv)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (1, s), dtype=np.int32)
               for s in lens]
    want = _jax_engine_tokens(cfg, params, prompts, gens, max_seq)
    reqs, m = _port_engine(tcfg, tparams, prompts, gens, max_seq)
    assert all(r.status is TE.RequestStatus.DONE for r in reqs), \
        [(r.status, r.error) for r in reqs]
    assert m["violations"] == 0 and m["done"] == len(reqs)
    assert [r.tokens for r in reqs] == want
    assert [len(t) for t in want] == list(gens)


def test_jax_engine_cannot_adopt_a_window_deep_ring_into_a_shorter_loop():
    """The reference engine's loop holds ``cache_seq_len(cfg, max_seq)``
    slots, but its prefill hands a window-deep ring over
    (``src/repro/serve/decode.py:37-59``): for a ring arch with max_seq
    below the window, ``cache_insert`` raises at adoption
    (ROADMAP C8)."""
    cfg, _, params, _ = _setup("mixtral-8x7b")
    max_seq = 24
    assert JD.cache_seq_len(cfg, max_seq) == max_seq < cfg.sliding_window
    model = JE.JaxModel(cfg, params, max_batch=2, max_seq=max_seq,
                        attn_impl="naive")
    req = JE.ServeRequest(rid=0, prompt_len=12, gen_len=4, arrival_t=0.0,
                          prompt=jnp.zeros((1, 12), jnp.int32))
    model.prefill(req)
    assert req.cache["k"].shape[3] == cfg.sliding_window
    with pytest.raises(ValueError, match="exceeds resident buffer"):
        model.adopt(model.make_loop_state(2), 0, req)


def test_port_engine_serves_a_ring_shorter_than_the_window():
    """Where the reference raises (above), the port adopts the ring's first
    max_seq slots (``serve.decode.resident_ring``): the tokens are JAX's
    static prefill and greedy decode over the full window-deep ring."""
    cfg, tcfg, params, tparams = _setup("mixtral-8x7b")
    max_seq = 24
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, (1, s), dtype=np.int32)
               for s in (12, 16, 9)]
    gens = (8, 5, 3)
    reqs, m = _port_engine(tcfg, tparams, prompts, gens, max_seq)
    assert m["violations"] == 0
    prefill = jax.jit(JS.make_prefill_step(cfg, attn_impl="naive"))
    for p, g, r in zip(prompts, gens, reqs):
        assert r.status is TE.RequestStatus.DONE, (r.status, r.error)
        logits, cache = prefill(params, {"tokens": jnp.asarray(p)})
        first = jnp.argmax(logits, -1).astype(jnp.int32)
        toks, _ = JS.greedy_generate(cfg, params, cache, first,
                                     p.shape[1], g - 1)
        assert r.tokens == [int(first[0])] + [int(t) for t in
                                              np.asarray(toks)[0]]


def test_resident_ring_cuts_only_a_deeper_ring():
    _, tcfg = _setup("mixtral-8x7b")[:2]
    ring = {"k": torch.arange(64.0).reshape(1, 1, 1, 64, 1).expand(
        2, 1, 1, 64, 4), "v": torch.zeros(2, 1, 1, 64, 4)}
    cut = TS.resident_ring(tcfg, ring, 24)
    assert cut["k"].shape[3] == 24
    assert torch.equal(cut["k"][0, 0, 0, :, 0], torch.arange(24.0))
    assert TS.resident_ring(tcfg, ring, 100) is ring
    _, gcfg = _setup("gemma2-9b")[:2]
    assert TS.resident_ring(gcfg, ring, 24) is ring


# --------------------------------------------------------------------------
# resource vectors
# --------------------------------------------------------------------------

def test_prefill_vec_leaves_the_weights_out_and_the_loop_charges_them_once():
    _, tcfg, _, tparams = _setup("gemma2-9b")
    weights = sum(t.numel() * t.element_size()
                  for t in jax.tree_util.tree_leaves(tparams))
    model = TE.TorchModel(tcfg, tparams, max_batch=4, max_seq=40)
    req = TE.ServeRequest(rid=0, prompt_len=16, gen_len=8, arrival_t=0.0,
                          prompt=torch.zeros(1, 16, dtype=torch.int64))
    prefill = TS.make_prefill_step(tcfg)
    charged = P.probe_fn(prefill, tparams, {"tokens": req.prompt})
    free = model.prefill_vec(req)
    assert charged.hbm_bytes - free.hbm_bytes == weights
    assert 0 < free.hbm_bytes < weights
    cache = TD.init_cache(tcfg, 4, 40, device="cpu")
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    assert model.slot_bytes * 4 == cache_bytes
    loop = model.loop_vec(4).hbm_bytes
    assert weights < loop < 2 * weights
    # every row's cache is allocated with the loop: the base holds it, plus
    # one adoption's staging, and a join adds no bytes
    assert loop == model.step_vec.hbm_bytes + model.slot_bytes
    assert model.step_vec.hbm_bytes > weights + cache_bytes
    assert model.slot_vec(req).hbm_bytes == 0
    # the same trace, charged twice over, is the weights once more
    twice = P.trace_counts(TE.loop_footprint, tparams, tcfg, 4, 40)
    assert twice["arg_bytes"] == weights and twice["unseen_bytes"] == 0


def test_uncharged_storage_shared_with_a_charged_argument_is_charged():
    w = torch.zeros(256)
    c = P.trace_counts(lambda a, b: a[:128] + b, w, w[:128], uncharged=(0,))
    assert c["arg_bytes"] == w.numel() * 4
    c = P.trace_counts(lambda a, b: a[:128] + b, w, torch.zeros(128),
                       uncharged=(0,))
    assert c["arg_bytes"] == 128 * 4


# --------------------------------------------------------------------------
# the engine with the no-compute model, and the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("max_batch,hbm,n", [(2, 64, 8), (4, 8, 12),
                                             (1, 64, 5)])
def test_null_model_engine_completes_every_request(max_batch, hbm, n):
    sched = MGBAlg3Scheduler(1, hbm_per_device=hbm * GB)
    c = Cluster(sched, workers=2, devices=[CPU])
    model = TE.NullModel(loop_hbm=2 * GB, slot_hbm=GB, prefill_hbm=GB,
                         prefill_s=0.0, step_s=0.0)
    eng = TE.ServeEngine(c, model, max_batch=max_batch,
                         slo=TE.SLO(600.0, 600.0))
    reqs = [eng.submit(prompt_len=8, gen_len=1 + i % 4) for i in range(n)]
    eng.drain(timeout_s=120.0)
    m = eng.metrics()
    eng.shutdown()
    c.shutdown()
    assert all(r.status is TE.RequestStatus.DONE for r in reqs)
    assert [r.n_tokens for r in reqs] == [r.gen_len for r in reqs]
    assert m["violations"] == 0 and m["done"] == n
    assert sched.devices[0].used_hbm == 0


def test_serve_continuous_on_cpu_reports_what_it_served():
    res = serve_continuous("gemma2-9b", device="cpu", requests=5, batch=2,
                           prompt_len=8, gen_len=4)
    assert res["done"] == 5 and res["violations"] == 0
    assert res["failed"] == 0 and res["shed"] == 0 and res["errors"] == []
    assert res["tokens"] == 20 and res["tokens_per_s"] > 0
    assert [len(g) for g in res["generated"]] == [4] * 5
    assert all(0 <= t < 512 for g in res["generated"] for t in g)
    assert res["peak_reserved"] >= res["loop_vec"].hbm_bytes \
        + 2 * res["slot_vec"].hbm_bytes
    assert res["steps"] >= 4 and res["capture_s"] == 0.0
    assert res["hbm_per_device"] == DEFAULT_HBM  # no pool reserve on a CPU


def test_pool_reserve_sets_aside_each_workers_stream_on_a_card():
    # each pool worker's stream keeps its cuBLAS workspace between tasks
    card = [torch.device("cuda", 0)]
    assert pool_reserve(card, 2) == 2 * P.CUDA_UNSEEN_BYTES
    assert pool_reserve(card, 4) == 4 * P.CUDA_UNSEEN_BYTES
    assert pool_reserve([CPU], 4) == 0


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_graph_replayed_decode_gives_the_eager_tokens_on_card():
    """Reduced gemma2 (int8 KV, alternating window) and mixtral (ring) on
    the card: ``greedy_generate``'s graph replays and the engine's replayed
    loop step emit the tokens of the same steps run eagerly on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured in a CUDA graph")
    dev = torch.device("cuda", 0)
    for arch in ("gemma2-9b", "mixtral-8x7b"):
        _, tcfg, _, tparams = _setup(arch)
        params = jax.tree_util.tree_map(lambda t: t.to(dev), tparams)
        tok = torch.randint(0, tcfg.vocab, (2, 40),
                            generator=torch.Generator().manual_seed(0))
        logits, cache = TS.make_prefill_step(tcfg)(params,
                                                   {"tokens": tok.to(dev)})
        first = torch.argmax(logits, -1).to(torch.int32)
        replays = TS.REPLAYS.value
        graph, _ = TS.greedy_generate(
            tcfg, params, TS.decode_cache(tcfg, {k: v.clone() for k, v in
                                                 cache.items()}, 60),
            first, 40, 12)
        assert TS.REPLAYS.value - replays == 11
        full = TS.decode_cache(tcfg, cache, 60)
        eager, nxt = [], first
        for i in range(12):
            lg, full = TD.decode_step(params, tcfg, full, nxt, 40 + i)
            nxt = torch.argmax(lg, -1).to(torch.int32)
            eager.append(nxt)
        assert torch.equal(graph.cpu(), torch.stack(eager, 1).cpu()), arch

        prompts = [tok[i:i + 1, :s] for i, s in enumerate((40, 33))]
        runs = {}
        for replayed in (True, False):
            sched = MGBAlg3Scheduler(1, hbm_per_device=64 * GB)
            c = Cluster(sched, workers=2, devices=[dev])
            model = TE.TorchModel(tcfg, params, max_batch=2, max_seq=60)
            eng = TE.ServeEngine(c, model, max_batch=2,
                                 slo=TE.SLO(600.0, 600.0))
            if not replayed:  # the same loop step, run eagerly
                eng.loops[0].state["graph"] = None
            reqs = [eng.submit(prompt=q, gen_len=12) for q in prompts]
            eng.drain(timeout_s=300.0)
            eng.shutdown()
            c.shutdown()
            assert all(r.status is TE.RequestStatus.DONE for r in reqs)
            runs[replayed] = [r.tokens for r in reqs]
        assert runs[True] == runs[False], arch
