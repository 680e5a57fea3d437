"""The port's static serving entry point, and the port's independence from
the JAX package: ``repro_torch`` imports neither ``jax`` nor ``repro``."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils._pytree import tree_map  # noqa: E402

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.launch import serve as LS  # noqa: E402
from repro_torch.serve import decode as SD  # noqa: E402
from repro_torch.serve.decode import (  # noqa: E402
    greedy_generate, make_prefill_step,
)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PORT = os.path.join(ROOT, "src", "repro_torch")


def test_serve_gemma2_on_cpu_completes_every_batch():
    res = serve("gemma2-9b", device="cpu")
    assert res["batches"] == 4 and res["completed"] == 4
    assert res["crashed"] == 0 and res["errors"] == []
    assert res["tokens_generated"] == 16 * 32
    assert res["p50_ttft_s"] > 0 and res["p50_tpot_s"] > 0
    assert res["probe"].hbm_bytes > 0 and res["probe"].flops > 0
    assert [g.shape for g in res["generated"]] == [(4, 32)] * 4


def test_serve_tokens_equal_a_direct_run():
    """What the scheduled runner generates is what prefill -> pad ->
    greedy decode gives when called directly on the same weights."""
    res = serve("llama3-405b", device="cpu", requests=3, batch=2,
                prompt_len=16, gen_len=5, seed=3)
    assert res["completed"] == 2 and res["tokens_generated"] == 3 * 5
    cfg = get_arch("llama3-405b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(3),
                         torch.float32, torch.device("cpu"))
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16),
                                        dtype=np.int64))
    logits, cache = make_prefill_step(cfg)(params, {"tokens": tok})
    first = torch.argmax(logits, -1).to(torch.int32)
    full = D.cache_insert(D.init_cache(cfg, 2, 21, device="cpu"), cache, 0)
    out, _ = greedy_generate(cfg, params, full, first, 16, 4)
    want = torch.cat([first[:, None], out], 1).numpy()
    np.testing.assert_array_equal(res["generated"][0], want)
    assert res["generated"][1].shape == (1, 5)  # padding row not served


def _model(arch, dtype, device="cpu"):
    cfg = get_arch(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype,
                         torch.device("cpu"))
    return cfg, tree_map(lambda t: t.to(device), params)


def _prefill(cfg, params, seed, rows=2, s=12):
    dev = params["embed"].device
    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (rows, s), dtype=np.int64)).to(dev)
    logits, cache = make_prefill_step(cfg)(params, {"tokens": tok})
    return torch.argmax(logits, -1).to(torch.int32), cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["gemma2-9b", "llama3-405b",
                                  "mixtral-8x7b", "falcon-mamba-7b"])
def test_decode_buffers_have_the_padded_prefill_caches_layout(arch, dtype):
    """A pool worker's decoder buffers take any batch's prefill cache: the
    shapes and dtypes of ``decode_cache`` of it (int8 KV for gemma2, a
    window-deep ring for mixtral, ssm states for falcon-mamba)."""
    cfg, params = _model(arch, dtype)
    _, cache = _prefill(cfg, params, 0, s=80)
    want = SD.decode_cache(cfg, cache, 90)
    got = SD.decode_buffers(cfg, 2, 90, dtype, "cpu")
    assert {k: (v.shape, v.dtype) for k, v in got.items()} \
        == {k: (v.shape, v.dtype) for k, v in want.items()}
    assert all(not v.any() for v in got.values())


def _kept_decoder_against_greedy_generate(arch, device, steps):
    """One ``GreedyDecoder`` serving three batches in turn, each loaded over
    the last one's leftovers, against a fresh ``greedy_generate`` over each
    batch's padded prefill cache."""
    cfg, params = _model(arch, torch.float32, device)
    dec = SD.GreedyDecoder(cfg, params, SD.decode_buffers(
        cfg, 2, 12 + steps + 1, torch.float32, device))
    for seed in range(3):
        first, cache = _prefill(cfg, params, seed)
        want, _ = greedy_generate(
            cfg, params, SD.decode_cache(cfg, {k: v.clone() for k, v in
                                               cache.items()}, 13 + steps),
            first, 12, steps)
        dec.load(cache, first, 12)
        assert torch.equal(dec.generate(steps).cpu(), want.cpu()), \
            (arch, seed)


@pytest.mark.parametrize("arch", ["gemma2-9b", "mixtral-8x7b",
                                  "falcon-mamba-7b"])
def test_a_kept_decoder_gives_each_batch_greedy_generates_tokens(arch):
    _kept_decoder_against_greedy_generate(arch, "cpu", 7)


def test_static_serve_probes_the_prefill_and_reserves_each_workers_decoder():
    """The static path probes the prefill as the task and the decoder as
    what each worker keeps; on a card both are charged (the task's probe
    to the scheduler, the decoder in ``pool_reserve``, once a worker, and
    beside them once what the workers share, the captured prefill)."""
    res = serve("gemma2-9b", device="cpu", requests=8, batch=2,
                prompt_len=12, gen_len=6, workers=2)
    assert res["completed"] == 4 and res["decode_graphs"] == 0  # CPU: eager
    kept = res["kept_per_worker"]
    cfg = get_arch("gemma2-9b").reduced()
    buf = SD.decode_buffers(cfg, 2, 18, torch.float32, "cpu")
    assert kept.hbm_bytes > sum(t.numel() * t.element_size()
                                for t in buf.values())
    card = [torch.device("cuda", 0)]
    assert LS.pool_reserve(card, 2, kept.hbm_bytes) == 2 * kept.hbm_bytes
    assert LS.pool_reserve([torch.device("cpu")], 2, kept.hbm_bytes) == 0
    assert res["kept_per_card"] is None  # CPU: the prefill runs eagerly


@pytest.mark.gpu
def test_a_kept_decode_graph_gives_per_batch_graphs_tokens_on_card():
    """Reduced gemma2 in f32 on the card: one ``GreedyDecoder`` whose graph
    is captured at the first batch and replayed for every later one gives
    each batch the tokens of a per-batch graph (``greedy_generate``), and
    captures once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured in a CUDA graph")
    captures = SD.CAPTURES.value
    _kept_decoder_against_greedy_generate("gemma2-9b",
                                          torch.device("cuda", 0), 15)
    # one capture for the kept decoder, one for each greedy_generate
    assert SD.CAPTURES.value - captures == 1 + 3


def _specs(cfg, device, dtype=torch.bfloat16):
    """``TensorSpec``s of a configuration's weights on ``device``."""
    from repro_torch.core.probe import TensorSpec
    meta = init_params(cfg, None, dtype, torch.device("meta"))
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype, device),
                    meta)


@pytest.mark.parametrize("arch", ["gemma2-9b", "falcon-mamba-7b",
                                  "mixtral-8x7b"])
def test_captured_prefill_is_charged_to_its_worker_once(arch):
    """With the prefill captured (on a card), its peak moves from the
    batch's vector into what the card keeps, charged once however many
    workers share the graph: the card keeps the prefill's pool
    (``static_task``'s live peak) and the graph's copy of the tokens, a
    worker its decoder; a batch is charged its weights, its tokens and its
    first tokens. Together they charge what the eager path did, plus only
    the graph's static copy of the tokens and the first tokens. Probed on
    ``TensorSpec``s (fake tensors): nothing allocated, no card needed."""
    from repro_torch.core.probe import TensorSpec, probe_fn, trace_counts
    cfg = get_arch(arch).reduced()
    dev = torch.device("cpu")
    params = _specs(cfg, dev)
    batch = {"tokens": TensorSpec((2, 12), torch.int64, dev)}
    first = TensorSpec((2,), torch.int32, dev)
    eager = probe_fn(LS.static_task, params, batch, cfg)
    replay = probe_fn(LS.replayed_task, params, batch,
                      TensorSpec((2, cfg.vocab), torch.float32, dev),
                      uncharged=(2,))
    pool = trace_counts(LS.static_task, params, batch, cfg, uncharged=(0,))
    dec = probe_fn(LS.decode_state, params, first, cfg, 18, uncharged=(0,))
    kept = LS.kept_by_worker(params, first, cfg, 18)
    card = LS.kept_by_card(params, batch, cfg)
    # the first tokens: argmax's int64 and their int32 copy
    first_tokens = trace_counts(
        LS.replayed_task, params, batch,
        TensorSpec((2, cfg.vocab), torch.float32, dev),
        uncharged=(0, 1, 2))["hbm_bytes"]
    tokens = 2 * 12 * 8
    assert first_tokens == 2 * 8 + 2 * 4
    assert pool["arg_bytes"] == tokens
    assert kept.hbm_bytes == dec.hbm_bytes
    assert card.hbm_bytes == tokens + pool["peak_live_bytes"]
    assert eager.hbm_bytes - replay.hbm_bytes \
        == pool["peak_live_bytes"] - first_tokens
    extra = (replay.hbm_bytes + kept.hbm_bytes + card.hbm_bytes) \
        - (eager.hbm_bytes + dec.hbm_bytes)
    assert extra == tokens + first_tokens


@pytest.mark.gpu
def test_a_replayed_prefill_equals_the_eager_prefill_on_card():
    """Reduced gemma2 (softcaps, window 64, int8 KV) and mixtral (grouped
    matmuls, a ring cache) in bf16 on the card: a ``PrefillGraph``
    captured at one batch and replayed for two others gives each the
    eager prefill's logits and cache bit for bit, one capture and one
    replay a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the prefill is captured in a CUDA "
                    "graph")
    dev = torch.device("cuda", 0)
    for arch in ("gemma2-9b", "mixtral-8x7b"):
        cfg, params = _model(arch, torch.bfloat16, dev)
        prefill = make_prefill_step(cfg)
        batches = [{"tokens": torch.from_numpy(np.random.default_rng(i)
                    .integers(0, cfg.vocab, (2, 100), dtype=np.int64))
                    .to(dev)} for i in range(3)]
        captures = SD.PREFILL_CAPTURES.value
        graph = SD.PrefillGraph(prefill, params, batches[0],
                                SD.capture_stream(dev))
        assert SD.PREFILL_CAPTURES.value == captures + 1
        for b in batches[1:] + batches[:1]:
            replays = SD.PREFILL_REPLAYS.value
            logits, cache = graph(b)
            want_logits, want_cache = prefill(params, b)
            torch.cuda.synchronize()
            assert SD.PREFILL_REPLAYS.value == replays + 1
            assert torch.equal(logits, want_logits)
            assert set(cache) == set(want_cache)
            for k in cache:
                assert torch.equal(cache[k], want_cache[k]), (arch, k)


def test_serve_without_a_card_needs_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve("gemma2-9b", requests=1, batch=1, prompt_len=4, gen_len=2)


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.core, repro_torch.obs, repro_torch.core.cluster, "
            "repro_torch.core.simulator, repro_torch.core.workloads, "
            "repro_torch.core.taskgraph, repro_torch.obs.replay, "
            "repro_torch.serve.engine, repro_torch.bench.common, "
            "repro_torch.bench.table2_crashes, "
            "repro_torch.bench.table3_turnaround, "
            "repro_torch.bench.table4_slowdown, "
            "repro_torch.bench.fig4_alg2_vs_alg3, "
            "repro_torch.bench.fig5_throughput, repro_torch.dist, "
            "repro_torch.dist.kernel_sharding, repro_torch.train.elastic, "
            "repro_torch.launch.mesh, repro_torch.launch.train, "
            "repro_torch.core.scheduler.sharded, "
            "repro_torch.core.scheduler.slice, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.gang_placement, "
            "repro_torch.examples.preemptive_cluster, "
            "repro_torch.examples.trace_viewer, "
            "repro_torch.examples.shared_cluster, "
            "repro_torch.examples.train_100m; "
            "repro_torch.dist.kernel_sharding.register(); print('ok')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_of_the_port_imports_jax_or_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    rel = {os.path.relpath(f, PORT) for f in files}
    assert {"dist/sharding.py", "dist/compression.py", "dist/pipeline.py",
            "dist/kernel_sharding.py", "train/elastic.py", "launch/mesh.py",
            "core/scheduler/sharded.py", "core/scheduler/slice.py",
            "examples/quickstart.py", "examples/gang_placement.py",
            "examples/preemptive_cluster.py", "examples/trace_viewer.py",
            "examples/shared_cluster.py", "examples/train_100m.py"} <= rel
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert bad == []
