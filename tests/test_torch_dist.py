"""The port's distribution (``repro_torch.dist``, ``train.elastic``,
``launch.mesh``, the sharded train step and launcher) against the JAX
package.

  * ``param_specs``, ``batch_specs`` and ``cache_specs`` equal the
    reference's ``PartitionSpec``s for every arch of the registry on meshes
    (1, 1), (2, 2), (4, 2), (16, 16) and (2, 16, 16) (the JAX side on an
    ``AbstractMesh``, the port's on its ``AbstractMesh``), a port leaf's
    spec being the reference's without the entries of its stacked dims.
  * ``compress_decompress`` equals the JAX function bit for bit on f32
    inputs, tails that are not a multiple of 256 included, and error
    feedback telescopes (``tests/test_substrate.py``).
  * Multi-rank checks run as 4 gloo ranks on the CPU (``_dist_ranks.py``,
    one process a rank over a ``FileStore`` under ``tmp_path``, each with
    its own timeout), two spawns started together:
      - the sharded train step on a (2, 2) ``("data", "model")`` mesh for
        qwen1.5-32b, falcon-mamba-7b, mixtral-8x7b and gemma2-9b (its tied
        table sharded, vocab on ``model`` and d on ``data``), ``reduced()``,
        and for gemma2-9b and mixtral-8x7b once more with
        ``seq_shard_activations=True`` as their published configs set it
        (the residual's sequence on ``model``), from parameters converted
        from JAX, against the UNSHARDED
        ``jax.jit(make_train_step(...))`` (the reference's sharded path
        fails on the installed jax, ROADMAP C2), 2 steps at lr 1e-3:
        loss within 1e-4, grad norm within 1e-4 relative, moments within
        1e-4 of their largest magnitude, every parameter within lr of the
        reference and all but 1e-3 of them within 1e-2 lr (the unsharded
        port's tolerances, ``tests/test_torch_train.py``; tighter than the
        reference test's 1e-3 loss and 1e-2 parameters);
      - world size 1 on a (1, 1) mesh, as on one card: the launcher
        through the ``ShardedScheduler`` gives the unsharded launcher's bits;
      - the pipeline on 4 stages with 4 and 8 microbatches against the
        sequential stack (within 1e-5), elastic reshard (2, 2) -> (2, 1)
        (bit-equal params and moments; ranks outside the new mesh get
        ``(None, None)``), DTensor compression in global blocks, ``constrain``,
        4 compressed steps with error feedback (the loss falls, sharded as
        unsharded), and ``launch.train.train(mesh_shape=(2, 2))`` under the
        ``ShardedScheduler`` against the unsharded launcher;
      - the sharded prefill and 4 decode steps on (2, 2) (``SERVE_CASES``:
        gemma2-9b with its int8 KV cache and with a bf16 one,
        falcon-mamba-7b, mixtral-8x7b expert-parallel, zamba2-2.7b, and
        gemma2-9b and zamba2-2.7b at batch 1 with a context-parallel
        cache, ``reduced()``) from parameters converted from JAX, the
        tokens fed the reference's greedy ones, against the unsharded
        jitted JAX ``make_prefill_step``/``make_serve_step``: logits within
        2e-3 (``tests/test_torch_model.py``'s tolerance), the prefill's
        cache placed by ``cache_specs``;
      - mixtral-8x7b's train steps (and ``+seq``) run expert-parallel:
        each rank's FFN takes [E/2, d, f] expert weights, and the rank's
        program of the step, counted on fake shards, moves no expert
        weight over ``model``;
      - the pipeline's backward against ``jax.grad`` through the
        reference's ``make_pipeline_forward`` on an Auto mesh of 4 host
        devices (``_jax_pipeline.py``, a subprocess started beside the
        ranks): the reference's own setup (4 stages, L = 8, d = 32, x [8,
        16, 32], w and x drawn with numpy from a seed) at 4 and 8
        microbatches, stage params plain and as DTensors, y and both
        gradients on every rank within 1e-5; reduced gemma2-9b's 4
        attention layers on 2 stages (two pipelines on a (2, 2) ("stage",
        "rep") mesh) against the reference's layers under the same
        pipeline, within 2e-3 of each tensor's largest magnitude (the
        reduced model's f32 parity, ``tests/test_torch_model.py``); and
        ROADMAP C23, the reference's gradient refused on ``jax.make_mesh``'s
        default Explicit mesh;
      - checkpoints of a sharded run (reduced qwen1.5-32b, batch 4 x 32,
        the reference's ``test_train_resume_matches_uninterrupted``):
        ``launch.train.train(mesh_shape=(2, 2), ckpt_dir=..., ckpt_every=4,
        steps=6)``, its step 6 deleted, then resumed from step 4 to 6 steps
        on (2, 2) (bit
        for bit the uninterrupted 6-step (2, 2) run), on (4, 1) and in
        this process unsharded (within the f32 parity tolerances), all
        three within ``case_step``'s tolerances of 6 steps of the
        unsharded jitted JAX ``make_train_step`` from the same start; the
        checkpoint has an unsharded run's manifest, and its leaves are
        within the f32 tolerances of an unsharded port run's at step 4.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.utils._pytree import (  # noqa: E402
    SequenceKey, tree_flatten_with_path, tree_leaves,
)

from repro.configs.registry import ARCHS, get_arch  # noqa: E402
from repro.dist import compression as JC  # noqa: E402
from repro.dist import sharding as JSH  # noqa: E402
from repro.launch import mesh as JMESH  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.serve import decode as JS  # noqa: E402
from repro.train.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_arch as port_arch  # noqa: E402
from repro_torch.dist import compression as C  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
# "+seq": the reduced config with the residual's sequence on ``model``
STEP_CASES = ["qwen1.5-32b", "falcon-mamba-7b", "mixtral-8x7b", "gemma2-9b",
              "gemma2-9b+seq", "mixtral-8x7b+seq"]
# (arch, KV cache dtype override, batch, context-parallel cache)
SERVE_CASES = {"gemma2-9b": ("gemma2-9b", "", 2, False),
               "gemma2-9b+bf16": ("gemma2-9b", "bfloat16", 2, False),
               "falcon-mamba-7b": ("falcon-mamba-7b", "", 2, False),
               "mixtral-8x7b": ("mixtral-8x7b", "", 2, False),
               "zamba2-2.7b": ("zamba2-2.7b", "", 2, False),
               "gemma2-9b+cp": ("gemma2-9b", "", 1, True),
               "zamba2-2.7b+cp": ("zamba2-2.7b", "", 1, True)}
SERVE_S, SERVE_PAD, SERVE_STEPS = 64, 8, 4
LR, STEPS, WORLD = 1e-3, 2, 4
SPAWN_TIMEOUT_S = 240
# the sharded checkpoints' runs (``_dist_ranks.case_ckpt``)
CKPT_ARCH, CKPT_BATCH, CKPT_SEQ, CKPT_STEPS, CKPT_AT = (
    "qwen1.5-32b", 4, 32, 6, 4)


# ---------------------------------------------------------------------------
# specs: the reference's rules on every arch and mesh
# ---------------------------------------------------------------------------

def _ref_lookup(tree, names):
    for n in names:
        tree = tree[n]
    return tree


def _port_vs_ref(port_specs, ref_specs):
    """Each port leaf's spec against the reference leaf's (its path with
    the list indices dropped, one stacked dim per index); every reference
    leaf is reached."""
    seen = set()
    for path, spec in tree_flatten_with_path(
            port_specs, is_leaf=lambda x: isinstance(x, tuple))[0]:
        names = tuple(k.key for k in path if not isinstance(k, SequenceKey))
        stacked = sum(isinstance(k, SequenceKey) for k in path)
        ref = tuple(_ref_lookup(ref_specs, names))
        want = ref if not spec else (None,) * stacked + spec
        assert ref == want, (names, spec, ref)
        seen.add(names)
    ref_paths = {tuple(k.key for k in p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(
                     ref_specs,
                     is_leaf=lambda x: isinstance(x, jax.sharding.
                                                  PartitionSpec))[0]}
    assert seen == ref_paths


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_batch_and_cache_specs_equal_the_references(arch):
    cfg, tcfg = get_arch(arch), port_arch(arch)
    ref_params = jax.eval_shape(lambda k: JM.init_params(cfg, k),
                                jax.random.PRNGKey(0))
    port_params = TM.init_params(tcfg, None, torch.float32,
                                 torch.device("meta"))
    batch = {"tokens": jax.ShapeDtypeStruct((32, 128), jnp.int32),
             "labels": jax.ShapeDtypeStruct((32, 128), jnp.int32),
             "pos": jax.ShapeDtypeStruct((), jnp.int32)}
    tbatch = {k: torch.empty(v.shape, device="meta") for k, v in
              batch.items()}
    ref_cache = jax.eval_shape(lambda: JD.init_cache(cfg, 16, 256))
    port_cache = TD.init_cache(tcfg, 16, 256, device="meta")
    for shape, axes in MESHES:
        jm, tm = AbstractMesh(shape, axes), SH.AbstractMesh(shape, axes)
        _port_vs_ref(SH.param_specs(tcfg, port_params, tm),
                     JSH.param_specs(cfg, ref_params, jm))
        assert SH.batch_specs(tcfg, tbatch, tm) == {
            k: tuple(v) for k, v in JSH.batch_specs(cfg, batch, jm).items()}
        for cp in (False, True):
            got = SH.cache_specs(tcfg, port_cache, tm, context_parallel=cp)
            want = JSH.cache_specs(cfg, ref_cache, jm, context_parallel=cp)
            assert set(got) == set(want)
            assert {k: tuple(v) for k, v in want.items()} == got


def test_to_placements_puts_pod_and_data_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    m = SH.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert SH.to_placements((("pod", "data"), None, "model"), m) \
        == [Shard(0), Shard(0), Shard(2)]
    assert SH.to_placements((), m) == [Replicate()] * 3
    assert SH.to_placements((None, "data"), SH.AbstractMesh(
        (2, 2), ("data", "model"))) == [Shard(1), Replicate()]


def test_mesh_helpers_match_the_reference():
    for shape, axes in MESHES:
        jm, tm = AbstractMesh(shape, axes), SH.AbstractMesh(shape, axes)
        assert TMESH.data_axes(tm) == JMESH.data_axes(jm)
        assert TMESH.fsdp_axis(tm) == JMESH.fsdp_axis(jm) == "data"
        assert TMESH.model_axis(tm) == JMESH.model_axis(jm) == "model"


def test_meshes_need_a_group_and_a_card_unless_the_cpu_is_asked_for():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TMESH.mesh_device_type(None)
    assert TMESH.mesh_device_type("cpu") == "cpu"
    with pytest.raises(RuntimeError, match="process group"):
        TMESH.make_production_mesh(device="cpu")


def test_constrain_is_the_identity_off_a_mesh_and_on_one_device():
    x = torch.ones(4, 8)
    assert SH.constrain(x, "batch", "model") is x
    with SH.activation_mesh(SH.AbstractMesh((1, 1), ("data", "model"))):
        assert SH.current_mesh() is not None
        assert SH.constrain(x, "batch", "model") is x
    assert SH.current_mesh() is None


# ---------------------------------------------------------------------------
# compression against the JAX function, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4096,), (300,), (7, 37), (2, 3, 129),
                                   (1,), (256, 2)])
def test_compress_decompress_equals_jax_bit_for_bit(shape):
    rng = np.random.default_rng(sum(shape))
    g = (rng.standard_normal(shape) * rng.choice([1e-3, 1.0, 50.0], shape)
         ).astype(np.float32)
    g.reshape(-1)[::17] = 0.0
    want = np.asarray(JC.compress_decompress(jnp.asarray(g)))
    got = C.compress_decompress(torch.from_numpy(g)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_compress_decompress_keeps_bf16_and_rounds_like_jax():
    g = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    want = np.asarray(JC.compress_decompress(
        jnp.asarray(g, jnp.bfloat16)).astype(jnp.float32))
    got = C.compress_decompress(torch.from_numpy(g).bfloat16())
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


def test_error_feedback_telescopes_and_matches_jax():
    """sum(applied) + residual == sum(true grads) (test_substrate.py), and
    each step's applied gradient and residual equal the JAX package's."""
    rng = np.random.default_rng(1)
    g_total = torch.zeros(512)
    applied = torch.zeros(512)
    err = C.init_error_state({"g": g_total})
    jerr = JC.init_error_state({"g": jnp.zeros(512)})
    for _ in range(10):
        g = rng.standard_normal(512).astype(np.float32)
        g_total = g_total + torch.from_numpy(g)
        q, err = C.apply_with_error_feedback({"g": torch.from_numpy(g)}, err)
        jq, jerr = JC.apply_with_error_feedback({"g": jnp.asarray(g)}, jerr)
        assert np.array_equal(q["g"].numpy(), np.asarray(jq["g"]))
        assert np.array_equal(err["g"].numpy(), np.asarray(jerr["g"]))
        applied = applied + q["g"]
    torch.testing.assert_close(applied + err["g"], g_total, rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# multi-rank: 4 gloo ranks on the CPU
# ---------------------------------------------------------------------------

def _step_cfg(get, case):
    """The reduced config of a ``STEP_CASES`` entry from ``get`` (either
    package's ``get_arch``)."""
    arch, _, seq = case.partition("+")
    return dataclasses.replace(get(arch).reduced(),
                               seq_shard_activations=seq == "seq")


def _opt(mod):
    return mod.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _launch(case, workdir, world=WORLD):
    """Start the ``world`` rank processes of ``case`` (not waited for)."""
    store = os.path.join(workdir, f"{case}.store")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), HERE]))
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_dist_ranks.py"), case,
         str(r), str(world), store, workdir], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _wait(procs, case, workdir):
    """Each rank under its own timeout; every rank must exit 0. Returns
    rank 0's results."""
    errs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=SPAWN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{case}: rank {r} past {SPAWN_TIMEOUT_S} s")
        if p.returncode:
            errs.append(f"rank {r} rc {p.returncode}: {err[-3000:]}")
    assert not errs, "\n".join(errs)
    with open(os.path.join(workdir, f"{case}.pkl"), "rb") as f:
        return pickle.load(f)


def _serve_cfg(case):
    arch, kv, _, _ = SERVE_CASES[case]
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, kv_cache_dtype=kv) if kv else cfg


def _jax_serve(case):
    """The unsharded jitted JAX prefill and ``SERVE_STEPS`` greedy decode
    steps: (start entry for the ranks, (prefill logits, step logits))."""
    cfg = _serve_cfg(case)
    b = SERVE_CASES[case][2]
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tok = np.random.default_rng(5).integers(0, cfg.vocab, (b, SERVE_S),
                                            dtype=np.int32)
    logits, cache = jax.jit(JS.make_prefill_step(cfg, attn_impl="flash_jnp"))(
        params, {"tokens": jnp.asarray(tok)})
    if cfg.family != "ssm" and not JD.uses_ring(cfg):
        # the KV padded as the port's ``decode_cache`` pads it (states kept)
        kv = {k: v for k, v in cache.items() if k in ("k", "v", "k_s", "v_s")}
        empty = JD.init_cache(cfg, b, SERVE_S + SERVE_PAD)
        cache = {**cache, **JD.cache_insert({k: empty[k] for k in kv}, kv, 0)}
    serve = jax.jit(JS.make_serve_step(cfg))
    feed, steps = [], []
    nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for i in range(SERVE_STEPS):
        feed.append(np.asarray(nxt))
        lg, cache = serve(params, cache, nxt, jnp.asarray(SERVE_S + i,
                                                          jnp.int32))
        steps.append(np.asarray(lg))
        nxt = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    start = (SERVE_CASES[case][0], SERVE_CASES[case][1],
             SERVE_CASES[case][3], _np(params), tok, feed,
             SERVE_S + SERVE_PAD)
    return start, (np.asarray(logits), steps)


def _pipeline_inputs(workdir):
    """The pipeline cases' inputs (``pipe.pkl``), drawn with numpy from a
    seed: the tanh stack's w [8, 32, 32] and x [8, 16, 32]; reduced
    gemma2-9b's parameters at 4 layers (JAX's ``init_params``) and hidden
    states [4, 128, d]."""
    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(get_arch("gemma2-9b").reduced(), n_layers=4)
    inp = {"w": (rng.standard_normal((8, 32, 32)) * 0.1).astype(np.float32),
           "x": rng.standard_normal((8, 16, 32)).astype(np.float32),
           "gemma_params": _np(JM.init_params(cfg, jax.random.PRNGKey(0))),
           "gemma_x": rng.standard_normal(
               (4, 128, cfg.d_model)).astype(np.float32)}
    with open(os.path.join(workdir, "pipe.pkl"), "wb") as f:
        pickle.dump(inp, f)


def _jax_layout(params):
    """A dense model's port parameters (numpy) in the reference's tree: the
    per-layer dicts stacked on [L]."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = jax.tree_util.tree_map(lambda *ls: np.stack(ls),
                                           *params["layers"])
    return out


def _ckpt_opt(mod):
    """The launcher's AdamW for a run of ``CKPT_STEPS`` steps."""
    return mod.AdamWConfig(lr=LR, warmup_steps=min(20, CKPT_STEPS // 5 + 1),
                           total_steps=CKPT_STEPS)


def _jax_ckpt_run():
    """``CKPT_STEPS`` steps of the unsharded jitted JAX step from the
    port launcher's start (``init_params`` at seed 0, moved to the
    reference's tree) on the launcher's batches."""
    from repro.configs.base import ShapeConfig
    from repro.data.pipeline import TokenPipeline as JPipe
    cfg, tcfg = get_arch(CKPT_ARCH).reduced(), port_arch(CKPT_ARCH).reduced()
    start = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                           torch.float32, torch.device("cpu"))
    params = _jax_layout(jax.tree_util.tree_map(
        lambda t: t.numpy(), start))
    state = JA.init_state(_ckpt_opt(JA), params)
    step = jax.jit(jax_step(cfg, _ckpt_opt(JA), attn_impl="flash"))
    pipe = JPipe(cfg, ShapeConfig("train", CKPT_SEQ, CKPT_BATCH, "train"),
                 seed=0, batch_override=CKPT_BATCH, seq_override=CKPT_SEQ)
    metrics = []
    for i in range(CKPT_STEPS):
        params, state, m = step(params, state, {
            k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, convert.params_from_jax(_np(params), tcfg, "cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The spawns and the reference's pipeline gradients, started
    together; while they run, the reference's unsharded jitted steps from
    the same states on the same batches."""
    workdir = str(tmp_path_factory.mktemp("dist"))
    start, want = {}, {"workdir": workdir}
    _pipeline_inputs(workdir)
    jax_pipe = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_jax_pipeline.py"),
         os.path.join(workdir, "pipe.pkl"),
         os.path.join(workdir, "jax_pipe.pkl")],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for case in STEP_CASES:
        cfg = _step_cfg(get_arch, case)
        params = JM.init_params(cfg, jax.random.PRNGKey(0))
        state = JA.init_state(_opt(JA), params)
        rng = np.random.default_rng(7)
        batches = []
        for _ in range(STEPS):
            tok = rng.integers(0, cfg.vocab, (8, 64), dtype=np.int32)
            batches.append({"tokens": tok, "labels": np.roll(tok, -1, 1)})
        start[case] = (_np(params), _np(state), batches)
    with open(os.path.join(workdir, "start.pkl"), "wb") as f:
        pickle.dump(start, f)
    serve = {case: _jax_serve(case) for case in SERVE_CASES}
    with open(os.path.join(workdir, "serve.pkl"), "wb") as f:
        pickle.dump({case: st for case, (st, _) in serve.items()}, f)
    want["serve"] = {case: w for case, (_, w) in serve.items()}
    procs = {case: _launch(case, workdir)
             for case in ("step", "misc", "serve", "ckpt")}
    procs["one"] = _launch("one", workdir, world=1)
    try:
        want["ckpt"] = _jax_ckpt_run()
        for case, (params, state, batches) in start.items():
            cfg = _step_cfg(get_arch, case)
            step = jax.jit(jax_step(cfg, _opt(JA), attn_impl="flash"))
            p, s = params, state
            metrics = []
            for b in batches:
                p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in
                                      b.items()})
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            want[case] = (metrics, _np(p), _np(s))
    finally:
        out = {case: _wait(ps, case, workdir) for case, ps in procs.items()}
        out["jax_pipe"] = _wait([jax_pipe], "jax_pipe", workdir)
    return out, want


@pytest.mark.parametrize("arch", STEP_CASES)
def test_sharded_step_matches_the_unsharded_jitted_jax_step(ranks, arch):
    out, want = ranks
    got_m, got_p, got_o, step, placements, residual = out["step"][arch]
    want_m, want_p, want_s = want[arch]
    tcfg = _step_cfg(port_arch, arch)
    for (gl, gn), (wl, wn) in zip(got_m, want_m):
        assert abs(gl - wl) <= 1e-4
        assert abs(gn - wn) <= 1e-4 * wn
    ref_p = convert.params_from_jax(want_p, tcfg, "cpu")
    errs = np.concatenate([
        np.abs(np.asarray(g, np.float32) - w.float().numpy()).ravel()
        for g, w in zip(tree_leaves(got_p), tree_leaves(ref_p))])
    assert errs.max() <= LR
    assert (errs > 1e-2 * LR).sum() <= 1e-3 * errs.size
    ref_s = convert.opt_state_from_jax(want_s, tcfg, "cpu")
    for key in ("mu", "nu"):
        for g, w in zip(tree_leaves(got_o[key]), tree_leaves(ref_s[key])):
            scale = float(w.abs().max())
            np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                       atol=1e-4 * scale + 1e-30)
    assert step == ref_s["step"] == STEPS
    # the parameters were sharded, on both mesh axes
    assert (("Shard", 1), ("Shard", 0)) in placements
    # the residual's sequence went onto ``model`` exactly where asked
    seq = (("Shard", 0), ("Shard", 1))
    assert (seq in residual) == arch.endswith("+seq"), residual


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-8x7b+seq"])
def test_mixtral_steps_run_expert_parallel(ranks, arch):
    """E = 4 on a 2-wide ``model`` axis: each rank's FFN takes its 2
    experts' weights whole in d (gathered over ``data`` only), and the
    rank's counted program of the step (``launch.dryrun.count_local``)
    carries no expert weight in a collective over ``model``."""
    shapes, moved = ranks[0]["step"][arch + ":experts"]
    cfg = _step_cfg(port_arch, arch)
    e = cfg.moe.num_experts
    assert shapes == [(e // 2, cfg.d_model, cfg.d_ff)]
    assert moved == 0


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_sharded_prefill_and_decode_match_the_unsharded_jax_steps(ranks,
                                                                   case):
    logits, steps, pinned, placed = ranks[0]["serve"][case]
    want_logits, want_steps = ranks[1]["serve"][case]
    np.testing.assert_allclose(logits, want_logits, rtol=2e-3, atol=2e-3)
    assert len(steps) == len(want_steps) == SERVE_STEPS
    for got, want in zip(steps, want_steps):
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    # the prefill's cache came out placed by ``cache_specs``
    for key, (have, spec) in pinned.items():
        assert have == spec, key
    if SERVE_CASES[case][3]:  # the KV's sequence on ``data``
        assert placed["k"][0] == ("Shard", 3), placed
    elif "k" in placed:
        assert placed["k"][0] == ("Shard", 1), placed


@pytest.mark.parametrize("n_micro", [4, 8])
def test_pipeline_matches_sequential(ranks, n_micro):
    assert ranks[0]["misc"][f"pipeline{n_micro}"] < 1e-5


def test_pipeline_takes_stage_sharded_dtensors(ranks):
    assert ranks[0]["misc"]["pipeline_dtensor"] < 1e-5


def test_elastic_reshard_keeps_state_bit_equal(ranks):
    """(2, 2) -> (2, 1): bit-equal params and moments on the new mesh
    (checked on its ranks; the others hold nothing), and
    ``rescale_batch_size(256, 16, 8) == 128``."""
    placements = ranks[0]["misc"]["elastic_placements"]
    assert (("Shard", 0), ("Replicate", None)) in placements
    from repro_torch.train.elastic import rescale_batch_size
    assert rescale_batch_size(256, 16, 8) == 128


def test_dtensor_compression_follows_the_global_blocks(ranks):
    # local blocks where a shard is whole blocks of the leading dim; the
    # rest gathered; every case equal to the whole tensor's compression
    assert ranks[0]["misc"]["blocks_are_local"] \
        == [True, False, False, False, True]


def test_constrain_redistributes_on_a_mesh(ranks):
    assert ranks[0]["misc"]["constrain"] == (("Shard", 0), ("Shard", 1))


def test_compressed_steps_lower_the_loss_sharded_as_unsharded(ranks):
    losses = ranks[0]["misc"]["compressed_losses"]
    for ls in losses.values():
        assert ls[-1] < ls[0]
    np.testing.assert_allclose(losses["sharded"], losses["unsharded"],
                               rtol=0, atol=1e-3)


def test_launcher_trains_on_a_mesh_through_the_sharded_scheduler(ranks):
    got = ranks[0]["misc"]["launcher"]
    assert got["status"] == "done" and got["chips"] == WORLD
    # the gang's hbm_bytes is the unsharded step's total
    assert got["hbm"][0] == got["hbm"][1]
    np.testing.assert_allclose(got["losses"], got["plain"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["gnorms"], got["plain_gnorms"],
                               rtol=1e-4)
    assert got["stragglers"] == []


def test_one_device_mesh_gives_the_unsharded_bits(ranks):
    """World size 1, a (1, 1) mesh, as on one card: the launcher through
    the ``ShardedScheduler`` gives the unsharded launcher's losses and grad
    norms, bit for bit on the CPU."""
    got = ranks[0]["one"]
    assert got["status"] == "done" and got["chips"] == 1
    assert got["losses"] == got["plain"]
    assert got["gnorms"] == got["plain_gnorms"]


# ---------------------------------------------------------------------------
# the pipeline's backward against jax.grad through the reference's pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_micro", [4, 8])
@pytest.mark.parametrize("kind", ["plain", "dtensor"])
def test_pipeline_gradients_match_jax_grad_through_the_reference(
        ranks, n_micro, kind):
    """y, the stage params' gradient and x's on every rank: plain stage
    params get the whole [S, L/S, d, d] gradient, DTensors their own
    stage's slice as the local shard; x's is stage 0's on every rank."""
    want_y, want_w, want_x = ranks[0]["jax_pipe"][f"tanh{n_micro}"]
    key = f"tanh{n_micro}" + ("_dtensor" if kind == "dtensor" else "")
    per_rank = ranks[0]["misc"]["pipe"]
    assert len(per_rank) == WORLD
    for rank, out in enumerate(per_rank):
        y, gw, gx = out[key]
        np.testing.assert_allclose(y, want_y, rtol=0, atol=1e-5)
        w = want_w[rank:rank + 1] if kind == "dtensor" else want_w
        assert gw.shape == w.shape
        np.testing.assert_allclose(gw, w, rtol=0, atol=1e-5)
        np.testing.assert_allclose(gx, want_x, rtol=0, atol=1e-5)


def test_pipeline_gradient_through_gemma2_layers_matches_the_reference(ranks):
    """Reduced gemma2-9b's 4 attention layers (local and global windows,
    softcaps) on 2 stages of 2 layers, 2 microbatches, the loss the mean of
    the outputs' squares: y, every stacked layer weight's gradient and x's
    on every rank, against ``jax.grad`` through the reference's pipeline
    over the reference's layers."""
    want = ranks[0]["jax_pipe"]["gemma"]
    for out in ranks[0]["misc"]["pipe"]:
        got = out["gemma"]
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (path, g), (_, w) in zip(flat_got, flat_want):
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3 * scale,
                                       err_msg=str(path))


def test_reference_pipeline_gradient_refuses_the_default_explicit_mesh(
        ranks):
    """ROADMAP C23: on jax 0.9.0 ``jax.make_mesh`` makes Explicit axes, and
    ``jax.grad`` through the reference's pipeline on it raises; on an Auto
    mesh (above) it gives the sequential stack's gradient."""
    err = ranks[0]["jax_pipe"]["explicit_error"]
    assert err is not None and "Length of device assignment 1" in err \
        and "jax.set_mesh" in err, err


# ---------------------------------------------------------------------------
# checkpoints of a sharded run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unsharded_ckpt(ranks, tmp_path_factory):
    """In this process, unsharded: the 6-step run with a checkpoint at step
    4, and the sharded run's checkpoint (a copy of ``ckpt_c``) resumed to 6
    steps."""
    import shutil
    from repro_torch.launch.train import train
    kw = dict(steps=CKPT_STEPS, batch=CKPT_BATCH, seq=CKPT_SEQ,
              device="cpu", lr=LR, log_every=100, keep_state=True)
    tmp = tmp_path_factory.mktemp("unsharded_ckpt")
    full = train(CKPT_ARCH, ckpt_dir=str(tmp / "full"), ckpt_every=CKPT_AT,
                 **kw)
    shutil.copytree(os.path.join(ranks[1]["workdir"], "ckpt_c"),
                    tmp / "resumed")
    resumed = train(CKPT_ARCH, ckpt_dir=str(tmp / "resumed"), resume=True,
                    **kw)
    return str(tmp / "full"), full, resumed


def _ckpt_params_close(got, want):
    errs = np.concatenate([np.abs(np.asarray(g, np.float32)
                                  - np.asarray(w, np.float32)).ravel()
                           for g, w in zip(tree_leaves(got),
                                           tree_leaves(want))])
    assert errs.max() <= LR
    assert (errs > 1e-2 * LR).sum() <= 1e-3 * errs.size


def test_a_sharded_checkpoint_resumes_bit_equal_on_its_mesh(ranks):
    got = ranks[0]["ckpt"]
    full, same = got["full"], got["same"]
    assert full["status"] == same["status"] == "done"
    assert full["start"] == 0 and same["start"] == CKPT_AT
    assert len(full["losses"]) == CKPT_STEPS
    assert same["losses"] == full["losses"][CKPT_AT:]
    assert same["gnorms"] == full["gnorms"][CKPT_AT:]
    for a, b in zip(tree_leaves(same["params"]), tree_leaves(full["params"])):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("where", ["other", "unsharded"])
def test_a_sharded_checkpoint_resumes_on_another_mesh_and_unsharded(
        ranks, unsharded_ckpt, where):
    """Resumed on (4, 1), or in one process without a mesh, from the (2,
    2) run's step 4: the uninterrupted run's last losses, grad norms and
    parameters within the f32 parity tolerances."""
    full = ranks[0]["ckpt"]["full"]
    res = (ranks[0]["ckpt"]["other"] if where == "other" else
           {"losses": unsharded_ckpt[2]["losses"],
            "gnorms": unsharded_ckpt[2]["grad_norms"],
            "start": unsharded_ckpt[2]["start_step"],
            "params": tree_map_np(unsharded_ckpt[2]["params"])})
    assert res["start"] == CKPT_AT
    np.testing.assert_allclose(res["losses"], full["losses"][CKPT_AT:],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(res["gnorms"], full["gnorms"][CKPT_AT:],
                               rtol=1e-4)
    _ckpt_params_close(res["params"], full["params"])


def tree_map_np(tree):
    """A tree of tensors as numpy, in the port's leaf order."""
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("run", ["full", "same", "other", "unsharded"])
def test_sharded_checkpoint_runs_match_the_unsharded_jitted_jax_steps(
        ranks, unsharded_ckpt, run):
    """Each run's losses and grad norms (the uninterrupted run's before
    the checkpoint, then the resumed steps) and final parameters against
    6 steps of the
    unsharded jitted JAX step from the same start: ``case_step``'s
    tolerances."""
    got = ranks[0]["ckpt"]
    want_m, want_p = ranks[1]["ckpt"]
    if run == "full":
        losses, gnorms, params = (got["full"]["losses"],
                                  got["full"]["gnorms"],
                                  got["full"]["params"])
    elif run == "unsharded":
        res = unsharded_ckpt[2]
        losses = got["full"]["losses"][:CKPT_AT] + res["losses"]
        gnorms = got["full"]["gnorms"][:CKPT_AT] + res["grad_norms"]
        params = tree_map_np(res["params"])
    else:
        losses = got["full"]["losses"][:CKPT_AT] + got[run]["losses"]
        gnorms = got["full"]["gnorms"][:CKPT_AT] + got[run]["gnorms"]
        params = got[run]["params"]
    assert len(losses) == CKPT_STEPS
    for gl, gn, (wl, wn) in zip(losses, gnorms, want_m):
        assert abs(gl - wl) <= 1e-4
        assert abs(gn - wn) <= 1e-4 * wn
    _ckpt_params_close(params, tree_map_np(want_p))


def test_a_sharded_checkpoint_has_an_unsharded_runs_layout(ranks,
                                                           unsharded_ckpt):
    """The (2, 2) run's checkpoint at step 4 (rank 0 wrote it after the
    gathers) against the unsharded run's at the same step: the same
    manifest (tree, leaf order, shapes, dtypes) and leaves within the f32
    tolerances."""
    from repro_torch.train import checkpoint as CK
    sharded = os.path.join(ranks[1]["workdir"], "ckpt_c")
    step, leaves, manifest = CK.restore_leaves(sharded)
    ustep, uleaves, umanifest = CK.restore_leaves(unsharded_ckpt[0],
                                                  CKPT_AT)
    assert step == ustep == CKPT_AT
    assert manifest == umanifest
    assert os.listdir(sharded) == [f"step_{CKPT_AT:08d}"]
    n = len(leaves) - 1  # the optimizer's step, an int, comes last
    assert int(leaves[n]) == int(uleaves[n]) == CKPT_AT
    params = leaves[:n // 3]
    _ckpt_params_close(params, uleaves[:n // 3])
    for a, b in zip(leaves[n // 3:n], uleaves[n // 3:n]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()) + 1e-30)
