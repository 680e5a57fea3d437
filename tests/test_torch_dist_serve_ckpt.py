"""The port's sharded serving (prefill and decode) and the checkpoints of a
sharded run on 4 gloo ranks on the CPU, against the unsharded jitted JAX
steps (``tests/test_torch_dist.py`` has the rest of the port's
distribution).

  * Multi-rank checks run as 4 gloo ranks on the CPU (``_dist_ranks.py``,
    one process a rank over a ``FileStore`` under ``tmp_path``, all under
    one deadline, ``tests/_dist.py``), started together by the module's
    fixture. This file's:
      - the sharded prefill and 4 decode steps on (2, 2) (``SERVE_CASES``:
        gemma2-9b with its int8 KV cache and with a bf16 one,
        falcon-mamba-7b, mixtral-8x7b expert-parallel, zamba2-2.7b, and
        gemma2-9b and zamba2-2.7b at batch 1 with a context-parallel
        cache, ``reduced()``) from parameters converted from JAX, the
        tokens fed the reference's greedy ones, against the unsharded
        jitted JAX ``make_prefill_step``/``make_serve_step``: logits within
        2e-3 (``tests/test_torch_model.py``'s tolerance), the prefill's
        cache placed by ``cache_specs``;
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
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _spawn import reaped  # noqa: E402
from _worker_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from _dist import SPAWN_TIMEOUT_S, _launch, _wait  # noqa: E402
from _train import LR, _np  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.serve import decode as JS  # noqa: E402
from repro.train.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_arch as port_arch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402


# (arch, KV cache dtype override, batch, context-parallel cache)
SERVE_CASES = {"gemma2-9b": ("gemma2-9b", "", 2, False),
               "gemma2-9b+bf16": ("gemma2-9b", "bfloat16", 2, False),
               "falcon-mamba-7b": ("falcon-mamba-7b", "", 2, False),
               "mixtral-8x7b": ("mixtral-8x7b", "", 2, False),
               "zamba2-2.7b": ("zamba2-2.7b", "", 2, False),
               "gemma2-9b+cp": ("gemma2-9b", "", 1, True),
               "zamba2-2.7b+cp": ("zamba2-2.7b", "", 1, True)}
SERVE_S, SERVE_PAD, SERVE_STEPS = 64, 8, 4
# the sharded checkpoints' runs (``_dist_ranks.case_ckpt``)
CKPT_ARCH, CKPT_BATCH, CKPT_SEQ, CKPT_STEPS, CKPT_AT = (
    "qwen1.5-32b", 4, 32, 6, 4)


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
    """The checkpointed runs' spawns (``ckpt``, at once) and the sharded
    serving's (``serve``, once the reference's serving steps are made);
    while they run, the reference's unsharded jitted steps of the
    checkpointed run. Every child is reaped on the fixture's way out, a
    failure included."""
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    workdir = str(tmp_path_factory.mktemp("dist"))
    want = {"workdir": workdir}
    with reaped([]) as children:
        procs = {"ckpt": _launch("ckpt", workdir)}
        children += procs["ckpt"]
        serve = {case: _jax_serve(case) for case in SERVE_CASES}
        with open(os.path.join(workdir, "serve.pkl"), "wb") as f:
            pickle.dump({case: st for case, (st, _) in serve.items()}, f)
        want["serve"] = {case: w for case, (_, w) in serve.items()}
        procs["serve"] = _launch("serve", workdir)
        children += procs["serve"]
        want["ckpt"] = _jax_ckpt_run()
        out = {case: _wait(ps, case, workdir, deadline)
               for case, ps in procs.items()}
    return out, want


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
