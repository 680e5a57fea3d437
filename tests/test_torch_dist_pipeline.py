"""The port's pipeline (``repro_torch.dist.pipeline``), elastic reshard,
DTensor compression, ``constrain`` and the sharded launcher on 4 gloo
ranks on the CPU, against the sequential stack, the unsharded launcher and
the JAX package (``tests/test_torch_dist.py`` has the rest of the port's
distribution).

  * Multi-rank checks run as 4 gloo ranks on the CPU (``_dist_ranks.py``,
    one process a rank over a ``FileStore`` under ``tmp_path``, all under
    one deadline, ``tests/_dist.py``), started together by the module's
    fixture. This file's:
      - the pipeline on 4 stages with 4 and 8 microbatches against the
        sequential stack (within 1e-5), elastic reshard (2, 2) -> (2, 1)
        (bit-equal params and moments; ranks outside the new mesh get
        ``(None, None)``), DTensor compression in global blocks, ``constrain``,
        4 compressed steps with error feedback (the loss falls, sharded as
        unsharded), and ``launch.train.train(mesh_shape=(2, 2))`` under the
        ``ShardedScheduler`` against the unsharded launcher;
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
        default Explicit mesh.
"""
import dataclasses
import os
import pickle
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _spawn import reaped, spawn  # noqa: E402
from _worker_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402

from _dist import HERE, ROOT, SPAWN_TIMEOUT_S, WORLD, _launch, _wait  # noqa: E402
from _train import _np  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models import model as JM  # noqa: E402


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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The pipeline's spawns (``misc``) and the reference's pipeline
    gradients (``_jax_pipeline.py``), started together. Every child is
    reaped on the fixture's way out, a failure included."""
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    workdir = str(tmp_path_factory.mktemp("dist"))
    _pipeline_inputs(workdir)
    with reaped([]) as children:
        children.append(spawn(
            [sys.executable, os.path.join(HERE, "_jax_pipeline.py"),
             os.path.join(workdir, "pipe.pkl"),
             os.path.join(workdir, "jax_pipe.pkl")],
            os.path.join(workdir, "jax_pipe.0.log"),
            dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 XLA_FLAGS="--xla_force_host_platform_device_count=4")))
        misc = _launch("misc", workdir)
        children += misc
        out = {"misc": _wait(misc, "misc", workdir, deadline),
               "jax_pipe": _wait(children[:1], "jax_pipe", workdir,
                                 deadline)}
    return out, {"workdir": workdir}


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
