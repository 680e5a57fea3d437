"""The port's shared_cluster example (``repro_torch.examples.
shared_cluster``) against the reference's ``examples/shared_cluster.py``,
on the same inputs, on the CPU: the train jobs, started from the JAX
example's weights carried over by ``convert``, end their 3 steps at the
jitted JAX runner's losses and parameters (``tests/test_torch_train.py``'s
tolerances), the prefill jobs' logits match the JAX prefill's within 2e-3
(``tests/test_torch_model.py``'s), and ``main`` runs whole.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _examples import CPU, _metrics_close  # noqa: E402
from _train import _np, _params_close  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models.model import init_params as jax_init  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.serve.decode import make_prefill_step as jax_prefill  # noqa: E402
from repro.train.train_step import make_train_step as jax_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_arch as port_arch  # noqa: E402
from repro_torch.core.executor import Executor  # noqa: E402
from repro_torch.core.scheduler import MGBAlg3Scheduler  # noqa: E402
from repro_torch.examples import shared_cluster  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _jax_batch(cfg, seed, labels):
    """The reference example's batch for seed ``seed``."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (shared_cluster.BATCH,
                                      shared_cluster.SEQ), np.int32)
    batch = {"tokens": jnp.asarray(tok)}
    if labels:
        batch["labels"] = jnp.roll(batch["tokens"], -1, axis=1)
    if cfg.embedding_frontend_stub:
        batch["embeds"] = jnp.asarray(rng.standard_normal(
            (shared_cluster.BATCH, shared_cluster.SEQ, cfg.d_model),
            np.float32))
    return batch


def test_shared_cluster_builds_the_references_six_jobs():
    jobs = shared_cluster.build_jobs(torch.device("cpu"))
    assert [j.ej.job.name for j in jobs] == [
        "train-gemma2-9b-0", "train-qwen1.5-32b-1", "serve-mixtral-8x7b-0",
        "serve-falcon-mamba-7b-1", "serve-zamba2-2.7b-2",
        "serve-musicgen-large-3"]
    assert all(j.ej.job.tasks[0].resources.hbm_bytes > 0 for j in jobs)


@pytest.mark.parametrize("arch,idx", [("gemma2-9b", 0), ("qwen1.5-32b", 1)])
def test_shared_cluster_train_job_matches_the_jitted_jax_runner(arch, idx):
    """The JAX example's runner (3 jitted steps of ``make_train_step(cfg,
    AdamWConfig(), attn_impl="flash_jnp")`` from ``init_params(cfg,
    PRNGKey(idx))``) against the port's job on the carried weights, run
    through the executor."""
    cfg, tcfg = get_arch(arch).reduced(), port_arch(arch).reduced()
    params = jax_init(cfg, jax.random.PRNGKey(idx))
    opt_cfg = JA.AdamWConfig()
    state = JA.init_state(opt_cfg, params)
    tparams = convert.params_from_jax(_np(params), tcfg, "cpu")
    step = jax.jit(jax_step(cfg, opt_cfg, attn_impl="flash_jnp"))
    batch = _jax_batch(cfg, idx, labels=True)
    want = []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    job = shared_cluster.make_train_job(arch, idx, torch.device("cpu"),
                                        params=tparams)
    stats = Executor(MGBAlg3Scheduler(2), workers=1,
                     devices=["cpu"]).run([job.ej])
    assert stats["completed"] == 1 and stats["crashed"] == 0
    _metrics_close(list(zip(job.out["losses"], job.out["grad_norms"])),
                   want)
    _params_close(job.out["params"],
                  convert.params_from_jax(_np(params), tcfg, "cpu"),
                  opt_cfg.lr)


@pytest.mark.parametrize("arch,idx", [("mixtral-8x7b", 0),
                                      ("falcon-mamba-7b", 1),
                                      ("zamba2-2.7b", 2),
                                      ("musicgen-large", 3)])
def test_shared_cluster_prefill_job_matches_jax(arch, idx):
    """The JAX example's prefill (``flash_jnp``, weights from
    ``PRNGKey(100 + idx)``, musicgen-large on its ``embeds``) against the
    port's job on the carried weights."""
    cfg, tcfg = get_arch(arch).reduced(), port_arch(arch).reduced()
    params = jax_init(cfg, jax.random.PRNGKey(100 + idx))
    batch = _jax_batch(cfg, 100 + idx, labels=False)
    assert ("embeds" in batch) == (arch == "musicgen-large")
    want, _ = jax_prefill(cfg, attn_impl="flash_jnp")(params, batch)
    job = shared_cluster.make_serve_job(
        arch, idx, torch.device("cpu"),
        params=convert.params_from_jax(_np(params), tcfg, "cpu"))
    job.ej.runners[0](torch.device("cpu"))
    got = job.out["logits"]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_shared_cluster_runs_end_to_end_on_the_cpu():
    res = shared_cluster.main(CPU)
    assert res["mgb"]["completed"] == 6 and res["mgb"]["crashed"] == 0
    assert res["sa"]["completed"] == 6 and res["sa"]["crashed"] == 0
    assert res["fault"]["completed"] + res["fault"]["crashed"] == 6
    assert res["evicted"], "device 0 died and evicted nothing"
    assert sum(res["per_device"].values()) == 6
    fleet = res["fleet"]
    assert fleet["done"] == 64 and fleet["background"] == "done"
    assert fleet["stats"]["completed"] == 65
    assert fleet["stats"]["crashed"] == 0
