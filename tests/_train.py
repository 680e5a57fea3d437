"""What the tests of the port's training path share
(``tests/test_torch_train*.py``): the reduced configs' start states in both
packages, the port's train run, and the module's tolerances (their reasons:
``tests/test_torch_train.py``'s docstring). The distribution and examples
tests take ``LR``, ``_np``, ``_opt`` and ``_params_close`` from here too."""
import dataclasses

import jax
import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro.configs.registry import get_arch
from repro.models import model as JM
from repro.optim import adamw as JA
from repro_torch import convert
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.registry import get_arch as port_arch
from repro_torch.data.pipeline import TokenPipeline, to_device
from repro_torch.optim import adamw as TA
from repro_torch.train.train_step import make_train_step


# softcaps + window; QKV bias; Mamba-1 (the scan's backward); MoE, 4
# experts top-2 with a window (the grouped matmul's backward, the aux loss);
# the zamba2 hybrid (Mamba-2's SSD and the scan across chunks, a shared
# block whose gradient sums over groups)
ARCHS = ["gemma2-9b", "qwen1.5-32b", "falcon-mamba-7b", "mixtral-8x7b",
         "zamba2-2.7b"]
LR = 1e-3
B, S, STEPS = 2, 128, 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _opt(mod):
    return mod.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)


def _start(arch, policy=None):
    """Reduced configs of both packages, the JAX parameters and AdamW
    state, and the same state in the port."""
    cfg, tcfg = get_arch(arch).reduced(), port_arch(arch).reduced()
    if policy:
        tcfg = dataclasses.replace(tcfg, remat_policy=policy)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    state = JA.init_state(_opt(JA), params)
    return (cfg, tcfg, params, state,
            convert.params_from_jax(_np(params), tcfg, "cpu"),
            convert.opt_state_from_jax(_np(state), tcfg, "cpu"))


def _port_run(arch, policy, micro=None, steps=STEPS):
    _, tcfg, _, _, params, state = _start(arch, policy)
    step = make_train_step(tcfg, _opt(TA), num_microbatches=micro)
    pipe = TokenPipeline(tcfg, TShape("t", S, B, "train"), seed=0)
    metrics = []
    for i in range(steps):
        params, state, m = step(params, state,
                                to_device(pipe.batch_at(i), "cpu"))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return tcfg, metrics, params, state


def _params_close(got, want, lr=LR):
    errs = torch.cat([(g.float() - w.float()).abs().flatten()
                      for g, w in zip(tree_leaves(got), tree_leaves(want))])
    assert float(errs.max()) <= lr
    assert int((errs > 1e-2 * lr).sum()) <= 1e-3 * errs.numel()


def _moments_close(got, want):
    for key in ("mu", "nu"):
        for g, w in zip(tree_leaves(got[key]), tree_leaves(want[key])):
            scale = float(w.abs().max())
            torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)
    assert got["step"] == want["step"]
