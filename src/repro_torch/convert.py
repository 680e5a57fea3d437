"""Move weights and caches between the JAX package's trees and the port.

The JAX package stacks layer weights on a leading [L] dim
(``src/repro/models/model.py:124-164``); the port keeps one dict per layer
(``repro_torch.models.model``). This module is the one place where that
layout changes. It takes the JAX tree already converted to numpy (the caller
maps ``np.asarray`` over it), so it imports no JAX. bf16 arrays arrive as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` cannot read; they cross
bit for bit through a uint16 view.

The optimizer state crosses the same way (``opt_state_from_jax``: moments
unstacked like the parameters, ``step`` as a host int), so a parity test
starts both packages from one state; ``train_state_from_jax_leaves`` reads
the leaves of a checkpoint the reference wrote (``train/checkpoint.py``,
JAX's flatten order: dict keys sorted, layers stacked on [L]) into the
port's ``{"params", "opt"}``, so a JAX run can be resumed in the port.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Params, check_supported, init_params


def to_torch(a: Any, device=None) -> torch.Tensor:
    """A numpy array (bf16 included) as a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bf16 comes back as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig,
                    device=None) -> Params:
    """The port's parameters from a dense, moe or ssm JAX ``init_params``
    tree (numpy leaves): embed / final_norm / lm_head as they are,
    ``layers`` (``{norm1, norm2, attn, mlp or moe}`` or ``{norm, mamba}``,
    stacked on [L]) unstacked into ``cfg.n_layers`` per-layer dicts with the
    same keys."""
    check_supported(cfg)
    out: Params = {k: to_torch(tree[k], device)
                   for k in ("embed", "final_norm", "lm_head") if k in tree}
    out["layers"] = [_map(lambda a, i=i: to_torch(np.asarray(a)[i], device),
                          tree["layers"])
                     for i in range(cfg.n_layers)]
    return _in_port_order(out, cfg)


def _in_port_order(params: Params, cfg: ArchConfig) -> Params:
    """``params`` with every dict's keys in the order ``init_params`` makes
    them, so the port's trees (parameters, moments, checkpoints) all
    flatten in one order."""
    skeleton = init_params(cfg, None, torch.float32, torch.device("meta"))

    def order(node, like):
        if isinstance(like, dict):
            return {k: order(node[k], v) for k, v in like.items()}
        if isinstance(like, list):
            return [order(n, v) for n, v in zip(node, like)]
        return node
    return order(params, skeleton)


def cache_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """The port's decode cache from a JAX one (numpy leaves). Both stack
    over layers in the same layouts (KV ``[L, B, Hkv, S, hd]``; ssm conv
    ``[L, B, W-1, E]`` and state ``[L, B, E, N]``), so each entry crosses
    as it is."""
    return {k: to_torch(v, device) for k, v in tree.items()}


def opt_state_from_jax(tree: Dict[str, Any], cfg: ArchConfig,
                       device=None) -> Dict[str, Any]:
    """The port's AdamW state (``optim.adamw``) from the reference's
    ``{"mu", "nu", "step"}`` (numpy leaves): the moments unstacked like the
    parameters, ``step`` a host int."""
    return {"mu": params_from_jax(tree["mu"], cfg, device),
            "nu": params_from_jax(tree["nu"], cfg, device),
            "step": int(np.asarray(tree["step"]))}


def _sorted_paths(node, prefix=()) -> List[tuple]:
    """Leaf paths of a nested dict in JAX's flatten order (keys sorted)."""
    if isinstance(node, dict):
        return [p for k in sorted(node)
                for p in _sorted_paths(node[k], prefix + (k,))]
    return [prefix]


def _stored(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A checkpoint leaf as a tensor (bf16 stored as uint16 bits)."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def train_state_from_jax_leaves(leaves: Sequence[np.ndarray],
                                dtypes: Sequence[str], cfg: ArchConfig,
                                device=None) -> Dict[str, Any]:
    """The port's ``{"params", "opt"}`` from the stored leaves of the
    reference's ``{"params", "opt": {"mu", "nu", "step"}}`` checkpoint
    (``train.checkpoint.restore_leaves``): the leaves are matched to the
    reference's tree by its flatten order, built from the port's own
    parameter names, and the layers unstacked."""
    check_supported(cfg)
    meta = init_params(cfg, None, torch.float32, torch.device("meta"))
    shape = {k: v for k, v in meta.items() if k != "layers"}
    shape["layers"] = meta["layers"][0]
    skeleton = {"opt": {"mu": shape, "nu": shape, "step": None},
                "params": shape}
    paths = _sorted_paths(skeleton)
    if len(paths) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for {len(paths)} in "
                         f"{cfg.name}'s train state")
    flat = {path: _stored(a, dt) for path, a, dt in zip(paths, leaves, dtypes)}

    def tree(prefix: tuple, node) -> Any:
        if not isinstance(node, dict):
            return flat[prefix]
        return {k: tree(prefix + (k,), v) for k, v in node.items()}

    def unstack(p: Dict[str, Any]) -> Params:
        out: Params = {k: v.to(device) for k, v in p.items()
                       if k != "layers"}
        out["layers"] = [tree_map(lambda t, i=i: t[i].clone().to(device),
                                  p["layers"])
                         for i in range(cfg.n_layers)]
        return out

    state = tree((), skeleton)
    unstack = lambda p, f=unstack: _in_port_order(f(p), cfg)  # noqa: E731
    return {"params": unstack(state["params"]),
            "opt": {"mu": unstack(state["opt"]["mu"]),
                    "nu": unstack(state["opt"]["nu"]),
                    "step": int(state["opt"]["step"])}}
