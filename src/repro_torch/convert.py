"""Move weights and caches between the JAX package's trees and the port.

The JAX package stacks layer weights on a leading [L] dim
(``src/repro/models/model.py:124-164``); the port keeps one dict per layer
(``repro_torch.models.model``). This module is the one place where that
layout changes. It takes the JAX tree already converted to numpy (the caller
maps ``np.asarray`` over it), so it imports no JAX. bf16 arrays arrive as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` cannot read; they cross
bit for bit through a uint16 view.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Params, check_supported


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
    return out


def cache_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """The port's decode cache from a JAX one (numpy leaves). Both stack
    over layers in the same layouts (KV ``[L, B, Hkv, S, hd]``; ssm conv
    ``[L, B, W-1, E]`` and state ``[L, B, E, N]``), so each entry crosses
    as it is."""
    return {k: to_torch(v, device) for k, v in tree.items()}
