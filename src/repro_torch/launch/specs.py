"""``TensorSpec`` stand-ins for every model input: zero allocation. Shared by
the probes and the benchmarks.

Port of ``src/repro/launch/specs.py``: ``TensorSpec`` (shape, dtype, device)
in place of ``jax.ShapeDtypeStruct``, on ``device``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.probe import TensorSpec


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                device=torch.device("cpu")) -> Dict[str, TensorSpec]:
    """Inputs for the step function the given shape lowers.

    train/prefill: the full-sequence batch; decode: one token per sequence.
    [vlm]/[audio] archs get precomputed frontend embeddings per spec.
    """
    device = torch.device(device)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": TensorSpec((b,), torch.int32, device),
                "pos": TensorSpec((), torch.int32, device)}
    specs = {"tokens": TensorSpec((b, s), torch.int32, device)}
    if shape.kind == "train":
        specs["labels"] = TensorSpec((b, s), torch.int32, device)
    if cfg.embedding_frontend_stub:
        specs["embeds"] = TensorSpec((b, s, cfg.d_model), torch.bfloat16,
                                     device)
    return specs
