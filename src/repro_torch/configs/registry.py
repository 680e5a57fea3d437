"""Registry of the assigned architectures (``--arch <id>``).

Copy of ``src/repro/configs/registry.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (
    ALL_SHAPES, ArchConfig, SHAPES_BY_NAME, ShapeConfig,
)
from repro_torch.configs import (
    mixtral_8x7b, dbrx_132b, internvl2_76b, musicgen_large, nemotron_4_340b,
    llama3_405b, gemma2_9b, qwen1_5_32b, zamba2_2_7b, falcon_mamba_7b,
)

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in [
        mixtral_8x7b.CONFIG,
        dbrx_132b.CONFIG,
        internvl2_76b.CONFIG,
        musicgen_large.CONFIG,
        nemotron_4_340b.CONFIG,
        llama3_405b.CONFIG,
        gemma2_9b.CONFIG,
        qwen1_5_32b.CONFIG,
        zamba2_2_7b.CONFIG,
        falcon_mamba_7b.CONFIG,
    ]
}

# long_500k applicability (see DESIGN.md §Arch-applicability / long_500k):
# run only for sub-quadratic-per-token archs with bounded/shardable cache.
LONG_OK = frozenset({"falcon-mamba-7b", "zamba2-2.7b", "mixtral-8x7b"})


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]


def cells():
    """All 40 (arch, shape) cells with applicability flag."""
    out = []
    for arch in ARCHS.values():
        for shape in ALL_SHAPES:
            skip = shape.name == "long_500k" and arch.name not in LONG_OK
            out.append((arch, shape, skip))
    return out
