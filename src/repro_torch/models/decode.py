"""One-token decode over a dense model's KV cache.

Port of ``src/repro/models/decode.py:29-174, 189-233`` for the dense
attention family: the cache is KV stacked over layers
``[L, B, Hkv, Smax, hd]`` in bf16, or int8 codes with per-(position, head)
scales (``cfg.kv_cache_dtype == "int8"``). ``decode_step`` takes one scalar
position for the whole batch. Ring caches (pure sliding-window archs), SSM
and hybrid states, and per-row positions come in later slices.

The port updates caches IN PLACE (``decode_step``, ``cache_insert``) where
the reference returns updated copies, so one cache stays resident per task.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.model import (
    Params, attn_decode_block, check_supported, kv_shape, logits_from_hidden,
    scale_embedding, _layer_window,
)

Cache = Dict[str, torch.Tensor]


def uses_ring(cfg: ArchConfig) -> bool:
    return cfg.sliding_window > 0 and not cfg.local_global_alternate


def _check(cfg: ArchConfig) -> None:
    check_supported(cfg)
    if uses_ring(cfg):
        raise NotImplementedError(f"{cfg.name}: ring KV caches come in a "
                                  f"later slice of the port")


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Cache:
    """Zeroed cache for ``batch`` rows of up to ``max_seq`` positions."""
    _check(cfg)
    shape = kv_shape(cfg, batch, max_seq)
    if cfg.kv_cache_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:-1], dtype=dtype, device=device),
            "v_s": torch.zeros(shape[:-1], dtype=dtype, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(params: Params, cfg: ArchConfig, cache: Cache,
                tokens: torch.Tensor, pos: int) -> Tuple[torch.Tensor, Cache]:
    """tokens: [B] int; pos: the current position (0-based), one for the
    whole batch. Returns (logits [B, V] f32, the cache, updated in place)."""
    _check(cfg)
    x = scale_embedding(cfg, params["embed"][tokens])  # [B, d]
    q8 = cfg.kv_cache_dtype == "int8"
    for i, lp in enumerate(params["layers"]):
        a = attn_decode_block(
            lp["attn"], L.rms_norm(x, lp["norm1"])[:, None], cfg, pos=pos,
            kcache=cache["k"][i], vcache=cache["v"][i],
            kscale=cache["k_s"][i] if q8 else None,
            vscale=cache["v_s"][i] if q8 else None,
            window=_layer_window(cfg, i))
        x = x + a[:, 0]
        m = L.mlp_apply(lp["mlp"], L.rms_norm(x, lp["norm2"])[:, None],
                        cfg.mlp_act)
        x = x + m[:, 0]
    x = L.rms_norm(x, params["final_norm"])
    logits = logits_from_hidden(cfg, params, x[:, None])[:, 0]
    return logits, cache


# per-key (batch_axis, seq_axis) of the dense cache layouts
CACHE_AXES: Dict[str, Tuple[int, int]] = {
    "k": (1, 3), "v": (1, 3), "k_s": (1, 3), "v_s": (1, 3),
}


def cache_insert(cache: Cache, row_cache: Cache, row: int) -> Cache:
    """Write ``row_cache`` into ``cache`` at batch rows ``row ..`` in place.

    The row cache's sequence axis may be SHORTER than the resident buffer's
    (a prompt-length prefill cache joining a buffer sized for prompt plus
    generation): it lands at the front, and the slots after it are left as
    they are; decode masks them (``cache_len``) until it writes them. A
    LONGER sequence axis is an error."""
    for key, t in cache.items():
        bax, sax = CACHE_AXES[key]
        rt = row_cache[key]
        if rt.shape[sax] > t.shape[sax]:
            raise ValueError(
                f"cache_insert: row cache {key} seq {rt.shape[sax]} "
                f"exceeds resident buffer seq {t.shape[sax]}")
        t.narrow(bax, row, rt.shape[bax]).narrow(sax, 0, rt.shape[sax]) \
            .copy_(rt)
    return cache
