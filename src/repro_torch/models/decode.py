"""One-token decode over a model's cache: an attention model's KV cache,
the Mamba-1 family's recurrent states, or the zamba2 hybrid's Mamba-2
states beside its shared block's KV cache.

Port of ``src/repro/models/decode.py``. A KV cache is stacked
over layers ``[L, B, Hkv, Smax, hd]`` in bf16, or int8 codes with
per-(position, head) scales (``cfg.kv_cache_dtype == "int8"``). Pure
sliding-window archs (mixtral) keep a ring of ``min(max_seq, window)``
slots: position p lives at slot ``p % Smax`` and the overwrite enforces the
window, so the cache costs O(window) whatever the context. An ssm cache is the conv state ``[L, B, W-1,
E]`` in the cache dtype and the SSM state ``[L, B, E, N]`` in f32, O(1) in
the context. A hybrid cache is ``m_conv [G, k-1, B, W-1, E+2N]`` and
``m_ssm [G, k-1, B, nh, P, N]`` f32 (the Mamba-2 states of each group's k-1
layers) and ``k``, ``v`` ``[G, B, Hkv, Smax, hd]`` (one shared block a
group), never int8: the reference does not quantize a hybrid's KV cache.
``decode_step`` takes one position for the whole batch or a
[B] vector, one per row (continuous batching).

The port updates caches IN PLACE (``decode_step``, ``cache_insert``,
``cache_clear_row``) where the reference returns updated copies, so one
cache stays resident per task or decode loop. Under a mesh ``decode_step``
takes DTensor parameters and a cache placed by ``dist.sharding.
cache_specs``, context-parallel too: the KV writes and the attention run
on each rank's shard (``models.model.attn_decode_block``), the states'
in-place updates keep the cache's placements.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models.model import (
    Params, attn_decode_block, check_supported, hybrid_state_shapes,
    kv_shape, logits_from_hidden, lookup_rows, scale_embedding,
    ssm_state_shapes, _layer_window,
)
from repro_torch.models.moe import moe_apply
from repro_torch.models.ssm import mamba1_decode_step, mamba2_decode_step

Cache = Dict[str, torch.Tensor]


def uses_ring(cfg: ArchConfig) -> bool:
    return cfg.sliding_window > 0 and not cfg.local_global_alternate


def cache_seq_len(cfg: ArchConfig, max_seq: int) -> int:
    return min(max_seq, cfg.sliding_window) if uses_ring(cfg) else max_seq


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device=None,
               conv_dtype: Optional[torch.dtype] = None) -> Cache:
    """Zeroed cache for ``batch`` rows of up to ``max_seq`` positions (a
    ring holds ``cache_seq_len`` slots; an ssm cache does not depend on
    ``max_seq``): KV in ``dtype``, conv states in ``conv_dtype`` (default
    ``dtype``), SSM states in f32."""
    check_supported(cfg)
    conv_dtype = conv_dtype or dtype
    if cfg.family == "ssm":
        conv, ssm = ssm_state_shapes(cfg, batch)
        return {"conv": torch.zeros(conv, dtype=conv_dtype, device=device),
                "ssm": torch.zeros(ssm, dtype=torch.float32, device=device)}
    shape = kv_shape(cfg, batch, cache_seq_len(cfg, max_seq))
    if cfg.family == "hybrid":
        conv, ssm = hybrid_state_shapes(cfg, batch)
        return {"m_conv": torch.zeros(conv, dtype=conv_dtype, device=device),
                "m_ssm": torch.zeros(ssm, dtype=torch.float32, device=device),
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
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
                tokens: torch.Tensor, pos) -> Tuple[torch.Tensor, Cache]:
    """tokens: [B] int; pos: the current position (0-based), an int for the
    whole batch or an int tensor, 0-d or [B] with one position per row
    (unused by the ssm family). An int becomes a 0-d tensor on the tokens'
    device, so every step runs one path: nothing in it reads a value on the
    host, and a step over a tensor can be captured in a CUDA graph.
    Returns (logits [B, V] f32, the cache, updated in place)."""
    check_supported(cfg)
    x = constrain(lookup_rows(params["embed"], tokens), "batch", None)
    x = scale_embedding(cfg, x)
    if cfg.family == "ssm":
        for i, lp in enumerate(params["layers"]):
            x = x + mamba1_decode_step(
                lp["mamba"], L.rms_norm(x, lp["norm"]),
                {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}, cfg.ssm)
        x = L.rms_norm(x, params["final_norm"])
        return logits_from_hidden(cfg, params, x[:, None])[:, 0], cache
    if not torch.is_tensor(pos):
        pos = torch.full((), pos, dtype=torch.int32, device=tokens.device)
    ring = uses_ring(cfg)
    if cfg.family == "hybrid":
        shared = params["shared"]
        for gi, gp in enumerate(params["groups"]):
            for j, (mp, nm) in enumerate(zip(gp["mamba"], gp["norm_m"])):
                x = x + mamba2_decode_step(
                    mp, L.rms_norm(x, nm), {"conv": cache["m_conv"][gi, j],
                                            "ssm": cache["m_ssm"][gi, j]},
                    cfg.ssm)
            a = attn_decode_block(
                shared["attn"], L.rms_norm(x, gp["norm_attn"])[:, None], cfg,
                pos=pos, kcache=cache["k"][gi], vcache=cache["v"][gi],
                window=cfg.sliding_window, ring=ring)
            x = x + a[:, 0]
            x = x + L.mlp_apply(shared["mlp"], L.rms_norm(x, gp["norm_mlp"]),
                                cfg.mlp_act)
        x = L.rms_norm(x, params["final_norm"])
        return logits_from_hidden(cfg, params, x[:, None])[:, 0], cache
    q8 = cfg.kv_cache_dtype == "int8"
    for i, lp in enumerate(params["layers"]):
        a = attn_decode_block(
            lp["attn"], L.rms_norm(x, lp["norm1"])[:, None], cfg, pos=pos,
            kcache=cache["k"][i], vcache=cache["v"][i],
            kscale=cache["k_s"][i] if q8 else None,
            vscale=cache["v_s"][i] if q8 else None,
            window=_layer_window(cfg, i), ring=ring)
        x = x + a[:, 0]
        hn = L.rms_norm(x, lp["norm2"])[:, None]
        if cfg.moe is not None:
            m, _ = moe_apply(lp["moe"], hn, cfg.moe, cfg.mlp_act)
        else:
            m = L.mlp_apply(lp["mlp"], hn, cfg.mlp_act)
        x = x + m[:, 0]
    x = L.rms_norm(x, params["final_norm"])
    logits = logits_from_hidden(cfg, params, x[:, None])[:, 0]
    return logits, cache


# ---------------------------------------------------------------------------
# Slot-wise cache surgery (continuous batching)
#
# A running decode batch adopts a prefilled request's single-row cache and
# retires finished rows in place: extract copies one row out, insert writes a
# row back (zero-padding the sequence axis, so a short prefill cache drops
# into a longer resident buffer; slots past the row's cache_len are masked by
# decode attention, so the padding is never attended).
# ---------------------------------------------------------------------------

# per-key (batch_axis, seq_axis or None) of the dense, ssm and hybrid cache
# layouts
CACHE_AXES: Dict[str, Tuple[int, Optional[int]]] = {
    "k": (1, 3), "v": (1, 3), "k_s": (1, 3), "v_s": (1, 3),
    "conv": (1, None), "ssm": (1, None),
    "m_conv": (2, None), "m_ssm": (2, None),
}


def cache_rows(cache: Cache) -> int:
    """Batch capacity (number of resident rows) of a decode cache."""
    key = next(iter(cache))
    return cache[key].shape[CACHE_AXES[key][0]]


def cache_extract(cache: Cache, row: int) -> Cache:
    """A copy of resident row ``row`` as a batch-1 cache."""
    return {key: t.narrow(CACHE_AXES[key][0], row, 1).clone()
            for key, t in cache.items()}


def cache_insert(cache: Cache, row_cache: Cache, row: int) -> Cache:
    """Write ``row_cache`` into ``cache`` at batch rows ``row ..`` in place.

    The row cache's sequence axis may be SHORTER than the resident buffer's
    (a prompt-length prefill cache joining a buffer sized for prompt plus
    generation): it lands at the front and the rest of the rows' sequence
    axis is zeroed, as the reference pads it; decode masks those slots
    (``cache_len``) until it writes them. A LONGER sequence axis is an
    error. A state (ssm, and a hybrid's ``m_conv``, ``m_ssm``) has no
    sequence axis: its rows are copied as they are, cast to the resident
    buffer's dtype."""
    for key, t in cache.items():
        bax, sax = CACHE_AXES[key]
        rt = row_cache[key]
        dst = t.narrow(bax, row, rt.shape[bax])
        if sax is not None and rt.shape[sax] != t.shape[sax]:
            if rt.shape[sax] > t.shape[sax]:
                raise ValueError(
                    f"cache_insert: row cache {key} seq {rt.shape[sax]} "
                    f"exceeds resident buffer seq {t.shape[sax]}")
            dst.narrow(sax, rt.shape[sax],
                       t.shape[sax] - rt.shape[sax]).zero_()
            dst = dst.narrow(sax, 0, rt.shape[sax])
        dst.copy_(rt)
    return cache


def cache_clear_row(cache: Cache, row: int) -> Cache:
    """Zero a retired row in place, so stale KV bytes cannot leak into a
    later adopt (hygiene; correctness never reads a masked slot)."""
    for key, t in cache.items():
        t.narrow(CACHE_AXES[key][0], row, 1).zero_()
    return cache
