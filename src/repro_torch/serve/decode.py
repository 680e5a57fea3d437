"""Serving steps: prefill (prompt -> last-token logits + decode cache) and
the greedy decode loop. These are the "GPU task" bodies of the static
serving path.

Port of ``src/repro/serve/decode.py:21-105`` for the dense, moe and ssm
families. ``greedy_generate`` is a Python loop over ``decode_step`` (the
reference's ``lax.scan``).

Ring-cache hand-off: pure sliding-window archs (mixtral) decode over a ring
of ``window`` slots, position p at slot ``p % window``. After a prefill of S
tokens the last ``window`` K/V rows are rotated into that order, or, when S
is shorter than the window, padded to it, so the ring's modulus is the
window (reference ``serve/decode.py:37-59``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decode as D
from repro_torch.models.layers import quantize_kv
from repro_torch.models.model import forward, logits_from_hidden


def make_prefill_step(cfg: ArchConfig, *, attn_impl: str = "flash_kernel"):
    """prefill(params, batch) -> (last-token logits [B, V] f32, cache).

    A KV cache is prompt-deep, or for a ring (pure sliding-window archs)
    ``window`` deep in ring order (``ring_from_prefill``). With
    ``cfg.kv_cache_dtype == "int8"`` it is then quantized as the reference
    does (per-(position, head) absmax, bf16 scales), one layer at a time so
    the f32 temporaries stay one layer big. An ssm cache (conv and SSM
    states) is returned as it is.
    """
    def prefill(params, batch: Dict[str, torch.Tensor]):
        hidden, _, cache = forward(params, cfg, batch, attn_impl=attn_impl,
                                   collect_cache=True)
        logits = logits_from_hidden(cfg, params, hidden[:, -1:])[:, 0]
        if D.uses_ring(cfg) and "k" in cache:
            for name in ("k", "v"):
                cache[name] = ring_from_prefill(cache.pop(name),
                                                cfg.sliding_window)
        if cfg.kv_cache_dtype == "int8" and "k" in cache:
            q8 = {}
            for name in ("k", "v"):
                t = cache.pop(name)
                codes = torch.empty(t.shape, dtype=torch.int8, device=t.device)
                scales = torch.empty(t.shape[:-1], dtype=torch.bfloat16,
                                     device=t.device)
                for i in range(t.shape[0]):
                    c, s = quantize_kv(t[i])
                    codes[i].copy_(c)
                    scales[i].copy_(s)
                del t
                q8[name], q8[name + "_s"] = codes, scales
            cache = q8
        return logits, cache

    return prefill


def ring_from_prefill(t: torch.Tensor, window: int) -> torch.Tensor:
    """A prompt-deep KV stack ``[L, B, Hkv, S, hd]`` as a ring of ``window``
    slots with position p at slot ``p % window``: at S >= window the last
    ``window`` positions rolled by ``S % window``, else the S positions at
    the front of a zeroed ring (the empty slots are masked by ``cache_len``
    until decode writes them)."""
    s = t.shape[3]
    if s >= window:
        return torch.roll(t[:, :, :, s - window:], s % window, dims=3)
    ring = t.new_zeros(t.shape[:3] + (window,) + t.shape[4:])
    ring[:, :, :, :s].copy_(t)
    return ring


def decode_cache(cfg: ArchConfig, cache: D.Cache, max_seq: int) -> D.Cache:
    """The prefill ``cache`` made ready for ``max_seq`` positions of decode.

    A prompt-deep KV cache is copied to the front of a zeroed one
    ``max_seq`` deep (``models.decode.cache_insert``). A ring cache already
    holds its ``window`` slots and wraps, and an ssm cache holds states
    with no positions to pad: both are returned as they are, in their own
    dtypes, as the reference decodes on its prefill cache.
    """
    if cfg.family == "ssm" or D.uses_ring(cfg):
        return cache
    k = cache["k"]
    return D.cache_insert(D.init_cache(cfg, k.shape[1], max_seq,
                                       device=k.device), cache, 0)


def greedy_generate(cfg: ArchConfig, params, cache: D.Cache,
                    first_tokens: torch.Tensor, start_pos: int,
                    num_steps: int) -> Tuple[torch.Tensor, D.Cache]:
    """Greedy generation: ``num_steps`` decode steps from ``first_tokens``
    at position ``start_pos``. Returns (tokens [B, num_steps] int32, cache).
    A KV cache must hold ``start_pos + num_steps`` positions, or be a ring;
    the caller pads a prompt-deep prefill cache first (``decode_cache``). An
    ssm cache holds states, whatever the position.
    ``num_steps=0`` returns an empty [B, 0] block with the cache untouched.
    """
    b = first_tokens.shape[0]
    out = torch.empty(b, max(num_steps, 0), dtype=torch.int32,
                      device=first_tokens.device)
    tokens = first_tokens
    for step in range(max(num_steps, 0)):
        logits, cache = D.decode_step(params, cfg, cache, tokens,
                                      start_pos + step)
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        out[:, step] = tokens
    return out, cache
