"""Serving steps: prefill (prompt -> last-token logits + KV cache) and the
greedy decode loop. These are the "GPU task" bodies of the static serving
path.

Port of ``src/repro/serve/decode.py:21-105`` for the dense attention family.
``greedy_generate`` is a Python loop over ``decode_step`` (the reference's
``lax.scan``). Ring-cache rotation comes with the ring caches, in a later
slice.
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

    The cache is prompt-deep. With ``cfg.kv_cache_dtype == "int8"`` it is
    quantized as the reference does (per-(position, head) absmax, bf16
    scales), one layer at a time so the f32 temporaries stay one layer big.
    """
    def prefill(params, batch: Dict[str, torch.Tensor]):
        hidden, _, cache = forward(params, cfg, batch, attn_impl=attn_impl,
                                   collect_cache=True)
        logits = logits_from_hidden(cfg, params, hidden[:, -1:])[:, 0]
        if cfg.kv_cache_dtype == "int8":
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


def greedy_generate(cfg: ArchConfig, params, cache: D.Cache,
                    first_tokens: torch.Tensor, start_pos: int,
                    num_steps: int) -> Tuple[torch.Tensor, D.Cache]:
    """Greedy generation: ``num_steps`` decode steps from ``first_tokens``
    at position ``start_pos``. Returns (tokens [B, num_steps] int32, cache).
    The cache must hold ``start_pos + num_steps`` positions; the caller pads
    a prompt-deep prefill cache first (``models.decode.cache_insert``).
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
