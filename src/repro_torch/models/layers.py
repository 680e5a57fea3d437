"""Core transformer layers of the dense family: RMSNorm, RoPE, softcap, the
attention mask, naive and chunked ("flash") attention in plain PyTorch, decode
attention over a bf16 or int8 KV cache, int8 KV quantization, and the MLP.

Port of ``src/repro/models/layers.py`` (dense parts). Layouts and arithmetic
follow the reference: q ``[B, Hq, S, D]``, k/v ``[B, Hkv, S, D]``; RoPE
rotates ADJACENT lane pairs (2i, 2i+1); the norm scale is ``(1 + scale)``;
the causal mask is top-left aligned; the window rule is ``q - k < w``;
``jax.nn.gelu``'s default is the tanh approximation. ``rms_norm`` and
``flash_attention`` go through the hand kernels in ``repro_torch.kernels``,
whose ops are differentiable: under autograd their backward is a hand
kernel too on a CUDA tensor (the plain backward on a CPU tensor).
``flash_attention_plain`` stays the memory-bounded plain path (plain
autograd differentiates it).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain, replicated_like
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """The hand RMSNorm kernel (its plain version on CPU tensors)."""
    return _rn.rmsnorm(x, scale, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, head_dim]; positions: [..., S] (broadcastable). Pairs are
    adjacent lanes (2i, 2i+1), as in the reference."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # [..., S, hd/2]
    sin, cos = (replicated_like(t, x) for t in (torch.sin(angles),
                                                 torch.cos(angles)))
    xr = x.float().reshape(x.shape[:-1] + (half, 2))
    x1, x2 = xr[..., 0], xr[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap else x


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_q: int) -> torch.Tensor:
    """[B, Hkv, S, D] -> [B, Hq, S, D] by repeating each KV head."""
    hkv = k.shape[1]
    return k if hkv == n_q else k.repeat_interleave(n_q // hkv, dim=1)


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                   window: int) -> torch.Tensor:
    """Boolean [Sq, Sk] mask; True = attend. ``window`` <= 0: no window."""
    delta = q_pos[:, None] - k_pos[None, :]
    m = torch.ones(delta.shape, dtype=torch.bool, device=delta.device)
    if causal:
        m &= delta >= 0
    if window and window > 0:
        m &= delta < window
    return m


# The oracle: softmax over the full masked score matrix in f32. It is the
# flash kernel's plain version, the same function.
naive_attention = _fa.flash_attention_plain


def flash_attention_plain(q, k, v, *, causal=True, window=0, logit_softcap=0.0,
                          block_k: int = 512):
    """Memory-efficient attention in plain PyTorch: a loop over KV blocks with
    an online softmax (the reference's ``flash_attention_jnp``). Peak live
    memory is O(Sq * block_k) instead of O(Sq * Sk)."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    q_pos = torch.arange(sq, device=q.device)
    acc = torch.zeros(b, hq, sq, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, hq, sq, dtype=torch.float32, device=q.device)
    for j in range(0, sk, block_k):
        kj = _repeat_kv(k[:, :, j:j + block_k], hq).float()
        vj = _repeat_kv(v[:, :, j:j + block_k], hq).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kj) * scale
        s = softcap(s, logit_softcap)
        k_pos = j + torch.arange(kj.shape[2], device=q.device)
        mask = attention_mask(q_pos, k_pos, causal=causal, window=window)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vj)
        m = m_new
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, window=0, logit_softcap=0.0):
    """The hand flash-attention kernel (its plain version on CPU tensors)."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               logit_softcap=logit_softcap)


def _decode_valid_mask(smax: int, cache_len, window: int,
                       device, offset: int = 0) -> torch.Tensor:
    """[B or 1, Smax] bool mask of attendable cache slots, the slots being
    positions ``offset ..`` (a shard of a longer cache). ``cache_len`` is
    an int (the whole batch at one position) or a [B] device tensor (each
    row of a continuous batch at its own position), never read on the
    host, so a step over a tensor can be captured in a CUDA graph."""
    cl = torch.as_tensor(cache_len, device=device).reshape(-1, 1)
    k_pos = offset + torch.arange(smax, device=device)[None, :]
    valid = k_pos < cl
    if window and window > 0:
        valid = valid & (k_pos >= cl - window)
    return valid


def _decode_out(s, v_of, q, seq_reduce):
    """Softmax of the masked scores s [B, Hkv, G, Smax] against values
    (``v_of(p)`` -> [B, Hkv, G, D] f32): [B, Hq, 1, D] in q's dtype. With
    ``seq_reduce`` (``t, op -> t`` reduced over the ranks that hold the
    other slots of the sequence) the max and the sum of the exponentials
    are the whole sequence's, so each rank's probabilities are the global
    ones, rounded as the unsharded step rounds them, and its partial
    output is summed across the ranks: only [B, H]-sized statistics and
    [B, H, 1, D] partial outputs cross ranks."""
    b, hq, _, d = q.shape
    if seq_reduce is None:
        p = torch.softmax(s, dim=-1)
        return v_of(p).reshape(b, hq, 1, d).to(q.dtype)
    top = seq_reduce(s.amax(dim=-1, keepdim=True), "max")
    e = torch.exp(s - top)
    p = e / seq_reduce(e.sum(dim=-1, keepdim=True), "sum")
    return seq_reduce(v_of(p), "sum").reshape(b, hq, 1, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0,
                     logit_softcap=0.0, k_offset=0, seq_reduce=None):
    """One-token decode. q: [B, Hq, 1, D]; caches: [B, Hkv, Smax, D]. The new
    token's K/V must already sit at slot cache_len - 1; ``cache_len`` is an
    int or a [B] tensor (``_decode_valid_mask``). GQA is contracted
    grouped (q as [B, Hkv, G, D]) with f32 accumulation, as the reference's
    ``preferred_element_type=f32`` einsums. The caches may be a shard of
    the sequence whose first slot is position ``k_offset``, the softmax
    then taken across the shards through ``seq_reduce`` (``_decode_out``).
    """
    b, hq, _, d = q.shape
    hkv, smax = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = q[:, :, 0, :].reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float()) \
        * (1.0 / math.sqrt(d))
    s = softcap(s, logit_softcap)
    valid = _decode_valid_mask(smax, cache_len, window, q.device, k_offset)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    return _decode_out(s, lambda p: torch.einsum(
        "bhgk,bhkd->bhgd", p.to(v_cache.dtype).float(), v_cache.float()),
        q, seq_reduce)


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor, scale_dtype=torch.bfloat16):
    """x: [..., D] -> (int8 codes [..., D], scales [...]): per-(position,
    head) absmax scaling, as the reference."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale.to(scale_dtype)


def decode_attention_q8(q, k_q, k_s, v_q, v_s, cache_len, *, window=0,
                        logit_softcap=0.0, k_offset=0, seq_reduce=None):
    """One-token decode over an int8 cache. q: [B, Hq, 1, D]; k_q/v_q: int8
    [B, Hkv, Smax, D]; k_s/v_s: [B, Hkv, Smax]. The scales factor out of the
    contractions: ``q.k = (q.k_q) k_s`` and ``sum p v = sum (p v_s) v_q``.
    ``k_offset`` and ``seq_reduce`` as ``decode_attention``'s."""
    b, hq, _, d = q.shape
    hkv, smax = k_q.shape[1], k_q.shape[2]
    g = hq // hkv
    qg = q[:, :, 0, :].reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_q.float())
    s = s * k_s[:, :, None, :].float() * (1.0 / math.sqrt(d))
    s = softcap(s, logit_softcap)
    valid = _decode_valid_mask(smax, cache_len, window, q.device, k_offset)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    return _decode_out(s, lambda p: torch.einsum(
        "bhgk,bhkd->bhgd", (p * v_s[:, :, None, :].float()).to(q.dtype)
        .float(), v_q.float()), q, seq_reduce)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """x: [..., d]. p: {'wi': [d,f], 'wo': [f,d], optional 'wg': [d,f]}.

    Under a mesh the hidden activation is pinned to [batch->data, ...,
    f->model], as the reference pins it, so the products are Megatron-TP
    shaped in both passes."""
    pin = ("batch",) + (None,) * (x.dim() - 2) + ("model",)
    if act == "silu_gated":
        h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    elif act == "gelu_gated":
        h = F.gelu(x @ p["wi"], approximate="tanh") * (x @ p["wg"])
    elif act == "squared_relu":
        h = torch.square(F.relu(x @ p["wi"]))
    else:
        raise ValueError(f"unknown mlp act {act!r}")
    h = constrain(h, *pin)
    return h @ p["wo"]
