"""Decoder model of the dense attention family (dense, and the vlm/audio
stacks that feed precomputed embeddings), in PyTorch.

Port of ``src/repro/models/model.py`` (dense family only; MoE, SSM and the
hybrid come in later slices and raise ``NotImplementedError`` here). Where
the reference stacks layer weights on a leading [L] dim and ``lax.scan``s
over them, the port keeps a list of per-layer dicts and runs a Python loop,
so ``_layer_window`` returns a plain int per layer and gemma2's alternating
window reaches the attention kernel as a runtime argument. Parameters keep
the reference's layouts (``wq: [d, h, hd]``, ``wo: [h, hd, d]``), so
``repro_torch.convert`` moves JAX weights over unchanged.

``attn_impl`` picks the prefill attention: ``"flash_kernel"`` (the hand CUDA
kernel; its plain version on CPU tensors), ``"flash_plain"`` (chunked
online-softmax in plain PyTorch) or ``"naive"`` (the oracle).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]
DENSE_FAMILIES = ("dense", "vlm", "audio")
ATTN_IMPLS = ("flash_kernel", "flash_plain", "naive")


def check_supported(cfg: ArchConfig) -> None:
    if cfg.family not in DENSE_FAMILIES or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense attention family so far "
            f"(family {cfg.family!r}, moe={cfg.moe is not None})")


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _init(gen: torch.Generator, shape, dtype, device, scale=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


def _attn_params(gen, cfg: ArchConfig, dtype, device) -> Params:
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": _init(gen, (d, h, hd), dtype, device, d ** -0.5),
        "wk": _init(gen, (d, kv, hd), dtype, device, d ** -0.5),
        "wv": _init(gen, (d, kv, hd), dtype, device, d ** -0.5),
        "wo": _init(gen, (h, hd, d), dtype, device, (h * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h, hd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(kv, hd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(kv, hd, dtype=dtype, device=device)
    return p


def _mlp_params(gen, cfg: ArchConfig, dtype, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": _init(gen, (d, f), dtype, device),
         "wo": _init(gen, (f, d), dtype, device)}
    if cfg.mlp_act.endswith("gated"):
        p["wg"] = _init(gen, (d, f), dtype, device)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                param_dtype: torch.dtype = torch.float32,
                device=None) -> Params:
    """Random weights at the reference's scales (the numbers differ: torch's
    generator is not JAX's; tests move JAX weights over with ``convert``).
    ``device`` must match the generator's device."""
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab
    zeros = dict(dtype=param_dtype, device=device)
    params: Params = {"embed": _init(generator, (v, d), param_dtype, device,
                                     1.0)}
    params["layers"] = [
        {"norm1": torch.zeros(d, **zeros), "norm2": torch.zeros(d, **zeros),
         "attn": _attn_params(generator, cfg, param_dtype, device),
         "mlp": _mlp_params(generator, cfg, param_dtype, device)}
        for _ in range(cfg.n_layers)]
    params["final_norm"] = torch.zeros(d, **zeros)
    if not cfg.tie_embeddings:
        params["lm_head"] = _init(generator, (d, v), param_dtype, device)
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _project_qkv(p: Params, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    return q, k, v


def attn_block(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
               positions: torch.Tensor, window: int, attn_impl: str,
               return_kv: bool = False):
    """Full-sequence attention (train/prefill). x: [B, S, d]."""
    q, k, v = _project_qkv(p, x)
    q = L.apply_rope(q, positions[None, None, :], cfg.rope_theta)
    k = L.apply_rope(k, positions[None, None, :], cfg.rope_theta)
    kwargs = dict(causal=True, window=window,
                  logit_softcap=cfg.attn_logit_softcap)
    if attn_impl == "flash_kernel":
        o = L.flash_attention(q, k, v, **kwargs)
    elif attn_impl == "flash_plain":
        o = L.flash_attention_plain(q, k, v, **kwargs)
    elif attn_impl == "naive":
        o = L.naive_attention(q, k, v, **kwargs)
    else:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def attn_decode_block(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                      pos: int, kcache: torch.Tensor, vcache: torch.Tensor,
                      window: int, kscale: Optional[torch.Tensor] = None,
                      vscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token attention for a batch at one position ``pos``. x: [B, 1, d];
    caches: [B, Hkv, Smax, D] (int8 with per-(position, head) scales when
    ``kscale``/``vscale`` are given). The new token's K/V are written INTO the
    caches in place at slot ``min(pos, Smax - 1)`` (the reference returns
    updated copies; the port updates in place to keep one cache resident).
    Returns the attention output [B, 1, d]."""
    q, k, v = _project_qkv(p, x)  # [B, H, 1, hd]
    posv = torch.full((1, 1, 1), pos, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, posv, cfg.rope_theta)
    k = L.apply_rope(k, posv, cfg.rope_theta)
    smax = kcache.shape[2]
    slot = min(pos, smax - 1)
    cache_len = min(pos + 1, smax)
    if kscale is not None:
        k_q, k_s = L.quantize_kv(k, kscale.dtype)
        v_q, v_s = L.quantize_kv(v, vscale.dtype)
        kcache[:, :, slot] = k_q[:, :, 0]
        vcache[:, :, slot] = v_q[:, :, 0]
        kscale[:, :, slot] = k_s[:, :, 0]
        vscale[:, :, slot] = v_s[:, :, 0]
        o = L.decode_attention_q8(q, kcache, kscale, vcache, vscale,
                                  cache_len, window=window,
                                  logit_softcap=cfg.attn_logit_softcap)
    else:
        kcache[:, :, slot] = k[:, :, 0]
        vcache[:, :, slot] = v[:, :, 0]
        o = L.decode_attention(q, kcache, vcache, cache_len, window=window,
                               logit_softcap=cfg.attn_logit_softcap)
    return torch.einsum("bhsk,hkd->bsd", o, p["wo"])


def _layer_window(cfg: ArchConfig, layer_idx: int) -> int:
    """Per-layer sliding window (gemma2 alternates local/global)."""
    if not cfg.sliding_window:
        return 0
    if cfg.local_global_alternate:
        return cfg.sliding_window if layer_idx % 2 == 0 else 0
    return cfg.sliding_window


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ArchConfig, params: Params,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if cfg.embedding_frontend_stub and "embeds" in batch:
        x = batch["embeds"]  # modality frontend stub: precomputed embeddings
    else:
        x = params["embed"][batch["tokens"]]
    return scale_embedding(cfg, x)


def scale_embedding(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """gemma2 multiplies the embedding by sqrt(d_model), rounded to x's
    dtype first as the reference does. The factor is a host scalar: a
    tensor made on the card from a Python number would be a blocking copy,
    stalling the host once per step."""
    if cfg.name.startswith("gemma2"):
        return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x


def logits_from_hidden(cfg: ArchConfig, params: Params,
                       x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.softcap((x @ head).float(), cfg.final_logit_softcap)


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, attn_impl: str = "flash_kernel", collect_cache: bool = False):
    """Full-sequence forward. Returns (hidden [B, S, d], aux loss 0) — plus
    the KV cache ``{"k", "v": [L, B, Hkv, S, hd]}`` when ``collect_cache``
    (prefill). The cache is written layer by layer into one preallocated
    stack, so no second copy of it is ever live."""
    check_supported(cfg)
    x = embed_tokens(cfg, params, batch)
    bsz, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    cache: Optional[Dict[str, torch.Tensor]] = None
    if collect_cache:
        shape = kv_shape(cfg, bsz, s)
        cache = {"k": torch.empty(shape, dtype=x.dtype, device=x.device),
                 "v": torch.empty(shape, dtype=x.dtype, device=x.device)}
    for i, lp in enumerate(params["layers"]):
        a, (k, v) = attn_block(lp["attn"], L.rms_norm(x, lp["norm1"]), cfg,
                               positions=positions,
                               window=_layer_window(cfg, i),
                               attn_impl=attn_impl, return_kv=True)
        if cache is not None:
            cache["k"][i].copy_(k)
            cache["v"][i].copy_(v)
        del k, v
        x = x + a
        x = x + L.mlp_apply(lp["mlp"], L.rms_norm(x, lp["norm2"]),
                            cfg.mlp_act)
    x = L.rms_norm(x, params["final_norm"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if collect_cache:
        return x, aux, cache
    return x, aux


def kv_shape(cfg: ArchConfig, batch: int, seq: int) -> Tuple[int, ...]:
    """Shape of one stacked KV cache tensor: [L, B, Hkv, S, hd]."""
    return (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.resolved_head_dim)
