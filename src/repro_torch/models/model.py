"""Decoder model of the attention families (dense, the vlm/audio stacks that
feed precomputed embeddings, and moe: mixtral, dbrx) and of the Mamba-1
family (ssm: falcon-mamba), in PyTorch.

Port of ``src/repro/models/model.py`` (dense, moe and ssm families; the
zamba2 hybrid comes in a later slice and raises ``NotImplementedError``
here).
Where the reference stacks layer weights on a leading [L] dim and
``lax.scan``s over them, the port keeps a list of per-layer dicts and runs a
Python loop, so ``_layer_window`` returns a plain int per layer and gemma2's
alternating window reaches the attention kernel as a runtime argument.
Parameters keep the reference's layouts (``wq: [d, h, hd]``, ``wo: [h, hd,
d]``, ``in_proj: [d, 2E]``, experts ``router: [d, E]``, ``wi/wg: [E, d, f]``,
``wo: [E, f, d]``), so ``repro_torch.convert`` moves JAX weights over
unchanged.

``attn_impl`` picks the prefill attention: ``"flash_kernel"`` (the hand CUDA
kernel; its plain version on CPU tensors), ``"flash_plain"`` (chunked
online-softmax in plain PyTorch) or ``"naive"`` (the oracle).

Training (``loss_fn``, ``chunked_softmax_xent``: ``model.py:438-471`` of the
reference) differentiates the same forward: the hand kernels' ops carry
their backward kernels (``repro_torch.kernels``), and under
``remat_policy="full"`` each layer is a non-reentrant
``torch.utils.checkpoint`` whose backward recomputes the layer (the
reference's ``_remat``, ``:309``), so only the layers' inputs are saved;
under ``"dots"`` the outputs of the layer's matrix products stay saved too
and the rest is recomputed.
The loss recomputes each 512-position chunk's f32 logits in the backward
instead of saving them. Training runs every family the port serves: the
Mamba-1 layer's scan and the MoE layer's grouped matmuls have backward
kernels too, and the loss adds the MoE aux loss (``aux_weight``, 0.01).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Params = Dict[str, Any]
FAMILIES = ("dense", "vlm", "audio", "moe", "ssm")
# families whose every kernel has a backward
TRAIN_FAMILIES = ("dense", "vlm", "audio", "moe", "ssm")
XENT_CHUNK = 512
ATTN_IMPLS = ("flash_kernel", "flash_plain", "naive")


def check_supported(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the {', '.join(FAMILIES)} families "
            f"so far (family {cfg.family!r})")


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

# f32 elements of one random draw for a weight kept in a narrower dtype: a
# larger one is drawn in slices of its first dim, so the f32 draw beside it
# stays 0.5e9 B (nemotron-4-340b's 256000 x 18432 embedding in one draw
# would hold 18.9e9 B of f32 beside its 9.4e9 B of bf16)
INIT_DRAW = 1 << 27


def _init(gen: torch.Generator, shape, dtype, device, scale=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    row = math.prod(shape[1:])
    if dtype == torch.float32 or len(shape) < 2 or shape[0] * row <= INIT_DRAW:
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dtype)
    w = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, INIT_DRAW // row)
    for i in range(0, shape[0], rows):
        part = torch.randn((min(rows, shape[0] - i),) + tuple(shape[1:]),
                           generator=gen, dtype=torch.float32, device=device)
        w[i:i + rows] = part.mul_(scale)
    return w


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


def _init_experts(gen: torch.Generator, shape, dtype, device):
    """An [E, fan_in, out] expert stack made one expert at a time, so the
    f32 draw is one expert big (0.23e9 B at mixtral's widths, not 1.9e9)."""
    w = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        w[e] = _init(gen, shape[1:], dtype, device)
    return w


def _moe_params(gen, cfg: ArchConfig, dtype, device) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {"router": _init(gen, (d, e), dtype, device),
         "wi": _init_experts(gen, (e, d, f), dtype, device),
         "wo": _init_experts(gen, (e, f, d), dtype, device)}
    if cfg.mlp_act.endswith("gated"):
        p["wg"] = _init_experts(gen, (e, d, f), dtype, device)
    return p


def _mamba1_params(gen, cfg: ArchConfig, dtype, device) -> Params:
    """``A_log`` and ``D`` stay f32 whatever the parameter dtype."""
    d = cfg.d_model
    e, n, w = cfg.ssm.expand * d, cfg.ssm.state_dim, cfg.ssm.conv_width
    r = max(1, d // 16)  # dt_rank
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device)).expand(e, n).clone()
    return {
        "in_proj": _init(gen, (d, 2 * e), dtype, device),
        "conv_w": _init(gen, (e, w), dtype, device, 0.2),
        "conv_b": torch.zeros(e, dtype=dtype, device=device),
        "x_proj": _init(gen, (e, r + 2 * n), dtype, device),
        "dt_proj_w": _init(gen, (r, e), dtype, device),
        "dt_proj_b": torch.full((e,), -4.0, dtype=dtype, device=device),
        "A_log": a_log,
        "D": torch.ones(e, dtype=torch.float32, device=device),
        "out_proj": _init(gen, (e, d), dtype, device),
    }


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
    if cfg.family == "ssm":
        params["layers"] = [
            {"norm": torch.zeros(d, **zeros),
             "mamba": _mamba1_params(generator, cfg, param_dtype, device)}
            for _ in range(cfg.n_layers)]
    else:
        ffn, ffn_params = ("moe", _moe_params) if cfg.moe is not None \
            else ("mlp", _mlp_params)
        params["layers"] = [
            {"norm1": torch.zeros(d, **zeros),
             "norm2": torch.zeros(d, **zeros),
             "attn": _attn_params(generator, cfg, param_dtype, device),
             ffn: ffn_params(generator, cfg, param_dtype, device)}
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
                      pos, kcache: torch.Tensor, vcache: torch.Tensor,
                      window: int, ring: bool = False,
                      kscale: Optional[torch.Tensor] = None,
                      vscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token attention. x: [B, 1, d]; caches: [B, Hkv, Smax, D] (int8
    with per-(position, head) scales when ``kscale``/``vscale`` are given).

    ``pos`` is an int tensor on the card, 0-d (the whole batch at one
    position) or [B] (continuous batching: each row at its own position);
    nothing reads it on the host, so the step can be captured in a CUDA
    graph and replayed with the positions advanced in place. The new
    token's K/V are written INTO the caches in place (the reference returns
    updated copies; the port updates in place to keep one cache resident)
    at each row's slot ``min(pos, Smax - 1)``, or for a ``ring`` cache (pure
    sliding-window archs, Smax = the window) ``pos % Smax``, where the
    overwrite enforces the window and no window mask is applied: one
    indexed scatter, the reference's one-hot ``where`` without rewriting
    the whole cache. Returns the attention output [B, 1, d]."""
    q, k, v = _project_qkv(p, x)  # [B, H, 1, hd]
    b, smax = x.shape[0], kcache.shape[2]
    posv = pos.reshape(-1).expand(b)
    slot = (posv % smax if ring else posv.clamp(max=smax - 1)).long()
    cache_len = (posv + 1).clamp(max=smax)
    at = (torch.arange(b, device=x.device), slice(None), slot)
    q = L.apply_rope(q, posv[:, None, None], cfg.rope_theta)
    k = L.apply_rope(k, posv[:, None, None], cfg.rope_theta)
    window = 0 if ring else window
    if kscale is not None:
        k_q, k_s = L.quantize_kv(k, kscale.dtype)
        v_q, v_s = L.quantize_kv(v, vscale.dtype)
        kcache[at] = k_q[:, :, 0]
        vcache[at] = v_q[:, :, 0]
        kscale[at] = k_s[:, :, 0]
        vscale[at] = v_s[:, :, 0]
        o = L.decode_attention_q8(q, kcache, kscale, vcache, vscale,
                                  cache_len, window=window,
                                  logit_softcap=cfg.attn_logit_softcap)
    else:
        kcache[at] = k[:, :, 0].to(kcache.dtype)
        vcache[at] = v[:, :, 0].to(vcache.dtype)
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


def _attn_layer(lp: Params, x: torch.Tensor, cfg: ArchConfig, i: int,
                positions: torch.Tensor, attn_impl: str,
                cache: Optional[Dict[str, torch.Tensor]]):
    """One attention layer: x + attn(norm1(x)), then + ffn(norm2(.)).
    Returns (x, the MoE aux loss or None); writes layer i's K, V into
    ``cache`` when given (prefill)."""
    a, (k, v) = attn_block(lp["attn"], L.rms_norm(x, lp["norm1"]), cfg,
                           positions=positions, window=_layer_window(cfg, i),
                           attn_impl=attn_impl, return_kv=True)
    if cache is not None:
        cache["k"][i].copy_(k)
        cache["v"][i].copy_(v)
    del k, v
    x = x + a
    hn = L.rms_norm(x, lp["norm2"])
    if cfg.moe is not None:
        m, aux_l = MOE.moe_apply(lp["moe"], hn, cfg.moe, cfg.mlp_act)
    else:
        m, aux_l = L.mlp_apply(lp["mlp"], hn, cfg.mlp_act), None
    return x + m, aux_l


def _ssm_layer(lp: Params, x: torch.Tensor, cfg: ArchConfig,
               return_state: bool):
    """One Mamba-1 layer: x + mamba(norm(x)), and with ``return_state``
    its decode state (prefill), else None."""
    out = SSM.mamba1_apply(lp["mamba"], L.rms_norm(x, lp["norm"]), cfg.ssm,
                           return_state=return_state)
    if return_state:
        return x + out[0], out[1]
    return x + out, None


# the matrix products without batch dims, which "dots" saves: JAX's
# ``checkpoint_dots_with_no_batch_dims`` saves every ``dot_general`` that
# has no batch dimension, and a projection's ``einsum`` or ``@`` over
# [B, S, d] reaches PyTorch's dispatcher as one of these on the rows
# folded together
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for "dots": save the outputs of
    matrix products without batch dims (and a batched product over a
    batch of one, which is the same product), recompute everything else,
    the hand kernels' ops (flash attention, the grouped matmul, the scan,
    RMSNorm) among them."""
    if op in _DOTS or (op is torch.ops.aten.bmm.default
                       and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """The reference's ``_remat`` (``model.py:309``): ``"nothing"`` saves
    every activation; ``"full"`` checkpoints the layer (non-reentrant: the
    backward reruns its forward, hand kernels included, and only the
    layer's inputs stay saved); ``"dots"`` checkpoints it selectively
    (``torch.utils.checkpoint.create_selective_checkpoint_contexts``): the
    outputs of its matrix products without batch dims stay saved and the
    rest is recomputed (``_dots_policy``), as the reference's
    ``checkpoint_dots_with_no_batch_dims``. No randomness runs in a layer,
    so no RNG state is stashed."""
    if policy == "nothing":
        return fn
    if policy == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        preserve_rng_state=False)
    if policy == "dots":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat_policy {policy!r}")


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ArchConfig, params: Params,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if cfg.embedding_frontend_stub and "embeds" in batch:
        x = batch["embeds"]  # modality frontend stub: precomputed embeddings
    else:
        # a gather whose backward sums repeated tokens in a fixed order
        # (indexing's accumulating backward does not, on the CPU)
        x = F.embedding(batch["tokens"], params["embed"])
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
    """Full-sequence forward. Returns (hidden [B, S, d], the MoE aux loss
    summed over layers, 0 without experts) — plus
    the decode cache when ``collect_cache`` (prefill): the KV cache
    ``{"k", "v": [L, B, Hkv, S, hd]}``, or for the ssm family the states
    ``{"conv": [L, B, W-1, E], "ssm": [L, B, E, N] f32}``. The cache is
    written layer by layer into preallocated stacks, so no second copy of
    it is ever live."""
    check_supported(cfg)
    x = embed_tokens(cfg, params, batch)
    bsz, s, _ = x.shape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache: Optional[Dict[str, torch.Tensor]] = None
    # under autograd each layer is rematerialised per the config
    grad = torch.is_grad_enabled() and x.requires_grad
    if cfg.family == "ssm":
        if collect_cache:
            conv, ssm = ssm_state_shapes(cfg, bsz)
            cache = {"conv": torch.empty(conv, dtype=x.dtype,
                                         device=x.device),
                     "ssm": torch.empty(ssm, dtype=torch.float32,
                                        device=x.device)}
        body = _remat(_ssm_layer, cfg.remat_policy) if grad else _ssm_layer
        for i, lp in enumerate(params["layers"]):
            x, st = body(lp, x, cfg, cache is not None)
            if cache is not None:
                cache["conv"][i].copy_(st["conv"])
                cache["ssm"][i].copy_(st["ssm"])
            del st
    else:
        positions = torch.arange(s, device=x.device)
        if collect_cache:
            shape = kv_shape(cfg, bsz, s)
            cache = {"k": torch.empty(shape, dtype=x.dtype, device=x.device),
                     "v": torch.empty(shape, dtype=x.dtype, device=x.device)}
        body = _remat(_attn_layer, cfg.remat_policy) if grad \
            else _attn_layer
        for i, lp in enumerate(params["layers"]):
            x, aux_l = body(lp, x, cfg, i, positions, attn_impl, cache)
            if aux_l is not None:
                aux = aux + aux_l
    x = L.rms_norm(x, params["final_norm"])
    if collect_cache:
        return x, aux, cache
    return x, aux


def ssm_state_shapes(cfg: ArchConfig, batch: int
                     ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Shapes of the stacked Mamba-1 decode states: conv [L, B, W-1, E] and
    ssm [L, B, E, N]."""
    e = cfg.ssm.expand * cfg.d_model
    return ((cfg.n_layers, batch, cfg.ssm.conv_width - 1, e),
            (cfg.n_layers, batch, e, cfg.ssm.state_dim))


def kv_shape(cfg: ArchConfig, batch: int, seq: int) -> Tuple[int, ...]:
    """Shape of one stacked KV cache tensor: [L, B, Hkv, S, hd]."""
    return (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.resolved_head_dim)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _xent_chunk(cfg: ArchConfig, params: Params, h: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross-entropy of one chunk: [B, chunk, V] f32
    logits, their log-sum-exp minus the gold logit."""
    logits = logits_from_hidden(cfg, params, h)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def chunked_softmax_xent(cfg: ArchConfig, params: Params,
                         hidden: torch.Tensor, labels: torch.Tensor,
                         chunk: int = XENT_CHUNK) -> torch.Tensor:
    """Mean next-token cross-entropy without keeping [B, S, V] logits: the
    sequence in chunks of ``chunk`` positions, each chunk's f32 logits
    recomputed in the backward (a non-reentrant checkpoint) instead of
    saved (2.1e9 B a chunk at vocab 256000 and batch 4). Port of the
    reference's ``chunked_softmax_xent`` (``model.py:438``)."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{chunk}")
    grad = torch.is_grad_enabled() and hidden.requires_grad
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        h, y = hidden[:, i:i + chunk], labels[:, i:i + chunk]
        if grad:
            part = checkpoint(_xent_chunk, cfg, params, h, y,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            part = _xent_chunk(cfg, params, h, y)
        tot = tot + part
    return tot / (b * s)


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, attn_impl: str = "flash_kernel",
            aux_weight: float = 0.01) -> torch.Tensor:
    """The training loss: chunked cross-entropy + ``aux_weight`` x the MoE
    aux loss (reference ``loss_fn``, ``model.py:467``)."""
    hidden, aux = forward(params, cfg, batch, attn_impl=attn_impl)
    ce = chunked_softmax_xent(cfg, params, hidden, batch["labels"])
    return ce + aux_weight * aux
