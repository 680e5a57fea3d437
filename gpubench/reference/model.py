"""The plain reference: a float32 forward pass of the served models in
plain PyTorch, written from the layer equations and sharing no code with
the program (it imports nothing of ``repro_torch``).

Families:

  * ``ssm`` (falcon-mamba-7b): per layer ``x + mamba1(rms(x))``; Mamba-1
    is ``xs, z = x W_in``; ``xs = silu(conv(xs))``; ``dt, B, C = xs
    W_x``; ``dt = softplus(dt W_dt + b_dt)``; ``h_t = exp(dt_t A) h_{t-1}
    + dt_t xs_t B_t``; ``y_t = h_t C_t``; ``((y + D xs) silu(z)) W_out``
    with ``A = -exp(A_log)``;
  * ``hybrid`` (the port's zamba2): groups of k-1 Mamba-2 layers ``x +
    mamba2(rms(x))`` and then the one shared block, ``x + attn(rms(x))``
    and ``x + mlp(rms(x))``, each group with its own norms. Mamba-2 is
    ``z, xBC, dt = x W_in``; ``xBC = silu(conv(xBC))``; ``dt =
    softplus(dt + dt_bias)``; per head ``h_t = exp(dt_t A) h_{t-1} + dt_t
    x_t B_t^T``, ``y_t = h_t C_t + D x_t``; ``rms(y silu(z)) W_out``. The
    attention is causal softmax attention with adjacent-pair RoPE, the
    MLP ``gelu_tanh(x W_i) (x W_g) W_o``.

``rms(x) = x / sqrt(mean(x²) + eps) · (1 + scale)``. The recurrences run
as written, one position after the other (``linear_scan``), not in the
SSD's chunked matrix form the program uses. Every product goes through
``mm``, so the same forward computes the lower-precision control
(``gpubench/reference/precision.py``). The weights are the harness's
tensors, read a layer at a time in float32; the caller turns TF32 off.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

MM = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.float()


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution along dim 1: out_t = sum_i x_{t-W+1+i}
    w[:, i] + b. x [B, S, C]; w [C, W]."""
    width = w.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = b.float().expand_as(x).clone()
    for i in range(width):
        out += xp[:, i:i + x.shape[1]] * w[:, i].float()
    return out


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                block: int = 64) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h = 0, along dim 1 (a broadcasts to
    b). Every block of ``block`` positions runs its recurrence position
    by position from zero, all blocks at once; then each block adds what
    it carries in, block after block."""
    bsz, s = b.shape[:2]
    nb = -(-s // block)
    pad = nb * block - s
    if pad:
        a = torch.cat([a, a.new_ones((a.shape[0], pad) + a.shape[2:])], 1)
        b = torch.cat([b, b.new_zeros((bsz, pad) + b.shape[2:])], 1)
    a = a.reshape((a.shape[0], nb, block) + a.shape[2:])
    b = b.reshape((bsz, nb, block) + b.shape[2:])
    hs = torch.empty_like(b)
    prods = torch.empty((a.shape[0], nb, block) + a.shape[3:],
                        dtype=a.dtype, device=a.device)
    h = torch.zeros_like(b[:, :, 0])
    p = torch.ones_like(a[:, :, 0])
    for t in range(block):
        h = a[:, :, t] * h + b[:, :, t]
        hs[:, :, t] = h
        p = p * a[:, :, t]
        prods[:, :, t] = p
    carry = torch.zeros_like(hs[:, 0, 0])
    for c in range(nb):
        hs[:, c] += prods[:, c] * carry[:, None]
        carry = hs[:, c, -1]
    return hs.reshape((bsz, nb * block) + b.shape[3:])[:, :s]


def mamba1(p: Dict, x: torch.Tensor, c: Dict, mm: MM) -> torch.Tensor:
    n = c["ssm"]["state_dim"]
    e = p["out_proj"].shape[0]
    r = p["dt_proj_w"].shape[0]
    xs, z = mm(x, p["in_proj"]).split([e, e], dim=-1)
    xs = F.silu(causal_conv(xs, p["conv_w"], p["conv_b"]))
    dt, bm, cm = mm(xs, p["x_proj"]).split([r, n, n], dim=-1)
    dt = F.softplus(mm(dt, p["dt_proj_w"]) + p["dt_proj_b"].float())
    a_cont = -torch.exp(p["A_log"].float())                  # [E, N]
    a = torch.exp(dt[..., None] * a_cont)                    # [B, S, E, N]
    b = (dt * xs)[..., None] * bm[..., None, :]
    h = linear_scan(a, b)
    del a, b
    y = torch.einsum("bsen,bsn->bse", h, cm)
    del h
    y = (y + xs * p["D"].float()) * F.silu(z)
    return mm(y, p["out_proj"])


def mamba2(p: Dict, x: torch.Tensor, c: Dict, mm: MM) -> torch.Tensor:
    n, ph = c["ssm"]["state_dim"], c["ssm"]["headdim"]
    e = p["out_proj"].shape[0]
    nh = e // ph
    bsz, s, _ = x.shape
    z, xbc, dt = mm(x, p["in_proj"]).split([e, e + 2 * n, nh], dim=-1)
    xbc = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs, bm, cm = xbc.split([e, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].float())                # [B, S, nh]
    xh = xs.reshape(bsz, s, nh, ph)
    a = torch.exp(dt * -torch.exp(p["A_log"].float()))[..., None, None]
    b = (dt[..., None] * xh)[..., None] * bm[:, :, None, None, :]
    h = linear_scan(a, b)                                    # [B,S,nh,P,N]
    del a, b
    y = torch.einsum("bshpn,bsn->bshp", h, cm)
    del h
    y = (y + p["D"].float()[:, None] * xh).reshape(bsz, s, e)
    return mm(rms(y * F.silu(z), p["norm"], c["norm_eps"]), p["out_proj"])


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, H, S, D] at positions 0 .. S-1; lanes (2i, 2i+1) rotate
    together by position / theta^(2i / D)."""
    d, s = x.shape[-1], x.shape[2]
    freqs = theta ** -(torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).flatten(-2)


def attention(p: Dict, x: torch.Tensor, c: Dict, mm: MM,
              block: int = 1024) -> torch.Tensor:
    bsz, s, d = x.shape
    h, hkv = c["n_heads"], c["n_kv_heads"]
    hd = c["head_dim"] or d // h

    def heads(w, nh):
        return mm(x, w.reshape(d, nh * hd)).reshape(bsz, s, nh, hd) \
            .transpose(1, 2)
    q = rope(heads(p["wq"], h), c["rope_theta"])
    k = rope(heads(p["wk"], hkv), c["rope_theta"])
    v = heads(p["wv"], hkv)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    out = torch.empty_like(q)
    pos = torch.arange(s, device=x.device)
    for i in range(0, s, block):  # query blocks, so scores stay small
        sc = q[:, :, i:i + block] @ k.transpose(-1, -2) / math.sqrt(hd)
        sc = sc.masked_fill(pos[None, :] > pos[i:i + block, None],
                            float("-inf"))
        out[:, :, i:i + block] = torch.softmax(sc, dim=-1) @ v
    o = out.transpose(1, 2).reshape(bsz, s, h * hd)
    return mm(o, p["wo"].reshape(h * hd, d))


def mlp(p: Dict, x: torch.Tensor, c: Dict, mm: MM) -> torch.Tensor:
    act = c["mlp_act"]
    hi = mm(x, p["wi"])
    if act == "gelu_gated":
        hid = F.gelu(hi, approximate="tanh") * mm(x, p["wg"])
    elif act == "silu_gated":
        hid = F.silu(hi) * mm(x, p["wg"])
    else:
        raise ValueError(f"no reference for mlp_act {act!r}")
    return mm(hid, p["wo"])


@torch.no_grad()
def logits(params: Dict, c: Dict, tokens: torch.Tensor, last: int,
           mm: MM = f32_mm) -> torch.Tensor:
    """[B, S] token ids -> [B, last, V] float32 logits of the last
    ``last`` positions."""
    eps = c["norm_eps"]
    x = params["embed"][tokens].float()
    if c["family"] == "ssm":
        for lp in params["layers"]:
            x = x + mamba1(lp["mamba"], rms(x, lp["norm"], eps), c, mm)
    elif c["family"] == "hybrid":
        sh = params["shared"]
        for gp in params["groups"]:
            for mp, nm in zip(gp["mamba"], gp["norm_m"]):
                x = x + mamba2(mp, rms(x, nm, eps), c, mm)
            x = x + attention(sh["attn"], rms(x, gp["norm_attn"], eps), c,
                              mm)
            x = x + mlp(sh["mlp"], rms(x, gp["norm_mlp"], eps), c, mm)
    else:
        raise ValueError(f"no reference for family {c['family']!r}")
    x = x[:, -last:]
    return mm(rms(x, params["final_norm"], eps), params["lm_head"])
