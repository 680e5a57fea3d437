"""Mamba-1 block (selective scan) in PyTorch: the layer of falcon-mamba.

Port of ``src/repro/models/ssm.py:24-124`` (Mamba-1 only; Mamba-2 / SSD and
the zamba2 hybrid come in a later slice). The casts are the reference's:
``dt`` is computed in the parameter dtype, the scan inputs ``a``, ``b`` are
built in f32, ``y`` is computed in f32 and cast to x's dtype before
``out_proj``, and the conv state is the tail of the pre-conv, pre-activation
``xs``.

Differences from the reference:

  * the recurrence runs in the hand kernel ``kernels.mamba_scan`` (its plain
    version on CPU tensors), where the reference's model runs a chunked
    associative scan (``_scan_chunked``), so S need not divide any chunk;
  * ``a`` and ``b`` ([B, S, E, N] f32, 2.15 GB each at falcon-mamba-7b's
    prefill shape) are built with in-place ops, so a layer's peak holds a,
    b and the scan's output and no further temporaries of that size;
  * ``mamba1_decode_step`` updates the decode state IN PLACE (the reference
    returns new arrays), so one state stays resident per task.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.mamba_scan import mamba_scan


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: ``sum_i shift(x, W-1-i) * w[:, i] + b``, summed
    in the reference's order. x: [B, S, C]; w: [C, W]; b: [C]."""
    width, s = w.shape[-1], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(width):
        shift = width - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + xi * w[:, i]
    return out + b


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One decode step. x_t: [B, C]; conv_state: [B, W-1, C], shifted IN
    PLACE to hold the last W-1 inputs (in its own dtype). Returns the conv
    output [B, C]."""
    window = torch.cat([conv_state, x_t[:, None]], 1)  # promotes, as jnp
    out = torch.einsum("bwc,cw->bc", window, w) + b
    conv_state.copy_(window[:, 1:])
    return out


def _split_proj(p: dict, xs: torch.Tensor, n: int):
    """(dt [.., E] in the parameter dtype, B [.., N], C [.., N])."""
    dt_rank = p["dt_proj_w"].shape[0]
    proj = xs @ p["x_proj"]
    dt_low, bmat, cmat = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = F.softplus(dt_low @ p["dt_proj_w"] + p["dt_proj_b"])
    return dt, bmat, cmat


def _gate(p: dict, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """(y + xs·D)·silu(z) in f32, cast to ``dtype`` before ``out_proj``."""
    y = (y + xs.float() * p["D"]) * F.silu(z).float()
    return y.to(dtype) @ p["out_proj"]


def mamba1_apply(p: dict, x: torch.Tensor, cfg: SSMConfig, *,
                 return_state: bool = False):
    """Mamba-1 block. x: [B, S, d] -> [B, S, d]; with ``return_state`` also
    the decode state ``{"conv": [B, W-1, E], "ssm": [B, E, N] f32}``."""
    n = cfg.state_dim
    xs, z = (x @ p["in_proj"]).chunk(2, dim=-1)  # [B, S, E] each
    conv_tail = xs[:, -(cfg.conv_width - 1):].clone()
    xs = F.silu(causal_conv1d(xs, p["conv_w"], p["conv_b"]))
    dt, bmat, cmat = _split_proj(p, xs, n)
    a_cont = -torch.exp(p["A_log"].float())  # [E, N]
    # the scan's [B, S, E, N] inputs, each made by one broadcast op and then
    # updated in place
    a = (dt[..., None].float() * a_cont).exp_()
    b = (dt * xs)[..., None].float() * bmat[..., None, :].float()
    h, h_last = mamba_scan(a, b)
    del a, b
    y = torch.matmul(h, cmat.float()[..., None])[..., 0]  # [B, S, E]
    del h
    out = _gate(p, y, xs, z, x.dtype)
    if return_state:
        return out, {"conv": conv_tail, "ssm": h_last}
    return out


def mamba1_decode_step(p: dict, x_t: torch.Tensor,
                       state: Dict[str, torch.Tensor],
                       cfg: SSMConfig) -> torch.Tensor:
    """x_t: [B, d]; state: ``{"conv": [B, W-1, E], "ssm": [B, E, N] f32}``,
    both updated IN PLACE. Returns the block output [B, d]."""
    n = cfg.state_dim
    xs, z = (x_t @ p["in_proj"]).chunk(2, dim=-1)
    xs = F.silu(conv1d_step(xs, state["conv"], p["conv_w"], p["conv_b"]))
    dt, bmat, cmat = _split_proj(p, xs, n)
    a_cont = -torch.exp(p["A_log"].float())
    a = (dt[..., None].float() * a_cont).exp_()  # [B, E, N]
    b = (dt * xs)[..., None].float() * bmat[:, None, :].float()
    h = state["ssm"].mul_(a).add_(b)
    y = torch.matmul(h, cmat.float()[..., None])[..., 0]  # [B, E]
    return _gate(p, y, xs, z, x_t.dtype)
