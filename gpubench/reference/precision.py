"""The control: the reference's products computed in the precision below
the configuration's bfloat16, float8 (e4m3), the step a later change would
be tempted to take on this card.

Each product quantizes its activations per row and its weights per output
column to e4m3, scaled so the largest magnitude lands on e4m3's largest
finite value (448), and multiplies the dequantized values in float32: the
rounding of an fp8 matrix product with per-row and per-column scales,
without its speed. Everything between the products stays float32.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _quantize(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _quantize(x, -1) @ _quantize(w.float(), 0)
