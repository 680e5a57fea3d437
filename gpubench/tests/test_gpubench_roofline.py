"""The frozen yardstick against hand counts at small shapes, and its model
FLOPs against the port's analytic model less the scan's elementwise
term."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from gpubench import roofline as R
from gpubench.harness import flat_config

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_scan_bound_by_hand():
    # [1, 2, 3, 4]: 24 elements; a, b read and h written (3 x 24 x 4 B),
    # the last state written (12 x 4 B)
    assert R.scan_bound_s([1, 2, 3, 4]) == pytest.approx(
        max((3 * 24 * 4 + 12 * 4) / 3.35e12, 48 / 67e12))


def test_rmsnorm_bound_by_hand():
    assert R.rmsnorm_bound_s([3, 8], 2) == pytest.approx(
        max((2 * 24 * 2 + 8 * 2) / 3.35e12, 96 / 67e12))


# the port's hybrid (Mamba-2 and one shared attention block) at the widths
# it serves zamba2-2.7b with
HYBRID = {"name": "hybrid", "family": "hybrid", "n_layers": 54,
          "d_model": 2560, "n_heads": 32, "n_kv_heads": 32, "head_dim": 80, "d_ff": 10240, "vocab": 32000,
          "ssm": {"state_dim": 64, "conv_width": 4, "expand": 2,
                  "headdim": 64, "chunk": 256},
          "hybrid_shared_every": 6, "mlp_act": "gelu_gated",
          "rope_theta": 10000.0, "norm_eps": 1e-05}


def _conf(name):
    return flat_config(json.loads((CONFIGS / f"{name}.json").read_text()))


def test_mamba1_flops_by_hand():
    c = dict(_conf("falcon-mamba-7b"), n_layers=1, vocab=10)
    d, e, n, r = 4096, 8192, 16, 256
    per_tok = 2 * d * 2 * e + 2 * e * 4 + 2 * e * (r + 2 * n) + 2 * r * e \
        + 2 * e * n + 2 * e * d
    assert R.prefill_flops(c, 3) == pytest.approx(3 * per_tok + 2 * d * 10)
    assert R.decode_flops(c, 100) == pytest.approx(per_tok + 2 * d * 10)


def test_hybrid_flops_by_hand():
    c = dict(flat_config(HYBRID), n_layers=2, hybrid_shared_every=2,
             vocab=10)
    d, e, n, nh, f, hd, h = 2560, 5120, 64, 80, 10240, 80, 32
    m2 = 2 * d * (2 * e + 2 * n + nh) + 2 * (e + 2 * n) * 4 \
        + 4 * e * n + 2 * e * d
    proj = 2 * d * 3 * h * hd + 2 * h * hd * d
    mlp = 2 * d * f * 3
    s = 512
    want = s * (m2 + 2 * 256 * n + 2 * 256 * e) + s * proj \
        + 4 * s * (s / 2) * h * hd + s * mlp + 2 * d * 10
    assert R.prefill_flops(c, s) == pytest.approx(want)
    assert R.decode_flops(c, 700) == pytest.approx(
        m2 + proj + 4 * 700 * h * hd + mlp + 2 * d * 10)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "hybrid"])
def test_prefill_flops_match_the_ports_model(name):
    from gpubench.harness import program_config
    from repro_torch.launch.flops import forward_flops
    raw = HYBRID if name == "hybrid" else \
        json.loads((CONFIGS / f"{name}.json").read_text())
    c, cfg, s = flat_config(raw), program_config(raw), 1024
    scan = 9 * c["expand"] * c["d_model"] * c["state_dim"] * s \
        * c["n_layers"] if c["family"] == "ssm" else 0
    # the port's model counts the head at every position; ours, the last
    head = 2.0 * c["d_model"] * c["vocab"]
    assert R.prefill_flops(c, s) == pytest.approx(
        forward_flops(cfg, 1, s) - scan - head * (s - 1))
