"""The plain reference against the port at a reduced size on the CPU, in
float32: the harness's weights in the layout the port's own
``init_params`` makes, the reference's logits against the port's forward
(its hand kernels' plain versions, the SSD in chunked form), and the
reference's scan against a loop over positions."""
from __future__ import annotations

import torch
import pytest

from gpubench.harness import program_config
from gpubench.reference import model as R
from gpubench.tests import tiny
from gpubench.weights import Weights

CONFIGS = {"hybrid": tiny.HYBRID, "ssm": tiny.SSM}


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree(v) for v in t]
    return (tuple(t.shape), t.dtype)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_weights_have_the_ports_layout(family):
    from repro_torch.models.model import init_params
    c = CONFIGS[family]
    ours = Weights(c, torch.bfloat16, "cpu")
    ours.fill(3)
    theirs = init_params(program_config(c), torch.Generator().manual_seed(0),
                         torch.bfloat16, torch.device("cpu"))
    assert _tree(ours.params) == _tree(theirs)


def test_weights_follow_the_seed():
    a, b = (Weights(tiny.SSM, torch.bfloat16, "cpu") for _ in range(2))
    a.fill(2**31 + 3)
    b.fill(2**31 + 3)
    assert torch.equal(a.flat, b.flat)
    b.fill(4)
    assert not torch.equal(a.flat, b.flat)


def test_linear_scan_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    a = torch.rand(2, 150, 3, 4, generator=g)
    b = torch.randn(2, 150, 3, 4, generator=g)
    h, want = torch.zeros(2, 3, 4), []
    for t in range(150):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(R.linear_scan(a, b, block=16),
                               torch.stack(want, 1))


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_reference_logits_match_the_port(family):
    from repro_torch.models.model import forward, logits_from_hidden
    c = CONFIGS[family]
    w = Weights(c, torch.float32, "cpu")
    w.fill(11)
    cfg = program_config(c)
    tokens = torch.randint(0, c["vocab"], (1, 64),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        hidden, _ = forward(w.params, cfg, {"tokens": tokens},
                            attn_impl="flash_kernel")
        port = logits_from_hidden(cfg, w.params, hidden)
    ref = R.logits(w.params, c, tokens, 64)
    assert port.abs().max() > 0.5
    torch.testing.assert_close(ref, port, rtol=1e-4, atol=2e-4)
