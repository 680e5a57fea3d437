"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped): a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct, once for each fault a serving
cell can have:

  * a decode step that returns its state unchanged;
  * half of the rows in use left out of the step;
  * a token altered where it is produced (the prefill's first token).

The exchange between chips has no fault to plant: every cell runs on one
card and the engine moves no state across cards. The control, the
reference computed in fp8, reads wider gaps than the program does, and
the sample the reference checks spans the window's requests."""
from __future__ import annotations

import time

import pytest
import torch

from gpubench import faults
from gpubench.harness import Bench, run_cell
from gpubench.reference import compare
from gpubench.tests import tiny

CELLS = {"hybrid-open": (tiny.HYBRID, tiny.OPEN),
         "ssm-closed": (tiny.SSM, tiny.CLOSED)}
SECONDS = 2.0


def _run(name, hooks=None):
    conf, mix = CELLS[name]
    return run_cell(tiny.cell(conf, mix), 2**31 + 21, SECONDS, False, "cpu",
                    time.time(), hooks)


@pytest.fixture
def engine():
    from repro_torch.serve import engine
    return engine


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"tokens_per_s", "setup_s"}
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("name", sorted(CELLS))
def test_step_that_keeps_its_state(name, engine, monkeypatch):
    monkeypatch.setattr(engine, "loop_step", faults.frozen(engine.loop_step))
    res = _run(name)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_half_the_rows_left_out(name, engine, monkeypatch):
    monkeypatch.setattr(engine, "loop_step", faults.half(engine.loop_step))
    res = _run(name)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_token_altered_where_produced(name):
    res = _run(name, hooks={"model": faults.altered})
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_reads_wider_than_the_program(name):
    conf, mix = CELLS[name]
    bench = Bench(tiny.cell(conf, mix), "cpu", False)
    # at these widths fp8's per-row scales round little, so a seed may
    # read the control level with the program; over four seeds its mean
    # gap is several times the program's (on the card, at the cells'
    # widths, each seed separates: PERF.md)
    program, control = [], []
    for seed in (5, 2**31 + 9, 77, 3):
        bench.setup(seed)
        ctx = bench.window(seed, SECONDS, time.time())
        got = bench.check(ctx, seed, control=True)
        assert got["lost_requests"] == 0 and got["tokens"] > 0
        program.append(got["mean_token_gap"])
        control.append(got["control_mean_token_gap"])
    assert sum(control) > 3 * sum(program), (program, control)


def test_half_leaves_out_the_later_rows_in_use():
    def step(params, cfg, cache, tokens, pos, active):
        tokens.add_(active * 10)
    tokens = torch.arange(6, dtype=torch.int32)
    active = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.int32)
    faults.half(step)(None, None, {}, tokens, None, active)
    # rows in use 0, 2, 3, 5: the later two keep their tokens
    assert tokens.tolist() == [10, 1, 12, 3, 4, 5]
    lone = torch.zeros(3, dtype=torch.int32)
    faults.half(step)(None, None, {}, lone,
                      None, torch.tensor([0, 1, 0], dtype=torch.int32))
    assert lone.tolist() == [0, 0, 0]


def test_sample_spans_the_requests():
    class Done:
        def __init__(self, n_prompt, n_served):
            self.tokens = list(range(n_prompt))
            self.served = list(range(n_served))
    done = [Done(64, 300 + 10 * i) for i in range(20)] + [Done(256, 1000)]
    picked = compare.sample(done, 2**31 + 3, 8, 64)
    assert len(picked) == 8
    assert len(picked[0].served) == 1000       # the longest, whole
    assert all(len(p.served) == 64 for p in picked[1:])
    again = compare.sample(done, 2**31 + 3, 8, 64)
    assert [p.served for p in again] == [p.served for p in picked]
    assert len(compare.sample(done[:3], 1, 8, 64)) == 3
