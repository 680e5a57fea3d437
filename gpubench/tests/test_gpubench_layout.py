"""Every cell of ``BENCHMARK.json`` finds what it needs by name: its
configuration's file, its mix's file, a reader for each of its metrics and
its limits, each limit on a number the comparison gives. A later cell
adds files; it edits none."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from gpubench.harness import Cell, judge, load_reader

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NUMBERS = {"token_gap", "mean_token_gap"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = Cell.from_benchmark(ROOT, name)
    assert cell.config["name"] == next(
        w["config"] for w in SPEC["workloads"] if w["name"] == name)
    assert cell.mix["loop"] in ("open", "closed")
    for m in cell.end_to_end + cell.per_layer:
        assert callable(load_reader(m["name"]))
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert cell.limits and set(cell.limits) <= NUMBERS


def test_judge_holds_every_number_to_its_limit():
    limits = {"token_gap": 0.5, "mean_token_gap": 0.01}
    got = {"lost_requests": 0, "token_gap": 0.2, "mean_token_gap": 0.001,
           "tokens": 300}
    compared, ok = judge(got, limits)
    assert ok and list(compared) == ["lost_requests", "token_gap",
                                     "mean_token_gap"]
    assert not judge(dict(got, lost_requests=1), limits)[1]
    assert not judge(dict(got, mean_token_gap=0.02), limits)[1]
    assert not judge(dict(got, tokens=0), limits)[1]
    assert not judge(got, None)[1]
