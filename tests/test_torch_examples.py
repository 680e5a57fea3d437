"""The port's examples (``repro_torch.examples``) against the reference's
``examples/*.py``, on the same inputs, on the CPU: quickstart, the three
sim examples, and every example's refusal without a card. shared_cluster
and train_100m have files of their own
(``tests/test_torch_examples_shared_cluster.py``,
``tests/test_torch_examples_train_100m.py``), so that xdist can spread the
examples' tests over its workers.

  * quickstart: the four results within 1e-5 relative of the JAX
    example's (f32 sums of 262144 terms in another order), placements on
    both devices, probe A's flops within 1% of XLA's; probe B's flops are
    0 (``FlopCounterMode`` counts no elementwise op; XLA counts 2.62e5,
    ROADMAP C27) and the probes' bytes are printed beside XLA's (C21);
  * gang_placement, preemptive_cluster, trace_viewer: the sim sections'
    output equals the JAX example's, line for line; the live sections'
    figures equal it too.
"""
import ast
import importlib
import re

import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

from _examples import CPU, _reference  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    gang_placement, preemptive_cluster, quickstart, trace_viewer,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# -- quickstart --------------------------------------------------------------
def test_quickstart_matches_the_reference(capsys):
    _reference("quickstart").main()
    ref = capsys.readouterr().out
    got = quickstart.main(CPU)
    out = capsys.readouterr().out
    want = ast.literal_eval(ref.splitlines()[-2].split("results: ", 1)[1])
    assert set(got["results"]) == set(want) == {"app1", "app2", "app3",
                                                "app4"}
    for app, v in want.items():
        assert abs(got["results"][app] - v) <= 1e-5 * abs(v)
    assert {d for _, d in got["placements"]} == {0, 1}
    assert got["stats"]["completed"] == 2 and got["stats"]["crashed"] == 0
    assert got["app4_records"] == ["app4-task"]
    assert len(got["tasks"]) == 1 and len(got["tasks"][0].units) == 2
    xla = {k: re.search(rf"probe {k}: ([\d.]+) MB, ([\d.e+-]+) flops",
                        ref).groups() for k in "AB"}
    assert abs(got["probe_a"].flops - float(xla["A"][1])) \
        <= 0.01 * float(xla["A"][1])
    # C27: the port's trace counts no elementwise op's flops
    assert got["probe_b"].flops == 0 and float(xla["B"][1]) > 0
    print(f"probe A: port {got['probe_a'].hbm_bytes / 1e6:.1f} MB, "
          f"{got['probe_a'].flops:.3e} flops; XLA {xla['A'][0]} MB, "
          f"{xla['A'][1]} flops. probe B: port "
          f"{got['probe_b'].hbm_bytes / 1e6:.1f} MB, "
          f"{got['probe_b'].flops:.3e} flops; XLA {xla['B'][0]} MB, "
          f"{xla['B'][1]} flops")
    assert out.strip().endswith("quickstart OK")


@pytest.mark.gpu
def test_quickstart_on_the_card_equals_the_cpu_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = quickstart.main(CPU)["results"]
    card = quickstart.main([])["results"]
    assert set(card) == set(cpu)
    for app, v in cpu.items():
        assert abs(card[app] - v) <= 1e-4 * abs(v)


# -- the sim examples --------------------------------------------------------
def test_gang_placement_prints_the_references_figures(capsys):
    _reference("gang_placement").main()
    ref = capsys.readouterr().out
    got = gang_placement.main(CPU)
    assert capsys.readouterr().out == ref
    assert f"{got['t']:.1f}" == "39.9"
    assert got["bound"] == [torch.device("cpu")] * 4
    assert got["gang_chips"] == 4
    assert got["shed_status"] == "shed"
    assert got["shed_stats"] == {"completed": 1, "shed": 1}
    assert ("gang002x4", 4, 0) in [p[:3] for p in got["placements"]]


def _live_figures(line):
    m = re.match(r"\[live\] events: (.*); statuses: (.*); (\d+) "
                 r"preemption\(s\)$", line)
    events, statuses, n = m.groups()
    # the hook (scheduler's notify thread) and the runner race for the
    # first entry, in both packages
    return sorted(ast.literal_eval(events)), ast.literal_eval(statuses), \
        int(n)


def test_preemptive_cluster_prints_the_references_figures(capsys):
    ref_mod = _reference("preemptive_cluster")
    ref_mod.sim_comparison()
    ref_mod.live_cooperative_checkpoint()
    ref = capsys.readouterr().out.splitlines()
    got = preemptive_cluster.main(CPU)
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ref[:2]
    assert _live_figures(out[2]) == _live_figures(ref[2])
    assert out[3] == "preemptive cluster demo OK"
    assert got["sim"] == {"met": 0, "total": 10, "met_preemptive": 10,
                          "total_preemptive": 10, "preemptions": 11,
                          "migrations": 3}
    assert sorted(got["live"]["events"]) == [
        "checkpoint(train-bg)", "finished", "stopped-early"]
    assert got["live"]["preemptions"] == 1


def test_trace_viewer_prints_the_references_lines(capsys, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    _reference("trace_viewer").main()
    ref = capsys.readouterr().out
    got = trace_viewer.main(CPU + ["--out", "port.json"])
    out = capsys.readouterr().out
    # a verdict names its preemptor by task uid, a count each package
    # keeps on across the tests of a process
    assert re.sub(r"by=\d+", "by=#", out) == re.sub(
        r"by=\d+", "by=#",
        ref.replace("wrote trace_viewer.json", "wrote port.json"))
    assert got["summary"]["flows"] == 2
    assert got["summary"]["cross_device_flows"] == 1
    assert got["migrations"] == 1 and got["queueing_delay"]["n"] == 5
    assert len(got["profiles"]) == 6 and len(got["verdicts"]) == 6
    for line in got["profiles"]:
        assert f"  {line}\n" in ref
    assert (tmp_path / "port.json").exists()


@pytest.mark.parametrize("name", ["quickstart", "gang_placement",
                                  "preemptive_cluster", "trace_viewer",
                                  "shared_cluster", "train_100m"])
def test_an_example_needs_a_card_unless_the_cpu_is_asked_for(name,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
