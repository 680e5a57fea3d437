"""The NN half of the port's workloads (§V-E, Fig. 6) against the JAX
package's: each kind's vector probed from the port's own steps on fake
tensors, the seeded mix's draws, and Fig. 6's bands on the CPU.

Flops: predict and train take ``launch/flops.py``'s analytic counts in both
packages, and detect is half of predict's, so those are equal to 1e-9.
generate's flops are traced in both: the reference's from XLA's
``cost_analysis``, which counts the body of the scan over layers once
(``launch/flops.py``'s docstring), the port's from ``FlopCounterMode`` over
every layer, so the port's count is held against the analytic decode count
(within 25%: the analytic model leaves out the int8 cache's scaling) and
printed beside the reference's. Bytes and footprints are eager PyTorch's
against XLA's fused program: printed, not compared; the demands each kind's
``efficiency`` pins (the bandwidth demand of memory-bound kinds, detect's
fixed demands) are equal.
"""
import contextlib
import io
import os

import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

from repro.core import workloads as JW  # noqa: E402
from repro_torch.bench import common as TC  # noqa: E402
from repro_torch.bench import fig6_nn_schedgpu as T6  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import workloads as TW  # noqa: E402
from repro_torch.launch.flops import step_flops  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CPU = torch.device("cpu")
FIELDS = ("hbm_bytes", "flops", "bytes_accessed", "est_seconds",
          "core_demand", "bw_demand")


@pytest.mark.parametrize("kind", ["predict", "train", "detect", "generate"])
def test_nn_vector_against_the_reference(kind):
    got, want = TW._nn_vector(kind, CPU), JW._nn_vector(kind)
    print(f"{kind}: " + ", ".join(
        f"{f} port {getattr(got, f):.6g} / ref {getattr(want, f):.6g}"
        for f in FIELDS))
    if kind == "generate":
        cfg = get_arch("musicgen-large").reduced()
        analytic = step_flops(cfg, ShapeConfig("g", 512, 8, "decode"))
        assert got.flops / 20000.0 == pytest.approx(analytic, rel=0.25)
        assert got.flops > want.flops  # the reference counts one layer
        assert got.bw_demand == pytest.approx(want.bw_demand, rel=1e-9)
    else:
        assert got.flops == pytest.approx(want.flops, rel=1e-9)
    if kind == "detect":
        for f in ("hbm_bytes", "core_demand", "bw_demand"):
            assert getattr(got, f) == getattr(want, f)
    if kind in ("predict", "train"):
        assert got.bw_demand == pytest.approx(want.bw_demand, rel=1e-9)
    assert got.hbm_bytes > 0 and got.est_seconds > 0


def test_train_vector_traces_the_backward():
    """train's job is probed from the whole step at its shape (bf16
    weights, f32 moments): forward, backward and update, at least 2.5x
    the forward's traced flops."""
    from repro_torch.core.probe import trace_counts
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.model import loss_fn
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (abstract_train_state,
                                              make_train_step)
    cfg, opt = get_arch("gemma2-9b").reduced(), AdamWConfig()
    params, opts = abstract_train_state(cfg, opt)
    batch = input_specs(cfg, ShapeConfig("nn_train", 512, 16, "train"))
    step = trace_counts(make_train_step(cfg, opt), params, opts, batch)
    fwd = trace_counts(lambda p, b: loss_fn(p, cfg, b), params, batch)
    assert step["flops"] >= 2.5 * fwd["flops"]


def test_nn_mix_draws_the_references_kinds():
    got = [j.name for j in TW.nn_mix(3, 128, "cpu")]
    want = [j.name for j in JW.nn_mix(3, 128)]
    assert got == want
    job = TW.make_nn_job("train", 0, "cpu")
    assert job.tasks[0].units[0].resources.hbm_bytes == TW._NN_MEM["train"]


def test_nn_jobs_need_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.make_nn_job("predict", 0)


def _bands(run, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = run(**kw)
    text = buf.getvalue()
    print(text)
    return out, {ln.split(":", 1)[0].split(" ", 1)[1]: ln.split()[0]
                 for ln in map(str.strip, text.splitlines())
                 if ln.startswith(("PASS", "MISS"))}


def test_fig6_bands_on_the_cpu(tmp_path, monkeypatch):
    """The port's Fig. 6 beside the reference's, both printed with their
    PASS/MISS lines: the homogeneous ratios depend only on the demands,
    which are the reference's, so they equal the reference's within 2%;
    the 128-job mix also weighs the kinds' durations, which eager bytes
    move (printed, not enforced, as the reference does)."""
    monkeypatch.syspath_prepend(ROOT)
    import importlib
    ref_common = importlib.import_module("benchmarks.common")
    ref = importlib.import_module("benchmarks.fig6_nn_schedgpu")
    monkeypatch.setattr(ref_common, "RESULTS_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(TC, "RESULTS_DIR", str(tmp_path / "port"))
    want, want_bands = _bands(ref.run)
    got, got_bands = _bands(T6.run, device="cpu")
    assert set(got_bands) == set(want_bands) and len(got_bands) == 5
    for kind in TW.NN_KINDS:
        assert got["rows"][kind]["mgb_over_schedgpu"] == pytest.approx(
            want["rows"][kind]["mgb_over_schedgpu"], rel=0.02)
    assert got["mix128_mgb_over_sa"] > 1.0
    assert os.listdir(tmp_path / "port") == ["fig6.json"]


def test_train_bytes_gap_is_the_references_materialised_scores():
    """ROADMAP C13, a departure: the train job's probed bytes are the port's
    own traffic, not the reference's. The reference compiles its step with
    ``attn_impl="flash_jnp"``, whose key block (512) is the whole key range
    at S = 512, so XLA's program materialises the score matrices; the port
    probes its fused flash op, which reads q, k, v and writes o and lse.
    The same step traced through the port's materialising paths
    (``flash_plain``, ``naive``) counts more than XLA: eager PyTorch counts
    every elementwise pass over the scores, which XLA fuses into one. So
    the reference's count lies between the port's fused and materialising
    counts, and no closer tolerance exists between the two frameworks."""
    from repro_torch.core.probe import trace_counts
    from repro_torch.launch.specs import input_specs
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (abstract_train_state,
                                              make_train_step)
    cfg, opt = get_arch("gemma2-9b").reduced(), AdamWConfig()
    params, opts = abstract_train_state(cfg, opt, device=CPU)
    batch = input_specs(cfg, ShapeConfig("nn_train", 512, 16, "train"), CPU)
    port = {impl: trace_counts(make_train_step(cfg, opt, attn_impl=impl),
                               params, opts, batch)["bytes_accessed"]
            for impl in ("flash_kernel", "flash_plain", "naive")}
    # the reference's vector is XLA's cost analysis x work_scale (250)
    xla = JW._nn_vector("train").bytes_accessed / 250.0
    print("train step bytes accessed, unscaled: XLA (flash_jnp) "
          f"{xla:.5g}; port " + ", ".join(f"{k} {v:.5g}"
                                          for k, v in port.items()))
    assert port["flash_kernel"] < xla
    assert port["flash_plain"] > xla and port["naive"] > xla
    # the job's own probe is the fused count
    assert TW._nn_vector("train", CPU).bytes_accessed == pytest.approx(
        250.0 * port["flash_kernel"], rel=1e-9)
