"""The port's Rodinia workloads and paper scripts against the JAX
package's: each kernel family computes what the JAX function does, a seed
draws the same jobs, the probed vectors keep the families' personalities,
and the port's Table II and Fig. 5 pass the bands the reference passes."""
import contextlib
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _worker_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import workloads as JW  # noqa: E402
from repro_torch.bench import common as TC  # noqa: E402
from repro_torch.bench import fig5_throughput as T5  # noqa: E402
from repro_torch.bench import table2_crashes as T2  # noqa: E402
from repro_torch.core import workloads as TW  # noqa: E402
from repro_torch.core.probe import TensorSpec, trace_counts  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
GB = 1024**3
CPU = torch.device("cpu")


def _inputs(family, rng):
    u = lambda *s: rng.uniform(-1.0, 1.0, s).astype(np.float32)  # noqa
    if family == "backprop":
        return u(48, 64), u(64, 64) * 0.2, u(64, 32) * 0.2
    if family == "srad":
        return (rng.uniform(0.5, 1.5, (40, 56)).astype(np.float32),)
    if family == "lavamd":
        return u(5, 16, 3), u(16)
    if family == "needle":
        return (u(24, 40),)
    if family == "dwt2d":
        return (u(32, 48),)
    if family == "bfs":
        return ((rng.uniform(0, 1, (64, 64)) < 0.1).astype(np.float32),
                (rng.uniform(0, 1, 64) < 0.1).astype(np.float32))
    raise KeyError(family)


@pytest.mark.parametrize("family", ["backprop", "srad", "lavamd", "needle",
                                    "dwt2d", "bfs"])
def test_kernel_family_computes_the_jax_function(family):
    """Same seeded f32 inputs through the JAX family and the port's:
    outputs within rtol 1e-5 (atol 1e-6 for values near zero). backprop's
    backward is written out as products in the port and taken by
    ``jax.grad`` in the reference."""
    args = _inputs(family, np.random.default_rng(0))
    want = getattr(JW, f"_k_{family}")(*map(jnp.asarray, args))
    got = getattr(TW, f"_k_{family}")(*map(torch.from_numpy, args))
    want = jax.tree_util.tree_leaves(want)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def _draws(seed, n_jobs, ratio):
    """The (family, footprint, duration target) each job of ``make_mix``
    draws, in submission order, replayed on the reference's generator."""
    rng = np.random.default_rng(seed)
    lg, sm = ratio
    out = []
    for i in range(n_jobs):
        large = (i % (lg + sm)) < lg
        fam = rng.choice(JW.LARGE_FAMILIES if large else JW.SMALL_FAMILIES)
        lo, hi = JW.LARGE_RANGE if large else JW.SMALL_RANGE
        foot = int(rng.uniform(lo, hi) / (0.5 * GB)) * int(0.5 * GB)
        out.append((str(fam), foot, rng.uniform(*JW.TARGET_JOB_SECONDS)))
    order = rng.permutation(n_jobs)
    return [out[i] for i in order]


def _tag(name):
    return sum(ord(c) * 31 ** i for i, c in enumerate(name)) % 1000


@pytest.mark.parametrize("mix", ["W1", "W2", "W3", "W4", "W5", "W6", "W7",
                                 "W8", (123, 32, (5, 1)), (7, 16, (1, 1))])
def test_a_seed_draws_the_references_jobs(mix):
    """``workload``/``make_mix`` give the reference's jobs in the
    reference's order: the same names, families and footprint grid points,
    the same duration targets (to 1e-9), each job's footprint within 25% of
    its target, and demands from the same family."""
    if isinstance(mix, str):
        n, ratio = JW.WORKLOADS[mix]
        seed = _tag(mix)
        port, ref = TW.workload(mix, device="cpu"), JW.workload(mix)
    else:
        seed, n, ratio = mix
        port = TW.make_mix(seed, n, ratio, device="cpu")
        ref = JW.make_mix(seed, n, ratio)
    draws = _draws(seed, n, ratio)
    assert [j.name for j in port] == [j.name for j in ref]
    assert [j.tasks[0].name for j in port] == [j.tasks[0].name for j in ref]
    for job, (fam, foot, tgt) in zip(port, draws):
        vec = job.tasks[0].resources
        assert job.tasks[0].name == f"{fam}-{foot // GB}G"
        assert vec.est_seconds == pytest.approx(tgt, rel=1e-9)
        assert 0.75 <= vec.hbm_bytes / foot <= 1.25
        core, bw = TW.EFFICIENCY[fam]
        if fam == "backprop":
            assert vec.core_demand == pytest.approx(core)
        else:
            assert vec.core_demand == 0.01
            assert vec.bw_demand == pytest.approx(bw)


@pytest.mark.parametrize("footprint_gb", [2, 8])
@pytest.mark.parametrize("family", sorted(TW.EFFICIENCY))
def test_probed_family_keeps_the_references_personality(family,
                                                        footprint_gb):
    """Probed on fake tensors (nothing allocated), each family's vector has
    the reference's demands: backprop compute-bound at its core efficiency
    (its bandwidth demand within 25% of the reference's: eager bytes and
    the H100's peaks against XLA's fused bytes and v5e's), every other
    family bandwidth-bound at its bandwidth efficiency; the footprint lands
    within 25% of the target in both packages."""
    foot = footprint_gb * GB
    port = TW._probe_family(family, foot, CPU)
    ref = JW._probe_family(family, foot)
    assert 0.75 <= port.hbm_bytes / foot <= 1.25
    assert 0.75 <= ref.hbm_bytes / foot <= 1.25
    assert port.core_demand == pytest.approx(ref.core_demand, abs=1e-3)
    if family == "backprop":
        assert port.core_demand == pytest.approx(0.85)
        assert 0.8 <= port.bw_demand / ref.bw_demand <= 1.25
    else:
        assert port.core_demand == 0.01
        assert port.bw_demand == pytest.approx(TW.EFFICIENCY[family][1])
        assert port.bw_demand == pytest.approx(ref.bw_demand, abs=1e-3)


@pytest.mark.parametrize("side", [256, 384])
def test_needle_extension_equals_a_full_trace(side):
    """needle's probe traces a few rows and extends linearly: flops, bytes
    and footprint equal those of the whole scan traced."""
    spec = TensorSpec((side, side), torch.float32, CPU)
    full = trace_counts(TW._k_needle, spec)
    vec = TW._needle_vector(side, CPU)
    assert vec.hbm_bytes == full["hbm_bytes"]
    assert vec.flops == pytest.approx(full["flops"], rel=1e-12, abs=0)
    assert vec.bytes_accessed == pytest.approx(full["bytes_accessed"],
                                               rel=1e-12)


def test_workloads_need_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.workload("W1")
    assert TW.probe_device("cpu") == CPU


def _band_lines(run, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = run(**kw)
    lines = [ln.strip() for ln in buf.getvalue().splitlines()
             if ln.strip().startswith(("PASS", "MISS"))]
    return out, {ln.split(":", 1)[0].split(" ", 1)[1]: ln.split()[0]
                 for ln in lines}


@pytest.mark.parametrize("script", ["table2_crashes", "fig5_throughput"])
def test_paper_script_passes_the_bands_the_reference_passes(
        script, tmp_path, monkeypatch):
    """The port's Table II and Fig. 5, at the paper's full job counts on
    its two systems, against the reference scripts run here: every band
    the reference passes, the port passes."""
    monkeypatch.syspath_prepend(ROOT)
    import importlib
    ref_common = importlib.import_module("benchmarks.common")
    ref = importlib.import_module(f"benchmarks.{script}")
    monkeypatch.setattr(ref_common, "RESULTS_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(TC, "RESULTS_DIR", str(tmp_path / "port"))
    port_mod = {"table2_crashes": T2, "fig5_throughput": T5}[script]
    _, want = _band_lines(ref.run)
    out, got = _band_lines(port_mod.run, device="cpu")
    assert set(got) == set(want) and len(want) == 4
    assert [b for b, s in want.items() if s == "PASS"] \
        == [b for b, s in got.items() if s == "PASS"]
    assert os.listdir(tmp_path / "port") == [f"{script.split('_')[0]}.json"]
    assert set(out) >= {"2xP100", "4xV100"}
