"""The port's dry run and roofline (``repro_torch.launch.{dryrun,
roofline}``) against the JAX package's, and the serving steps the dry run
traces (``serve.decode.make_serve_step``, ``abstract_cache``).

  * Reduced cells (gemma2-9b train, mixtral-8x7b train with E = 4 on a
    2-wide ``model`` axis: expert parallel; zamba2-2.7b prefill; gemma2-9b
    decode at batch 1, context-parallel; shapes at seq 64, batch 4 or 1)
    on a (2, 2) ``("data", "model")`` mesh: the reference's ``lower_cell``
    compiled on 4 host devices with its production mesh (Auto axes),
    ``get_arch`` and ``get_shape`` swapped, and the port's on a fake
    process group of 4 ranks with the same swaps, each in a process of its
    own, started together (``tests/_dryrun_cells.py``). Equal: parameter
    counts, chips, the analytic and model flops; argument bytes a device
    equal but for one named departure (a train step's ``opt_state.step``,
    the reference's int32 array, 4 B, the port's Python int). The port's
    peak a device is at least its arguments; its ratio to XLA's peak is
    printed, not asserted (ROADMAP C22).
  * Each collective kind: the port's ``collective_bytes`` of one counted
    collective equals the reference's on a hand-written HLO line of the
    same op and shapes.
  * Per device, not global: a product batch-sharded over the 4 ranks
    counts a quarter of the global flops (which a mode around the DTensor
    op sees) and a quarter of the global bytes as its peak.
  * ROADMAP C19: the reference's ``lower_cell`` on a mesh of
    ``jax.make_mesh``'s default (Explicit) axes raises its ValueError.
  * In process: ``abstract_cache`` against the reference's for every
    arch, ``model_flops`` for every cell, the roofline's terms on the
    card's constants, and one ``make_serve_step`` step against the
    reference's on reduced gemma2-9b (logits within 2e-3).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ALL_SHAPES  # noqa: E402
from repro.configs.registry import ARCHS, get_arch  # noqa: E402
from repro.launch import roofline as JRL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import decode as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_arch as port_arch  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.serve import decode as TS  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import _dryrun_cells as CELLS  # noqa: E402

CELL_NAMES = [f"{a}:{s}" for a, s in CELLS.CELLS]
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Both sides' results: (reference, port)."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), HERE]), JAX_PLATFORMS="cpu",
        OMP_NUM_THREADS="2")
    procs = {side: subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_dryrun_cells.py"), side,
         str(out / f"{side}.json")],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
        if side == "ref" else env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for side in ("ref", "port")}
    res = {}
    for side, p in procs.items():
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"{side} dry run past {TIMEOUT_S} s")
        assert p.returncode == 0, err[-3000:]
        with open(out / f"{side}.json") as f:
            res[side] = json.load(f)
    return res["ref"], res["port"]


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_dry_run_cells_agree_with_the_references_compiled_numbers(cells,
                                                                  cell):
    ref, port = (side["cells"][cell] for side in cells)
    for key in ("params_total", "params_active", "chips"):
        assert port[key] == ref[key], key
    for key in ("analytic_flops_global", "model_flops"):
        assert port["roofline"][key] == ref["roofline"][key], key
    # per-device argument bytes: equal, but for the named departure
    departure = {"opt_state.step": 4} if cell.endswith(":train") else {}
    assert port["memory"]["argument_bytes"] + sum(departure.values()) \
        == ref["memory"]["argument_bytes"], (port["by_input"], departure)
    assert sum(port["by_input"].values()) == port["memory"]["argument_bytes"]
    mem = port["memory"]
    assert mem["peak_per_device"] >= mem["argument_bytes"]
    assert mem["fits_80GB"] and port["roofline"]["dominant"]
    print(f"{cell}: peak a device {mem['peak_per_device']:.0f} B, XLA's "
          f"{ref['memory']['peak_per_device']:.0f} B (ratio "
          f"{mem['peak_per_device'] / ref['memory']['peak_per_device']:.3f})")


def test_expert_parallel_cell_moves_no_expert_over_model(cells):
    _, port = cells
    assert port["cells"]["mixtral-8x7b:train"]["expert_bytes_over_model"] == 0


@pytest.mark.parametrize("kind", [k for k, _, _ in CELLS.COLLECTIVES])
def test_collective_bytes_equal_the_references_on_one_collective(cells,
                                                                 kind):
    ref, port = cells
    assert port["collectives"][kind] == ref["collectives"][kind]
    src, dst = next((s, d) for k, s, d in CELLS.COLLECTIVES if k == kind)
    assert port["collective_shapes"][kind] == [[list(src), list(dst)]]


def test_counts_are_per_device_not_global(cells):
    got = cells[1]["per_device"]
    assert got["local_shapes"] == [[1, 64, 64], [1, 64, 224]]
    assert got["flops"] * 4 == got["global_flops"] == 2 * 4 * 64 * 64 * 224
    assert got["peak"] * 4 == got["global_bytes"]


def test_reference_dry_run_refuses_its_explicit_production_mesh(cells):
    """ROADMAP C19: ``jax.make_mesh`` makes Explicit axes by default on
    jax 0.9.0, and ``with_sharding_constraint`` refuses them."""
    kind, msg = cells[0]["c19"]
    assert kind == "ValueError"
    assert "can only refer to Auto axes" in msg


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_cache_equals_the_references(arch):
    cfg, tcfg = get_arch(arch), port_arch(arch)
    want = JS.abstract_cache(cfg, 4, 256)
    got = TS.abstract_cache(tcfg, 4, 256)
    assert set(got) == set(want)
    for key, spec in got.items():
        assert spec.shape == tuple(want[key].shape), key
        assert str(spec.dtype).split(".")[-1] == str(want[key].dtype), key
        assert spec.device == torch.device("cpu")


def test_model_flops_equal_the_references_on_every_cell():
    for arch in ARCHS:
        for shape in ALL_SHAPES:
            assert RL.model_flops(port_arch(arch), shape) \
                == JRL.model_flops(get_arch(arch), shape)


def test_roofline_terms_use_the_cards_constants():
    r = RL.Roofline(hlo_flops_per_device=0.0, analytic_flops_global=989e12,
                    bytes_per_device=3.35e12, collective_per_device=900e9,
                    coll_breakdown={}, peak_mem_per_device=1.0, chips=2,
                    model_flops=494.5e12).finalize()
    assert (r.compute_s, r.memory_s, r.collective_s) == (0.5, 1.0, 2.0)
    assert r.dominant == "collective" and r.roofline_fraction == 0.125
    assert r.useful_ratio == 0.5
    assert RL.peak_flops(torch.float32) == 67e12
    assert RL.peak_flops(torch.bfloat16) == 989e12
    assert RL.HBM_BYTES == 80e9


@pytest.mark.parametrize("arch,ranks", [("mixtral-8x7b", 1), ("mixtral-8x7b", 2),
                                        ("mixtral-8x7b", 4), ("dbrx-132b", 2)])
def test_expert_slices_sum_to_the_whole_layer(arch, ranks):
    """``expert_slice_apply`` over a partition of the experts into
    ``ranks`` slices (each slice's weights alone): the shares sum to
    ``moe_apply``'s output within 1e-5 (f32; the grouped matmul's plain
    version on the CPU, summed in another order)."""
    from repro_torch.models.model import init_params
    from repro_torch.models.moe import expert_slice_apply, moe_apply
    cfg = port_arch(arch).reduced()
    p = init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                    torch.device("cpu"))["layers"][0]["moe"]
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    whole, _ = moe_apply(p, x, cfg.moe, cfg.mlp_act)
    e = cfg.moe.num_experts
    share = e // ranks
    total = sum(expert_slice_apply(
        {"router": p["router"], **{k: v[lo:lo + share] for k, v in p.items()
                                   if k != "router"}},
        x, cfg.moe, cfg.mlp_act, lo, lo + share)
        for lo in range(0, e, share))
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)


def test_serve_step_is_one_decode_step_and_matches_jax():
    cfg, tcfg = get_arch("gemma2-9b").reduced(), port_arch("gemma2-9b") \
        .reduced()
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 32),
                                            dtype=np.int32)
    jl, jc = JS.make_prefill_step(cfg, attn_impl="flash_jnp")(
        params, {"tokens": jnp.asarray(tok)})
    tl, tc = TS.make_prefill_step(tcfg)(tparams,
                                        {"tokens": torch.from_numpy(tok)})
    nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    want, _ = JS.make_serve_step(cfg)(params, jc, jnp.asarray(nxt),
                                      jnp.asarray(31, jnp.int32))
    step = TS.make_serve_step(tcfg)
    got, cache = step(tparams, tc, torch.from_numpy(nxt.copy()),
                      torch.tensor(31, dtype=torch.int32))
    assert cache is tc
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
