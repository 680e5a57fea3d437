"""The port's static serving entry point, and the port's independence from
the JAX package: ``repro_torch`` imports neither ``jax`` nor ``repro``."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serve.decode import (  # noqa: E402
    greedy_generate, make_prefill_step,
)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PORT = os.path.join(ROOT, "src", "repro_torch")


def test_serve_gemma2_on_cpu_completes_every_batch():
    res = serve("gemma2-9b", device="cpu")
    assert res["batches"] == 4 and res["completed"] == 4
    assert res["crashed"] == 0 and res["errors"] == []
    assert res["tokens_generated"] == 16 * 32
    assert res["p50_ttft_s"] > 0 and res["p50_tpot_s"] > 0
    assert res["probe"].hbm_bytes > 0 and res["probe"].flops > 0
    assert [g.shape for g in res["generated"]] == [(4, 32)] * 4


def test_serve_tokens_equal_a_direct_run():
    """What the scheduled runner generates is what prefill -> pad ->
    greedy decode gives when called directly on the same weights."""
    res = serve("llama3-405b", device="cpu", requests=3, batch=2,
                prompt_len=16, gen_len=5, seed=3)
    assert res["completed"] == 2 and res["tokens_generated"] == 3 * 5
    cfg = get_arch("llama3-405b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(3),
                         torch.float32, torch.device("cpu"))
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16),
                                        dtype=np.int64))
    logits, cache = make_prefill_step(cfg)(params, {"tokens": tok})
    first = torch.argmax(logits, -1).to(torch.int32)
    full = D.cache_insert(D.init_cache(cfg, 2, 21, device="cpu"), cache, 0)
    out, _ = greedy_generate(cfg, params, full, first, 16, 4)
    want = torch.cat([first[:, None], out], 1).numpy()
    np.testing.assert_array_equal(res["generated"][0], want)
    assert res["generated"][1].shape == (1, 5)  # padding row not served


def test_serve_without_a_card_needs_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve("gemma2-9b", requests=1, batch=1, prompt_len=4, gen_len=2)


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.core, repro_torch.obs; print('ok')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_of_the_port_imports_jax_or_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert bad == []
