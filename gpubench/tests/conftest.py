"""The benchmark's own tests run from the repository root:

    PYTHONPATH=src:. python -m pytest -q gpubench/tests

They import the port (``src/repro_torch``) and nothing of the JAX
package."""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
torch.set_num_threads(2)
