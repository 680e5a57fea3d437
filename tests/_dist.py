"""What the port's multi-rank distribution tests share
(``tests/test_torch_dist*.py``): starting the gloo ranks of a case of
``_dist_ranks.py`` and waiting for them under one deadline, and the step's
settings. Each test file starts only its own cases, so xdist can run the
three files' ranks on three workers at once.
"""
import os
import pickle
import sys

from _spawn import spawn, tail, wait

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STEPS, WORLD = 2, 4
# every spawn's deadline, from the fixture's start: inside ``conftest.py``'s
# 300 s guard a test, so a late rank fails with its log, not its worker
SPAWN_TIMEOUT_S = 280


def _launch(case, workdir, world=WORLD):
    """Start the ``world`` rank processes of ``case`` (not waited for);
    rank r's output goes to ``<case>.<r>.log`` in ``workdir``."""
    store = os.path.join(workdir, f"{case}.store")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), HERE]))
    return [spawn(
        [sys.executable, os.path.join(HERE, "_dist_ranks.py"), case,
         str(r), str(world), store, workdir],
        os.path.join(workdir, f"{case}.{r}.log"), env)
        for r in range(world)]


def _wait(procs, case, workdir, deadline):
    """Every rank by ``deadline`` (a ``time.monotonic()`` value); every
    rank must exit 0. Returns rank 0's results."""
    errs = []
    for r, p in enumerate(procs):
        log = os.path.join(workdir, f"{case}.{r}.log")
        rc = wait(p, log, deadline, f"{case}: rank {r}")
        if rc:
            errs.append(f"rank {r} rc {rc}: {tail(log)}")
    assert not errs, "\n".join(errs)
    with open(os.path.join(workdir, f"{case}.pkl"), "rb") as f:
        return pickle.load(f)
