"""Child processes of the port's tests.

Each child writes its output to a file of its own: a pipe that nobody
drains while the test waits on another child can fill and stop its
writer, and with it every rank that waits on that one in a collective.
All of a test's children are waited for under one deadline, and
``reaped`` kills and reaps every child still alive on any way out of the
test, a failure included, so none outlives it.
"""
import contextlib
import subprocess
import time

import pytest


def spawn(args, log, env):
    """Start ``args`` with stdout and stderr into the file ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen(args, env=env, stdout=f,
                                stderr=subprocess.STDOUT)


def tail(log, n=3000):
    with open(log, errors="replace") as f:
        return f.read()[-n:]


def wait(proc, log, deadline, what):
    """``proc``'s exit code, waited for until ``deadline`` (a
    ``time.monotonic()`` value); the test fails past it."""
    try:
        return proc.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{what}: still running at its deadline\n{tail(log)}")


@contextlib.contextmanager
def reaped(procs):
    """Yield ``procs`` (a list the body may extend); on leaving, kill every
    one still running and reap them all."""
    try:
        yield procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
