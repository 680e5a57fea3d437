"""Build the port's CUDA sources with ``nvcc`` at first use and load them with
``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C function and compiles on its own into
``<repo>/build/kernels/<name>-<hash>.so`` (``/build/`` is git-ignored), for
``sm_90a``. The hash covers the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing here runs at import:
``load`` builds on the first call of a kernel's wrapper, and ``build_all``
starts one ``nvcc`` per source, all at once, for a caller that wants every
kernel ready up front (``chip_smoke.py``).

This is the route that keeps PyTorch's headers out of the build (seconds per
source instead of minutes); pointers and the stream cross as Python ints.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("rmsnorm", "flash_attention")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: the build log lists each kernel's registers, shared memory
# and spills
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_fns: Dict[str, ctypes._CFuncPtr] = {}


class LaunchCounter:
    """Thread-safe count of kernel launches: a wrapper adds one where it
    launches its kernel, and nowhere else (pool threads launch concurrently,
    so a bare ``+= 1`` could lose updates)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): the "
                       "port's CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(ARCH_FLAGS + FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together. Returns name -> compiler output for the sources
    it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *ARCH_FLAGS, *FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<name>.cu``, built first if
    needed, with its ``argtypes`` declared (a pointer or stream passes as
    ``c_void_p``: left undeclared, ctypes would cut it to 32 bits)."""
    fn = _fns.get(symbol)
    if fn is not None:
        return fn
    with _lock:
        fn = _fns.get(symbol)
        if fn is None:
            path = _target(name)
            if not path.exists():
                build_all([name])
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[symbol] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
