"""Compiler-guided probes for PyTorch: derive a task's ResourceVector by
tracing its step on fake tensors — the analogue of the paper's instrumented
``task_begin(mem, threads, blocks)``.

Port of ``src/repro/core/probe.py``. The reference reads XLA's compiled
artifact (``memory_analysis``/``cost_analysis``); eager PyTorch has none, so
``probe_fn`` runs the step once under ``FakeTensorMode``: every op computes
shapes and dtypes only, nothing is allocated on the card. During that trace

  * ``hbm_bytes`` = the bytes of the arguments + the peak of bytes allocated
    by the step and still live (outputs included, since they are live at
    the end) — the counterpart of XLA's argument + temp + output − alias sum
    — + ``CUDA_UNSEEN_BYTES`` for each thread that runs the step's ops when
    the arguments live on a card: what the libraries the step calls
    allocate there that no fake tensor shows (a step with a backward runs
    it on the autograd engine's device thread, whose cuBLAS handle keeps a
    workspace of its own);
  * ``flops`` comes from ``torch.utils.flop_counter.FlopCounterMode``. The
    port's hand kernels are custom ops with fake implementations, and flash
    attention registers a flop formula (``4·B·Hq·visible pairs·D``), so the
    count covers matmuls and attention;
  * ``bytes_accessed`` sums the bytes each op reads and writes, as XLA's
    "bytes accessed" does per HLO op; views and metadata queries move none.

The arithmetic of ``vector_from_compiled`` is kept (``vector_from_counts``),
with H100 SXM datasheet peaks in place of the v5e constants. Probes are
cached by (fn, shape signature), as the reference caches compilations. An
argument may be a ``TensorSpec`` (shape, dtype, device and no data, the
reference's ``jax.ShapeDtypeStruct``): the trace takes a fake tensor in its
place, so a probe at a multi-GB footprint allocates nothing anywhere.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.task import ResourceVector

# What a step allocates on a card that its fake-tensor trace cannot see: the
# first matrix product on a stream makes cuBLAS's workspace for that stream
# through PyTorch's caching allocator (32 MiB on Hopper), and reductions and
# sorts take a little scratch. Measured with the allocator's history over
# one batch of each served model alone (tools/probe_memory.py, NVIDIA H100
# 80GB HBM3, 700 W): the task's peak above the weights exceeded the traced
# live peak by at most 34,341,372 B (falcon-mamba-7b, the first task on its
# stream; 1,671,676 B for gemma2-9b and 508 B for mixtral-8x7b on a stream
# that had its workspace). Charged to every probe of work on a card, once
# for each thread that runs its ops, rounded up to 40 MiB.
CUDA_UNSEEN_BYTES = 40 << 20

# NVIDIA H100 SXM datasheet peaks (dense, 700 W): bf16 tensor-core rate,
# HBM3 bandwidth, and NVLink 4 bandwidth per direction to the other cards
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """An argument's shape, dtype and device, without data: what a probe
    needs of a tensor that is never allocated."""
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _LiveBytes(TorchDispatchMode):
    """Peak of live bytes allocated while tracing, the bytes every non-view
    op reads and writes, and the threads that ran ops. Storages are keyed
    by their StorageImpl and released when the last tensor seen on them
    dies (views share one entry); storages of the arguments are excluded
    (counted apart)."""

    def __init__(self, arg_keys: set):
        super().__init__()
        self._args = arg_keys
        self._refs: Dict[int, list] = {}   # storage key -> [tensors, bytes]
        self.live = 0
        self.peak = 0
        self.bytes_accessed = 0
        self.threads = set()

    def _release(self, key: int) -> None:
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args:
            return
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [0, st.nbytes()]
            self.live += ref[1]
            self.peak = max(self.peak, self.live)
        ref[0] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.threads.add(threading.get_ident())
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        # views move no bytes, nor do metadata queries (``prim.device``,
        # which indexing with a Python int asks of the whole tensor)
        if not getattr(func, "is_view", False) \
                and getattr(func, "namespace", None) != "prim":
            self.bytes_accessed += sum(
                _nbytes(t) for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)) + sum(map(_nbytes, outs))
        for t in outs:
            self._track(t)
        return out


def vector_from_counts(*, hbm_bytes: int, flops: float,
                       bytes_accessed: float, chips: int = 1,
                       flops_override: Optional[float] = None,
                       collective_bytes: float = 0.0,
                       work_scale: float = 1.0,
                       efficiency: Tuple[float, float] = (1.0, 1.0)
                       ) -> ResourceVector:
    """The reference's ``vector_from_compiled`` arithmetic over traced
    counts. ``efficiency`` = (core_eff, bw_eff): the fraction of peak
    compute / memory bandwidth the work achieves running solo."""
    flops = float(flops_override if flops_override is not None else flops)
    bytes_acc = float(bytes_accessed)
    core_eff, bw_eff = efficiency
    compute_s = flops / (chips * PEAK_FLOPS * core_eff)
    memory_s = bytes_acc / (HBM_BW * bw_eff)
    collective_s = collective_bytes / LINK_BW
    est = max(compute_s, memory_s, collective_s, 1e-9)
    compute_share = (flops / (chips * PEAK_FLOPS)) / est
    memory_share = (bytes_acc / HBM_BW) / est
    return ResourceVector(
        hbm_bytes=int(hbm_bytes),
        flops=flops * work_scale,
        bytes_accessed=bytes_acc * work_scale,
        collective_bytes=collective_bytes * work_scale,
        est_seconds=est * work_scale,
        core_demand=max(min(compute_share, 1.0), 0.01),
        bw_demand=max(min(memory_share, 1.0), 0.01),
        chips=chips,
    )


def trace_counts(fn: Callable, *args, uncharged: Sequence[int] = ()
                 ) -> Dict[str, float]:
    """Run ``fn(*args)`` once on fake copies of the tensor arguments (fake
    tensors of a ``TensorSpec``'s shape) and return {hbm_bytes, arg_bytes,
    peak_live_bytes, unseen_bytes, flops, bytes_accessed}.
    Nothing is allocated on any device. The arguments at the positions in
    ``uncharged`` are traced like the others but their bytes are left out of
    ``arg_bytes`` (shared state that something else already holds, such as
    the weights of a server whose decode loop charges them once); a storage
    that a charged argument shares is charged."""
    on_card = any(torch.device(t.device).type == "cuda"
                  for t in tree_leaves(args)
                  if isinstance(t, (torch.Tensor, TensorSpec)))
    fake = FakeTensorMode()

    def fake_arg(a):
        if isinstance(a, torch.Tensor):
            return fake.from_tensor(a)
        if isinstance(a, TensorSpec):
            with fake:
                return torch.empty(a.shape, dtype=a.dtype, device=a.device)
        return a

    fargs = tree_map(fake_arg, args)
    storages, charged = {}, set()
    for i, arg in enumerate(fargs):
        for t in tree_leaves(arg):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                storages[st._cdata] = st.nbytes()
                if i not in uncharged:
                    charged.add(st._cdata)
    arg_bytes = sum(storages[k] for k in charged)
    flop_mode = FlopCounterMode(display=False)
    live = _LiveBytes(set(storages))
    with torch.no_grad(), fake, flop_mode, live:
        out = fn(*fargs)
        del out
    # a cuBLAS workspace a thread: the caller's, and the autograd engine's
    # device thread where the step has a backward (chip_smoke's train step
    # alone: 69,075,960 B above the traced live peak for falcon-mamba-7b,
    # NVIDIA H100 80GB HBM3)
    unseen = CUDA_UNSEEN_BYTES * len(live.threads) if on_card else 0
    return {"hbm_bytes": arg_bytes + live.peak + unseen,
            "arg_bytes": arg_bytes, "peak_live_bytes": live.peak,
            "unseen_bytes": unseen,
            "flops": float(flop_mode.get_total_flops()),
            "bytes_accessed": float(live.bytes_accessed)}


_probe_cache: Dict[Tuple, Dict[str, float]] = {}


def _signature(args) -> Tuple:
    leaves, treedef = tree_flatten(args)
    return (treedef, tuple(
        (tuple(a.shape), str(a.dtype), a.device.type)
        if isinstance(a, torch.Tensor) else repr(a) for a in leaves))


def probe_fn(fn: Callable, *args: Any, uncharged: Sequence[int] = (),
             chips: int = 1, work_scale: float = 1.0,
             flops_override: Optional[float] = None,
             efficiency: Tuple[float, float] = (1.0, 1.0)) -> ResourceVector:
    """Probe ``fn`` on ``args`` (any nesting of dicts/lists/tuples of
    tensors; real tensors are only read for their metadata). This is the
    instrumented ``task_begin`` of the paper: called right before launch,
    it conveys the resource needs to the scheduler. ``uncharged``: the
    positions of arguments traced but not charged (``trace_counts``).
    Traced once per (fn, shape signature, uncharged)."""
    key = (id(fn), _signature(args), tuple(uncharged))
    counts = _probe_cache.get(key)
    if counts is None:
        counts = trace_counts(fn, *args, uncharged=uncharged)
        if len(_probe_cache) < 512:
            _probe_cache[key] = counts
    return vector_from_counts(
        hbm_bytes=counts["hbm_bytes"], flops=counts["flops"],
        bytes_accessed=counts["bytes_accessed"], chips=chips,
        flops_override=flops_override, work_scale=work_scale,
        efficiency=efficiency)
