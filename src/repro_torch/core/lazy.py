"""Lazy runtime: device-independent buffers with deferred binding.

Port of ``src/repro/core/lazy.py``. Paper §III-A2: statically-unbound memory
ops are replaced by lazy ops that record into a per-buffer queue under a
*pseudo-address*; just before a kernel launch, ``kernelLaunchPrepare``
replays the queues on the device the scheduler picked and patches the real
addresses in.

``LazyBuffer`` records (alloc / h2d / fill) ops against host-side state;
``bind(device)`` replays them onto the scheduler-chosen ``torch.device``. A
bare alloc binds as zeros (deterministic, like cudaMalloc + memset).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_pseudo_addr = itertools.count(0x1000)


@dataclasses.dataclass
class _Op:
    kind: str                     # alloc | h2d | fill
    payload: Any = None


class LazyBuffer:
    """A memory object with a pseudo-address and a recorded op queue."""

    def __init__(self, name: str = ""):
        self.pseudo = next(_pseudo_addr)
        self.name = name or f"buf@{self.pseudo:#x}"
        self.ops: List[_Op] = []
        self.shape: Optional[Tuple[int, ...]] = None
        self.dtype: Optional[torch.dtype] = None
        self.device: Optional[torch.device] = None
        self._real: Optional[torch.Tensor] = None

    # -- recorded (lazy) operations --------------------------------------
    def alloc(self, shape: Sequence[int],
              dtype: torch.dtype = torch.float32) -> "LazyBuffer":
        """lazyMalloc: record the allocation; nothing touches a device."""
        self.shape, self.dtype = tuple(shape), dtype
        self.ops.append(_Op("alloc"))
        return self

    def h2d(self, host_array: np.ndarray) -> "LazyBuffer":
        """lazy cudaMemcpyHostToDevice."""
        host_array = np.asarray(host_array)
        if self.shape is None:
            self.alloc(host_array.shape,
                       torch.from_numpy(host_array[:0].copy()).dtype)
        self.ops.append(_Op("h2d", host_array))
        return self

    def fill(self, value) -> "LazyBuffer":
        """lazy cudaMemset."""
        self.ops.append(_Op("fill", value))
        return self

    @property
    def nbytes(self) -> int:
        if self.shape is None:
            return 0
        return int(np.prod(self.shape, dtype=np.int64)) * \
            torch.empty((), dtype=self.dtype).element_size()

    # -- replay -----------------------------------------------------------
    def bind(self, device) -> torch.Tensor:
        """Replay the recorded queue on ``device``; return the real tensor."""
        device = torch.device(device)
        if self._real is not None and self.device == device:
            return self._real
        if self.shape is None:
            raise RuntimeError(f"{self.name}: bind before alloc")
        arr: Optional[torch.Tensor] = None
        for op in self.ops:
            if op.kind == "alloc":
                arr = None  # realised by the first write below
            elif op.kind == "h2d":
                arr = torch.as_tensor(op.payload).to(device=device,
                                                     dtype=self.dtype)
            elif op.kind == "fill":
                arr = torch.full(self.shape, op.payload, dtype=self.dtype,
                                 device=device)
        if arr is None:  # bare alloc: zeros
            arr = torch.zeros(self.shape, dtype=self.dtype, device=device)
        self._real = arr
        self.device = device
        return arr

    def free(self):
        """cudaFree: drop the device reference (post-dominator of the task)."""
        self._real = None
        self.device = None

    def d2h(self) -> np.ndarray:
        if self._real is None:
            raise RuntimeError(f"{self.name}: d2h before bind")
        return self._real.cpu().numpy()

    def __repr__(self):
        return (f"LazyBuffer({self.name}, {self.shape}, {self.dtype}, "
                f"bound={self._real is not None})")


def kernel_launch_prepare(buffers: Dict[str, LazyBuffer], device
                          ) -> Dict[str, torch.Tensor]:
    """Paper's ``kernelLaunchPrepare``: replay every buffer queue on the
    scheduler-chosen device, returning pseudo-address -> real tensor."""
    return {name: buf.bind(device) for name, buf in buffers.items()}


def free_all(buffers: Dict[str, LazyBuffer]) -> None:
    for buf in buffers.values():
        buf.free()
