"""Checkpoint/restore for train state: the fault-tolerance substrate.

Port of ``src/repro/train/checkpoint.py`` over numpy, with the reference's
on-disk layout: one directory per step, ``step_<N:08d>/``, holding a
manifest (tree structure as text, shapes, dtypes) and one ``.npy`` per leaf
(``leaf_<i:05d>.npy``) in the tree's flatten order, committed by a
``COMMITTED`` marker after an atomic rename, so a crash mid-save never
corrupts the newest checkpoint. bf16 leaves are stored as their raw bits in
uint16, the manifest recording ``bfloat16``, as the reference's
``_to_storable`` does; a host int (the optimizer's ``step``) is stored as
int32, the reference's dtype. ``AsyncCheckpointer`` copies the state to the
host inline and writes it on a worker thread; it keeps that host copy, from
which ``AsyncCheckpointer.restore_into`` restores the step it last saved
without reading the disk. ``restore_into`` copies a
checkpoint into a state that already exists, leaf by leaf, so a resumed
task holds one copy of its state and a leaf's host staging, not two.

The port's tree flattens in ``torch.utils._pytree`` order (dicts in
insertion order), the reference's in JAX's (keys sorted, layers stacked on
[L]); ``repro_torch.convert.train_state_from_jax_leaves`` reads a checkpoint
the reference wrote (``restore_leaves``) into the port's state.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

_MANIFEST = "manifest.json"
_COMMIT = "COMMITTED"


def _leaf_path(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _to_storable(leaf) -> Tuple[np.ndarray, str]:
    """(array to ``np.save``, the dtype the manifest records)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf, np.int32 if isinstance(leaf, int) else None)
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype: str, like) -> Any:
    """A stored leaf back in the kind of ``like``: a tensor on like's
    device, or a host int."""
    if not isinstance(like, torch.Tensor):
        return int(arr)
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    # a copy in torch's own allocation: CPU matrix products may take
    # another summation path for numpy's less aligned buffers
    return t.to(like.device, copy=True)


def save(ckpt_dir: str, step: int, state: Any) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    leaves, treedef = tree_flatten(state)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    shapes, dtypes = [], []
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_storable(leaf)
        np.save(os.path.join(tmp, _leaf_path(i)), arr)
        shapes.append(list(arr.shape))
        dtypes.append(dtype)
    manifest = {"step": step, "treedef": str(treedef),
                "n_leaves": len(leaves), "shapes": shapes, "dtypes": dtypes}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(ckpt_dir, name, _COMMIT)):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_leaves(ckpt_dir: str, step: Optional[int] = None
                   ) -> Tuple[int, List[np.ndarray], dict]:
    """(step, the stored leaves as numpy arrays in flatten order with bf16
    as uint16 bits, the manifest) of a committed checkpoint (the newest
    when ``step`` is None), whichever package wrote it."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves = [np.load(os.path.join(d, _leaf_path(i)))
              for i in range(manifest["n_leaves"])]
    return step, leaves, manifest


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None
            ) -> Tuple[int, Any]:
    """Restore into the structure of ``like`` (a tree of tensors and host
    ints): each tensor lands on its ``like`` leaf's device."""
    step, arrays, manifest = restore_leaves(ckpt_dir, step)
    leaves_like, treedef = tree_flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"the state {len(leaves_like)}")
    out = []
    for i, (arr, ref) in enumerate(zip(arrays, leaves_like)):
        expect = tuple(getattr(ref, "shape", arr.shape))
        if arr.shape != expect:
            raise ValueError(f"leaf {i}: {arr.shape} != {expect}")
        out.append(_from_storable(arr, manifest["dtypes"][i], ref))
    return step, tree_unflatten(out, treedef)


def restore_into(ckpt_dir: str, state: Any, step: Optional[int] = None
                 ) -> Tuple[int, Any]:
    """Restore a committed checkpoint (the newest when ``step`` is None)
    into the tensors of ``state`` in place, one leaf at a time; host ints
    are replaced. Returns (step, the state)."""
    step, arrays, manifest = restore_leaves(ckpt_dir, step)
    leaves, treedef = tree_flatten(state)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"the state {len(leaves)}")
    out = []
    for i, (arr, ref) in enumerate(zip(arrays, leaves)):
        if not isinstance(ref, torch.Tensor):
            out.append(int(arr))
            continue
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"leaf {i}: {arr.shape} != {tuple(ref.shape)}")
        host = _from_storable(arr, manifest["dtypes"][i],
                              torch.empty(0, device="cpu"))
        if host.dtype != ref.dtype:
            raise ValueError(f"leaf {i}: {host.dtype} != {ref.dtype}")
        ref.copy_(host)
        out.append(ref)
    return step, tree_unflatten(out, treedef)


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` committed checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _on_card(x) -> bool:
    """Whether a leaf (a tensor or a ``TensorSpec``) lives on a card."""
    dev = getattr(x, "device", None)
    return dev is not None and torch.device(dev).type == "cuda"


class AsyncCheckpointer:
    """Overlap checkpoint writes with training compute.

    save(): the device->host copy happens inline, serialization on the
    worker thread. At most one write is in flight; a second save() waits
    for the first (backpressure rather than unbounded host memory growth).
    A card's tensors are copied into pinned host buffers made at the first
    save, or beforehand by ``reserve`` on a thread of its own, and kept for
    the checkpointer's life (the write reads them, and the next save waits
    for the write): a copy into pinned memory runs at the host link's rate,
    one into pageable memory at a fraction of it, and making the buffers
    takes longer than either (7.66e9 B on an H100 host, PERF.md §6: 0.17 s,
    3.5 s and 1.6 s), while an evicted training task holds the card until
    its copy is done.

    ``save(..., start=False)`` makes the copy and holds the write back
    until ``commit()`` or ``wait()``: a write in flight stalls ``cudaFree``
    for most of its length and slows the work beside it (PERF.md §6), so an
    evicted training task leaves its write to the attempt that resumes it
    (ROADMAP C15). That attempt restores the saved step from the host copy
    (``restore_into``; the write reads the same buffers, and the next save
    waits for the write before it copies over them), then commits the
    write, which runs beside its training.
    """

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_committed: Optional[int] = None
        # the last save's host bytes, seconds of its copy to the host and
        # seconds of its write (set when the write commits)
        self.nbytes = 0
        self.copy_s = 0.0
        self.write_s = 0.0
        self._pinned: List[Optional[torch.Tensor]] = []
        self._held = False  # the write was made but not started
        self._reserving: Optional[threading.Thread] = None
        # (step, host copy) of the last save
        self._saved: Optional[Tuple[int, Any]] = None

    def reserve(self, like) -> None:
        """Make the pinned buffers for a state shaped like ``like`` (tensors
        or ``TensorSpec``s: shape, dtype, device) on a thread of its own, so
        that the first save only copies; the save waits for them."""
        leaves = tree_flatten(like)[0]

        def make():
            self._pinned = [
                torch.empty(tuple(x.shape), dtype=x.dtype, pin_memory=True)
                if _on_card(x) else None for x in leaves]

        self._reserving = threading.Thread(target=make, daemon=True)
        self._reserving.start()

    def _to_host(self, leaves) -> list:
        """Host copies of ``leaves``: a card's tensors through the pinned
        buffers (made, or remade where a shape changed), the rest as they
        are or copied."""
        if self._reserving is not None:
            self._reserving.join()
            self._reserving = None
        if len(self._pinned) != len(leaves) or any(
                b is not None and (b.shape != x.shape or b.dtype != x.dtype)
                for b, x in zip(self._pinned, leaves)):
            self._pinned = [
                torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                if _on_card(x) else None for x in leaves]
        out, streams = [], set()
        for buf, x in zip(self._pinned, leaves):
            if buf is not None:
                buf.copy_(x.detach(), non_blocking=True)
                streams.add(torch.cuda.current_stream(x.device))
                out.append(buf)
            elif isinstance(x, torch.Tensor):
                out.append(x.detach().to("cpu", copy=True))
            else:
                out.append(x)
        for s in streams:
            s.synchronize()
        return out

    def save(self, step: int, state: Any, start: bool = True) -> None:
        self.wait()
        # snapshot to host NOW: the train step updates the state in place
        t0 = time.perf_counter()
        leaves, treedef = tree_flatten(state)
        host = tree_unflatten(self._to_host(leaves), treedef)
        self.copy_s = time.perf_counter() - t0
        self.nbytes = sum(x.numel() * x.element_size()
                          for x in tree_flatten(host)[0]
                          if isinstance(x, torch.Tensor))

        def _write():
            t1 = time.perf_counter()
            save(self.ckpt_dir, step, host)
            prune(self.ckpt_dir, keep=self.keep)
            self.write_s = time.perf_counter() - t1
            self.last_committed = step

        self._saved = (step, host)
        self._thread = threading.Thread(target=_write, daemon=True)
        self._held = True
        if start:
            self.commit()

    @property
    def saved_step(self) -> Optional[int]:
        """The step of the last save (committed or not), None before one."""
        return self._saved[0] if self._saved is not None else None

    def restore_into(self, state: Any) -> Tuple[int, Any]:
        """Copy the last save's host copy into the tensors of ``state`` in
        place (host ints are replaced), as the module's ``restore_into``
        does from the disk. Returns (its step, the state)."""
        if self._saved is None:
            raise FileNotFoundError("nothing saved yet")
        step, host = self._saved
        leaves, treedef = tree_flatten(state)
        saved = tree_flatten(host)[0]
        if len(saved) != len(leaves):
            raise ValueError(f"the save has {len(saved)} leaves, the state "
                             f"{len(leaves)}")
        out, streams = [], set()
        for i, (h, ref) in enumerate(zip(saved, leaves)):
            if not isinstance(ref, torch.Tensor):
                out.append(h)
                continue
            if h.shape != ref.shape or h.dtype != ref.dtype:
                raise ValueError(f"leaf {i}: {h.dtype}{list(h.shape)} != "
                                 f"{ref.dtype}{list(ref.shape)}")
            ref.copy_(h, non_blocking=h.is_pinned())
            if ref.is_cuda:
                streams.add(torch.cuda.current_stream(ref.device))
            out.append(ref)
        for s in streams:
            s.synchronize()
        return step, tree_unflatten(out, treedef)

    def commit(self) -> None:
        """Start a write that ``save(..., start=False)`` held back."""
        if self._thread is not None and self._held:
            self._held = False
            self._thread.start()

    def wait(self) -> None:
        """Commit a held write, and wait for the write in flight."""
        if self._thread is not None:
            self.commit()
            self._thread.join()
            self._thread = None
