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
host inline and writes it on a worker thread.

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


class AsyncCheckpointer:
    """Overlap checkpoint writes with training compute.

    save(): the device->host copy happens inline, serialization on the
    worker thread. At most one write is in flight; a second save() waits
    for the first (backpressure rather than unbounded host memory growth).
    """

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_committed: Optional[int] = None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        # snapshot to host NOW: the train step updates the state in place
        leaves, treedef = tree_flatten(state)
        host = tree_unflatten(
            [x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
             else x for x in leaves], treedef)

        def _write():
            save(self.ckpt_dir, step, host)
            prune(self.ckpt_dir, keep=self.keep)
            self.last_committed = step

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
