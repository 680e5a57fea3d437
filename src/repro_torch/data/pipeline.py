"""Deterministic synthetic token pipeline with host-side prefetch.

Copy of ``src/repro/data/pipeline.py`` (numpy, seeded by ``(seed, step)``:
the same batches as the reference, array for array), with ``shard_batch``
replaced by ``to_device``; keep the two in step.

Produces next-token-prediction batches for any arch/shape; for frontend-stub
archs ([vlm]/[audio]) it also emits precomputed frame/patch embeddings. The
pipeline is seeded and step-indexed, so restarts resume bit-identically from a
checkpointed step.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


class TokenPipeline:
    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, *, seed: int = 0,
                 start_step: int = 0, batch_override: Optional[int] = None,
                 seq_override: Optional[int] = None):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.step = start_step
        self.batch = batch_override or shape.global_batch
        self.seq = seq_override or shape.seq_len

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, step))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        tokens = rng.integers(0, self.cfg.vocab,
                              (self.batch, self.seq), dtype=np.int32)
        labels = np.roll(tokens, -1, axis=1)
        out = {"tokens": tokens, "labels": labels}
        if self.cfg.embedding_frontend_stub:
            # modality frontend stub: pretend an encoder produced embeddings
            out["embeds"] = rng.standard_normal(
                (self.batch, self.seq, self.cfg.d_model),
                dtype=np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.batch_at(self.step)
            self.step += 1
            yield b


class Prefetcher:
    """Host-side prefetch thread: overlaps batch synthesis with device compute."""

    def __init__(self, pipeline: TokenPipeline, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._it = iter(pipeline)
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        for batch in self._it:
            if self._stop.is_set():
                return
            self._q.put(batch)

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass


def to_device(batch: Dict[str, np.ndarray],
              device) -> Dict[str, torch.Tensor]:
    """A pipeline batch as tensors on ``device`` (copies of the arrays)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
