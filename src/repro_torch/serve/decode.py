"""Serving steps: prefill (prompt -> last-token logits + decode cache) and
the greedy decode loop. These are the "GPU task" bodies of the static
serving path.

Port of ``src/repro/serve/decode.py`` for every family the port runs.
``greedy_generate`` loops over ``decode_step`` where the reference
``lax.scan``s; on the card the step is captured once in a CUDA graph
(``StepGraph``) and replayed, the port's counterpart of the reference's
compiled loop, so a step costs no host time per kernel. A
``GreedyDecoder`` keeps its buffers and its graph between batches of one
shape, so a static server's pool worker captures once. A static server's
prefill is captured the same way (``PrefillGraph``), once per pool worker
and prompt shape, and replayed for every batch. ``make_serve_step`` is the
plain one-token step the dry run traces (``launch/dryrun.py``), and
``abstract_cache`` its cache as ``TensorSpec``s, nothing allocated.

Under a mesh both steps take DTensor parameters (``dist.sharding.
param_specs``): the prefill's cache comes out placed by ``cache_specs``
(the reference pins it, ``launch/dryrun.py:82-85``), and the decode step
takes a cache placed by ``cache_specs``, context-parallel too
(``models/model.py::attn_decode_block``).

Ring-cache hand-off: pure sliding-window archs (mixtral) decode over a ring
of ``window`` slots, position p at slot ``p % window``. After a prefill of S
tokens the last ``window`` K/V rows are rotated into that order, or, when S
is shorter than the window, padded to it, so the ring's modulus is the
window (reference ``serve/decode.py:37-59``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.probe import TensorSpec
from repro_torch.dist.sharding import local_map
from repro_torch.kernels.build import LaunchCounter
from repro_torch.models import decode as D
from repro_torch.models.layers import quantize_kv
from repro_torch.models.model import forward, logits_from_hidden


def make_prefill_step(cfg: ArchConfig, *, attn_impl: str = "flash_kernel"):
    """prefill(params, batch) -> (last-token logits [B, V] f32, cache).

    A KV cache is prompt-deep, or for a ring (pure sliding-window archs)
    ``window`` deep in ring order (``ring_from_prefill``). With
    ``cfg.kv_cache_dtype == "int8"`` it is then quantized as the reference
    does (per-(position, head) absmax, bf16 scales), one layer at a time so
    the f32 temporaries stay one layer big; a hybrid's KV cache is never
    quantized, as the reference's is not. An ssm cache (conv and SSM
    states) is returned as it is, and so are a hybrid's Mamba-2 states.
    Sequence-sharded activations are off in a prefill, as the reference
    turns them off (``serve/decode.py:30-32``): nothing is saved for a
    backward, so they would only add collectives under a mesh.
    """
    if cfg.seq_shard_activations:
        cfg = dataclasses.replace(cfg, seq_shard_activations=False)

    def prefill(params, batch: Dict[str, torch.Tensor]):
        hidden, _, cache = forward(params, cfg, batch, attn_impl=attn_impl,
                                   collect_cache=True)
        logits = logits_from_hidden(cfg, params, hidden[:, -1:])[:, 0]
        if D.uses_ring(cfg) and "k" in cache:
            w = cfg.sliding_window
            for name in ("k", "v"):
                t = cache.pop(name)
                cache[name] = local_map(
                    lambda x: ring_from_prefill(x, w), t,
                    t.shape[:3] + (w,) + t.shape[4:])
        if cfg.kv_cache_dtype == "int8" and "k" in cache \
                and cfg.family != "hybrid":
            q8 = {}
            for name in ("k", "v"):
                t = cache.pop(name)
                q8[name], q8[name + "_s"] = local_map(
                    quantize_stack, t, (t.shape, t.shape[:-1]))
                del t
            cache = q8
        return logits, cache

    return prefill


def quantize_stack(t: torch.Tensor):
    """(int8 codes, bf16 scales) of a KV stack ``[L, ...]``, one layer at a
    time so the f32 temporaries stay one layer big."""
    codes = torch.empty(t.shape, dtype=torch.int8, device=t.device)
    scales = torch.empty(t.shape[:-1], dtype=torch.bfloat16, device=t.device)
    for i in range(t.shape[0]):
        c, s = quantize_kv(t[i])
        codes[i].copy_(c)
        scales[i].copy_(s)
    return codes, scales


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, cache, tokens [B], pos) -> (logits [B, V] f32,
    cache): one token against the cache, updated in place
    (``models.decode.decode_step``). The ``decode_*``/``long_*`` shapes of
    the dry run trace this function (reference ``serve/decode.py:71-81``);
    the static and continuous servers replay the same step from a CUDA
    graph (``GreedyDecoder``, ``serve.engine``)."""

    def serve_step(params, cache, tokens, pos):
        return D.decode_step(params, cfg, cache, tokens, pos)

    return serve_step


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device=torch.device("cpu")) -> Dict[str, TensorSpec]:
    """``models.decode.init_cache``'s cache as ``TensorSpec``s on
    ``device``: shapes and dtypes only, nothing allocated (made on the meta
    device), as ``train_step.abstract_train_state`` gives the state
    (reference ``serve/decode.py:108-111``)."""
    device = torch.device(device)
    meta = D.init_cache(cfg, batch, max_seq, dtype, device="meta")
    return {k: TensorSpec(tuple(t.shape), t.dtype, device)
            for k, t in meta.items()}


def ring_from_prefill(t: torch.Tensor, window: int) -> torch.Tensor:
    """A prompt-deep KV stack ``[L, B, Hkv, S, hd]`` as a ring of ``window``
    slots with position p at slot ``p % window``: at S >= window the last
    ``window`` positions rolled by ``S % window``, else the S positions at
    the front of a zeroed ring (the empty slots are masked by ``cache_len``
    until decode writes them)."""
    s = t.shape[3]
    if s >= window:
        return torch.roll(t[:, :, :, s - window:], s % window, dims=3)
    ring = t.new_zeros(t.shape[:3] + (window,) + t.shape[4:])
    ring[:, :, :, :s].copy_(t)
    return ring


def decode_cache(cfg: ArchConfig, cache: D.Cache, max_seq: int) -> D.Cache:
    """The prefill ``cache`` made ready for ``max_seq`` positions of decode.

    A prompt-deep KV cache is copied to the front of a zeroed one
    ``max_seq`` deep (``models.decode.cache_insert``). A ring cache already
    holds its ``window`` slots and wraps, and an ssm cache holds states
    with no positions to pad: both are returned as they are, in their own
    dtypes, as the reference decodes on its prefill cache. A hybrid's KV
    cache is padded and its Mamba-2 states (``m_conv``, ``m_ssm``) are
    copied in their own dtypes.
    """
    if cfg.family == "ssm" or D.uses_ring(cfg):
        return cache
    k = cache["k"]
    return D.cache_insert(D.init_cache(
        cfg, k.shape[1], max_seq, device=k.device,
        conv_dtype=cache.get("m_conv", k).dtype), cache, 0)


def resident_ring(cfg: ArchConfig, cache: D.Cache, max_seq: int) -> D.Cache:
    """A prefill cache cut to the depth of a resident decode cache built for
    ``max_seq`` positions (``models.decode.cache_seq_len``).

    A ring prefill hands back ``window`` slots (``ring_from_prefill``), but
    a resident ring for ``max_seq < window`` positions holds only
    ``max_seq`` (mixtral: 1056 of 4096). Positions below ``max_seq`` never
    wrap, so position p sits at slot p of both and the first ``max_seq``
    slots are the whole of the row's context: they are returned as views.
    Any other cache is returned as it is. (The reference engine inserts the
    window-deep ring and raises.)"""
    smax = D.cache_seq_len(cfg, max_seq)
    if not D.uses_ring(cfg) or "k" not in cache or cache["k"].shape[3] <= smax:
        return cache
    return {key: t.narrow(D.CACHE_AXES[key][1], 0, smax)
            for key, t in cache.items()}


# Decode steps captured and replayed over the process (``StepGraph``): a
# replay runs a step's kernels without their wrappers, so the kernels'
# launch counters see the warm-up and the capture of a step, not its
# replays; a caller that counts launches adds replays x launches per step.
CAPTURES = LaunchCounter()
REPLAYS = LaunchCounter()
# the same for captured prefills (``PrefillGraph``)
PREFILL_CAPTURES = LaunchCounter()
PREFILL_REPLAYS = LaunchCounter()


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The caller's current stream, or a stream of the pool forked from it
    where the caller is on the default stream, which cannot capture. A pool
    worker keeps its own stream, and cuBLAS makes one workspace per stream
    it runs on and keeps it, so a capture does not add a stream per task."""
    caller = torch.cuda.current_stream(device)
    if caller != torch.cuda.default_stream(device):
        return caller
    side = torch.cuda.Stream(device)
    side.wait_stream(caller)
    return side


class StepGraph:
    """``step()`` captured in a CUDA graph on ``stream`` and replayed there.

    ``step`` must read and write only tensors that outlive the graph (the
    weights, a cache, token and position buffers) and must not read a value
    on the host. It runs once eagerly first on ``stream`` (the warm-up: a
    real step, which also makes cuBLAS's workspace for the stream and builds
    the kernels outside the capture); the capture records it without running
    it. The capture uses ``capture_error_mode="thread_local"``, so several
    pool threads can capture at once, and none of ``torch.cuda.graph``'s
    device-wide synchronize and cache release, which would reach into other
    threads' streams. Warm-ups and captures of the process take turns
    (``_TURNS``): four pool threads capturing at once each took 3.6x longer
    to warm up, 4.4x to capture and 4.3x to instantiate the graph than one
    alone, and 1.1x, 1.4x and 0.8x when they took turns
    (``tools/pool_workers.py``, gemma2-9b on an H100). A failed capture
    raises: nothing falls back to eager steps on the card. The graph's
    private memory pool holds the step's temporaries for as long as the
    graph lives (the probe charges them as the step's live peak)."""

    _TURNS = threading.Lock()

    def __init__(self, step: Callable[[], None], stream: "torch.cuda.Stream",
                 counters: Tuple[LaunchCounter, LaunchCounter] = (CAPTURES,
                                                                  REPLAYS)):
        self.stream = stream
        self._captures, self._replays = counters
        with self._TURNS, torch.cuda.stream(stream):
            step()
            t = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                step()
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass  # the step's own error is the one to report
                raise
            self.graph.capture_end()
        self.capture_s = time.perf_counter() - t
        self._captures.add()

    def replay(self) -> None:
        with torch.cuda.stream(self.stream):
            self.graph.replay()
        self._replays.add()


class PrefillGraph:
    """A static server's prefill captured once in a CUDA graph (a
    ``StepGraph`` on ``stream``) and replayed for every later batch of the
    same shape: the host issues one graph launch where the eager prefill
    issued each of its kernels through the interpreter, so pool threads no
    longer queue on the interpreter lock for their prefills (ROADMAP C12).

    ``inputs`` holds a static copy of the batch's tensors; ``__call__``
    copies a batch into it, replays, and returns the static outputs
    ``(last-token logits, cache)``, valid until the next call: the caller
    copies what it keeps (``GreedyDecoder.load``). The graph's private
    memory pool holds the prefill's temporaries and outputs for as long as
    the graph lives, so it is the worker's, charged where the worker's
    decoder is (``launch.serve.prefill_state``). The kernels' TMA
    descriptors are made on the host during the capture and point into
    that pool, where every replay finds the same tensors. The warm-up's
    outputs are dropped before the capture begins, so its cache and the
    pool's are never held at once."""

    def __init__(self, prefill: Callable, params, batch: Dict[str, torch.Tensor],
                 stream: "torch.cuda.Stream"):
        with torch.cuda.stream(stream):
            self.inputs = {k: v.clone() for k, v in batch.items()}
        self.outputs = None

        def run() -> None:
            out = prefill(params, self.inputs)
            if torch.cuda.is_current_stream_capturing():
                self.outputs = out  # the warm-up's go when this returns

        self.graph = StepGraph(run, stream, (PREFILL_CAPTURES,
                                             PREFILL_REPLAYS))

    def __call__(self, batch: Dict[str, torch.Tensor]):
        stream = self.graph.stream
        caller = torch.cuda.current_stream(stream.device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                self.inputs[k].copy_(v)
        self.graph.replay()
        caller.wait_stream(stream)
        return self.outputs


def decode_buffers(cfg: ArchConfig, rows: int, max_seq: int,
                   act_dtype: torch.dtype, device=None) -> D.Cache:
    """Zeroed buffers of the shapes and dtypes that ``decode_cache`` makes
    of a prefill of ``rows`` rows whose activations are ``act_dtype``: a
    KV cache padded for ``max_seq`` positions (bf16, or int8 codes with
    bf16 scales), a ring of ``window`` slots in the prefill's dtype, or an
    ssm cache (conv state in the prefill's dtype, SSM state f32), or a
    hybrid's (its KV bf16 and padded, its conv states in the prefill's
    dtype, its SSM states f32)."""
    if cfg.family in ("ssm", "hybrid"):
        return D.init_cache(cfg, rows, max_seq, device=device,
                            conv_dtype=act_dtype)
    if D.uses_ring(cfg):
        dtype = torch.bfloat16 if cfg.kv_cache_dtype == "int8" \
            else act_dtype
        return D.init_cache(cfg, rows, cfg.sliding_window, dtype=dtype,
                            device=device)
    return D.init_cache(cfg, rows, max_seq, device=device)


class GreedyDecoder:
    """Greedy decode over buffers that outlive a batch: ``cache`` (a decode
    cache as ``decode_cache`` makes it, or ``decode_buffers``), the tokens
    and the position. ``load`` copies a batch's prefill cache and first
    tokens in, ``generate`` steps.

    On a CPU tensor the steps run eagerly. On the card the step is
    captured once (``StepGraph``) on ``capture_stream``: the first step of
    the first ``generate`` is the warm-up, and every later step, of that
    batch and of every batch loaded after it, is a replay. A static
    server's pool worker keeps one decoder per batch shape, so it captures
    once, not once a batch; the decoder's buffers and graph pool are then
    the worker's, set aside from what the scheduler manages
    (``launch.serve.pool_reserve``)."""

    def __init__(self, cfg: ArchConfig, params, cache: D.Cache):
        self.cfg, self.params, self.cache = cfg, params, cache
        t = next(iter(cache.values()))
        self.device = t.device
        self.tokens = torch.zeros(D.cache_rows(cache), dtype=torch.int32,
                                  device=self.device)
        self.pos = torch.zeros((), dtype=torch.int32, device=self.device)
        self.graph = None

    def step(self) -> None:
        logits, _ = D.decode_step(self.params, self.cfg, self.cache,
                                  self.tokens, self.pos)
        self.tokens.copy_(torch.argmax(logits, dim=-1))
        self.pos.add_(1)

    def load(self, cache: D.Cache, first_tokens: torch.Tensor,
             start_pos: int) -> None:
        """Copy a prefill ``cache`` into the decoder's (zero-padding the
        sequence axis, ``models.decode.cache_insert``; nothing is copied
        where it is the decoder's own) and start from ``first_tokens`` at
        position ``start_pos``."""
        if cache is not self.cache:
            D.cache_insert(self.cache, cache, 0)
        self.tokens.copy_(first_tokens)
        self.pos.fill_(start_pos)

    def generate(self, num_steps: int,
                 stop: Optional[Callable[[], bool]] = None
                 ) -> Optional[torch.Tensor]:
        """``num_steps`` greedy steps from the loaded tokens and position:
        the tokens [B, num_steps] int32 (an empty [B, 0] block for 0).
        ``stop`` is asked on the host before each step (a cooperative
        task's eviction check): once it answers True no further step is
        launched, the steps in flight finish, and None is returned."""
        out = torch.empty(self.tokens.shape[0], max(num_steps, 0),
                          dtype=torch.int32, device=self.device)
        if num_steps <= 0:
            return out
        if self.device.type != "cuda":
            for i in range(num_steps):
                if stop is not None and stop():
                    return None
                self.step()
                out[:, i] = self.tokens
            return out
        caller = torch.cuda.current_stream(self.device)
        first = 0
        if self.graph is None:
            self.graph = StepGraph(self.step, capture_stream(self.device))
            first = 1  # the warm-up was this batch's first step
        stream = self.graph.stream
        stream.wait_stream(caller)
        stopped = False
        with torch.cuda.stream(stream):
            if first:
                out[:, 0].copy_(self.tokens)
            for i in range(first, num_steps):
                if stop is not None and stop():
                    stopped = True
                    break
                self.graph.replay()
                out[:, i].copy_(self.tokens)
        stream.synchronize()
        caller.wait_stream(stream)
        return None if stopped else out


def greedy_generate(cfg: ArchConfig, params, cache: D.Cache,
                    first_tokens: torch.Tensor, start_pos: int,
                    num_steps: int) -> Tuple[torch.Tensor, D.Cache]:
    """Greedy generation: ``num_steps`` decode steps from ``first_tokens``
    at position ``start_pos``, over ``cache`` in place. Returns (tokens
    [B, num_steps] int32, cache). A KV cache must hold ``start_pos +
    num_steps`` positions, or be a ring; the caller pads a prompt-deep
    prefill cache first (``decode_cache``). An ssm cache holds states,
    whatever the position. ``num_steps=0`` returns an empty [B, 0] block
    with the cache untouched. A ``GreedyDecoder`` of its own over
    ``cache``: on the card its graph, and the graph's memory pool, are
    released when this returns."""
    dec = GreedyDecoder(cfg, params, cache)
    dec.load(cache, first_tokens, start_pos)
    return dec.generate(num_steps), cache
