"""Serving steps: prefill (prompt -> last-token logits + decode cache) and
the greedy decode loop. These are the "GPU task" bodies of the static
serving path.

Port of ``src/repro/serve/decode.py`` for the dense, moe and ssm families.
``greedy_generate`` loops over ``decode_step`` where the reference
``lax.scan``s; on the card the step is captured once in a CUDA graph
(``StepGraph``) and replayed, the port's counterpart of the reference's
compiled loop, so a step costs no host time per kernel.

Ring-cache hand-off: pure sliding-window archs (mixtral) decode over a ring
of ``window`` slots, position p at slot ``p % window``. After a prefill of S
tokens the last ``window`` K/V rows are rotated into that order, or, when S
is shorter than the window, padded to it, so the ring's modulus is the
window (reference ``serve/decode.py:37-59``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
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
    the f32 temporaries stay one layer big. An ssm cache (conv and SSM
    states) is returned as it is.
    """
    def prefill(params, batch: Dict[str, torch.Tensor]):
        hidden, _, cache = forward(params, cfg, batch, attn_impl=attn_impl,
                                   collect_cache=True)
        logits = logits_from_hidden(cfg, params, hidden[:, -1:])[:, 0]
        if D.uses_ring(cfg) and "k" in cache:
            for name in ("k", "v"):
                cache[name] = ring_from_prefill(cache.pop(name),
                                                cfg.sliding_window)
        if cfg.kv_cache_dtype == "int8" and "k" in cache:
            q8 = {}
            for name in ("k", "v"):
                t = cache.pop(name)
                codes = torch.empty(t.shape, dtype=torch.int8, device=t.device)
                scales = torch.empty(t.shape[:-1], dtype=torch.bfloat16,
                                     device=t.device)
                for i in range(t.shape[0]):
                    c, s = quantize_kv(t[i])
                    codes[i].copy_(c)
                    scales[i].copy_(s)
                del t
                q8[name], q8[name + "_s"] = codes, scales
            cache = q8
        return logits, cache

    return prefill


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
    dtypes, as the reference decodes on its prefill cache.
    """
    if cfg.family == "ssm" or D.uses_ring(cfg):
        return cache
    k = cache["k"]
    return D.cache_insert(D.init_cache(cfg, k.shape[1], max_seq,
                                       device=k.device), cache, 0)


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
    threads' streams. A failed capture raises: nothing falls back to eager
    steps on the card. The graph's private memory pool holds the step's
    temporaries for as long as the graph lives (the probe charges them as
    the step's live peak)."""

    def __init__(self, step: Callable[[], None], stream: "torch.cuda.Stream"):
        self.stream = stream
        with torch.cuda.stream(stream):
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
        CAPTURES.add()

    def replay(self) -> None:
        with torch.cuda.stream(self.stream):
            self.graph.replay()
        REPLAYS.add()


def greedy_generate(cfg: ArchConfig, params, cache: D.Cache,
                    first_tokens: torch.Tensor, start_pos: int,
                    num_steps: int) -> Tuple[torch.Tensor, D.Cache]:
    """Greedy generation: ``num_steps`` decode steps from ``first_tokens``
    at position ``start_pos``. Returns (tokens [B, num_steps] int32, cache).
    A KV cache must hold ``start_pos + num_steps`` positions, or be a ring;
    the caller pads a prompt-deep prefill cache first (``decode_cache``). An
    ssm cache holds states, whatever the position.
    ``num_steps=0`` returns an empty [B, 0] block with the cache untouched.

    Tokens and the position live in device buffers that the step updates
    in place (argmax, ``pos += 1``). On a CPU tensor the steps run eagerly;
    on the card the first step is the warm-up of a ``StepGraph`` captured on
    ``capture_stream`` (a pool worker's own stream in the executor), and
    the rest are its replays. The stream is synchronised before the graph,
    and its memory pool, are released.
    """
    b, dev = first_tokens.shape[0], first_tokens.device
    out = torch.empty(b, max(num_steps, 0), dtype=torch.int32, device=dev)
    if num_steps <= 0:
        return out, cache
    tokens = first_tokens.to(torch.int32).clone()
    pos = torch.full((), start_pos, dtype=torch.int32, device=dev)

    def step():
        logits, _ = D.decode_step(params, cfg, cache, tokens, pos)
        tokens.copy_(torch.argmax(logits, dim=-1))
        pos.add_(1)

    if dev.type != "cuda":
        for i in range(num_steps):
            step()
            out[:, i] = tokens
        return out, cache
    stream = capture_stream(dev)
    graph = StepGraph(step, stream)
    with torch.cuda.stream(stream):
        out[:, 0].copy_(tokens)
        for i in range(1, num_steps):
            graph.replay()
            out[:, i].copy_(tokens)
    stream.synchronize()
    torch.cuda.current_stream(dev).wait_stream(stream)
    return out, cache
