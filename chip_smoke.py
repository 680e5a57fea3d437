"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. build: compile the hand CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and print ptxas' resource lines and
   the card's name and power limit (``nvidia-smi``).
2. paper: the seven Rodinia families of ``core/workloads.py`` probed on fake
   tensors on the card (nothing allocated) at 2 GB and 8 GB, each vector
   printed with the card's name and power limit (fails where a footprint
   misses its target by more than 25%); then ``repro_torch.bench``'s Fig. 5
   and Table II on vectors probed on the card, with their PASS/MISS band
   lines (printed, not enforced, as the reference does). Then the four NN
   jobs of §V-E probed on the card from the port's prefill, train and
   decode steps, beside the same probes on the CPU and the reference's
   vectors, and Fig. 6 on the card's vectors with its band lines.
3. twin: the reference's seven-job ordering trace (priorities, deadlines,
   one exclusive device) on a live ``Cluster`` whose runners each run a
   small Rodinia family on the card, and on a sim ``Cluster``: fails if
   ``obs.replay.diff_streams`` finds a divergence or a family's card output
   differs from its CPU run beyond atol = rtol = 1e-4.
4. kernels: hold each kernel against its plain PyTorch version at the main
   paths' shapes and at edge cases (bf16 atol = rtol = 2e-2, f32 1e-4) and
   time kernel, plain version and, as a yardstick only, the PyTorch library
   call that computes the same function where there is one: device time of
   a CUDA-graph replay, after warm-up. Flash attention has two routes, bf16
   on the tensor cores (wgmma, TMA) and f32 on the CUDA cores, each held
   at its own cases; its yardsticks are SDPA at mixtral's shape (no
   softcap) and ``flex_attention`` (softcap as a score_mod, causal + window
   as a block mask, compiled once before timing) at gemma2's. The
   selective scan has no library call; the grouped matmul's is
   ``torch._grouped_mm``. The grouped matmul has three routes (bf16 wgmma
   fed by TMA for many rows an expert, bf16 small tiles for a few, f32 on
   the CUDA cores) and a gated variant (act(x wi) * (x wg) in one launch),
   each route and act forced at every edge case it takes. The backward
   kernels (flash attention's, RMSNorm's) are held against their plain
   versions and against autograd through the forwards' plain versions,
   in f32 and bf16, at gemma2-9b's training shape (B 4, Hq 16, Hkv 8, S
   1024, D 256, softcap 50, window 4096 and 0), D 128 with a window of
   256, ragged tails and rows; RMSNorm's dscale must be the same bits run
   to run. Yardsticks: SDPA's and ``F.rms_norm``'s forward + backward
   through autograd where they compute the same function (none for
   gemma2's softcap).
5. reduced: the reduced gemma2-9b, falcon-mamba-7b and mixtral-8x7b served
   paths on the card (hand kernels) against the same weights on the CPU
   (plain versions), in f32: last-token logits within 2e-3 and 8 greedy
   tokens equal. mixtral's prompt (128) is past its window (64), so the
   ring rotates; a disagreement reports how many expert choices flipped.
6. continuous, reduced: the same three reduced models served continuously
   (``serve_continuous``: 6 requests, a loop of 4 rows, 9 tokens each) on
   the card, the loop step replayed from a CUDA graph, against the CPU:
   every request's tokens equal. Then reduced gemma2-9b (softcaps, window
   64) and qwen1.5-32b (QKV bias) trained 3 steps of 2 x 128 on the card
   and on the CPU from one seed: losses, grad norms, parameters and
   moments within the CPU parity tests' tolerances (10x where absolute).
7. serve, one main path per model, each through probe -> MGB admission ->
   executor with the launch counters zeroed just before and read just
   after, every kernel's count checked exactly. Each pool worker keeps one
   decoder (``serve.decode.GreedyDecoder``: the padded cache, buffers and
   the step captured in a CUDA graph on its stream at its first batch), and
   every later step of every batch is a replay: the counters see the
   warm-up and the capture of each worker's step, so the check takes them
   as two steps a captured graph, checks the capture and replay counts, and
   adds replays x launches per step to the reported launches.
   - gemma2-9b, full width and depth, bf16: 32 requests in 8 batches of 4,
     prompt 1000, 32 generated tokens; flash attention 42 launches per
     prefill, RMSNorm 85 per prefill and per decode step. Then one batch
     alone (the batch's probe, its prefill, plus what its worker keeps,
     the decoder, against ``torch.cuda.max_memory_allocated``: fails below
     1.0), and the same 32 requests with four pool workers sharing the
     card, their tokens/s beside one worker's (fails below it), with the
     per-batch host, stream and wall times of the prefills and of the
     graphs' warm-ups and captures on 1 and on 4 workers.
   - falcon-mamba-7b, full width and depth, bf16: 32 requests in 8 batches
     of 4, prompt 1024 (a multiple of the reference's scan chunk, 256),
     32 generated tokens, one worker; the selective scan 64 launches per
     prefill, RMSNorm 65 per prefill and per decode step. Then one batch
     alone.
   - mixtral-8x7b, every published width, depth cut to 24 of 32 layers
     (32 are 93.4e9 B in bf16, more than the card), bf16: 32 requests in 8
     batches of 4, prompt 1024 (a multiple of the reference's 512-token MoE
     group), 32 generated tokens, one worker; flash attention 24 launches
     per prefill, RMSNorm 49 and the grouped matmul 48 (2 a layer: the
     gated wi/wg launch, 24, and wo) per prefill and per decode step. Then
     one batch alone.
8. continuous, one main path per model at the same widths: 32 requests
   submitted together (prompt 1000 for gemma2-9b, 1024 for the others), 32
   tokens each, one decode loop of 8 rows whose step is replayed from a
   CUDA graph, 2 pool workers for the prefills; launches checked as in 7
   (one warm-up and one capture, one replay a step), every request done,
   0 violations, the scheduler's highest reservation against
   ``torch.cuda.max_memory_allocated`` (fails below 1.0), and after every
   adoption of a row and every pump the bytes the card holds for the run
   (the decode graph's pool included) against the reservation at that
   moment plus the pool's streams' reserve (fails where they pass it).
9. decode: for each model at batch 4, the device time of one prefill and
   of one decode step by kernel (``torch.profiler``), and one decode step
   eager (host wall time) against the same step replayed from a CUDA graph
   (device time, no host gaps): the difference is the time the card waits
   on the host. The step's bound reads its weights once (for MoE only the
   experts the step routed to) and the cache's filled slots.
10. train, the training main path: gemma2-9b at every published width,
   depth cut to 12 of 42 layers (all 42 are 9.24e9 parameters x 16 B =
   148e9 B in f32 with a gradient and two moments), f32, batch 4 x 1024,
   ``remat_policy="full"``, 5 steps through ``launch.train.train``: the
   probe of one step at 12 and 14 layers against the memory free on the
   card first, then the run as one task through probe -> MGB ->
   executor, each step's loss, grad norm, lr, host and device ms and
   tokens/s printed, the launches checked exactly (flash attention's
   forward 2 a layer a step, its backward 1; RMSNorm's forward 4 a layer
   + 1 a step, its backward 2 a layer + 1), the probe's flops at least
   2.5x the analytic forward; then one step alone whose probe must cover
   ``torch.cuda.max_memory_allocated`` (fails below 1.0), and a
   ``torch.profiler`` breakdown of one step.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOPS = 989e12   # dense tensor-core peak, NVIDIA H100 SXM datasheet
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores
H100_HBM_BW = 3.35e12      # bytes/s
# the port's kernel functions, as the profiler names them
PORT_KERNELS = ("rmsnorm_kernel", "flash_tc_kernel", "flash_fwd_kernel",
                "mamba_scan_kernel", "gmm_tma_kernel", "gmm_small_kernel",
                "gmm_f32_kernel", "flash_bwd_delta_kernel",
                "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                "rmsnorm_bwd_kernel", "rmsnorm_dscale_kernel")
# mixtral-8x7b's 32 layers are 93.4e9 B in bf16, more than one 80 GB card;
# 24 (70.2e9 B) leave room for the activations and the 1.6e9 B ring cache
MIXTRAL_LAYERS = 24


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def setup():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch next to {__file__}: run from the repo root")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # plain versions reduce in f32 (cuBLAS may otherwise split K in bf16)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn()``: ``iters`` calls captured in one CUDA
    graph after two warm-up calls, the replay timed with CUDA events, so the
    host's launch overhead is left out for kernel, plain version and library
    call alike."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return replay_ms(torch, graph, iters)


def replay_ms(torch, graph, iters: int) -> float:
    """Device time of one of the ``iters`` calls captured in ``graph``: one
    replay to warm, one timed between CUDA events."""
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def time_grad_ms(torch, forward, leaves, grad, iters: int):
    """Mean device time of the backward alone of ``forward()`` with respect
    to ``leaves``: the library's side of a backward kernel's row, timed as
    ``time_ms`` times the kernel. The forward runs once on a side stream
    and its graph is kept; autograd runs each node's backward on the stream
    of its forward, so ``torch.autograd.grad`` of the kept graph is captured
    ``iters`` times in one CUDA graph on that stream and the replay timed.
    Returns (ms, the gradients of a warm-up call)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward()
        for _ in range(2):
            grads = torch.autograd.grad(out, leaves, grad, retain_graph=True)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            torch.autograd.grad(out, leaves, grad, retain_graph=True)
    return replay_ms(torch, graph, iters), grads


def compare(torch, got, want, dtype, what: str) -> float:
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} elements outside atol=rtol={tol} "
             f"(max abs err {float(err.max()):.3e})")
    return float(err.max())


def phase_build(torch):
    from repro_torch.kernels import build
    t = time.time()
    logs = build.build_all()
    print(f"[build] {sorted(logs)} built in {time.time() - t:.1f} s "
          f"under {build.BUILD_DIR}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry", "C75")):
                print(f"[build] {name}: {line.strip()[:160]}")


def phase_kernels(torch):
    """Every kernel against its plain version at the main paths' shapes;
    returns {kernel: entry of the JSON table} for the main-path case."""
    import torch.nn.functional as F
    from repro_torch.kernels import mamba_scan as SC
    from repro_torch.kernels import rmsnorm as RN
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = {}

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(dtype)

    # gemma2-9b's prefill and decode rows (d 3584), falcon-mamba-7b's
    # (d 4096), then a narrow edge case
    for shape, dtype in [((4000, 3584), torch.bfloat16),
                         ((4000, 3584), torch.float32),
                         ((4, 3584), torch.bfloat16),
                         ((4, 3584), torch.float32),
                         ((4096, 4096), torch.bfloat16),
                         ((4096, 4096), torch.float32),
                         ((4, 4096), torch.bfloat16),
                         ((4, 4096), torch.float32),
                         ((1000, 512), torch.float32),
                         ((1000, 512), torch.bfloat16)]:
        x = randn(shape, dtype)
        sc = randn(shape[-1:], dtype, 0.1)
        out = RN.rmsnorm(x, sc)
        torch.cuda.synchronize()
        err = compare(torch, out, RN.rmsnorm_plain(x, sc), dtype,
                      f"rmsnorm {shape} {dtype}")
        ms = time_ms(torch, lambda: RN.rmsnorm(x, sc), 50)
        plain_ms = time_ms(torch, lambda: RN.rmsnorm_plain(x, sc), 20)
        w = 1.0 + sc
        lib_ms = time_ms(torch, lambda: F.rms_norm(x, shape[-1:], w, 1e-5),
                         50)
        nbytes = 2 * x.numel() * x.element_size() + sc.numel() \
            * sc.element_size()
        flops = 4 * x.numel()
        bound = max(nbytes / H100_HBM_BW, flops / H100_F32_FLOPS) * 1e3
        print(f"[kernels] rmsnorm {shape} {str(dtype)[6:]}: max_abs_err "
              f"{err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.rms_norm {lib_ms:.4f} ms, bound {bound:.4f} ms (bytes)",
              flush=True)
        if shape == (4000, 3584) and dtype == torch.bfloat16:
            table["rmsnorm"] = dict(
                name="rmsnorm", route="cuda",
                source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm.py:40", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=lib_ms)

    phase_flash(torch, randn, table)

    # the selective scan: edge cases (S = 1, S = 7, B*E*N off the block
    # size, E*N not a multiple of 4, N = 64), then falcon-mamba-7b's prefill
    # shape, timed. a = exp(-|randn|) as tests/test_kernels.py:108.
    for shape in [(2, 1, 8, 4), (1, 7, 5, 3), (3, 33, 17, 64),
                  (2, 96, 128, 64), (1, 64, 128, 16), (2, 300, 1000, 16),
                  (4, 1024, 8192, 16)]:
        a = torch.exp(-randn(shape, torch.float32).abs_())
        b = randn(shape, torch.float32)
        h_all, h_last = SC.mamba_scan(a, b)
        torch.cuda.synchronize()
        want_all, want_last = SC.mamba_scan_plain(a, b)
        err = max(compare(torch, h_all, want_all, torch.float32,
                          f"mamba_scan {shape} h_all"),
                  compare(torch, h_last, want_last, torch.float32,
                          f"mamba_scan {shape} h_last"))
        del h_all, h_last, want_all, want_last
        line = f"[kernels] mamba_scan {shape} f32: max_abs_err {err:.3e}"
        if shape == (4, 1024, 8192, 16):
            ms = time_ms(torch, lambda: SC.mamba_scan(a, b), 10)
            plain_ms = time_ms(torch, lambda: SC.mamba_scan_plain(a, b), 2)
            # a, b read once, h_all and h_last written once
            nbytes = 3 * a.numel() * 4 + a[:, 0].numel() * 4
            t_bytes, t_ops = nbytes / H100_HBM_BW, 2 * a.numel() \
                / H100_F32_FLOPS
            bound = max(t_bytes, t_ops) * 1e3
            by = "bytes" if t_bytes > t_ops else "operations"
            line += (f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, no "
                     f"library call, bound {bound:.4f} ms ({by}), "
                     f"{nbytes / ms / 1e6:.1f} GB/s = "
                     f"{100 * bound / ms:.1f}% of the bound")
            table["mamba_scan"] = dict(
                name="mamba_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/mamba_scan.cu",
                replaces="src/repro/kernels/mamba_scan.py:73",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)
        del a, b
        print(line, flush=True)
    phase_gmm(torch, randn, table)
    phase_backward(torch, randn, table)
    return table


def flex_library(torch, q, k, v, cap: float, win: int):
    """gemma2's yardstick, never used by the port: one
    ``torch.nn.attention.flex_attention`` call with the softcap as a
    ``score_mod`` and causal + window as a block mask, compiled once here,
    outside any timed graph. Returns (call, its max abs error against the
    plain version) or (None, None) when this build refuses the inputs;
    ``call(q, k, v)`` takes other tensors of the same shapes (leaves that
    need their gradients, for the backward's yardstick)."""
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        sq, sk = q.shape[2], k.shape[2]

        def mask_mod(b, h, qi, ki):
            keep = qi >= ki
            return keep & (qi - ki < win) if win > 0 else keep

        def score_mod(score, b, h, qi, ki):
            return cap * torch.tanh(score / cap)

        kw = dict(block_mask=create_block_mask(mask_mod, None, None, sq, sk,
                                               device=q.device),
                  enable_gqa=True)
        if cap:
            kw["score_mod"] = score_mod
        fn = torch.compile(flex_attention, dynamic=False)
        out = fn(q, k, v, **kw)
        torch.cuda.synchronize()
    except Exception as exc:  # a refusal is a finding: printed and recorded
        print(f"[kernels] flex_attention refused {tuple(q.shape)}: "
              f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}",
              flush=True)
        return None, None
    from repro_torch.kernels import flash_attention as FA
    want = FA.flash_attention_plain(q, k, v, causal=True, window=win,
                                    logit_softcap=cap)
    err = float((out.float() - want.float()).abs().max())
    return (lambda q=q, k=k, v=v: fn(q, k, v, **kw)), err


def phase_flash(torch, randn, table) -> None:
    """Flash attention against its plain version. bfloat16 takes the
    tensor-core route (wgmma, TMA), float32 the CUDA-core route. Main-path
    shapes: gemma2-9b's prefill (softcap 50, window 4096 on alternate
    layers) and mixtral-8x7b's (D 128, Hq/Hkv = 4, window 4096 past the
    prompt, no softcap: SDPA computes the same function there), timed with
    flex_attention (gemma2) and SDPA (mixtral) as yardsticks. Then edge
    cases on both routes: every head dim with Sk a multiple of 64 (random,
    so distinct, V columns: a wrong V layout cannot pass), ragged lengths,
    top-left causal with Sq != Sk, windows below, at and above a tile,
    softcaps on scores scaled up, non-causal, and q, k, v as the model's
    einsum views (a [B, S, H, D] buffer seen as [B, H, S, D])."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    bf16, f32 = torch.bfloat16, torch.float32
    # (shape, dtype, softcap, window, score scale, einsum views, causal)
    timed = [((4, 16, 8, 1000, 1000, 256), bf16, 50.0, 4096, 1.0, False, True),
             ((4, 32, 8, 1024, 1024, 128), bf16, 0.0, 4096, 1.0, False, True),
             ((4, 16, 8, 1000, 1000, 256), bf16, 50.0, 0, 1.0, False, True),
             ((4, 16, 8, 1000, 1000, 256), bf16, 0.0, 0, 1.0, False, True),
             ((1, 16, 8, 5000, 5000, 256), bf16, 50.0, 4096, 1.0, False, True),
             ((4, 16, 8, 1000, 1000, 256), f32, 50.0, 4096, 1.0, False, True)]
    cases = []
    for d in (32, 64, 128, 256):
        cases += [((1, 4, 2, 256, 256, d), bf16, 0.0, 0, 1.0, False, True),
                  ((2, 2, 1, 128, 192, d), bf16, 0.0, 0, 1.0, False, False),
                  ((1, 4, 2, 100, 100, d), bf16, 0.0, 0, 1.0, False, True)]
    cases += [((2, 4, 2, 1000, 1000, 128), bf16, 0.0, 0, 1.0, False, True),
              ((1, 4, 2, 1000, 1000, 256), bf16, 0.0, 0, 1.0, False, True)]
    for shape in [(2, 4, 2, 128, 128, 64), (1, 8, 1, 256, 256, 32),
                  (2, 2, 2, 128, 384, 64), (1, 4, 4, 512, 512, 128),
                  (1, 4, 2, 100, 100, 256)]:
        for dtype in (f32, bf16):
            cases.append((shape, dtype, 0.0, 0, 1.0, False, True))
    for w in (32, 96, 128):
        cases += [((1, 2, 2, 256, 256, 64), dtype, 0.0, w, 1.0, False, True)
                  for dtype in (f32, bf16)]
        cases += [((1, 2, 2, 300, 300, d), bf16, 0.0, w, 1.0, False, True)
                  for d in (128, 256)]
    for cap in (20.0, 50.0):
        cases += [((1, 2, 2, 128, 128, 64), dtype, cap, 0, 3.0, False, True)
                  for dtype in (f32, bf16)]
        cases.append(((1, 4, 2, 200, 200, 256), bf16, cap, 0, 3.0, False,
                      True))
    cases += [((2, 8, 4, 1000, 1000, 256), bf16, 50.0, 4096, 1.0, True, True),
              ((2, 8, 2, 1024, 1024, 128), bf16, 0.0, 4096, 1.0, True, True),
              ((1, 4, 2, 100, 100, 64), f32, 0.0, 0, 1.0, True, True)]

    def operands(b, h, s, d, dtype, scale, views):
        if views:
            return randn((b, s, h, d), dtype, scale).transpose(1, 2)
        return randn((b, h, s, d), dtype, scale)

    worst = {bf16: 0.0, f32: 0.0}
    for case in timed + cases:
        (b, hq, hkv, sq, sk, d), dtype, cap, win, scale, views, causal = case
        q = operands(b, hq, sq, d, dtype, scale, views)
        k = operands(b, hkv, sk, d, dtype, scale, views)
        v = operands(b, hkv, sk, d, dtype, 1.0, views)
        kw = dict(causal=causal, window=win, logit_softcap=cap)
        out = FA.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        route = "tensor cores" if dtype == bf16 else "CUDA cores"
        what = (f"flash {(b, hq, hkv, sq, sk, d)} {str(dtype)[6:]} ({route})"
                f" softcap {cap:g} window {win}"
                + (f" scores x{scale:g}" if scale != 1.0 else "")
                + (" einsum views" if views else "")
                + ("" if causal else " non-causal"))
        err = compare(torch, out, FA.flash_attention_plain(q, k, v, **kw),
                      dtype, what)
        worst[dtype] = max(worst[dtype], err)
        line = f"[kernels] {what}: max_abs_err {err:.3e}"
        if case not in timed:
            print(line, flush=True)
            continue
        iters = 20 if dtype == bf16 else 3
        ms = time_ms(torch, lambda: FA.flash_attention(q, k, v, **kw), iters)
        plain_ms = time_ms(
            torch, lambda: FA.flash_attention_plain(q, k, v, **kw), 3)
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
        flops = 4 * b * hq * d * FA.visible_pairs(sq, sk, causal=True,
                                                  window=win)
        peak = H100_BF16_FLOPS if dtype == bf16 else H100_F32_FLOPS
        t_bytes, t_ops = nbytes / H100_HBM_BW, flops / peak
        bound = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes > t_ops else "operations"
        lib_ms, lib = None, None
        if dtype == bf16 and cap == 0.0 and (win == 0 or win >= sk):
            lib = "SDPA"
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 20)
        elif dtype == bf16 and b == 4 and win == 4096:
            lib = "flex_attention"
            call, lib_err = flex_library(torch, q, k, v, cap, win)
            if call is None:
                lib = "flex_attention refused"
            else:
                lib_ms = time_ms(torch, call, 20)
                line += f", flex_attention max_abs_err {lib_err:.3e}"
        line += (f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                 + (f"{lib} {lib_ms:.4f} ms, " if lib_ms else
                    f"{lib}, " if lib else "")
                 + f"bound {bound:.4f} ms ({by}), "
                 f"{flops / ms / 1e9:.1f} TFLOP/s = "
                 f"{100 * bound / ms:.1f}% of the bound")
        print(line, flush=True)
        entry = dict(shape=[b, hq, hkv, sq, sk, d], softcap=cap, window=win,
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound, bound_by=by, library_ms=lib_ms,
                     library=lib)
        if (b, sq, cap, win) == (4, 1000, 50.0, 4096) and dtype == bf16:
            table["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:93",
                **{k: entry[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "library")},
                routes={"bfloat16": dict(
                            kernel="flash_tc_kernel",
                            design="tensor cores: wgmma, TMA into an "
                                   "mbarrier ring, warp-specialised"),
                        "float32": dict(kernel="flash_fwd_kernel",
                                        design="CUDA cores")})
        elif d == 128:
            table["flash_attention"]["mixtral_case"] = entry
        elif dtype == f32:
            table["flash_attention"]["routes"]["float32"]["gemma2_case"] = \
                entry
    table["flash_attention"]["routes"]["bfloat16"]["max_abs_err_all_cases"] \
        = worst[bf16]
    table["flash_attention"]["routes"]["float32"]["max_abs_err_all_cases"] \
        = worst[f32]


def grouped_mm_library(torch, x, w, gs):
    """The yardstick for the grouped matmul, never used by the port: one
    ``torch._grouped_mm`` call, or None when this build refuses the inputs.
    Tried once eagerly, so a refusal never happens inside a graph
    capture."""
    offs = torch.cumsum(gs, 0).to(torch.int32)
    try:
        torch._grouped_mm(x, w, offs=offs)
        torch.cuda.synchronize()
    except (RuntimeError, AttributeError, TypeError) as exc:
        print(f"[kernels] torch._grouped_mm refused the inputs: "
              f"{str(exc).splitlines()[0][:160]}", flush=True)
        return None
    return lambda: torch._grouped_mm(x, w, offs=offs)


GMM_ACTS = (None, "silu_gated", "gelu_gated")  # None: the plain product


def phase_gmm(torch, randn, table) -> None:
    """The grouped matmul, plain and gated (silu and tanh gelu), against
    its plain versions on every route: f32 (CUDA cores), and in bf16 the
    wgmma/TMA route and the small-tile route, each forced at every edge
    case it takes: tiles that straddle experts (sizes off 128), groups of
    1, every row in one expert, an empty expert, rows past the groups
    (exactly zero), T below 64, widths that are multiples of 8 but not of
    64, widths off 8 (small-tile and f32 only). Then mixtral-8x7b's prefill
    (batch 4 x 1024 tokens, top-2: 8192 (token, slot) rows over 8 experts,
    sizes uneven and a few slots dropped past the groups) and decode (8
    rows) shapes in bf16, timed on the route the wrapper picks, each beside
    ``torch._grouped_mm``: wi and wo plain, and the gated pair (wi, wg,
    silu) in one launch against two plain launches of the same route +
    silu + mul, and against two ``torch._grouped_mm`` calls + silu + mul."""
    import torch.nn.functional as F
    from repro_torch.kernels import moe_gmm as MG
    dev = torch.device("cuda", 0)
    bf16, f32 = torch.bfloat16, torch.float32
    prefill = [1100, 950, 1280, 1005, 870, 1200, 760, 1020]  # 8185 rows
    decode = [2, 1, 0, 1, 2, 1, 0, 1]
    edges = [("mid", 1024, 512, 1024, [300, 0, 1, 129, 200, 77, 250, 60]),
             ("straddling, many tiles", 2048, 1024, 1024,
              [300, 700, 129, 500, 400]),
             ("ragged, empty expert, rows past", 200, 72, 136,
              [0, 64, 1, 100]),
             ("groups of 1", 4, 64, 64, [1, 1, 1, 1]),
             ("all rows in one", 300, 128, 256, [0, 300, 0]),
             ("T below 64", 40, 128, 264, [17, 0, 20]),
             ("widths off 64", 392, 200, 328, [130, 70, 128, 60]),
             ("widths off 8", 77, 50, 70, [13, 0, 33, 31]),
             ("no rows", 0, 64, 64, [0, 0])]

    def inputs(t, d, f, sizes, dtype, n_w=1):
        x = randn((t, d), dtype)
        ws = [randn((len(sizes), d, f), dtype, d ** -0.5) for _ in range(n_w)]
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        return x, ws, gs

    def plain(x, ws, gs, act):
        if act is None:
            return MG.moe_gmm_plain(x, ws[0], gs)
        return MG.moe_gmm_gated_plain(x, ws[0], ws[1], gs, act)

    def check(out, x, ws, gs, sizes, act, what):
        err = compare(torch, out, plain(x, ws, gs, act), x.dtype, what) \
            if out.numel() else 0.0
        if out.shape != (x.shape[0], ws[0].shape[2]) \
                or out.dtype != x.dtype or bool(out[sum(sizes):].ne(0).any()):
            fail(f"{what}: wrong shape or dtype, or rows past the groups "
                 f"not zero")
        return err

    worst = {}
    for label, t, d, f, sizes in edges:
        for dtype in (f32, bf16):
            routes = ["f32"] if dtype == f32 else \
                ["small"] + (["wgmma"] if d % 8 == 0 and f % 8 == 0 else [])
            x, ws, gs = inputs(t, d, f, sizes, dtype, 2)
            for act in GMM_ACTS:
                gate = {} if act is None else dict(wg=ws[1], act=act)
                errs = []
                for route in routes:
                    what = (f"moe_gmm{'' if act is None else ' ' + act} "
                            f"{label} {str(dtype)[6:]} route {route}")
                    out = MG._launch(x, ws[0], gs, route=route, **gate)
                    torch.cuda.synchronize()
                    errs.append(check(out, x, ws, gs, sizes, act, what))
                    key = (route, act is not None)
                    worst[key] = max(worst.get(key, 0.0), errs[-1])
                # and through the public wrapper, on the route it picks
                out = MG.moe_gmm(x, ws[0], gs) if act is None else \
                    MG.moe_gmm_gated(x, ws[0], ws[1], gs, act)
                torch.cuda.synchronize()
                errs.append(check(out, x, ws, gs, sizes, act,
                                  f"moe_gmm {act} {label} wrapper"))
                route = MG.gmm_route(dtype, t, d, f, len(sizes), True) \
                    if t else "none"
                print(f"[kernels] moe_gmm {act or 'plain'} {label} "
                      f"({t}, {d}, {f}) groups {sizes} {str(dtype)[6:]}: "
                      f"routes {routes} (wrapper: {route}), max_abs_err "
                      f"{max(errs):.3e}", flush=True)
            del x, ws, gs

    def bound_of(n, t, d, f, used, n_w):
        # x's rows in the groups read, the used experts' weights read, the
        # whole output written; the products of the rows in the groups
        nbytes = 2 * (n * d + n_w * used * d * f + t * f)
        t_bytes = nbytes / H100_HBM_BW
        t_ops = 2 * n_w * n * d * f / H100_BF16_FLOPS
        by = "bytes" if t_bytes > t_ops else "operations"
        return max(t_bytes, t_ops) * 1e3, by

    timed = [("prefill wi", 8192, 4096, 14336, prefill, None),
             ("prefill wo", 8192, 14336, 4096, prefill, None),
             ("decode wi", 8, 4096, 14336, decode, None),
             ("decode wo", 8, 14336, 4096, decode, None),
             ("prefill gated", 8192, 4096, 14336, prefill, "silu_gated"),
             ("decode gated", 8, 4096, 14336, decode, "silu_gated")]
    for label, t, d, f, sizes, act in timed:
        n_w = 1 if act is None else 2
        x, ws, gs = inputs(t, d, f, sizes, bf16, n_w)
        route = MG.gmm_route(bf16, t, d, f, len(sizes), True)
        what = f"moe_gmm {label} ({t}, {d}, {f}) bf16 route {route}"
        iters = 5 if t > 8 else 20
        n, used = sum(sizes), sum(1 for z in sizes if z)
        bound, by = bound_of(n, t, d, f, used, n_w)
        lib = [grouped_mm_library(torch, x, w, gs) for w in ws]
        lib_ms = time_ms(torch, lib[0], iters) if lib[0] else None
        if act is None:
            out = MG.moe_gmm(x, ws[0], gs)
            torch.cuda.synchronize()
            err = check(out, x, ws, gs, sizes, act, what)
            ms = time_ms(torch, lambda: MG.moe_gmm(x, ws[0], gs), iters)
            plain_ms = time_ms(torch, lambda: plain(x, ws, gs, act), 2)
            extra, line = {}, ""
        else:
            out = MG.moe_gmm_gated(x, ws[0], ws[1], gs, act)
            torch.cuda.synchronize()
            err = check(out, x, ws, gs, sizes, act, what)

            def unfused():
                h = MG._launch(x, ws[0], gs, route=route)
                F.silu(h, inplace=True)
                return h.mul_(MG._launch(x, ws[1], gs, route=route))

            def composed():
                h = lib[0]()
                F.silu(h, inplace=True)
                return h.mul_(lib[1]())

            err_unfused = check(unfused(), x, ws, gs, sizes, act,
                                f"{what}, two launches + silu + mul")
            ms = time_ms(torch, lambda: MG.moe_gmm_gated(
                x, ws[0], ws[1], gs, act), iters)
            unfused_ms = time_ms(torch, unfused, iters)
            ms_again = time_ms(torch, lambda: MG.moe_gmm_gated(
                x, ws[0], ws[1], gs, act), iters)
            plain_ms = time_ms(torch, lambda: plain(x, ws, gs, act), 2)
            lib_one_ms = lib_ms
            lib_ms = None  # no one PyTorch call computes the gated pair
            composed_ms = time_ms(torch, composed, iters) \
                if all(lib) else None
            extra = dict(ms_second=ms_again, unfused_ms=unfused_ms,
                         unfused_max_abs_err=err_unfused,
                         library_composed_ms=composed_ms,
                         library_one_product_ms=lib_one_ms)
            line = (f"; again {ms_again:.4f} ms; two launches + silu + mul "
                    f"{unfused_ms:.4f} ms; 2 x torch._grouped_mm + silu + "
                    f"mul " + (f"{composed_ms:.4f} ms" if composed_ms
                               else "refused")
                    + (f", one torch._grouped_mm {lib_one_ms:.4f} ms"
                       if lib_one_ms else ""))
        flops = 2 * n_w * n * d * f
        print(f"[kernels] {what} groups {sizes}: max_abs_err {err:.3e}, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              + (f"torch._grouped_mm {lib_ms:.4f} ms, " if lib_ms else "")
              + f"bound {bound:.4f} ms ({by}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s, "
              f"{100 * bound / ms:.1f}% of the bound" + line, flush=True)
        entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                     library_ms=lib_ms, max_abs_err=err, kernel_route=route,
                     **extra)
        name = "moe_gmm" if act is None else "moe_gmm_gated"
        if name not in table:
            table[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/moe_gmm.cu",
                replaces="src/repro/kernels/moe_gmm.py:54", **entry,
                routes={"bfloat16 many rows": "gmm_tma_kernel: wgmma fed by "
                        "TMA through a 4-stage mbarrier ring, "
                        "warp-specialised",
                        "bfloat16 few rows": "gmm_small_kernel: wmma, two "
                        "slices in flight through registers",
                        "float32": "gmm_f32_kernel: CUDA cores"},
                max_abs_err_all_cases={f"{r}{' gated' if g else ''}": v
                                       for (r, g), v in worst.items()})
        else:
            table[name][label.replace(" ", "_") + "_case"] = entry
        del x, ws, gs, out, lib


def phase_backward(torch, randn, table) -> None:
    """The backward kernels against their plain versions, and against
    autograd through the forward's plain version (``gradcheck``-style), in
    f32 and bf16. Flash: gemma2-9b's training shape (B 4, Hq 16, Hkv 8, S
    1024, D 256, softcap 50) with window 4096 and 0, D 128 with a window of
    256, and ragged Sq/Sk tails; timed at gemma2's shape against the
    backward of flex_attention (softcap as a score_mod, causal + window as
    a block mask) and at D 128 against SDPA's backward. RMSNorm: the train
    path's rows [4096, 3584] and row tails, timed against the backward of
    ``F.rms_norm``; its dscale must be the same bits from run to run (no
    atomics). A library's backward is timed alone, graph-replayed, as the
    kernel is (``time_grad_ms``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    bf16, f32 = torch.bfloat16, torch.float32
    # (b, hq, hkv, sq, sk, d, softcap, window), timed when marked
    cases = [((4, 16, 8, 1024, 1024, 256, 50.0, 4096), True),
             ((4, 16, 8, 1024, 1024, 256, 50.0, 0), False),
             ((2, 32, 8, 1024, 1024, 128, 0.0, 256), True),
             ((1, 4, 2, 1000, 1000, 256, 50.0, 0), False),
             ((1, 4, 2, 100, 300, 64, 0.0, 33), False),
             ((2, 4, 4, 77, 77, 32, 0.0, 0), False)]
    for (b, hq, hkv, sq, sk, d, cap, win), timed in cases:
        for dtype in (f32, bf16):
            q, do = randn((b, hq, sq, d), dtype), randn((b, hq, sq, d), dtype)
            k, v = randn((b, hkv, sk, d), dtype), randn((b, hkv, sk, d), dtype)
            args = (True, win, cap)
            o, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, *args)
            got = torch.ops.repro_torch.flash_attention_bwd(q, k, v, o, lse,
                                                            do, *args)
            torch.cuda.synchronize()
            kw = dict(causal=True, window=win, logit_softcap=cap)
            what = (f"flash backward {(b, hq, hkv, sq, sk, d)} "
                    f"{str(dtype)[6:]} softcap {cap:g} window {win}")
            # the forward's lse (natural log on both routes) against plain
            lse_err = compare(torch, lse, FA.flash_attention_lse_plain(
                q, k, v, **kw)[1], dtype, f"{what} forward's lse")
            want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
            err = max(compare(torch, g, w, dtype, f"{what} {n}")
                      for n, g, w in zip(("dq", "dk", "dv"), got, want))
            # autograd through the forward's plain version (f32 math)
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
            ref = torch.autograd.grad(
                FA.flash_attention_plain(*leaves, **kw), leaves, do)
            ag = max(compare(torch, g, w, dtype, f"{what} {n} vs autograd")
                     for n, g, w in zip(("dq", "dk", "dv"), got, ref))
            del want, ref, leaves
            line = (f"[kernels] {what}: max_abs_err {err:.3e} vs the plain "
                    f"backward, {ag:.3e} vs autograd through the plain "
                    f"forward; forward's lse {lse_err:.3e}")
            if timed:
                ms = time_ms(torch, lambda: torch.ops.repro_torch
                             .flash_attention_bwd(q, k, v, o, lse, do, *args),
                             3)
                fwd_ms = time_ms(torch, lambda: torch.ops.repro_torch
                                 .flash_attention_lse(q, k, v, *args), 3)
                plain_ms = time_ms(torch, lambda: FA.flash_attention_bwd_plain(
                    q, k, v, o, lse, do, **kw), 2)
                pairs = FA.visible_pairs(sq, sk, causal=True, window=win)
                flops = 10 * b * hq * d * pairs
                e = q.element_size()
                # q, k, v, o, dO and lse read once; dQ, dK, dV written
                nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * e \
                    + lse.numel() * 4
                peak = H100_BF16_FLOPS if dtype == bf16 else H100_F32_FLOPS
                t_bytes, t_ops = nbytes / H100_HBM_BW, flops / peak
                bound = max(t_bytes, t_ops) * 1e3
                by = "bytes" if t_bytes > t_ops else "operations"
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in (q, k, v)]
                if cap == 0.0:
                    lib = "SDPA backward"
                    mask = FA.visible_mask(sq, sk, causal=True, window=win,
                                           device=q.device)
                    call = (lambda: F.scaled_dot_product_attention(
                        *leaves, attn_mask=mask, enable_gqa=True))
                else:
                    lib = "flex_attention backward"
                    call, _ = flex_library(torch, q, k, v, cap, win)
                    if call is not None:
                        call = (lambda call=call: call(*leaves))
                lib_ms = None
                if call is None:
                    lib = "flex_attention refused"
                else:
                    lib_ms, lib_grads = time_grad_ms(torch, call, leaves, do,
                                                     3)
                    lib_err = max(float((g.float() - w.float()).abs().max())
                                  for g, w in zip(lib_grads, got))
                    line += f", {lib} max_abs_err {lib_err:.3e} vs the kernel"
                    del lib_grads
                del leaves
                line += (f", kernel {ms:.4f} ms (forward with lse "
                         f"{fwd_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                         + (f"{lib} {lib_ms:.4f} ms, " if lib_ms else
                            f"{lib}, ")
                         + f"bound {bound:.4f} ms ({by}), "
                         f"{flops / ms / 1e9:.1f} TFLOP/s = "
                         f"{100 * bound / ms:.1f}% of the bound")
                entry = dict(shape=[b, hq, hkv, sq, sk, d], softcap=cap,
                             window=win, dtype=str(dtype)[6:],
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=lib_ms,
                             library=lib, forward_lse_ms=fwd_ms)
                if d == 256 and dtype == f32:
                    table["flash_attention_bwd"] = dict(
                        name="flash_attention_bwd", route="cuda",
                        source="src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                        replaces="src/repro/models/layers.py:242",
                        backward_of="src/repro/kernels/flash_attention.py:93",
                        **{k: entry[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "library")},
                        kernels="flash_bwd_delta_kernel, "
                                "flash_bwd_dkdv_kernel, flash_bwd_dq_kernel "
                                "(CUDA cores, f32 and bf16)")
                else:
                    table["flash_attention_bwd"][
                        f"case_d{d}_{str(dtype)[6:]}"] = entry
            print(line, flush=True)
            del q, k, v, o, lse, do, got

    for shape in [(4096, 3584), (4097, 3584), (1000, 512), (7, 100),
                  (3, 5, 128)]:
        for dtype in (f32, bf16):
            x, dy = randn(shape, dtype), randn(shape, dtype)
            sc = randn(shape[-1:], dtype, 0.1)
            got = torch.ops.repro_torch.rmsnorm_bwd(x, sc, dy, 1e-5)
            again = torch.ops.repro_torch.rmsnorm_bwd(x, sc, dy, 1e-5)
            torch.cuda.synchronize()
            want = RN.rmsnorm_bwd_plain(x, sc, dy)
            what = f"rmsnorm backward {shape} {str(dtype)[6:]}"
            err = max(compare(torch, got[0], want[0], dtype, f"{what} dx"),
                      compare(torch, got[1], want[1], dtype,
                              f"{what} dscale"))
            leaves = [x.detach().clone().requires_grad_(True),
                      sc.detach().clone().requires_grad_(True)]
            ref = torch.autograd.grad(RN.rmsnorm_plain(*leaves), leaves, dy)
            ag = max(compare(torch, got[0], ref[0], dtype,
                             f"{what} dx vs autograd"),
                     compare(torch, got[1], ref[1], dtype,
                             f"{what} dscale vs autograd"))
            if not torch.equal(got[1], again[1]):
                fail(f"{what}: dscale differs between two runs")
            line = (f"[kernels] {what}: max_abs_err {err:.3e} vs the plain "
                    f"backward, {ag:.3e} vs autograd through the plain "
                    f"forward; dscale the same bits twice")
            if shape == (4096, 3584):
                ms = time_ms(torch, lambda: torch.ops.repro_torch
                             .rmsnorm_bwd(x, sc, dy, 1e-5), 20)
                plain_ms = time_ms(torch, lambda: RN.rmsnorm_bwd_plain(
                    x, sc, dy), 5)
                xl = x.detach().clone().requires_grad_(True)
                wl = (1.0 + sc).detach().requires_grad_(True)
                lib_ms, _ = time_grad_ms(
                    torch, lambda: F.rms_norm(xl, shape[-1:], wl, 1e-5),
                    (xl, wl), dy, 20)
                nbytes = 3 * x.numel() * x.element_size() \
                    + 2 * sc.numel() * sc.element_size()
                flops = 10 * x.numel()
                bound = max(nbytes / H100_HBM_BW, flops / H100_F32_FLOPS) \
                    * 1e3
                line += (f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"F.rms_norm backward {lib_ms:.4f} ms, "
                         f"bound {bound:.4f} ms (bytes), "
                         f"{100 * bound / ms:.1f}% of the bound")
                if dtype == f32:
                    table["rmsnorm_bwd"] = dict(
                        name="rmsnorm_bwd", route="cuda",
                        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                        replaces="src/repro/models/layers.py:23",
                        backward_of="src/repro/kernels/rmsnorm.py:40",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by="bytes", library_ms=lib_ms,
                        library="F.rms_norm backward",
                        kernels="rmsnorm_bwd_kernel, rmsnorm_dscale_kernel")
                else:
                    table["rmsnorm_bwd"]["bf16_case"] = dict(
                        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=bound, max_abs_err=err)
            print(line, flush=True)
            del x, dy, sc, got, again, want, ref, leaves


def to_device(tree, dev):
    """A nested dict/list of tensors, moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


class RouteLog:
    """Records every MoE layer's expert choices and kept slots (copied to
    the host) while active, except while a CUDA graph is being captured
    (its replays run no Python): a graph-replayed decode logs its eager
    warm-up step only. For checks outside the measured runs only: the
    copies stall the host."""

    def __init__(self):
        from repro_torch.models import moe as MOE
        self._moe, self._route, self.calls = MOE, MOE.route, []

    def __enter__(self):
        def route(*args, **kwargs):
            import torch
            out = self._route(*args, **kwargs)
            if not torch.cuda.is_current_stream_capturing():
                self.calls.append((out[1].cpu(), out[2].cpu()))
            return out
        self._moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def phase_reduced(torch, arch: str, seq: int):
    """A reduced model: the card (hand kernels) against the CPU (plain
    versions) on the same weights and prompts, in f32."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import init_params
    from repro_torch.serve.decode import (decode_cache, greedy_generate,
                                          make_prefill_step)
    cfg = get_arch(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, torch.device("cpu"))
    tokens = torch.randint(0, cfg.vocab, (2, seq),
                           generator=torch.Generator().manual_seed(1))
    prefill = make_prefill_step(cfg)
    results, routes = {}, {}
    for dev in (torch.device("cpu"), torch.device("cuda", 0)):
        p = to_device(params, dev)
        with RouteLog() as log:
            logits, cache = prefill(p, {"tokens": tokens.to(dev)})
            first = torch.argmax(logits, -1).to(torch.int32)
            toks, _ = greedy_generate(cfg, p,
                                      decode_cache(cfg, cache, seq + 8),
                                      first, seq, 8)
        results[dev.type] = (logits.cpu(), toks.cpu())
        routes[dev.type] = log.calls
    err = float((results["cpu"][0] - results["cuda"][0]).abs().max())
    same = bool(torch.equal(results["cpu"][1], results["cuda"][1]))
    line = (f"[reduced] {cfg.name} prefill logits card vs CPU max abs err "
            f"{err:.3e}; 8 greedy tokens equal: {same}")
    if cfg.moe is not None:
        pairs = list(zip(routes["cpu"], routes["cuda"]))
        flips = sum(int(((ci != gi) | (ck != gk)).sum())
                    for (ci, ck), (gi, gk) in pairs)
        total = sum(ci.numel() for (ci, _), _ in pairs)
        line += (f"; expert choices flipped card vs CPU: {flips} of {total}"
                 f" (token, slot) pairs over {len(pairs)} MoE layer calls")
    print(line, flush=True)
    if err > 2e-3 or not same:
        fail(f"reduced {arch} on the card disagrees with the CPU")


def phase_paper(torch, gpu: str, dev=None) -> None:
    """The paper's evaluation on the port's probes: the seven Rodinia
    families probed on fake tensors on the card (nothing allocated) at 2 GB
    and 8 GB, then Fig. 5 and Table II (``repro_torch.bench``) on the
    vectors their mixes draw, probed on the card, with their band lines
    (printed, not enforced, as the reference does)."""
    from repro_torch.bench import fig5_throughput, table2_crashes
    from repro_torch.core import workloads as W
    dev = dev or torch.device("cuda", 0)
    for fam in sorted(W.EFFICIENCY):
        for gb in (2, 8):
            v = W._probe_family(fam, gb * W.GB, dev)
            print(f"[paper] {fam} at {gb} GB on {gpu}: hbm {v.hbm_bytes} B "
                  f"({v.hbm_bytes / (gb * W.GB):.3f} of the target), flops "
                  f"{v.flops:.4e}, bytes {v.bytes_accessed:.4e}, core "
                  f"{v.core_demand:.3f}, bw {v.bw_demand:.3f}", flush=True)
            if not 0.75 <= v.hbm_bytes / (gb * W.GB) <= 1.25:
                fail(f"{fam} at {gb} GB: the footprint is not within 25% "
                     f"of the target")
    t = time.perf_counter()
    fig5_throughput.run(device=dev)
    table2_crashes.run(device=dev)
    print(f"[paper] Fig. 5 and Table II on the card's probes in "
          f"{time.perf_counter() - t:.1f} s", flush=True)


def twin_inputs(torch, family: str, gen):
    """Small seeded f32 inputs of a Rodinia family (``phase_twin``)."""
    def u(*shape):
        return torch.rand(shape, generator=gen) * 2 - 1
    if family == "backprop":
        return u(256, 256), u(256, 256) * 0.1, u(256, 256) * 0.1
    if family == "srad":
        return (torch.rand((256, 256), generator=gen) + 0.5,)
    if family == "lavamd":
        return u(64, 128, 3), u(128)
    if family == "bfs":
        return ((torch.rand((512, 512), generator=gen) < 0.05).float(),
                (torch.rand(512, generator=gen) < 0.05).float())
    return (u(128, 128),)  # needle, dwt2d


def phase_twin(torch, dev=None) -> None:
    """The reference's determinism claim on the card: one submission trace
    (``tests/test_cluster.py::_ordering_trace``, seven jobs with priorities
    and deadlines on one exclusive device) on a live ``Cluster`` whose
    runners each run a small Rodinia family on the card, and on a sim
    ``Cluster``; fails if ``obs.replay.diff_streams`` finds a divergence
    between their admission orders, or if a family's card output differs
    from its CPU run beyond atol = rtol = 1e-4 (f32)."""
    from repro_torch.core import workloads as W
    from repro_torch.core.cluster import Cluster, JobStatus
    from repro_torch.core.executor import ExecJob
    from repro_torch.core.probe import probe_fn
    from repro_torch.core.scheduler import MGBAlg2Scheduler
    from repro_torch.core.task import Job, ResourceVector, Task, UnitTask
    from repro_torch.obs.replay import admission_order, diff_streams
    families = ["backprop", "srad", "lavamd", "needle", "dwt2d", "bfs",
                "backprop"]
    names = ["first", "low-a", "low-b", "hi-late", "hi-edf-9", "hi-edf-1",
             "low-edf"]
    ranks = [(None, None), (0, None), (0, None), (5, None), (5, 9.0),
             (5, 1.0), (0, 3.0)]
    expected = ["first", "hi-edf-1", "hi-edf-9", "hi-late", "low-edf",
                "low-a", "low-b"]
    dev = dev or torch.device("cuda", 0)
    gate = threading.Event()
    checked = []

    def job(i, live: bool):
        fam = families[i]
        args = twin_inputs(torch, fam, torch.Generator().manual_seed(i))
        fn = getattr(W, f"_k_{fam}")
        vec = probe_fn(fn, *[a.to(dev) for a in args])
        vec = ResourceVector(hbm_bytes=vec.hbm_bytes, flops=vec.flops,
                             bytes_accessed=vec.bytes_accessed,
                             est_seconds=0.01, core_demand=1.0,
                             bw_demand=1.0)
        task = Task(units=[UnitTask(fn=None, memobjs=frozenset({names[i]}),
                                    resources=vec, name=names[i])],
                    name=names[i])
        plain = Job(tasks=[task], name=names[i])
        if not live:
            return plain

        def runner(device, i=i, fn=fn, args=args, fam=fam):
            if i == 0:
                gate.wait(30.0)  # the others park behind it
            got = fn(*[a.to(device) for a in args])
            got = got if isinstance(got, tuple) else (got,)
            want = fn(*args)
            want = want if isinstance(want, tuple) else (want,)
            err = max(compare(torch, g.cpu(), w, torch.float32,
                              f"twin {fam} card vs CPU")
                      for g, w in zip(got, want))
            checked.append((names[i], fam, err))
        return ExecJob(job=plain, runners=[runner])

    streams = {}
    for backend in ("live", "sim"):
        live = backend == "live"
        c = Cluster(MGBAlg2Scheduler(1), workers=1 if live else 8,
                    backend=backend, trace=True,
                    devices=[dev] if live else None)
        handles = []
        for i, (prio, deadline) in enumerate(ranks):
            handles.append(c.submit(job(i, live), priority=prio,
                                    deadline_s=deadline))
        gate.set()
        c.drain()
        c.shutdown()
        if any(h.status is not JobStatus.DONE for h in handles):
            fail(f"twin {backend}: {[h.job.error for h in handles]}")
        streams[backend] = c.trace.events()
    div = diff_streams(streams["live"], streams["sim"])
    order = admission_order(streams["live"])
    print(f"[twin] ordering trace, live on the card ({len(checked)} Rodinia "
          f"families run, card vs CPU max abs err "
          f"{max(e for *_, e in checked):.3e}) and simulated: admission "
          f"order {order}; first divergence {div}", flush=True)
    if div is not None or order != expected or len(checked) != 7:
        fail(f"twin: live and simulated runs diverge: {div}")


def counters():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba_scan as SC
    from repro_torch.kernels import moe_gmm as MG
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.serve import decode as SD
    return {"rmsnorm": RN.LAUNCHES, "flash_attention": FA.LAUNCHES,
            "mamba_scan": SC.LAUNCHES, "moe_gmm": MG.LAUNCHES,
            "moe_gmm_gated": MG.GATED_LAUNCHES,
            "flash_attention_bwd": FA.BWD_LAUNCHES,
            "rmsnorm_bwd": RN.BWD_LAUNCHES,
            "graph_captures": SD.CAPTURES, "graph_replays": SD.REPLAYS}


def read_counts() -> dict:
    return {name: c.value for name, c in counters().items()}


def expected_launches(cfg, prefills: int, steps: int) -> dict:
    """Each kernel's launches on a serve path: per prefill, one scan per
    Mamba layer or one flash attention per attention layer; per prefill and
    per decode step, one RMSNorm per norm of a layer plus the final norm,
    and for an MoE layer two grouped-matmul launches (``moe_gmm`` counts
    both): the gated one (wi, wg) and wo, or wi and wo ungated."""
    if cfg.family == "ssm":
        return {"rmsnorm": (cfg.n_layers + 1) * (prefills + steps),
                "flash_attention": 0, "mamba_scan": cfg.n_layers * prefills,
                "moe_gmm": 0, "moe_gmm_gated": 0, "flash_attention_bwd": 0,
                "rmsnorm_bwd": 0}
    moe_layers = 0 if cfg.moe is None else cfg.n_layers
    gated = moe_layers if cfg.mlp_act.endswith("gated") else 0
    return {"rmsnorm": (2 * cfg.n_layers + 1) * (prefills + steps),
            "flash_attention": cfg.n_layers * prefills, "mamba_scan": 0,
            "moe_gmm": 2 * moe_layers * (prefills + steps),
            "moe_gmm_gated": gated * (prefills + steps),
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0}


def expected_train_launches(cfg, steps: int) -> dict:
    """Each kernel's launches over ``steps`` train steps of a dense model
    under ``remat_policy="full"``: per step and layer, flash attention's
    forward twice (the forward and the layer's recompute in the backward)
    and its backward once; RMSNorm's forward 4 times a layer (two norms,
    each run again in the recompute) plus the final norm once, its
    backward twice a layer plus once."""
    n = cfg.n_layers
    assert cfg.remat_policy == "full" and cfg.family == "dense"
    return {"rmsnorm": (4 * n + 1) * steps, "flash_attention": 2 * n * steps,
            "mamba_scan": 0, "moe_gmm": 0, "moe_gmm_gated": 0,
            "flash_attention_bwd": n * steps, "rmsnorm_bwd": (2 * n + 1) * steps}


def check_launches(what: str, cfg, counts: dict, prefills: int,
                   steps: int, captures: int, replays: int) -> dict:
    """A path's launches, replays included. A decode step replayed from a
    CUDA graph runs its kernels without their wrappers, so the counters see
    the warm-up and the capture of each graph (both counted as a step here)
    and no replay: they must equal the formula for ``prefills`` prefills
    and ``steps - replays + captures`` steps exactly, the capture and replay
    counts must be the ones given, and the launches that ran are the counted
    ones plus replays x the launches of one step taken at capture (the
    formula's). Returns the launches by kernel, replays included."""
    got = {k: counts[k] for k in expected_launches(cfg, 0, 0)}
    want = expected_launches(cfg, prefills, steps - replays + captures)
    print(f"[launches] {what}: counted {got}, expected {want}; graphs "
          f"captured {counts['graph_captures']} (expected {captures}), "
          f"replayed {counts['graph_replays']} (expected {replays})",
          flush=True)
    if got != want or counts["graph_captures"] != captures \
            or counts["graph_replays"] != replays:
        fail(f"{what}: launches, captures or replays differ from expected")
    per_step = expected_launches(cfg, 0, 1)
    return {k: got[k] + replays * per_step[k] for k in got}


def fresh_card(torch) -> int:
    """Nothing of an earlier run may stay allocated while one is measured
    (mixtral's weights alone take 70.2e9 B of the card). cuBLAS keeps a
    workspace for every stream it ran on (32 MiB each on Hopper, allocated
    through PyTorch's allocator), so the earlier phases' are released too.
    Returns the bytes still allocated."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    left = torch.cuda.memory_allocated()
    if left >= 1e9:
        fail(f"{left} B still allocated from an earlier phase")
    return left


def full_cfg(arch: str, n_layers=None):
    """The published configuration, its depth cut to ``n_layers``."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(arch)
    return cfg if n_layers is None else \
        dataclasses.replace(cfg, n_layers=n_layers)


def check_tokens(what: str, generated, shape, vocab: int) -> None:
    import numpy as np
    for i, g in enumerate(generated):
        g = None if g is None else np.asarray(g)
        if g is None or g.shape != shape or g.min() < 0 or g.max() >= vocab:
            fail(f"{what}: item {i} generated "
                 f"{None if g is None else g.shape} tokens out of range")


class PhaseClock:
    """While the block runs, the host, stream and wall seconds of each
    prefill and each decode graph's warm-up and capture made on a pool
    thread: ``host`` until the Python call returns, ``stream`` between CUDA
    events on the worker's stream around it, ``wall`` until that stream is
    synchronised (``tools/pool_workers.py`` splits them further, with stack
    samples)."""

    def __init__(self, torch):
        self.torch = torch
        self.spent = {"prefill": [], "warm-up + capture": []}
        self.lock = threading.Lock()

    def _timed(self, what, fn):
        torch = self.torch

        def run(*a, **k):
            stream = torch.cuda.current_stream()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            t = time.perf_counter()
            out = fn(*a, **k)
            host = time.perf_counter() - t
            end.record(stream)
            stream.synchronize()
            wall = time.perf_counter() - t
            if threading.current_thread() is not threading.main_thread():
                with self.lock:
                    self.spent[what].append(
                        (host, start.elapsed_time(end) / 1e3, wall))
            return out
        return run

    def __enter__(self):
        from repro_torch.launch import serve as S
        from repro_torch.serve import decode as SD
        self._saved = (S.make_prefill_step, SD.StepGraph.__init__)
        make = S.make_prefill_step
        S.make_prefill_step = lambda cfg: self._timed("prefill", make(cfg))
        SD.StepGraph.__init__ = self._timed("warm-up + capture",
                                            SD.StepGraph.__init__)
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import serve as S
        from repro_torch.serve import decode as SD
        S.make_prefill_step, SD.StepGraph.__init__ = self._saved

    def summary(self) -> str:
        def mean(v, i):
            return sum(x[i] for x in v) / len(v) * 1e3
        return "; ".join(
            f"{k} {mean(v, 0):.1f}/{mean(v, 1):.1f}/{mean(v, 2):.1f} "
            f"({len(v)})" for k, v in self.spent.items() if v)


def phase_serve(torch, arch: str, prompt_len: int, wide: bool,
                n_layers=None):
    """One main path: ``arch`` at every published width (depth cut to
    ``n_layers`` if given) in bf16 through ``serve()``, every decode loop
    replayed from a CUDA graph, with every kernel's launch count checked
    exactly; then one batch alone (the probe and the worker's reserve
    against the observed peak: fails below 1.0) and, with ``wide``, the
    same 32 requests on four pool workers sharing the card (fails where
    they serve fewer tokens/s than one)."""
    from repro_torch.launch.serve import serve
    cfg = full_cfg(arch, n_layers)
    kw = dict(full=True, param_dtype=torch.bfloat16, batch=4,
              prompt_len=prompt_len, gen_len=32, num_devices=1,
              n_layers=n_layers)
    fresh_card(torch)
    for c in counters().values():
        c.reset()
    with PhaseClock(torch) as one_clock:
        res = serve(arch, requests=32, **kw)
    counts = read_counts()
    steps = res["batches"] * (kw["gen_len"] - 1)
    launches = check_launches(
        f"serve {arch}", cfg, counts, res["batches"], steps,
        captures=res["decode_graphs"],
        replays=steps - res["decode_graphs"])
    vec = res["probe"]
    print(f"[serve] {arch} full width, {res['n_layers']} of "
          f"{res['published_layers']} layers, bf16, prompt {prompt_len}, "
          f"1 pool worker: "
          f"{res['completed']}/{res['batches']} batches done, "
          f"{res['crashed']} crashed, {res['tokens_generated']} tokens in "
          f"{res['wall_s']:.2f} s = {res['tokens_per_s']:.1f} tok/s; TTFT "
          f"p50/p99 {res['p50_ttft_s'] * 1e3:.1f}/"
          f"{res['p99_ttft_s'] * 1e3:.1f} ms; TPOT p50/p99 "
          f"{res['p50_tpot_s'] * 1e3:.2f}/{res['p99_tpot_s'] * 1e3:.2f} ms; "
          f"{res['sched_attempts']} admission attempts; scheduler HBM "
          f"{res['hbm_per_device'] / 2**30:.2f} GiB/device", flush=True)
    print(f"[serve] {arch} probe per batch (prefill): hbm {vec.hbm_bytes} B "
          f"({vec.hbm_bytes / 2**30:.3f} GiB), {vec.flops:.4e} flops, "
          f"{vec.bytes_accessed:.4e} bytes accessed, est "
          f"{vec.est_seconds * 1e3:.2f} ms, core demand "
          f"{vec.core_demand:.3f}, bw demand {vec.bw_demand:.3f}; kept by "
          f"each pool worker (its decoder: padded cache, buffers, one step; "
          f"cuBLAS workspace): {res['kept_per_worker'].hbm_bytes} B, "
          f"{res['decode_graphs']} decode graph(s) captured for "
          f"{res['batches']} batches", flush=True)
    for err in res["errors"]:
        print(f"[serve] error: {err}", flush=True)
    if res["crashed"] or res["completed"] < res["batches"] \
            or res["batches"] != 8:
        fail(f"serve {arch}: {res['completed']}/{res['batches']} completed, "
             f"{res['crashed']} crashed")
    check_tokens(f"serve {arch}", res["generated"], (4, kw["gen_len"]),
                 cfg.vocab)
    one_worker = res["tokens_per_s"]

    del res
    left = fresh_card(torch)
    alone = serve(arch, requests=4, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if alone["crashed"] or alone["completed"] != 1:
        fail(f"serve {arch}: the single-batch run did not complete")
    # what the scheduler sets aside for the batch: its probe, and what the
    # pool worker that runs it keeps (``pool_reserve``)
    charged = alone["probe"].hbm_bytes + alone["kept_per_worker"].hbm_bytes
    ratio = charged / peak
    print(f"[serve] {arch} one batch alone: probe hbm "
          f"{alone['probe'].hbm_bytes} B + kept by its worker "
          f"{alone['kept_per_worker'].hbm_bytes} B = {charged} B vs observed "
          f"max_memory_allocated {peak} B ({left} B allocated before the "
          f"run; probe/observed {ratio:.4f}); batch wall "
          f"{alone['wall_s']:.2f} s, TTFT "
          f"{alone['p50_ttft_s'] * 1e3:.1f} ms, TPOT "
          f"{alone['p50_tpot_s'] * 1e3:.2f} ms", flush=True)
    if ratio < 1.0:
        fail(f"serve {arch}: the probe and the worker's reserve ({charged} "
             f"B) are below the observed peak ({peak} B)")
    if not wide:
        return launches

    # the same 32 requests on four pool workers, each on its own stream:
    # 4 probed reservations fit the card, so 4 batches share it at once
    del alone
    fresh_card(torch)
    with PhaseClock(torch) as four_clock:
        wide_res = serve(arch, requests=32, workers=4, **kw)
    print(f"[serve] {arch} per-batch eager phases, host/stream/wall ms: "
          f"1 worker {one_clock.summary()}; 4 workers "
          f"{four_clock.summary()}", flush=True)
    print(f"[serve] {arch} 4 pool workers: {wide_res['completed']}/"
          f"{wide_res['batches']} done, {wide_res['crashed']} crashed, "
          f"{wide_res['tokens_per_s']:.1f} tok/s against "
          f"{one_worker:.1f} with 1 worker ("
          f"{wide_res['tokens_per_s'] / one_worker:.2f}x); TTFT p50/p99 "
          f"{wide_res['p50_ttft_s'] * 1e3:.1f}/"
          f"{wide_res['p99_ttft_s'] * 1e3:.1f} ms; TPOT p50/p99 "
          f"{wide_res['p50_tpot_s'] * 1e3:.2f}/"
          f"{wide_res['p99_tpot_s'] * 1e3:.2f} ms; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if wide_res["crashed"] or wide_res["completed"] != wide_res["batches"]:
        fail(f"serve {arch} with 4 workers: {wide_res['errors']}")
    check_tokens(f"serve {arch} with 4 workers", wide_res["generated"],
                 (4, kw["gen_len"]), cfg.vocab)
    if wide_res["tokens_per_s"] < one_worker:
        fail(f"serve {arch}: 4 pool workers sharing the card serve "
             f"{wide_res['tokens_per_s']:.1f} tok/s, fewer than 1 worker's "
             f"{one_worker:.1f}")
    return launches


def phase_continuous_reduced(torch, arch: str, prompt_len: int) -> None:
    """A reduced model served continuously on the card (hand kernels, the
    loop step replayed from a graph) against the same weights served
    continuously on the CPU (plain versions, eager steps), in f32: 6
    requests through ``ServeEngine`` + ``TorchModel`` with a loop of 4
    rows, 9 tokens each; the rule of ``phase_reduced``, every request's
    tokens equal."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.scheduler import MGBAlg3Scheduler
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import SLO, ServeEngine, TorchModel
    cfg = get_arch(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, torch.device("cpu"))
    prompts = torch.randint(0, cfg.vocab, (6, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    runs = {}
    for dev in (torch.device("cpu"), torch.device("cuda", 0)):
        cluster = Cluster(MGBAlg3Scheduler(1, hbm_per_device=64 << 30),
                          workers=2, devices=[dev])
        eng = ServeEngine(cluster, TorchModel(cfg, to_device(params, dev),
                                              max_batch=4,
                                              max_seq=prompt_len + 9),
                          max_batch=4, slo=SLO(600.0, 600.0))
        reqs = [eng.submit(prompt=prompts[i:i + 1], gen_len=9)
                for i in range(6)]
        eng.drain()
        m = eng.metrics()
        eng.shutdown()
        cluster.shutdown()
        if m["done"] != 6 or m["violations"]:
            fail(f"continuous reduced {arch} on {dev}: {m['done']}/6 done, "
                 f"{m['violations']} violations")
        runs[dev.type] = [r.tokens for r in reqs]
    same = runs["cuda"] == runs["cpu"]
    print(f"[continuous] reduced {arch}, 6 requests, prompt {prompt_len}, "
          f"9 tokens each: card tokens equal the CPU's: {same}", flush=True)
    if not same:
        fail(f"continuous reduced {arch} on the card disagrees with the "
             f"CPU: {runs}")


class SameMoment:
    """Holds the card's allocation against the scheduler's reservation at
    the same moment, while active: after every adoption of a row and every
    ``ServeEngine.pump``, the bytes the card holds for the run must not pass
    the device's ``used_hbm`` plus ``reserve`` (what the launcher set aside
    from the scheduler for the execution pool's streams,
    ``launch.serve.pool_reserve``), the reservation read just before and
    just after them (a task admitted or released between the two reads is
    then on the safe side of one of them). The bytes held are
    ``torch.cuda.memory_allocated()`` less the bytes allocated before the
    run, plus the free blocks of the decode graph's private memory pool
    (no other task can take them; read once from a memory snapshot after
    the capture, since replays allocate nothing). ``least`` is the
    smallest margin seen, in bytes, ``at`` the reservation and the bytes
    held at that moment; ``samples`` how many moments were read."""

    def __init__(self, torch, before: int, reserve: int):
        from repro_torch.serve import engine as E
        self._torch, self._e = torch, E
        self.before, self.reserve = before, reserve
        self.least, self.samples, self._dev = None, 0, None
        self.pool_free, self.at = 0, (0, 0)

    def graph_pool_free(self) -> int:
        """Reserved less allocated bytes of the segments in private pools."""
        free = 0
        for seg in self._torch.cuda.memory_snapshot():
            if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0):
                free += seg["total_size"] - seg["allocated_size"]
        return free

    def sample(self) -> None:
        if self._dev is None:
            return
        r1 = self._dev.used_hbm
        used = self._torch.cuda.memory_allocated() - self.before \
            + self.pool_free
        reserved = max(r1, self._dev.used_hbm)
        margin = reserved + self.reserve - used
        if self.least is None or margin < self.least:
            self.least, self.at = margin, (reserved, used)
        self.samples += 1

    def __enter__(self):
        E, mon = self._e, self
        self._saved = (E.ServeEngine.__init__, E.ServeEngine.pump,
                       E.TorchModel.adopt)
        init, pump, adopt = self._saved

        def init_(eng, *a, **k):
            init(eng, *a, **k)
            mon._dev = eng.sched.devices[0]
            mon.pool_free = mon.graph_pool_free()
            mon.sample()

        def pump_(eng):
            n = pump(eng)
            mon.sample()
            return n

        def adopt_(model, *a, **k):
            adopt(model, *a, **k)
            mon.sample()

        E.ServeEngine.__init__, E.ServeEngine.pump, E.TorchModel.adopt = \
            init_, pump_, adopt_
        return self

    def __exit__(self, *exc):
        E = self._e
        E.ServeEngine.__init__, E.ServeEngine.pump, E.TorchModel.adopt = \
            self._saved


def phase_continuous(torch, arch: str, prompt_len: int, n_layers=None):
    """A continuous main path: ``arch`` at every published width in bf16
    through ``serve_continuous`` (32 requests submitted together, 32 tokens
    each, a decode loop of 8 rows stepped from a CUDA graph, 2 pool workers
    for the prefills), every launch checked exactly, replays included, and
    the scheduler's highest reservation held against the observed peak
    (fails below 1.0)."""
    from repro_torch.launch.serve import pool_reserve, serve_continuous
    cfg = full_cfg(arch, n_layers)
    left = fresh_card(torch)
    for c in counters().values():
        c.reset()
    reserve = pool_reserve([torch.device("cuda", 0)], 2)
    with SameMoment(torch, left, reserve) as moment:
        res = serve_continuous(arch, requests=32, batch=8,
                               prompt_len=prompt_len, gen_len=32, full=True,
                               n_layers=n_layers, param_dtype=torch.bfloat16,
                               workers=2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    launches = check_launches(
        f"continuous {arch}", cfg, counts, 32, 1 + res["steps"],
        captures=1, replays=res["steps"])
    ratio = res["peak_reserved"] / peak
    lv, sv, pv = res["loop_vec"], res["slot_vec"], res["prefill_vec"]
    print(f"[continuous] {arch} full width, {res['n_layers']} layers, bf16, "
          f"prompt {prompt_len}, 32 requests, loop of 8 rows, 2 pool "
          f"workers: {res['done']} done, {res['shed']} shed, "
          f"{res['failed']} failed; {res['tokens']} tokens in "
          f"{res['wall_s']:.2f} s = {res['tokens_per_s']:.1f} tok/s; TTFT "
          f"p50/p99 {res['p50_ttft_s'] * 1e3:.1f}/"
          f"{res['p99_ttft_s'] * 1e3:.1f} ms; TPOT p50/p99 "
          f"{res['p50_tpot_s'] * 1e3:.2f}/{res['p99_tpot_s'] * 1e3:.2f} ms; "
          f"goodput {res['goodput_rps']:.3f} req/s; violations "
          f"{res['violations']}; loop base {lv.hbm_bytes} B, slot "
          f"{sv.hbm_bytes} B, prefill {pv.hbm_bytes} B; highest reservation "
          f"{res['peak_reserved']} B vs observed max_memory_allocated {peak} "
          f"B ({left} B allocated before the run; reserved/observed "
          f"{ratio:.4f}); reservation + pool reserve {reserve} B less "
          f"bytes held at the same moment, least of {moment.samples}: "
          f"{moment.least} B (reserved {moment.at[0]} B, held "
          f"{moment.at[1]} B, the graph pool's free blocks "
          f"{moment.pool_free} B counted held); graph capture "
          f"{res['capture_s'] * 1e3:.1f} ms; "
          f"{res['steps']} steps replayed, mean "
          f"{res['step_s'] / max(res['steps'], 1) * 1e3:.2f} ms a step "
          f"(host wall, token copy included)", flush=True)
    for err in res["errors"]:
        print(f"[continuous] error: {err}", flush=True)
    if res["done"] != 32 or res["violations"]:
        fail(f"continuous {arch}: {res['done']}/32 done, "
             f"{res['violations']} violations")
    check_tokens(f"continuous {arch}", res["generated"], (32,), cfg.vocab)
    if moment.least is None or moment.least < 0:
        fail(f"continuous {arch}: the card held {-(moment.least or 0)} B "
             f"more than the scheduler reserved and the pool's reserve at "
             f"one moment ({moment.samples} moments read)")
    if ratio < 1.0:
        fail(f"continuous {arch}: the highest reservation "
             f"({res['peak_reserved']} B) is below the observed peak "
             f"({peak} B)")
    return launches


def device_breakdown(torch, label: str, fn, top: int = 8) -> None:
    """Run ``fn()`` once under ``torch.profiler`` and print the device time
    by kernel: the busy total against the host wall time, the ``top``
    kernels, and the port's own kernels below them. The profiler's own cost
    inflates the wall time, not the kernels' device times."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    # only events that ran on the card: the aten ops that launch kernels
    # are credited with their kernels' time too, and CUPTI's "Command
    # Buffer Full" marks the host waiting on a full launch queue
    rows, full_ms = [], 0.0
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if e.key == "Command Buffer Full":
            full_ms += ms
        elif ms > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ms, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[profile] {label}: device busy {busy:.2f} ms over "
          f"{sum(r[1] for r in rows)} kernels in {wall_ms:.2f} ms of host "
          f"wall (profiled); launch queue full for {full_ms:.2f} ms",
          flush=True)
    for ms, count, name in rows[:top]:
        print(f"[profile]   {ms:9.3f} ms {100 * ms / busy:5.1f}% "
              f"x{count:<5d} {name[:110]}", flush=True)
    # the port's own kernels, wherever they rank
    for ms, count, name in rows[top:]:
        if any(k in name for k in PORT_KERNELS):
            print(f"[profile]   {ms:9.3f} ms {100 * ms / busy:5.1f}% "
                  f"x{count:<5d} {name[:110]} (port kernel)", flush=True)


def phase_decode(torch, arch: str, s: int, n_layers=None, streams: int = 0):
    """``arch`` at every published width (depth cut to ``n_layers`` if
    given) in bf16, batch 4 after an ``s``-token prefill: the device time of
    the prefill and of one decode step by kernel, and the wall time of an
    eager decode step against the device time of the same step replayed
    from a CUDA graph; with ``streams``, that many such loops sharing the
    card (``concurrent_steps``)."""
    from repro_torch.models import decode as D
    from repro_torch.models.model import init_params
    from repro_torch.serve.decode import decode_cache, make_prefill_step
    from torch.utils._pytree import tree_leaves
    fresh_card(torch)
    cfg = full_cfg(arch, n_layers)
    dev = torch.device("cuda", 0)
    b, steps = 4, 8
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         torch.bfloat16, dev)
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    prefill = make_prefill_step(cfg)
    logits, cache = prefill(params, {"tokens": tokens})
    del logits, cache
    device_breakdown(torch, f"{arch} prefill, batch {b} x {s}",
                     lambda: prefill(params, {"tokens": tokens}))
    logits, cache = prefill(params, {"tokens": tokens})
    tok = torch.argmax(logits, -1).to(torch.int32)
    full = decode_cache(cfg, cache, s + steps + 3)
    del cache, logits
    logits, _ = D.decode_step(params, cfg, full, tok, s)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(1, steps + 1):
        logits, _ = D.decode_step(params, cfg, full, tok, s + i)
        tok = torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t) / steps * 1e3
    if not bool(torch.isfinite(logits).all()):
        fail(f"decode {arch}: non-finite logits")
    device_breakdown(torch, f"{arch} decode step, batch {b}",
                     lambda: D.decode_step(params, cfg, full, tok, s + steps))
    graph_ms = time_ms(
        torch, lambda: D.decode_step(params, cfg, full, tok, s + steps + 1), 3)
    pos = s + steps + 2
    # the step's bound: every weight read once, but of the experts only
    # those the step routed a kept slot to, and the cache's filled slots
    experts = 0
    if cfg.moe is not None:
        with RouteLog() as log:
            D.decode_step(params, cfg, full, tok, pos)
        used = [set(i[k].tolist()) for i, k in log.calls]
        per_expert = sum(t[0].numel() * t.element_size()
                         for name, t in params["layers"][0]["moe"].items()
                         if name != "router")
        experts = per_expert * sum(map(len, used))
        skip = {id(t) for lp in params["layers"] for name, t
                in lp["moe"].items() if name != "router"}
    else:
        skip = set()
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params)
                  if id(t) not in skip)
    cache_bytes = sum(t.numel() * t.element_size() for t in full.values())
    smax = full["k"].shape[3] if "k" in full else 1
    filled = min(pos + 1, smax) / smax if "k" in full else 1.0
    bound = (weights + experts + cache_bytes * filled) / H100_HBM_BW * 1e3
    routed = (f", experts routed to {experts / 1e9:.2f} GB "
              f"({sum(map(len, used)) / len(used):.2f} of "
              f"{cfg.moe.num_experts} a layer)") if cfg.moe else ""
    print(f"[decode] {arch} {cfg.n_layers} layers, batch {b}, position {s}: "
          f"eager step {eager_ms:.2f} ms (host wall, mean of {steps}), "
          f"CUDA-graph replay {graph_ms:.2f} ms (device), card idle "
          f"{100 * (1 - graph_ms / eager_ms):.1f}% of an eager step; bound "
          f"{bound:.2f} ms (weights {weights / 1e9:.2f} GB{routed} + "
          f"cache {cache_bytes * filled / 1e9:.2f} GB read once)", flush=True)
    if streams:
        concurrent_steps(torch, params, cfg, cache_of=lambda: decode_cache(
            cfg, prefill(params, {"tokens": tokens})[1], s + 40),
            first=tok, pos=s, n=streams)


def concurrent_steps(torch, params, cfg, cache_of, first, pos: int,
                     n: int, rounds: int = 5) -> None:
    """What the card alone does with ``n`` decode loops sharing it, as the
    static path's pool workers do: ``n`` graph-captured steps, each with
    its own cache and buffers (``serve.decode.StepGraph``), replayed
    ``rounds`` times all on one stream, then each on its own stream at
    once. Device time per round, from CUDA events; no Python runs between
    the replays of a round, so the difference is the card's."""
    from repro_torch.models import decode as D
    from repro_torch.serve.decode import StepGraph
    graphs = []
    for _ in range(n):
        cache = cache_of()
        tokens = first.clone()
        p = torch.full((), pos, dtype=torch.int32, device=first.device)

        def step(cache=cache, tokens=tokens, p=p):
            logits, _ = D.decode_step(params, cfg, cache, tokens, p)
            tokens.copy_(torch.argmax(logits, dim=-1))
            p.add_(1)

        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        graphs.append((StepGraph(step, stream), cache, tokens, p))
    torch.cuda.synchronize()
    home = torch.cuda.current_stream()

    def timed(spread: bool) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for g, *_ in graphs:
            g.stream.wait_stream(home)
        for _ in range(rounds):
            for g, *_ in graphs:
                with torch.cuda.stream(g.stream if spread else home):
                    g.graph.replay()
        for g, *_ in graphs:
            home.wait_stream(g.stream)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / rounds

    one = timed(False)
    many = timed(True)
    print(f"[decode] {cfg.name} {n} decode loops sharing the card (graph "
          f"replays, batch {first.shape[0]} each): {one:.2f} ms a round on "
          f"one stream, {many:.2f} ms on {n} streams at once "
          f"({one / many:.2f}x)", flush=True)
    del graphs
    torch.cuda.synchronize()


# gemma2-9b trains at every published width in f32 with its depth cut:
# all 42 layers are 9.24e9 parameters x 16 B (f32 weight, gradient and two
# moments) = 148e9 B, beyond one 80 GB card; 12 are 3,295,763,968 x 16 B =
# 52.7e9 B, leaving room for the saved layer inputs, one layer's recompute,
# the loss chunks and the update's temporaries (an even depth keeps local
# and global layers paired). The probe of one step checks the fit first.
TRAIN_LAYERS = 12
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 5
TRAIN_LR = 1e-3


def phase_train_reduced(torch, arch: str, seq: int = 128,
                        steps: int = 3) -> None:
    """A reduced model trained ``steps`` steps on the card (hand kernels
    and their backward kernels) and on the CPU (plain versions) from one
    seed, on the same ``TokenPipeline`` batches, in f32. Held to the CPU
    parity tests' tolerances (``tests/test_torch_train.py``) widened 10x
    for the card's summation order where they are absolute: losses within
    1e-3, grad norms within 1e-3 relative, moments within 1e-3 of their
    largest magnitude; parameters as there, relative to lr (every element
    within lr, all but 1e-3 of them within 1e-2 lr: an element whose
    gradient is a rounding error's size may move up to ~lr either way)."""
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.pipeline import to_device as batch_to
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    cfg = get_arch(arch).reduced()
    opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    start = init_params(cfg, torch.Generator().manual_seed(0))
    runs = {}
    for dev in (torch.device("cpu"), torch.device("cuda", 0)):
        params = tree_map(lambda t: t.clone().to(dev), start)
        state = adamw.init_state(opt, params)
        step = make_train_step(cfg, opt)
        pipe = TokenPipeline(cfg, ShapeConfig("t", seq, 2, "train"), seed=0)
        metrics = []
        for i in range(steps):
            params, state, m = step(params, state,
                                    batch_to(pipe.batch_at(i), dev))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev.type] = (metrics, tree_map(lambda t: t.cpu(), params),
                          {k: tree_map(lambda t: t.cpu(), state[k])
                           for k in ("mu", "nu")})
    (cpu_m, cpu_p, cpu_s), (gpu_m, gpu_p, gpu_s) = runs["cpu"], runs["cuda"]
    d_loss = max(abs(a[0] - b[0]) for a, b in zip(cpu_m, gpu_m))
    d_gn = max(abs(a[1] - b[1]) / b[1] for a, b in zip(cpu_m, gpu_m))
    errs = torch.cat([(a - b).abs().flatten()
                      for a, b in zip(tree_leaves(gpu_p), tree_leaves(cpu_p))])
    far = int((errs > 1e-2 * TRAIN_LR).sum())
    d_mom = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for key in ("mu", "nu") for a, b in
                zip(tree_leaves(gpu_s[key]), tree_leaves(cpu_s[key])))
    print(f"[train-reduced] {cfg.name}, {steps} steps of 2 x {seq}, card vs "
          f"CPU: losses {[round(m[0], 6) for m in gpu_m]} / "
          f"{[round(m[0], 6) for m in cpu_m]} (max diff {d_loss:.3e}), grad "
          f"norm max rel diff {d_gn:.3e}, parameters max diff "
          f"{float(errs.max()) / TRAIN_LR:.3e} lr with {far} of "
          f"{errs.numel()} beyond 1e-2 lr, moments max rel diff "
          f"{d_mom:.3e}", flush=True)
    if d_loss > 1e-3 or d_gn > 1e-3 or float(errs.max()) > TRAIN_LR \
            or far > 1e-3 * errs.numel() or d_mom > 1e-3:
        fail(f"reduced {arch}: training on the card disagrees with the CPU")


def train_probe(torch, cfg, dev):
    """The probe of one train step of ``cfg`` (f32, the trainer's batch) on
    specs of the state: nothing allocated."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.probe import probe_fn
    from repro_torch.launch.specs import input_specs
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (abstract_train_state,
                                              make_train_step)
    opt = adamw.AdamWConfig(moment_dtype=cfg.optimizer_moment_dtype)
    params, state = abstract_train_state(cfg, opt, torch.float32, dev)
    shape = ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH, "train")
    return probe_fn(make_train_step(cfg, opt), params, state,
                    input_specs(cfg, shape, dev))


def phase_train(torch) -> dict:
    """The training main path: gemma2-9b at every published width, depth
    cut to ``TRAIN_LAYERS``, f32, batch 4 x 1024, ``remat_policy="full"``,
    through ``launch.train.train``: probe of one step -> MGB admission ->
    executor on the card, 5 steps, each kernel's launches checked exactly.
    First the depth: the probe at ``TRAIN_LAYERS`` and two more layers
    against the memory free on the card. Then one step alone after
    ``fresh_card``: the probe's hbm must be at least the observed peak
    (fails below 1.0). Then a ``torch.profiler`` breakdown of one step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.pipeline import to_device as batch_to
    from repro_torch.launch.flops import forward_flops
    from repro_torch.launch.train import train
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    dev = torch.device("cuda", 0)
    cfg = full_cfg("gemma2-9b", TRAIN_LAYERS)
    fresh_card(torch)
    free = torch.cuda.mem_get_info(dev)[0]
    for n in (TRAIN_LAYERS, TRAIN_LAYERS + 2):
        t = time.perf_counter()
        vec = train_probe(torch, full_cfg("gemma2-9b", n), dev)
        print(f"[train] depth: the probe of one gemma2-9b step at {n} "
              f"layers, f32, batch {TRAIN_BATCH} x {TRAIN_SEQ}: hbm "
              f"{vec.hbm_bytes} B ({vec.hbm_bytes / 1e9:.2f} GB) against "
              f"{free} B free on the card: "
              f"{'fits' if vec.hbm_bytes <= free else 'does not fit'} "
              f"(traced in {time.perf_counter() - t:.1f} s)", flush=True)
        if n == TRAIN_LAYERS and vec.hbm_bytes > free:
            fail(f"train: {TRAIN_LAYERS} layers do not fit the card")
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, reduced=False,
              n_layers=TRAIN_LAYERS, lr=TRAIN_LR, log_every=1)
    for c in counters().values():
        c.reset()
    res = train("gemma2-9b", steps=TRAIN_STEPS, **kw)
    counts = read_counts()
    want = expected_train_launches(cfg, TRAIN_STEPS)
    got = {k: counts[k] for k in want}
    print(f"[launches] train gemma2-9b: counted {got}, expected {want}",
          flush=True)
    if got != want:
        fail("train gemma2-9b: launches differ from expected")
    vec = res["probe"]
    host = res["step_ms"][1:]
    dms = res["device_ms"][1:]
    print(f"[train] gemma2-9b, every published width, reduced: "
          f"{'; '.join(res['reduced'])}; f32, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, remat full, one task through probe -> MGB -> "
          f"executor: {res['status']}, {res['steps']} steps, losses "
          f"{[round(x, 4) for x in res['losses']]}, grad norms "
          f"{[round(x, 4) for x in res['grad_norms']]}, lr "
          f"{[f'{x:.2e}' for x in res['lrs']]}; steps 2-{TRAIN_STEPS}: "
          f"host {sum(host) / len(host):.1f} ms, device "
          f"{sum(dms) / len(dms):.1f} ms, "
          f"{sum(res['tokens_per_s'][1:]) / len(host):.0f} tok/s; probe hbm "
          f"{vec.hbm_bytes} B, {vec.flops:.4e} flops, est "
          f"{vec.est_seconds * 1e3:.1f} ms, core {vec.core_demand:.3f}, bw "
          f"{vec.bw_demand:.3f}", flush=True)
    import math
    if res["steps"] != TRAIN_STEPS or not all(
            math.isfinite(x) for x in res["losses"] + res["grad_norms"]):
        fail(f"train gemma2-9b: {res['steps']} steps, losses "
             f"{res['losses']}")
    # the probe traced the backward and the recompute too (the autograd
    # engine runs a card's backward on its own thread)
    fwd = forward_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    print(f"[train] probe flops {vec.flops:.4e} = {vec.flops / fwd:.2f}x the "
          f"analytic forward ({fwd:.4e})", flush=True)
    if vec.flops < 2.5 * fwd:
        fail("train gemma2-9b: the probe did not trace the backward")
    launches = dict(got)

    del res
    left = fresh_card(torch)
    alone = train("gemma2-9b", steps=1, **kw)
    peak = torch.cuda.max_memory_allocated(dev)
    ratio = alone["probe"].hbm_bytes / peak
    print(f"[train] one step alone: probe hbm {alone['probe'].hbm_bytes} B "
          f"vs observed max_memory_allocated {peak} B ({left} B allocated "
          f"before; probe/observed {ratio:.4f}); step "
          f"{alone['step_ms'][0]:.1f} ms host, "
          f"{alone['device_ms'][0]:.1f} ms device", flush=True)
    if ratio < 1.0:
        fail(f"train gemma2-9b: the probe ({alone['probe'].hbm_bytes} B) is "
             f"below the observed peak ({peak} B)")
    del alone

    fresh_card(torch)
    opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         torch.float32, dev)
    state = adamw.init_state(opt, params)
    step = make_train_step(cfg, opt)
    pipe = TokenPipeline(cfg, ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH,
                                          "train"), seed=0)
    batch = batch_to(pipe.batch_at(0), dev)
    step(params, state, batch)  # warm-up
    device_breakdown(torch, f"gemma2-9b train step, {TRAIN_LAYERS} layers, "
                     f"f32, batch {TRAIN_BATCH} x {TRAIN_SEQ}",
                     lambda: step(params, state, batch), top=12)
    del params, state, batch
    return launches


# the JAX package's NN vectors (``src/repro/core/workloads.py::_nn_vector``
# on a CPU, virtual seconds): hbm, flops, bytes, core, bw
REFERENCE_NN = {"predict": (166458120, 7.731e12, 3.401e11, 0.014, 0.150),
                "train": (1796333484, 1.007e13, 1.925e12, 0.010, 0.300),
                "detect": (644245094, 3.865e12, 1.701e11, 0.120, 0.100),
                "generate": (10906988, 1.538e11, 3.498e11, 0.010, 0.275)}


def phase_paper_nn(torch, gpu: str, dev=None) -> None:
    """The NN jobs of §V-E probed on the card (fake tensors, nothing
    allocated) beside the same probes on the CPU and the reference's
    vectors, then Fig. 6 on the card's vectors with its band lines
    (printed, not enforced, as the reference does)."""
    from repro_torch.bench import fig6_nn_schedgpu
    from repro_torch.core import workloads as W
    dev = dev or torch.device("cuda", 0)
    for kind in W.NN_KINDS:
        card = W._nn_vector(kind, dev)
        cpu = W._nn_vector(kind, torch.device("cpu"))
        r = REFERENCE_NN[kind]
        print(f"[paper] NN {kind} on {gpu}: hbm {card.hbm_bytes} B, flops "
              f"{card.flops:.4e}, bytes {card.bytes_accessed:.4e}, est "
              f"{card.est_seconds:.4f} s, core {card.core_demand:.3f}, bw "
              f"{card.bw_demand:.3f}; CPU rehearsal: hbm {cpu.hbm_bytes} B, "
              f"flops {cpu.flops:.4e}, bytes {cpu.bytes_accessed:.4e}, core "
              f"{cpu.core_demand:.3f}, bw {cpu.bw_demand:.3f}; reference "
              f"(XLA, fused): hbm {r[0]} B, flops {r[1]:.4e}, bytes "
              f"{r[2]:.4e}, core {r[3]:.3f}, bw {r[4]:.3f}", flush=True)
    t = time.perf_counter()
    fig6_nn_schedgpu.run(device=dev)
    print(f"[paper] Fig. 6 on the card's probes in "
          f"{time.perf_counter() - t:.1f} s", flush=True)


def main() -> None:
    torch = setup()
    print(f"[card] {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)
    gpu = card_line()
    phase_build(torch)
    phase_paper(torch, gpu)
    phase_paper_nn(torch, gpu)
    phase_twin(torch)
    table = phase_kernels(torch)
    phase_reduced(torch, "gemma2-9b", 100)
    phase_reduced(torch, "falcon-mamba-7b", 128)
    phase_reduced(torch, "mixtral-8x7b", 128)
    phase_continuous_reduced(torch, "gemma2-9b", 100)
    phase_continuous_reduced(torch, "falcon-mamba-7b", 128)
    phase_continuous_reduced(torch, "mixtral-8x7b", 128)
    phase_train_reduced(torch, "gemma2-9b")
    phase_train_reduced(torch, "qwen1.5-32b")
    by_path = {"gemma2-9b": phase_serve(torch, "gemma2-9b", 1000, True),
               "falcon-mamba-7b": phase_serve(torch, "falcon-mamba-7b",
                                              1024, False),
               "mixtral-8x7b": phase_serve(torch, "mixtral-8x7b", 1024,
                                           False, MIXTRAL_LAYERS),
               "gemma2-9b continuous": phase_continuous(
                   torch, "gemma2-9b", 1000),
               "falcon-mamba-7b continuous": phase_continuous(
                   torch, "falcon-mamba-7b", 1024),
               "mixtral-8x7b continuous": phase_continuous(
                   torch, "mixtral-8x7b", 1024, MIXTRAL_LAYERS)}
    phase_decode(torch, "gemma2-9b", 1000, streams=4)
    phase_decode(torch, "falcon-mamba-7b", 1024)
    phase_decode(torch, "mixtral-8x7b", 1024, MIXTRAL_LAYERS)
    by_path["gemma2-9b train"] = phase_train(torch)
    for name, entry in table.items():
        entry["launches_by_path"] = {arch: launches[name]
                                     for arch, launches in by_path.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if not entry["launches"]:
            fail(f"{name} was never launched on a main path")
    print(gpu)
    print(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
