"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. build: compile the hand CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and print ptxas' resource lines and
   the card's name and power limit (``nvidia-smi``).
2. kernels: hold each kernel against its plain PyTorch version at the main
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
   each route and act forced at every edge case it takes.
3. reduced: the reduced gemma2-9b, falcon-mamba-7b and mixtral-8x7b served
   paths on the card (hand kernels) against the same weights on the CPU
   (plain versions), in f32: last-token logits within 2e-3 and 8 greedy
   tokens equal. mixtral's prompt (128) is past its window (64), so the
   ring rotates; a disagreement reports how many expert choices flipped.
4. continuous, reduced: the same three reduced models served continuously
   (``serve_continuous``: 6 requests, a loop of 4 rows, 9 tokens each) on
   the card, the loop step replayed from a CUDA graph, against the CPU:
   every request's tokens equal.
5. serve, one main path per model, each through probe -> MGB admission ->
   executor with the launch counters zeroed just before and read just
   after, every kernel's count checked exactly. Each batch's decode is
   captured once in a CUDA graph on its pool worker's stream and replayed:
   the counters see the warm-up and the capture of each batch's step, so
   the check takes them as two steps a batch, checks the capture and replay
   counts, and adds replays x launches per step to the reported launches.
   - gemma2-9b, full width and depth, bf16: 32 requests in 8 batches of 4,
     prompt 1000, 32 generated tokens; flash attention 42 launches per
     prefill, RMSNorm 85 per prefill and per decode step. Then one batch
     alone (the probe, which covers prefill, the padded cache and one
     step, against ``torch.cuda.max_memory_allocated``: fails below 1.0),
     and the same 32 requests with four pool workers sharing the card,
     their tokens/s beside one worker's.
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
6. continuous, one main path per model at the same widths: 32 requests
   submitted together (prompt 1000 for gemma2-9b, 1024 for the others), 32
   tokens each, one decode loop of 8 rows whose step is replayed from a
   CUDA graph, 2 pool workers for the prefills; launches checked as in 5
   (one warm-up and one capture, one replay a step), every request done,
   0 violations, the scheduler's highest reservation against
   ``torch.cuda.max_memory_allocated`` (fails below 1.0), and after every
   adoption of a row and every pump the bytes the card holds for the run
   (the decode graph's pool included) against the reservation at that
   moment plus the pool's streams' reserve (fails where they pass it).
7. decode: for each model at batch 4, the device time of one prefill and
   of one decode step by kernel (``torch.profiler``), and one decode step
   eager (host wall time) against the same step replayed from a CUDA graph
   (device time, no host gaps): the difference is the time the card waits
   on the host. The step's bound reads its weights once (for MoE only the
   experts the step routed to) and the cache's filled slots.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOPS = 989e12   # dense tensor-core peak, NVIDIA H100 SXM datasheet
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores
H100_HBM_BW = 3.35e12      # bytes/s
# the port's kernel functions, as the profiler names them
PORT_KERNELS = ("rmsnorm_kernel", "flash_tc_kernel", "flash_fwd_kernel",
                "mamba_scan_kernel", "gmm_tma_kernel", "gmm_small_kernel",
                "gmm_f32_kernel")
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
    return table


def flex_library(torch, q, k, v, cap: float, win: int):
    """gemma2's yardstick, never used by the port: one
    ``torch.nn.attention.flex_attention`` call with the softcap as a
    ``score_mod`` and causal + window as a block mask, compiled once here,
    outside any timed graph. Returns (call, its max abs error against the
    plain version) or (None, None) when this build refuses the inputs."""
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
    return (lambda: fn(q, k, v, **kw)), err


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


def counters():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba_scan as SC
    from repro_torch.kernels import moe_gmm as MG
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.serve import decode as SD
    return {"rmsnorm": RN.LAUNCHES, "flash_attention": FA.LAUNCHES,
            "mamba_scan": SC.LAUNCHES, "moe_gmm": MG.LAUNCHES,
            "moe_gmm_gated": MG.GATED_LAUNCHES,
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
                "moe_gmm": 0, "moe_gmm_gated": 0}
    moe_layers = 0 if cfg.moe is None else cfg.n_layers
    gated = moe_layers if cfg.mlp_act.endswith("gated") else 0
    return {"rmsnorm": (2 * cfg.n_layers + 1) * (prefills + steps),
            "flash_attention": cfg.n_layers * prefills, "mamba_scan": 0,
            "moe_gmm": 2 * moe_layers * (prefills + steps),
            "moe_gmm_gated": gated * (prefills + steps)}


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


def phase_serve(torch, arch: str, prompt_len: int, wide: bool,
                n_layers=None):
    """One main path: ``arch`` at every published width (depth cut to
    ``n_layers`` if given) in bf16 through ``serve()``, every decode loop
    replayed from a CUDA graph, with every kernel's launch count checked
    exactly; then one batch alone (the probe against the observed peak:
    fails below 1.0) and, with ``wide``, the same 32 requests on four pool
    workers sharing the card."""
    from repro_torch.launch.serve import serve
    cfg = full_cfg(arch, n_layers)
    kw = dict(full=True, param_dtype=torch.bfloat16, batch=4,
              prompt_len=prompt_len, gen_len=32, num_devices=1,
              n_layers=n_layers)
    fresh_card(torch)
    for c in counters().values():
        c.reset()
    res = serve(arch, requests=32, **kw)
    counts = read_counts()
    steps = res["batches"] * (kw["gen_len"] - 1)
    launches = check_launches(
        f"serve {arch}", cfg, counts, res["batches"], steps,
        captures=res["batches"],
        replays=res["batches"] * (kw["gen_len"] - 2))
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
    print(f"[serve] {arch} probe per batch (prefill, padded cache, one "
          f"step): hbm {vec.hbm_bytes} B "
          f"({vec.hbm_bytes / 2**30:.3f} GiB), {vec.flops:.4e} flops, "
          f"{vec.bytes_accessed:.4e} bytes accessed, est "
          f"{vec.est_seconds * 1e3:.2f} ms, core demand "
          f"{vec.core_demand:.3f}, bw demand {vec.bw_demand:.3f}", flush=True)
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
    ratio = alone["probe"].hbm_bytes / peak
    print(f"[serve] {arch} one batch alone: probe hbm "
          f"{alone['probe'].hbm_bytes} B vs observed max_memory_allocated "
          f"{peak} B ({left} B allocated before the run; probe/observed "
          f"{ratio:.4f}); batch wall {alone['wall_s']:.2f} s, TTFT "
          f"{alone['p50_ttft_s'] * 1e3:.1f} ms, TPOT "
          f"{alone['p50_tpot_s'] * 1e3:.2f} ms", flush=True)
    if ratio < 1.0:
        fail(f"serve {arch}: the probe ({alone['probe'].hbm_bytes} B) is "
             f"below the observed peak ({peak} B)")
    if not wide:
        return launches

    # the same 32 requests on four pool workers, each on its own stream:
    # 4 probed reservations fit the card, so 4 batches share it at once
    del alone
    fresh_card(torch)
    wide_res = serve(arch, requests=32, workers=4, **kw)
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


def main() -> None:
    torch = setup()
    print(f"[card] {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)
    gpu = card_line()
    phase_build(torch)
    table = phase_kernels(torch)
    phase_reduced(torch, "gemma2-9b", 100)
    phase_reduced(torch, "falcon-mamba-7b", 128)
    phase_reduced(torch, "mixtral-8x7b", 128)
    phase_continuous_reduced(torch, "gemma2-9b", 100)
    phase_continuous_reduced(torch, "falcon-mamba-7b", 128)
    phase_continuous_reduced(torch, "mixtral-8x7b", 128)
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
