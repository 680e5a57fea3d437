"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. build: compile the hand CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and print ptxas' resource lines and
   the card's name and power limit (``nvidia-smi``).
2. kernels: hold each kernel against its plain PyTorch version at the main
   path's shapes (bf16 atol = rtol = 2e-2, f32 1e-4) and time kernel, plain
   version and, as a yardstick only, the PyTorch library call that computes
   the same function: device time of a CUDA-graph replay, after warm-up.
3. reduced: the reduced gemma2-9b served path on the card (hand kernels)
   against the same weights on the CPU (plain versions): last-token logits
   and 8 greedy tokens.
4. serve: full-width, full-depth gemma2-9b in bf16 through probe -> MGB
   admission -> executor: 32 requests in 8 batches of 4, prompt 1000,
   32 generated tokens. Launch counters are zeroed just before and read just
   after; flash attention must have launched 42 times per prefill and RMSNorm
   85 times per prefill and per decode step. Then one batch alone, for the
   probe's memory against ``torch.cuda.max_memory_allocated`` and an
   unqueued TTFT, and four batches again with four pool workers, each on
   its own stream, so the admitted batches share the card.
5. decode: one decode step of the same model and batch, eager (host wall
   time) against the same step replayed from a CUDA graph (device time, no
   host gaps): the difference is the time the card waits on the host.

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
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernels(torch):
    """Every kernel against its plain version at the main path's shapes;
    returns {kernel: entry of the JSON table} for the main-path case."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = {}

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(dtype)

    for shape, dtype in [((4000, 3584), torch.bfloat16),
                         ((4000, 3584), torch.float32),
                         ((4, 3584), torch.bfloat16),
                         ((4, 3584), torch.float32),
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

    cases = [((4, 16, 8, 1000, 1000, 256), torch.bfloat16, 50.0, 4096),
             ((4, 16, 8, 1000, 1000, 256), torch.bfloat16, 50.0, 0),
             ((4, 16, 8, 1000, 1000, 256), torch.bfloat16, 0.0, 0),
             ((1, 16, 8, 5000, 5000, 256), torch.bfloat16, 50.0, 4096)]
    for shape in [(2, 4, 2, 128, 128, 64), (1, 8, 1, 256, 256, 32),
                  (2, 2, 2, 128, 384, 64), (1, 4, 4, 512, 512, 128),
                  (1, 4, 2, 100, 100, 256)]:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((shape, dtype, 0.0, 0))
    cases += [((1, 2, 2, 256, 256, 64), torch.float32, 0.0, w)
              for w in (32, 96, 128)]
    cases += [((1, 2, 2, 128, 128, 64), torch.float32, cap, 0)
              for cap in (20.0, 50.0)]
    for (b, hq, hkv, sq, sk, d), dtype, cap, win in cases:
        q = randn((b, hq, sq, d), dtype)
        k = randn((b, hkv, sk, d), dtype)
        v = randn((b, hkv, sk, d), dtype)
        kw = dict(causal=True, window=win, logit_softcap=cap)
        out = FA.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        what = f"flash {(b, hq, hkv, sq, sk, d)} {str(dtype)[6:]} " \
               f"softcap {cap:g} window {win}"
        err = compare(torch, out, FA.flash_attention_plain(q, k, v, **kw),
                      dtype, what)
        line = f"[kernels] {what}: max_abs_err {err:.3e}"
        if sq >= 1000:
            ms = time_ms(torch, lambda: FA.flash_attention(q, k, v, **kw), 5)
            plain_ms = time_ms(
                torch, lambda: FA.flash_attention_plain(q, k, v, **kw), 3)
            lib_ms = None
            if cap == 0.0 and win == 0:
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 5)
            nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
            flops = 4 * b * hq * d * FA.visible_pairs(sq, sk, causal=True,
                                                      window=win)
            t_bytes, t_ops = nbytes / H100_HBM_BW, flops / H100_BF16_FLOPS
            bound = max(t_bytes, t_ops) * 1e3
            by = "bytes" if t_bytes > t_ops else "operations"
            line += (f", kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                     + (f"SDPA {lib_ms:.3f} ms, " if lib_ms else "")
                     + f"bound {bound:.4f} ms ({by}), "
                     f"{flops / ms / 1e9:.1f} TFLOP/s")
            if (b, sq, cap, win) == (4, 1000, 50.0, 4096):
                table["flash_attention"] = dict(
                    name="flash_attention", route="cuda",
                    source="src/repro_torch/kernels/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention.py:93",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=None)
        print(line, flush=True)
    return table


def phase_reduced(torch):
    """Reduced gemma2-9b: the card (hand kernels) against the CPU (plain
    versions) on the same weights and prompts."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import decode as D
    from repro_torch.models.model import init_params
    from repro_torch.serve.decode import greedy_generate, make_prefill_step
    cfg = get_arch("gemma2-9b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, torch.device("cpu"))
    tokens = torch.randint(0, cfg.vocab, (2, 100),
                           generator=torch.Generator().manual_seed(1))
    prefill = make_prefill_step(cfg)
    results = {}
    for dev in (torch.device("cpu"), torch.device("cuda", 0)):
        p = {"embed": params["embed"].to(dev),
             "final_norm": params["final_norm"].to(dev),
             "layers": [{k: ({kk: vv.to(dev) for kk, vv in v.items()}
                             if isinstance(v, dict) else v.to(dev))
                         for k, v in lp.items()} for lp in params["layers"]]}
        logits, cache = prefill(p, {"tokens": tokens.to(dev)})
        first = torch.argmax(logits, -1).to(torch.int32)
        full = D.cache_insert(D.init_cache(cfg, 2, 100 + 8, device=dev),
                              cache, 0)
        toks, _ = greedy_generate(cfg, p, full, first, 100, 8)
        results[dev.type] = (logits.cpu(), toks.cpu())
    err = float((results["cpu"][0] - results["cuda"][0]).abs().max())
    same = bool(torch.equal(results["cpu"][1], results["cuda"][1]))
    print(f"[reduced] gemma2-9b-reduced prefill logits card vs CPU max abs "
          f"err {err:.3e}; 8 greedy tokens equal: {same}", flush=True)
    if err > 2e-3 or not same:
        fail("reduced gemma2-9b on the card disagrees with the CPU")


def phase_serve(torch):
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch.serve import serve
    cfg = get_arch("gemma2-9b")
    kw = dict(full=True, param_dtype=torch.bfloat16, batch=4,
              prompt_len=1000, gen_len=32, num_devices=1)
    RN.LAUNCHES.reset()
    FA.LAUNCHES.reset()
    res = serve("gemma2-9b", requests=32, **kw)
    launches = {"rmsnorm": RN.LAUNCHES.value,
                "flash_attention": FA.LAUNCHES.value}
    prefills, steps = res["batches"], res["batches"] * (kw["gen_len"] - 1)
    want = {"flash_attention": cfg.n_layers * prefills,
            "rmsnorm": (2 * cfg.n_layers + 1) * (prefills + steps)}
    vec = res["probe"]
    print(f"[serve] gemma2-9b full ({cfg.n_layers} layers, bf16): "
          f"{res['completed']}/{res['batches']} batches done, "
          f"{res['crashed']} crashed, {res['tokens_generated']} tokens in "
          f"{res['wall_s']:.2f} s = {res['tokens_per_s']:.1f} tok/s; TTFT "
          f"p50/p99 {res['p50_ttft_s'] * 1e3:.1f}/"
          f"{res['p99_ttft_s'] * 1e3:.1f} ms; TPOT p50/p99 "
          f"{res['p50_tpot_s'] * 1e3:.2f}/{res['p99_tpot_s'] * 1e3:.2f} ms; "
          f"{res['sched_attempts']} admission attempts; scheduler HBM "
          f"{res['hbm_per_device'] / 2**30:.2f} GiB/device", flush=True)
    print(f"[serve] probe per batch: hbm {vec.hbm_bytes / 2**30:.3f} GiB, "
          f"{vec.flops:.4e} flops, est {vec.est_seconds * 1e3:.2f} ms",
          flush=True)
    print(f"[serve] launches {launches}, expected {want}", flush=True)
    for err in res["errors"]:
        print(f"[serve] error: {err}", flush=True)
    if res["crashed"] or res["completed"] < res["batches"] \
            or res["batches"] != 8:
        fail(f"serve: {res['completed']}/{res['batches']} completed, "
             f"{res['crashed']} crashed")
    if launches != want:
        fail(f"serve: kernel launches {launches} != expected {want}")
    for i, g in enumerate(res["generated"]):
        if g is None or g.shape != (4, kw["gen_len"]) or g.min() < 0 \
                or g.max() >= cfg.vocab:
            fail(f"serve: batch {i} generated "
                 f"{None if g is None else g.shape} tokens out of range")

    # nothing of the first run may stay allocated while one batch is measured
    del res
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    alone = serve("gemma2-9b", requests=4, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if alone["crashed"] or alone["completed"] != 1:
        fail("serve: the single-batch run did not complete")
    ratio = alone["probe"].hbm_bytes / peak
    print(f"[serve] one batch alone: probe hbm {alone['probe'].hbm_bytes} B "
          f"vs observed max_memory_allocated {peak} B (probe/observed "
          f"{ratio:.4f}); batch wall {alone['wall_s']:.2f} s, TTFT "
          f"{alone['p50_ttft_s'] * 1e3:.1f} ms, TPOT "
          f"{alone['p50_tpot_s'] * 1e3:.2f} ms", flush=True)

    # four batches, all admitted at once (4 probed reservations fit the
    # card), each on its own pool worker and stream: they share the card
    del alone
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wide = serve("gemma2-9b", requests=16, workers=4, **kw)
    print(f"[serve] 4 pool workers: {wide['completed']}/{wide['batches']} "
          f"done, {wide['crashed']} crashed, {wide['tokens_per_s']:.1f} "
          f"tok/s; TTFT p50/p99 {wide['p50_ttft_s'] * 1e3:.1f}/"
          f"{wide['p99_ttft_s'] * 1e3:.1f} ms; TPOT p50/p99 "
          f"{wide['p50_tpot_s'] * 1e3:.2f}/{wide['p99_tpot_s'] * 1e3:.2f} "
          f"ms; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    if wide["crashed"] or wide["completed"] != wide["batches"]:
        fail(f"serve with 4 workers: {wide['errors']}")
    return launches


def phase_decode(torch):
    """Full gemma2-9b in bf16, batch 4 after a 1000-token prefill: the wall
    time of an eager decode step against the device time of the same step
    replayed from a CUDA graph."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import decode as D
    from repro_torch.models.model import init_params
    from repro_torch.serve.decode import make_prefill_step
    from torch.utils._pytree import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch("gemma2-9b")
    dev = torch.device("cuda", 0)
    b, s, steps = 4, 1000, 8
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         torch.bfloat16, dev)
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    logits, cache = make_prefill_step(cfg)(params, {"tokens": tokens})
    tok = torch.argmax(logits, -1).to(torch.int32)
    full = D.cache_insert(D.init_cache(cfg, b, s + steps + 2, device=dev),
                          cache, 0)
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
        fail("decode: non-finite logits")
    graph_ms = time_ms(
        torch, lambda: D.decode_step(params, cfg, full, tok, s + steps + 1), 3)
    weights, cache_bytes = (sum(t.numel() * t.element_size()
                                for t in tree_leaves(tree))
                            for tree in (params, full))
    bound = (weights + cache_bytes) / H100_HBM_BW * 1e3
    print(f"[decode] gemma2-9b full, batch {b}, position {s}: eager step "
          f"{eager_ms:.2f} ms (host wall, mean of {steps}), CUDA-graph "
          f"replay {graph_ms:.2f} ms (device), card idle "
          f"{100 * (1 - graph_ms / eager_ms):.1f}% of an eager step; bound "
          f"{bound:.2f} ms (weights {weights / 1e9:.2f} GB + cache "
          f"{cache_bytes / 1e9:.2f} GB read once)", flush=True)


def main() -> None:
    torch = setup()
    print(f"[card] {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)
    gpu = card_line()
    phase_build(torch)
    table = phase_kernels(torch)
    phase_reduced(torch)
    launches = phase_serve(torch)
    phase_decode(torch)
    for name, entry in table.items():
        entry["launches"] = launches[name]
        if not entry["launches"]:
            fail(f"{name} was never launched on the main path")
    print(gpu)
    print(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
