"""Where the probe of a static serve task falls short of what the task
allocates on the card.

    python3 tools/probe_memory.py [--arch gemma2-9b]

For each served model at full width in bf16 (mixtral-8x7b cut to 24 of 32
layers), one batch of 4 prompts runs alone, eagerly: prefill, the cache
padded for decode, 31 decode steps (the static serve path captures the
prefill and the step once and replays them; a graph's pool holds the peak
measured here for the prefill). The
caching allocator's history is recorded (``torch.cuda.memory.
_record_memory_history``) and the script prints, beside the probe's
fake-tensor trace of the same work:

  * the weights' bytes against what the allocator holds for them (block
    rounding);
  * the peak allocated by ``init_params`` above the weights (its f32 draw);
  * each stage's peak above what was allocated when it began (prefill, cache
    padding, decode), against the probe's live peak for the same work;
  * the blocks live at the task's peak, summed by the line of the port that
    allocated them.

Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MODELS = {"gemma2-9b": (1000, None), "falcon-mamba-7b": (1024, None),
          "mixtral-8x7b": (1024, 24)}


def _label(frames) -> str:
    for f in frames:
        if "repro_torch" in f["filename"] or "probe_memory" in f["filename"]:
            name = f["filename"].split("src/")[-1]
            return f"{name}:{f['line']} {f['name']}"
    return frames[0]["filename"].split("/")[-1] + f":{frames[0]['line']}" \
        if frames else "?"


def live_at_peak(trace):
    """Replay one device's allocator trace: (peak bytes above the start,
    {label: [bytes, blocks]} live at that peak)."""
    live, cur, peak, at_peak = {}, 0, 0, {}
    for e in trace:
        act = e["action"]
        if act == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif act == "free_completed" and e["addr"] in live:
            cur -= live.pop(e["addr"])["size"]
    by = collections.defaultdict(lambda: [0, 0])
    for e in at_peak.values():
        row = by[_label(e.get("frames", []))]
        row[0] += e["size"]
        row[1] += 1
    return peak, by


def run(torch, arch: str, prompt: int, n_layers) -> None:
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.probe import trace_counts
    from repro_torch.models import decode as D
    from repro_torch.models.model import init_params
    from repro_torch.serve.decode import (decode_cache, greedy_generate,
                                          make_prefill_step)
    from torch.utils._pytree import tree_leaves

    cfg = get_arch(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         torch.bfloat16, dev)
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    held = torch.cuda.memory_allocated() - base
    init_peak = torch.cuda.max_memory_allocated() - base
    gen, b, max_seq = 32, 4, prompt + 32
    tokens = torch.randint(0, cfg.vocab, (b, prompt), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    batch = {"tokens": tokens}
    prefill = make_prefill_step(cfg)

    def task(params, batch):
        logits, cache = prefill(params, batch)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        cache = decode_cache(cfg, cache, max_seq)
        return D.decode_step(params, cfg, cache, first, prompt)

    pc = trace_counts(prefill, params, batch)
    tc = trace_counts(task, params, batch)
    print(f"[memory] {arch} ({cfg.n_layers} layers): weights {weights} B, "
          f"allocator holds {held} B for them (+{held - weights}); "
          f"init_params peak {init_peak} B (+{init_peak - held} above "
          f"the weights)", flush=True)
    print(f"[memory] {arch} probe: prefill live peak "
          f"{pc['peak_live_bytes']} B (hbm {pc['hbm_bytes']}), task body "
          f"(prefill + pad + one step) live peak {tc['peak_live_bytes']} B "
          f"(hbm {tc['hbm_bytes']})", flush=True)

    torch.cuda.memory._record_memory_history(max_entries=400000)
    stages = {}
    a0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    stages["prefill"] = torch.cuda.max_memory_allocated() - a0
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.reset_peak_memory_stats()
    full = decode_cache(cfg, cache, max_seq)
    torch.cuda.synchronize()
    stages["pad"] = torch.cuda.max_memory_allocated() - a0
    del cache
    torch.cuda.reset_peak_memory_stats()
    out, _ = greedy_generate(cfg, params, full, first, prompt, gen - 1)
    torch.cuda.synchronize()
    stages["decode"] = torch.cuda.max_memory_allocated() - a0
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak, by = live_at_peak(snap["device_traces"][0])
    print(f"[memory] {arch} observed above the weights: "
          + ", ".join(f"{k} peak {v} B" for k, v in stages.items())
          + f"; task peak {max(stages.values())} B against the probe's "
          f"task live peak {tc['peak_live_bytes']} B (short by "
          f"{max(stages.values()) - tc['peak_live_bytes']} B); traced "
          f"peak {peak} B", flush=True)
    for label, (nbytes, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"[memory]   {nbytes:>12d} B x{n:<4d} {label}", flush=True)
    del params, batch, tokens, logits, full, out, first, snap
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(MODELS), action="append")
    args = ap.parse_args()
    import torch
    print(f"[memory] torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    if not torch.cuda.is_available():
        sys.exit("probe_memory: needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    for arch in args.arch or sorted(MODELS):
        prompt, n_layers = MODELS[arch]
        run(torch, arch, prompt, n_layers)


if __name__ == "__main__":
    main()
