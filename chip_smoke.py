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
   lines (printed, not enforced, as the reference does), and
   ``repro_torch.bench.preempt``'s (preemptive EDF against FIFO, EDF and
   shedding on the overload trace, on the virtual clock). Then the four NN
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
   a CUDA-graph replay, after warm-up. RMSNorm's forward runs at every
   row its main paths give it (``RMSNORM_ROWS``: static and continuous
   prefills, decode steps and the continuous loop's 8 rows, training
   rows; two calls must give the same bits), timed warm and, for prefill
   and train rows, with its inputs cold in L2, beside ``F.rms_norm``
   (``phase_rmsnorm``). Flash attention has two routes, bf16
   on the tensor cores (wgmma, TMA) and f32 on the CUDA cores, each held
   at its own cases; its yardsticks are SDPA at mixtral's shape (no
   softcap) and ``flex_attention`` (softcap as a score_mod, causal + window
   as a block mask, compiled once before timing) at gemma2's. The
   selective scan has no library call; the grouped matmul's is
   ``torch._grouped_mm``. The grouped matmul has three routes (bf16 wgmma
   fed by TMA for many rows an expert, bf16 small tiles for a few, f32 on
   the CUDA cores, register-blocked) and a gated variant (act(x wi) * (x
   wg) in one launch), each route and act forced at every edge case it
   takes; the f32 route is timed at mixtral-8x7b's training shape, beside
   ``torch.bmm`` over equal groups as a yardstick of cuBLAS's f32 rate.
   The backward kernels (flash attention's, RMSNorm's) are held against
   their plain versions and against autograd through the forwards' plain
   versions, in f32 and bf16, at gemma2-9b's training shape (B 4, Hq 16, Hkv 8, S
   1024, D 256, softcap 50, window 4096 and 0), D 128 with a window of
   256, ragged tails and rows; RMSNorm's dscale must be the same bits run
   to run. Flash's forward and backward also run, on both routes at every
   head dim, at (B 2, Hq 2, Hkv 1, Sq 129, Sk 65) with a window of 17,
   whose last 48 rows see no key: o 0 and lse +inf there, exactly, and no
   gradient (ROADMAP C10). Yardsticks: SDPA's (its backend printed; in f32
   too at D 80 and 192) and ``F.rms_norm``'s forward + backward through
   autograd where they compute the same function (none for gemma2's
   softcap). Flash also runs, both routes, forward and backward,
   at zamba2-2.7b's heads (32 of 80, no GQA) and nemotron-4-340b's (96 / 8
   of 192), and RMSNorm at nemotron's rows (d 18432: in f32 its backward
   takes the wide path), and at zamba2-2.7b's gated norm ([4096, 5120],
   bf16 and f32, forward and backward, timed beside ``F.rms_norm``) and
   every other row its paths give RMSNorm (d 2560 and 5120 at a 4 x 1024
   prefill, a decode step of 4 and a 1 x 1024 training microbatch). The
   scan is timed at zamba2-2.7b's recurrence across chunks too ([4, 4,
   5120, 64]: B, chunks, heads x head dim, N), forward and backward, and
   checked at a training microbatch's [1, 4, 5120, 64]. The
   backward kernels of the Mamba scan (at
   falcon-mamba-7b's training shape, timed) and of the grouped matmul
   (plain and gated, f32 and bf16, each route forced: bf16 on the tensor
   cores and on the CUDA cores; at the forward's edge cases, groups of 0,
   1, 63, 64, 65 and 127 rows and every row in one expert, and at
   mixtral-8x7b's training shape, timed with each kernel's device time;
   ``torch._grouped_mm``'s backward the yardstick in bf16) are held against
   their plain versions and autograd through the plain forwards, the same
   bits on two calls.
5. reduced: the reduced gemma2-9b, falcon-mamba-7b, mixtral-8x7b and
   zamba2-2.7b served paths on the card (hand kernels) against the same
   weights on the CPU
   (plain versions), in f32: last-token logits within 2e-3 and 8 greedy
   tokens equal. mixtral's prompt (128) is past its window (64), so the
   ring rotates; a disagreement reports how many expert choices flipped.
6. continuous, reduced: the same four reduced models served continuously
   (``serve_continuous``: 6 requests, a loop of 4 rows, 9 tokens each) on
   the card, the loop step replayed from a CUDA graph, against the CPU:
   every request's tokens equal. Then reduced gemma2-9b (softcaps, window
   64), qwen1.5-32b (QKV bias), falcon-mamba-7b (the scan's backward),
   mixtral-8x7b (the grouped matmul's backward, the aux loss) and
   zamba2-2.7b (Mamba-2's SSD, the scan across chunks, the shared block)
   trained 3
   steps of 2 x 128 on the card and on the CPU from one seed: losses, grad
   norms, parameters and moments within the CPU parity tests' tolerances
   (10x where absolute); and reduced gemma2-9b with bf16 parameters, a
   batch of 4 in 2 microbatches and every layer under ``remat_policy=
   "dots"``, 3 steps, within the CPU bf16 parity test's tolerances
   (``BF16_TOL``, 10x where absolute).
7. serve, one main path per model, each through probe -> MGB admission ->
   executor with the launch counters zeroed just before and read just
   after, every kernel's count checked exactly. Each pool worker keeps one
   decoder (``serve.decode.GreedyDecoder``: the padded cache, buffers and
   the step captured in a CUDA graph on its stream at its first batch), and
   every later step of every batch is a replay; the prefill is captured
   once for the card (``serve.decode.PrefillGraph``, on a stream of its
   own) and replayed for every batch, the workers taking turns. The
   counters see the warm-up and the capture of each
   graph, so the check takes them as two steps (or prefills) a captured
   graph, checks the capture and replay counts, and adds replays x
   launches per step (or prefill) to the reported launches.
   - gemma2-9b, full width and depth, bf16: 32 requests in 8 batches of 4,
     prompt 1000, 32 generated tokens; flash attention 42 launches per
     prefill, RMSNorm 85 per prefill and per decode step. Then one batch
     alone (the batch's probe, plus what its worker keeps, the decoder,
     and what the card keeps, the captured prefill, against
     ``torch.cuda.max_memory_allocated``: fails below 1.0), and the same
     32 requests with four pool workers sharing the card, their tokens/s
     beside one worker's (fails below it), with the
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
   - nemotron-4-340b, every published width, depth cut to 2 of 96 layers
     (``NEMOTRON_LAYERS``), bf16: 4 requests in one batch, prompt 1024, 32
     generated tokens: flash attention at D = 192 and RMSNorm at d = 18432
     on a main path. Then one batch alone.
   - zamba2-2.7b, every published width and all 54 layers (9 groups of 5
     Mamba-2 layers and the shared attention + MLP block), bf16: 32
     requests in 8 batches of 4, prompt 1024 (a multiple of its SSD chunk,
     256), 32 generated tokens, one worker; flash attention 9 launches
     (D 80) and the scan 45 (the recurrence across chunks) per prefill,
     RMSNorm 109 per prefill and per decode step. Then one batch alone.
8. continuous, one main path per model at the same widths (zamba2-2.7b
   too): 32 requests
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
10. train, the training main paths: gemma2-9b (depth cut to 12 of 42
   layers: all 42 are 9.24e9 parameters x 16 B = 148e9 B in f32 with a
   gradient and two moments), falcon-mamba-7b, mixtral-8x7b and
   zamba2-2.7b (depth from the probe: the deepest whose step fits 0.9 of
   the free memory, at most 16, 8 and 54 layers; zamba2's in whole groups
   of 6), each at every published width, f32, batch 4 x 1024,
   ``remat_policy="full"`` (zamba2 a group at a time, in its config's 4
   microbatches), 5 steps through ``launch.train.train``: the
   probe of one step at the depth and two layers (groups) more against the
   memory free on the card first, then the run as one task through probe
   -> MGB -> executor, each step's loss, grad norm, lr, host and device ms
   and tokens/s printed, the launches checked exactly (each forward kernel
   twice a layer a microbatch, forward and recompute, each backward once;
   the final norm once each way), the probe's flops at least 2.5x the
   analytic forward; then one step alone whose probe must cover
   ``torch.cuda.max_memory_allocated`` (fails below 1.0), and a
   ``torch.profiler`` breakdown of one step, with the ms a step of the
   kernels each path leans on (the scan's and the grouped matmul's
   backward among them; for zamba2 the SSD's batched einsums too).
11. preempt (``phase_preempt``): one card, 2 pool workers, probe ->
   ``PreemptiveAlg3Scheduler`` -> executor. A falcon-mamba-7b training
   task at every published width (f32, batch 4 x 1024, remat full,
   priority 0, 6 steps; its depth the least whose probe and the urgent
   batch's exceed the scheduler's memory, each fitting alone) is evicted
   after step 2 by one static mixtral-8x7b batch (24 layers, bf16, 4 x 1024
   prompts, 32 tokens, priority 5, a deadline) that makes its weights in
   the task. The training task checkpoints step 2 and returns; the batch
   begins after it has left (the executor's fence), then the training task
   restores step 2 from its checkpoint's host copy, resumes and writes
   the checkpoint to the disk beside its steps. Fails unless one eviction, of the training
   task, the batch admitted after it, nothing crashed, the batch's tokens
   equal the batch served alone, the resumed run equals an uninterrupted
   one within the f32 train tolerances (bits expected; the differences
   printed), the card holds at most the pool's reserve at the batch's
   BEGIN, probe/observed >= 1.0 for the batch and the resumed attempt, and
   the launches are exactly the formula's. Prints the eviction latency,
   the checkpoint's bytes, copy, write and restore times, and the batch's
   TTFT against waiting out the training task.
12. obs (``phase_obs``): one card, 2 pool workers, probe -> MGB Algorithm 3
   -> executor under ``Cluster(trace=True, calibrate=True, flight_path=)``:
   static batches that make their weights in the task
   (``launch.serve.batch_job``, bf16, 4 prompts, 32 tokens) of two
   resource classes at every published width, gemma2-9b at 12 of 42
   layers and falcon-mamba-7b at 16 of 64, five of each in waves, the
   first of each class alone on the card. The executor measures the
   memory high-water and duration of every attempt that had the card to
   itself (ROADMAP C16), and the calibration store corrects the later
   batches' vectors. Fails unless nothing crashed, the tokens are in
   range, the launches are exactly the formula's, the exported Chrome
   trace validates, a high-water was measured and none exceeds its
   reservation, a corrected vector was applied and the flight recorder's
   file loads. Prints each task's profile, the probe's runtime ratio and
   memory margin per class, raw against corrected error, the device's
   occupancy, the SLO drift stream, a ``launch.top`` frame and the run
   replayed on the sim backend under MGB Algorithm 3 and SA.
13. dist (``phase_dist``): the sharded control plane and the distributed
   train step on the card, world size 1: an NCCL process group over a
   ``FileStore`` in a temporary directory and a (1, 1) ``("data",
   "model")`` mesh on cuda:0. gemma2-9b at every published width and 12 of
   42 layers trains as in 10 (f32, batch 4 x 1024, remat full, 5 steps,
   the same seed and lr) through ``launch.train.train(mesh_shape=(1, 1),
   scheduler=ShardedScheduler(pods=1, rows=1, cols=1))``: a gang task
   through the sharded wrapper and the gang executor path, parameters and
   moments DTensors placed by ``param_specs``, the batch by
   ``batch_specs``. Fails unless the losses and grad norms are within the
   f32 train tolerances of 10's gemma2-9b run (whether the bits match is
   printed), the flash and RMSNorm forward and backward launches are
   exactly the formula's (the kernels, not the plain versions, ran under
   DTensor dispatch), probe/observed >= 1.0 for one step alone and nothing
   crashed. Then 4 steps of gemma2-9b at every width and 2 layers on the
   same mesh through ``make_train_step(grad_compressor=...)`` with the
   int8 compression's error feedback (``dist.compression``), one batch
   repeated: the loss must fall; the compression's ms a step is printed
   beside the step's. Then (a) checkpointed sharded training:
   falcon-mamba-7b at every published width and 2 of 64 layers (f32,
   batch 4 x 1024, remat full, the seed and lr of 10) trains 4 steps
   uninterrupted on the (1, 1) mesh with a checkpoint at step 2 and the
   final one at step 4 (each gathered leaf by leaf, written by rank 0);
   step 4 is deleted, as a crash after step 2 would leave the directory,
   and the run resumed to 4 steps on the mesh, then, step 4 deleted
   again, unsharded. Fails unless both resumed
   runs' losses, grad norms and final parameters are within the f32 train
   tolerances of the uninterrupted run's (whether the bits match is
   printed), the scan and RMSNorm launches of the resumed steps are
   exactly the formula's, probe/observed >= 1.0 over each resumed run
   (the restore, its steps and its save) and nothing crashed; prints the
   bytes written, the gather, copy and write seconds and each restore's.
   (b) A one-stage pipeline (``dist.pipeline`` on a (1,) mesh, no
   transfer): gemma2-9b's first 2 layers at every published width,
   stacked as the stage's slice, the port's attention layer over it, f32,
   batch 4 x 1024 in 4 microbatches, the loss the mean of the outputs'
   squares. Fails unless the gradients of the stage params and of x are
   within 1e-3 of their largest magnitude of autograd through the same
   layers without the pipeline and the flash and RMSNorm forward and
   backward launches are exactly the formula's (a forward, a recompute and
   a backward a microbatch); prints both device ms.
14. dryrun (``start_dryrun`` right after the build, ``phase_dryrun`` after
   ``phase_dist``): the production-mesh dry run in processes of its own,
   started together and run beside the earlier phases (they run on the
   host and allocate no tensor on the card): ``python -m
   repro_torch.launch.dryrun`` for gemma2-9b train_4k, dbrx-132b train_4k (E = 16 on the 16-wide
   ``model`` axis: expert parallel) and zamba2-2.7b long_500k (batch 1,
   a context-parallel cache) on the fake 16 x 16 "cuda" mesh, and
   gemma2-9b decode_32k on the 2 x 16 x 16 one; each must end ``ok``,
   and its three terms, dominant term, peak a device, fit against 80 GB
   and collective bytes by kind and axis are printed. Fails if dbrx's
   trace moves more than one expert's weights over ``model`` or
   zamba2's carries a collective over the cache's sequence. Then the
   dry run of the very step ``phase_train("gemma2-9b")`` measured (12
   layers, f32, 4 x 1024, remat full) on a fake (1, 1) mesh: its peak
   against that phase's probe and measured ``max_memory_allocated``, its
   compute and memory terms against the measured device ms a step
   (printed, not gated). Then mixtral-8x7b's experts (every width) split
   over 2 and 4 simulated ``model`` ranks at a prefill's (4 x 1024) and a
   decode step's (4 x 1) rows, bf16 and f32: each rank's share
   (``models.moe.expert_slice_apply``, the hand grouped matmul on its
   experts) summed must equal the whole layer within the grouped matmul's
   tolerances (bf16 2e-2, f32 1e-4), its launches the kernels table's
   ``dryrun`` path.
15. examples (``phase_examples``, after ``phase_obs``): the six examples
   of ``repro_torch.examples`` through their ``main`` on the card, in this
   process: quickstart, gang_placement, preemptive_cluster and
   trace_viewer, each beside its CPU run (quickstart's results within
   1e-4 relative, the sim sections equal); shared_cluster (reduced
   gemma2-9b and qwen1.5-32b train jobs, mixtral-8x7b, falcon-mamba-7b,
   zamba2-2.7b and musicgen-large prefills, under MGB and SA on two
   virtual devices of the card, a device death, a fleet of 64 zamba2
   prefills beside a gemma2 train job): nothing crashed outside the
   device death, 65 completed in the fleet; train_100m (lm-100m, 115M
   parameters at its full width and depth, f32, 300 steps of 8 x 256,
   checkpoints every 50): the loss falls, the launches are the formula's,
   and ``--resume`` restores step 300 and runs no step. Every kernel but
   the scan's and the grouped matmul's backward must launch; the counts
   are the kernel table's ``examples`` path.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import gc
import json
import os
import re
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
                "flash_bwd_tc_dkdv_kernel", "flash_bwd_tc_dq_kernel",
                "rmsnorm_smem_kernel", "rmsnorm_bwd_kernel",
                "rmsnorm_bwd_wide_kernel",
                "rmsnorm_dscale_kernel", "mamba_scan_bwd_kernel",
                "gmm_bwd_gate_kernel", "gmm_bwd_dx_kernel",
                "gmm_bwd_dw_kernel", "gmm_bwd_gate_tma_kernel",
                "gmm_bwd_dx_tma_kernel", "gmm_bwd_dw_tma_kernel")
# mixtral-8x7b's 32 layers are 93.4e9 B in bf16, more than one 80 GB card;
# 24 (70.2e9 B) leave room for the activations and the 1.6e9 B ring cache
MIXTRAL_LAYERS = 24
# nemotron-4-340b served at every published width: one layer in bf16 is
# 6.9e9 B and the 256000 x 18432 embedding and head 18.9e9 B; 2 of 96
# layers put its head dim (192) and its 18432-wide norms on a main path
NEMOTRON_LAYERS = 2
# the backward ops' counters (``counters``)
BWD_KERNELS = ("flash_attention_bwd", "rmsnorm_bwd", "mamba_scan_bwd",
               "moe_gmm_bwd", "moe_gmm_gated_bwd")


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


def host_call_ms(torch, fn, iters: int) -> float:
    """Wall time of one eager call of ``fn()`` (no graph): ``iters`` calls
    in a row after a warm-up, the clock stopped once the card has run them
    all. Where the card is quicker than the host, this is what the host
    spends to issue one call, which a launch-bound step pays a call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


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


def compare_lse(torch, got, want, dtype, what: str) -> float:
    """``compare`` for a forward's lse: +inf, exactly, on the rows that see
    no key (ROADMAP C10) and only there; the other rows within the dtype's
    tolerance."""
    empty = torch.isinf(want)
    if not torch.equal(torch.isinf(got), empty) \
            or not bool((got[empty] == want[empty]).all()):
        fail(f"{what}: lse is not +inf on exactly the rows that see no key")
    return compare(torch, got[~empty], want[~empty], dtype, what)


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
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = {}

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(dtype)

    phase_rmsnorm(torch, randn, table)
    phase_flash(torch, randn, table)

    # the selective scan: edge cases (S = 1, S = 7, B*E*N off the block
    # size, E*N not a multiple of 4, N = 64), zamba2-2.7b's recurrence
    # across chunks in a 1 x 1024 training microbatch, then falcon-mamba-
    # 7b's prefill shape and zamba2-2.7b's at a 4 x 1024 prefill ([B, nc,
    # nh·P, N]), timed. a = exp(-|randn|) as tests/test_kernels.py:108.
    for shape in [(2, 1, 8, 4), (1, 7, 5, 3), (3, 33, 17, 64),
                  (2, 96, 128, 64), (1, 64, 128, 16), (2, 300, 1000, 16),
                  (1, 4, 5120, 64), (4, 1024, 8192, 16), (4, 4, 5120, 64)]:
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
        if shape in ((4, 1024, 8192, 16), (4, 4, 5120, 64)):
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
            entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=None)
            if shape[1] == 4:
                table["mamba_scan"]["zamba2_case"] = dict(
                    shape=list(shape), **entry)
            else:
                table["mamba_scan"] = dict(
                    name="mamba_scan", route="cuda",
                    source="src/repro_torch/kernels/csrc/mamba_scan.cu",
                    replaces="src/repro/kernels/mamba_scan.py:73", **entry)
        del a, b
        print(line, flush=True)
    phase_gmm(torch, randn, table)
    phase_backward(torch, randn, table)
    phase_scan_gmm_backward(torch, randn, table)
    return table


def sdpa_backend(torch, q, k, v) -> str:
    """The backend SDPA picks for causal GQA attention on these operands:
    PyTorch's own choice where it tells it, else the kernels one call
    runs on the card."""
    import torch.nn.functional as F
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, is_causal=True, enable_gqa=True)).name
    except (AttributeError, TypeError, ValueError, RuntimeError):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=True)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        return "kernels " + ", ".join(n[:40] for n in names[:2])


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


# RMSNorm's rows on the main paths: (shape, dtype, where). gemma2-9b (d
# 3584), falcon-mamba-7b and mixtral-8x7b (d 4096), nemotron-4-340b (d
# 18432), zamba2-2.7b (d 2560 and its gated norm's E 5120): static prefills
# of 4 x ~1000 tokens and decode steps of 4 rows in bf16, continuous
# prefills of 1 x ~1000 tokens and the continuous loop's steps of 8 rows in
# bf16, f32 training batches of 4 x 1024 (zamba2: microbatches of 1 x
# 1024); lm-100m's (d 640, the examples' full-width training) f32 batches
# of 8 x 256; then a narrow edge case.
RMSNORM_ROWS = (
    ((4000, 3584), "bfloat16", "gemma2 static prefill"),
    ((4000, 3584), "float32", "gemma2 f32 rows"),
    ((4096, 3584), "float32", "gemma2 train"),
    ((1000, 3584), "bfloat16", "gemma2 continuous prefill"),
    ((4, 3584), "bfloat16", "gemma2 decode"),
    ((4, 3584), "float32", "gemma2 f32 decode"),
    ((8, 3584), "bfloat16", "gemma2 continuous loop"),
    ((4096, 4096), "bfloat16", "falcon-mamba, mixtral static prefill"),
    ((4096, 4096), "float32", "falcon-mamba, mixtral train"),
    ((1024, 4096), "bfloat16", "falcon-mamba, mixtral continuous prefill"),
    ((4, 4096), "bfloat16", "falcon-mamba, mixtral decode"),
    ((4, 4096), "float32", "falcon-mamba f32 decode"),
    ((8, 4096), "bfloat16", "falcon-mamba, mixtral continuous loop"),
    ((4096, 18432), "bfloat16", "nemotron static prefill"),
    ((4096, 18432), "float32", "nemotron f32 rows"),
    ((4, 18432), "bfloat16", "nemotron decode"),
    ((4096, 5120), "bfloat16", "zamba2 static prefill, gated norm"),
    ((4096, 5120), "float32", "zamba2 f32 rows, gated norm"),
    ((4096, 2560), "bfloat16", "zamba2 static prefill"),
    ((4096, 2560), "float32", "zamba2 f32 rows"),
    ((1024, 2560), "bfloat16", "zamba2 continuous prefill"),
    ((1024, 5120), "bfloat16", "zamba2 continuous prefill, gated norm"),
    ((1024, 2560), "float32", "zamba2 train microbatch"),
    ((1024, 5120), "float32", "zamba2 train microbatch, gated norm"),
    ((4, 2560), "bfloat16", "zamba2 decode"),
    ((4, 2560), "float32", "zamba2 f32 decode"),
    ((4, 5120), "bfloat16", "zamba2 decode, gated norm"),
    ((4, 5120), "float32", "zamba2 f32 decode, gated norm"),
    ((8, 2560), "bfloat16", "zamba2 continuous loop"),
    ((8, 5120), "bfloat16", "zamba2 continuous loop, gated norm"),
    ((2048, 640), "float32", "lm-100m train"),
    ((1000, 512), "float32", "narrow rows"),
    ((1000, 512), "bfloat16", "narrow rows"),
)
# rows of at least this many are prefill or train rows, also timed with
# their inputs cold: rotated through a pool of more than COLD_POOL_BYTES,
# twice the 50 MB L2
COLD_ROWS = 1000
COLD_POOL_BYTES = 100e6


def time_cold_ms(torch, fn, x, iters: int) -> float:
    """``time_ms`` of ``fn(x)`` with x cold in L2: each captured call reads
    the next of enough copies of x to hold more than ``COLD_POOL_BYTES``,
    so a copy is read again only after more than twice L2's bytes."""
    nbytes = x.numel() * x.element_size()
    pool = [x.clone() for _ in range(max(2, int(COLD_POOL_BYTES
                                                // nbytes) + 1))]
    calls = iter(range(1 << 30))
    ms = time_ms(torch, lambda: fn(pool[next(calls) % len(pool)]), iters)
    del pool
    return ms


def phase_rmsnorm(torch, randn, table) -> None:
    """RMSNorm's forward at every main-path row (``RMSNORM_ROWS``): held
    against its plain version, then the kernel, the plain version and
    ``F.rms_norm`` timed warm (the same input every call, which at most
    rows stays in L2) and, for prefill and train rows, the kernel and
    ``F.rms_norm`` cold (``time_cold_ms``). Fills the JSON table's
    ``rmsnorm`` entry: gemma2-9b's prefill row as its main case and every
    row under ``rows``."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as RN
    rows = []
    for shape, dname, where in RMSNORM_ROWS:
        dtype = getattr(torch, dname)
        x = randn(shape, dtype)
        sc = randn(shape[-1:], dtype, 0.1)
        out = RN.rmsnorm(x, sc)
        torch.cuda.synchronize()
        err = compare(torch, out, RN.rmsnorm_plain(x, sc), dtype,
                      f"rmsnorm {shape} {dtype}")
        if not torch.equal(out, RN.rmsnorm(x, sc)):
            fail(f"rmsnorm {shape} {dtype}: two calls differ")
        ms = time_ms(torch, lambda: RN.rmsnorm(x, sc), 50)
        plain_ms = time_ms(torch, lambda: RN.rmsnorm_plain(x, sc), 20)
        w = 1.0 + sc
        lib_ms = time_ms(torch, lambda: F.rms_norm(x, shape[-1:], w, 1e-5),
                         50)
        nbytes = 2 * x.numel() * x.element_size() + sc.numel() \
            * sc.element_size()
        flops = 4 * x.numel()
        bound = max(nbytes / H100_HBM_BW, flops / H100_F32_FLOPS) * 1e3
        row = dict(shape=list(shape), dtype=dname, where=where,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by="bytes")
        cold = ""
        if shape[0] >= COLD_ROWS:
            row["cold_ms"] = time_cold_ms(
                torch, lambda t: RN.rmsnorm(t, sc), x, 50)
            row["cold_library_ms"] = time_cold_ms(
                torch, lambda t: F.rms_norm(t, shape[-1:], w, 1e-5), x, 50)
            cold = (f"; cold: kernel {row['cold_ms']:.4f} ms "
                    f"({100 * bound / row['cold_ms']:.1f}%), F.rms_norm "
                    f"{row['cold_library_ms']:.4f} ms")
        rows.append(row)
        print(f"[kernels] rmsnorm {shape} {dname} ({where}): max_abs_err "
              f"{err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.rms_norm {lib_ms:.4f} ms, bound {bound:.4f} ms (bytes), "
              f"{100 * bound / ms:.1f}% of the bound{cold}", flush=True)
        case = {k: row[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "library_ms")}
        if shape == (4000, 3584) and dname == "bfloat16":
            table["rmsnorm"] = dict(
                name="rmsnorm", route="cuda",
                source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm.py:40", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=lib_ms)
        elif shape == (4096, 18432) and dname == "bfloat16":
            table["rmsnorm"]["nemotron_case"] = case
        elif shape == (4096, 5120):
            table["rmsnorm"][f"zamba2_case_{dname}"] = case
        del x, out
    table["rmsnorm"]["rows"] = rows


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
    einsum views (a [B, S, H, D] buffer seen as [B, H, S, D]). Last, the
    train path's forward (f32, with lse) at gemma2's training shape, at
    lm-100m's and at D 128 with a window, timed beside its bound, its plain
    version and flex_attention's (gemma2) or SDPA's (D 128, lm-100m) f32
    forward."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    bf16, f32 = torch.bfloat16, torch.float32
    # (shape, dtype, softcap, window, score scale, einsum views, causal)
    # zamba2-2.7b's attention (32 heads of 80, no GQA) and nemotron-4-340b's
    # prefill (96 / 8 heads of 192), at prompt 1024, in both dtypes
    timed = [((4, 16, 8, 1000, 1000, 256), bf16, 50.0, 4096, 1.0, False, True),
             ((4, 32, 8, 1024, 1024, 128), bf16, 0.0, 4096, 1.0, False, True),
             ((4, 16, 8, 1000, 1000, 256), bf16, 50.0, 0, 1.0, False, True),
             ((4, 16, 8, 1000, 1000, 256), bf16, 0.0, 0, 1.0, False, True),
             ((1, 16, 8, 5000, 5000, 256), bf16, 50.0, 4096, 1.0, False, True),
             ((4, 16, 8, 1000, 1000, 256), f32, 50.0, 4096, 1.0, False, True),
             ((4, 32, 32, 1024, 1024, 80), bf16, 0.0, 0, 1.0, False, True),
             ((4, 96, 8, 1024, 1024, 192), bf16, 0.0, 0, 1.0, False, True),
             ((1, 32, 32, 1024, 1024, 80), f32, 0.0, 0, 1.0, False, True),
             ((1, 96, 8, 1024, 1024, 192), f32, 0.0, 0, 1.0, False, True)]
    cases = []
    for d in FA.HEAD_DIMS:
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
        if cap == 0.0 and (win == 0 or win >= sk):
            lib = f"SDPA ({sdpa_backend(torch, q, k, v)})"
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), iters)
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
                                        design="CUDA cores: cp.async into "
                                               "two buffers, 4 x 4 score "
                                               "and 8-row PV register "
                                               "blocks, heaviest q tiles "
                                               "first")})
        elif d == 128:
            table["flash_attention"]["mixtral_case"] = entry
        elif d in (80, 192):
            model = "zamba2" if d == 80 else "nemotron"
            route = "bfloat16" if dtype == bf16 else "float32"
            table["flash_attention"]["routes"][route][f"{model}_case"] = entry
        elif dtype == f32:
            table["flash_attention"]["routes"]["float32"]["gemma2_case"] = \
                entry
    # rows that see no key (ROADMAP C10): top-left causal with Sq > Sk and a
    # window, the rows from Sk + window - 1 on; on both routes and at every
    # head dim o is 0 and lse +inf there exactly, as the plain versions give,
    # with and without the lse output
    b, hq, hkv, sq, sk, win = 2, 2, 1, 129, 65, 17
    sees = FA.visible_mask(sq, sk, causal=True, window=win,
                           device=torch.device("cuda", 0)).any(-1)
    for d in FA.HEAD_DIMS:
        for dtype in (f32, bf16):
            q = randn((b, hq, sq, d), dtype)
            k, v = randn((b, hkv, sk, d), dtype), randn((b, hkv, sk, d), dtype)
            o, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, True,
                                                               win, 0.0)
            o_fwd = FA.flash_attention(q, k, v, window=win)
            torch.cuda.synchronize()
            want_o, want_lse = FA.flash_attention_lse_plain(q, k, v,
                                                            causal=True,
                                                            window=win)
            route = "tensor cores" if dtype == bf16 else "CUDA cores"
            what = (f"flash {(b, hq, hkv, sq, sk, d)} {str(dtype)[6:]} "
                    f"({route}) window {win}, {int((~sees).sum())} rows that "
                    f"see no key")
            if bool(o[:, :, ~sees].any()) or bool(o_fwd[:, :, ~sees].any()):
                fail(f"{what}: o is not 0 on the rows that see no key")
            err = max(compare(torch, o, want_o, dtype, f"{what} o"),
                      compare(torch, o_fwd, want_o, dtype,
                              f"{what} o without lse"),
                      compare_lse(torch, lse, want_lse, dtype, f"{what} lse"))
            worst[dtype] = max(worst[dtype], err)
            print(f"[kernels] {what}: max_abs_err {err:.3e} (o, lse); o 0 and "
                  f"lse +inf on those rows", flush=True)
            del q, k, v, o, lse, o_fwd, want_o, want_lse
    table["flash_attention"]["routes"]["bfloat16"]["max_abs_err_all_cases"] \
        = worst[bf16]
    table["flash_attention"]["routes"]["float32"]["max_abs_err_all_cases"] \
        = worst[f32]

    # the train path's forward, f32 with lse, at the backward's timed shapes
    # (gemma2-9b's training case, D 128 with a window of 256, lm-100m's 10 /
    # 5 heads of 64 at 8 x 256) beside its bound, its plain version and the
    # same library's f32 forward
    for (b, hq, hkv, s, d), cap, win, name in [
            ((4, 16, 8, 1024, 256), 50.0, 4096, "train_case"),
            ((2, 32, 8, 1024, 128), 0.0, 256, "d128_case"),
            ((8, 10, 5, 256, 64), 0.0, 0, "lm100m_case")]:
        q = randn((b, hq, s, d), f32)
        k, v = randn((b, hkv, s, d), f32), randn((b, hkv, s, d), f32)
        args = (True, win, cap)
        kw = dict(causal=True, window=win, logit_softcap=cap)
        o, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, *args)
        torch.cuda.synchronize()
        want_o, want_lse = FA.flash_attention_lse_plain(q, k, v, **kw)
        what = (f"flash forward with lse {(b, hq, hkv, s, s, d)} float32 "
                f"(CUDA cores) softcap {cap:g} window {win}")
        err = max(compare(torch, o, want_o, f32, f"{what} o"),
                  compare_lse(torch, lse, want_lse, f32, f"{what} lse"))
        del o, lse, want_o, want_lse
        ms = time_ms(torch, lambda: torch.ops.repro_torch
                     .flash_attention_lse(q, k, v, *args), 3)
        plain_ms = time_ms(torch, lambda: FA.flash_attention_lse_plain(
            q, k, v, **kw), 2)
        # q, k, v read, o and lse written; four flops a visible pair and
        # head dim
        nbytes = (2 * q.numel() + 2 * k.numel()) * 4 + b * hq * s * 4
        flops = 4 * b * hq * d * FA.visible_pairs(s, s, causal=True,
                                                  window=win)
        t_bytes, t_ops = nbytes / H100_HBM_BW, flops / H100_F32_FLOPS
        bound = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes > t_ops else "operations"
        if cap:
            lib = "flex_attention"
            call, _ = flex_library(torch, q, k, v, cap, win)
        else:
            lib = "SDPA"
            mask = FA.visible_mask(s, s, causal=True, window=win,
                                   device=q.device)
            call = (lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True))
        lib_ms = time_ms(torch, call, 3) if call is not None else None
        # what the softcap's tanh costs the kernel: the same launch without
        # it (another function, timed for the kernel's own breakdown)
        nocap_ms = time_ms(torch, lambda: torch.ops.repro_torch
                           .flash_attention_lse(q, k, v, True, win, 0.0),
                           3) if cap else None
        print(f"[kernels] {what}: max_abs_err {err:.3e}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, "
              + (f"{lib} {lib_ms:.4f} ms, " if lib_ms else
                 f"{lib} refused, ")
              + f"bound {bound:.4f} ms ({by}), "
              f"{100 * bound / ms:.1f}% of the bound"
              + (f"; the kernel without the softcap {nocap_ms:.4f} ms"
                 if cap else ""), flush=True)
        table["flash_attention"]["routes"]["float32"][f"forward_lse_{name}"] \
            = dict(shape=[b, hq, hkv, s, s, d], softcap=cap, window=win,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=by, library_ms=lib_ms, library=lib)
        del q, k, v


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
                        "float32": "gmm_f32_kernel: CUDA cores, "
                        "register-blocked 128 x 128 tiles, 8 x 8 a thread, "
                        "cp.async into two buffers"},
                max_abs_err_all_cases={f"{r}{' gated' if g else ''}": v
                                       for (r, g), v in worst.items()})
        else:
            table[name][label.replace(" ", "_") + "_case"] = entry
        del x, ws, gs, out, lib

    # the f32 route at mixtral-8x7b's training shape, the train path's
    # forward: wi's product and the gated pair over the prefill's uneven
    # groups, then wi's over equal groups beside torch.bmm of [E, T/E, D] x
    # [E, D, F], a yardstick of cuBLAS's f32 rate on the same work (the
    # port never calls it)
    t, d, f = 8192, 4096, 14336
    for label, sizes, act in [("train", prefill, None),
                              ("train", prefill, "silu_gated"),
                              ("train, equal groups", [t // 8] * 8, None)]:
        n_w = 1 if act is None else 2
        x, ws, gs = inputs(t, d, f, sizes, f32, n_w)
        what = (f"moe_gmm{'' if act is None else ' ' + act} {label} ({t}, "
                f"{d}, {f}) f32 route f32")

        def call():
            return MG.moe_gmm(x, ws[0], gs) if act is None else \
                MG.moe_gmm_gated(x, ws[0], ws[1], gs, act)
        out = call()
        torch.cuda.synchronize()
        err = check(out, x, ws, gs, sizes, act, what)
        del out
        ms = time_ms(torch, call, 3)
        plain_ms = time_ms(torch, lambda: plain(x, ws, gs, act), 1)
        n, used = sum(sizes), sum(1 for z in sizes if z)
        nbytes = 4 * (n * d + n_w * used * d * f + t * f)
        flops = 2 * n_w * n * d * f
        t_bytes, t_ops = nbytes / H100_HBM_BW, flops / H100_F32_FLOPS
        bound = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes > t_ops else "operations"
        bmm_ms = None
        if len(set(sizes)) == 1:
            xb = x.view(len(sizes), t // len(sizes), d)
            bmm_ms = time_ms(torch, lambda: torch.bmm(xb, ws[0]), 3)
        print(f"[kernels] {what} groups {sizes}: max_abs_err {err:.3e}, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              + (f"torch.bmm (yardstick) {bmm_ms:.4f} ms, " if bmm_ms else "")
              + f"bound {bound:.4f} ms ({by}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s = "
              f"{100 * bound / ms:.1f}% of the bound", flush=True)
        name = "moe_gmm" if act is None else "moe_gmm_gated"
        key = "f32_train_equal_groups_case" if bmm_ms else "f32_train_case"
        table[name][key] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None, bmm_yardstick_ms=bmm_ms, max_abs_err=err,
            kernel_route="f32")
        del x, ws, gs


# the flash backward's cases, (b, hq, hkv, sq, sk, d, softcap, window) and
# whether it is timed: gemma2-9b's training shape with window 4096 and 0, D
# 128 with a window of 256, zamba2-2.7b's heads (32 of 80, no GQA) and
# nemotron-4-340b's (96 / 8 of 192) at S 1024, lm-100m's (10 / 5 of 64) at
# 8 x 256, ragged Sq/Sk tails at D 256,
# 192, 80, 64 and 32, and Sq > Sk with a window (48 rows that see no key)
# at every head dim
FLASH_BWD_CASES = [((4, 16, 8, 1024, 1024, 256, 50.0, 4096), True),
                   ((4, 16, 8, 1024, 1024, 256, 50.0, 0), False),
                   ((2, 32, 8, 1024, 1024, 128, 0.0, 256), True),
                   ((1, 32, 32, 1024, 1024, 80, 0.0, 0), True),
                   ((1, 96, 8, 1024, 1024, 192, 0.0, 0), True),
                   ((8, 10, 5, 256, 256, 64, 0.0, 0), True),
                   ((1, 4, 2, 1000, 1000, 256, 50.0, 0), False),
                   ((1, 4, 2, 300, 500, 192, 50.0, 0), False),
                   ((2, 4, 4, 333, 333, 80, 0.0, 96), False),
                   ((1, 4, 2, 100, 300, 64, 0.0, 33), False),
                   ((2, 4, 4, 77, 77, 32, 0.0, 0), False)] + [
    # rows that see no key (ROADMAP C10) at every head dim
    ((2, 2, 1, 129, 65, d, 0.0, 17), False) for d in (32, 64, 80, 128, 192,
                                                      256)]


def phase_backward(torch, randn, table, cases=FLASH_BWD_CASES) -> None:
    """The backward kernels against their plain versions, and against
    autograd through the forward's plain version (``gradcheck``-style), in
    f32 and bf16. Flash (bf16 on the tensor cores, f32 on the CUDA cores):
    ``cases``; dq, dk and dv must be the same bits on two calls. Timed at
    gemma2's shape against the backward of flex_attention (softcap as a
    score_mod, causal + window as a block mask), and at D 128 and lm-100m's
    shape against SDPA's backward. RMSNorm: the train path's rows [4096,
    3584] and row tails, timed against the backward of ``F.rms_norm``; its
    dscale must be the same bits from run to run (no atomics). A library's
    backward is timed alone, graph-replayed, as the kernel is
    (``time_grad_ms``). Needs no other phase: a short check can call it
    alone with its own cases."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    bf16, f32 = torch.bfloat16, torch.float32
    bwd_row = table.setdefault("flash_attention_bwd", {})
    for (b, hq, hkv, sq, sk, d, cap, win), timed in cases:
        for dtype in (f32, bf16):
            q, do = randn((b, hq, sq, d), dtype), randn((b, hq, sq, d), dtype)
            k, v = randn((b, hkv, sk, d), dtype), randn((b, hkv, sk, d), dtype)
            args = (True, win, cap)
            o, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, *args)
            got = torch.ops.repro_torch.flash_attention_bwd(q, k, v, o, lse,
                                                            do, *args)
            again = torch.ops.repro_torch.flash_attention_bwd(q, k, v, o,
                                                              lse, do, *args)
            torch.cuda.synchronize()
            kw = dict(causal=True, window=win, logit_softcap=cap)
            route = "tensor cores" if dtype == bf16 else "CUDA cores"
            what = (f"flash backward {(b, hq, hkv, sq, sk, d)} "
                    f"{str(dtype)[6:]} ({route}) softcap {cap:g} window {win}")
            for n, g, g2 in zip(("dq", "dk", "dv"), got, again):
                if not torch.equal(g, g2):
                    fail(f"{what}: {n} differs between two calls")
            del again
            # the forward's lse (natural log on both routes) against plain
            lse_err = compare_lse(torch, lse, FA.flash_attention_lse_plain(
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
                    f"forward; forward's lse {lse_err:.3e}; dq, dk, dv the "
                    f"same bits twice")
            if timed:
                ms = time_ms(torch, lambda: torch.ops.repro_torch
                             .flash_attention_bwd(q, k, v, o, lse, do, *args),
                             3)
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
                line += (f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         + (f"{lib} {lib_ms:.4f} ms, " if lib_ms else
                            f"{lib}, ")
                         + f"bound {bound:.4f} ms ({by}), "
                         f"{flops / ms / 1e9:.1f} TFLOP/s = "
                         f"{100 * bound / ms:.1f}% of the bound")
                entry = dict(shape=[b, hq, hkv, sq, sk, d], softcap=cap,
                             window=win, dtype=str(dtype)[6:],
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=lib_ms,
                             library=lib)
                if d == 256 and dtype == f32:
                    bwd_row.update(
                        name="flash_attention_bwd", route="cuda",
                        source="src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                        replaces="src/repro/models/layers.py:242",
                        backward_of="src/repro/kernels/flash_attention.py:93",
                        **{k: entry[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "library")},
                        kernels="flash_bwd_delta_kernel, then bf16: "
                                "flash_bwd_tc_dkdv_kernel, "
                                "flash_bwd_tc_dq_kernel (tensor cores: "
                                "wgmma fed by TMA, warp-specialised); f32: "
                                "flash_bwd_dkdv_kernel, flash_bwd_dq_kernel "
                                "(CUDA cores, cp.async into two buffers)")
                else:
                    bwd_row[f"case_d{d}_{str(dtype)[6:]}"] = entry
            print(line, flush=True)
            del q, k, v, o, lse, do, got

    # the train path's rows, nemotron-4-340b's (18432: in f32 past the
    # registers, the wide path), zamba2-2.7b's gated norm (5120) and its d
    # 2560, at 4 x 1024 and at a 1 x 1024 training microbatch, lm-100m's d
    # 640 at 8 x 256, a row past 32768 bf16 elements, tails. The timed rows
    # and their keys in the table's ``rmsnorm_bwd`` entry (None: the entry
    # itself in f32, ``bf16_case`` in bf16)
    timed = {(4096, 3584): None, (4096, 18432): "nemotron_case",
             (4096, 5120): "zamba2_case", (1024, 2560): "zamba2_micro_2560",
             (1024, 5120): "zamba2_micro_5120", (2048, 640): "lm100m_case"}
    for shape in [(4096, 3584), (4096, 18432), (4096, 5120), (4096, 2560),
                  (1024, 2560), (1024, 5120), (2048, 640), (4097, 3584),
                  (33, 40000), (1000, 512), (7, 100), (3, 5, 128)]:
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
            if shape in timed:
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
                row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound, max_abs_err=err)
                if shape == (2048, 640):
                    # lm-100m's step waits on the host's launches: the
                    # kernel beside the least a launch costs the card (a
                    # one-element add, graph-replayed) and the host (one
                    # eager call of the wrapper, 200 in a row)
                    one = torch.zeros(1, device=x.device)
                    row["launch_ms"] = time_ms(torch, lambda: one.add_(1),
                                               20)
                    row["host_launch_ms"] = host_call_ms(
                        torch, lambda: torch.ops.repro_torch.rmsnorm_bwd(
                            x, sc, dy, 1e-5), 200)
                    line += (f"; a one-element add {row['launch_ms']:.4f} "
                             f"ms on the card, an eager call of the "
                             f"wrapper {row['host_launch_ms']:.4f} ms on "
                             f"the host")
                    del one
                if shape[-1] == 18432:
                    row["kernel"] = "rmsnorm_bwd_wide_kernel" \
                        if dtype == f32 else "rmsnorm_bwd_kernel"
                if timed[shape] is not None:
                    table["rmsnorm_bwd"][f"{timed[shape]}_"
                                         f"{str(dtype)[6:]}"] = row
                elif dtype == f32:
                    table["rmsnorm_bwd"] = dict(
                        name="rmsnorm_bwd", route="cuda",
                        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                        replaces="src/repro/models/layers.py:23",
                        backward_of="src/repro/kernels/rmsnorm.py:40",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by="bytes", library_ms=lib_ms,
                        library="F.rms_norm backward",
                        kernels="rmsnorm_bwd_kernel (or, for rows past "
                                "the registers, rmsnorm_bwd_wide_kernel), "
                                "rmsnorm_dscale_kernel")
                else:
                    table["rmsnorm_bwd"]["bf16_case"] = row
            print(line, flush=True)
            del x, dy, sc, got, again, want, ref, leaves


def phase_scan_gmm_backward(torch, randn, table) -> None:
    """The backward kernels of the Mamba scan and of the grouped matmul
    (plain and gated, f32 and bf16) against their plain versions and
    against autograd through the plain forwards, each the same bits on two
    calls. The scan at edge cases (S = 1, E*N off 4) and at falcon-mamba-
    7b's training shape [4, 1024, 8192, 16], timed (no library call
    computes it). The grouped matmul on every route its operands allow,
    forced (bf16: the tensor cores and the CUDA cores), at the forward's
    edge cases (tiles straddling experts, groups of 0, 1, 63, 64, 65 and
    127 rows, every row in one expert, rows past the groups: dx exactly 0
    there, an empty expert's dw exactly 0) and at mixtral-8x7b's training
    shape (8192 (token, slot) rows over 8 experts, 4096 x 14336) in f32,
    the main path's dtype, timed beside the plain version, and in bf16
    beside the backward of ``torch._grouped_mm`` (which refuses f32
    operands), timed alone as ``time_grad_ms`` does; each kernel's device
    time from the profiler."""
    from repro_torch.kernels import mamba_scan as SC
    from repro_torch.kernels import moe_gmm as MG
    dev = torch.device("cuda", 0)
    bf16, f32 = torch.bfloat16, torch.float32
    for shape in [(2, 1, 8, 4), (1, 7, 5, 3), (3, 33, 17, 64),
                  (2, 300, 1000, 16), (1, 4, 5120, 64), (4, 1024, 8192, 16),
                  (4, 4, 5120, 64)]:
        a = torch.exp(-randn(shape, f32).abs_())
        b = randn(shape, f32)
        h, _ = SC.mamba_scan(a, b)
        dh, dl = randn(shape, f32), randn(shape[:1] + shape[2:], f32)
        got = torch.ops.repro_torch.mamba_scan_bwd(a, h, dh, dl)
        again = torch.ops.repro_torch.mamba_scan_bwd(a, h, dh, dl)
        torch.cuda.synchronize()
        what = f"mamba_scan backward {shape} f32"
        if not all(torch.equal(g, g2) for g, g2 in zip(got, again)):
            fail(f"{what}: da or db differs between two calls")
        del again
        want = SC.mamba_scan_bwd_plain(a, h, dh, dl)
        err = max(compare(torch, g, w, f32, f"{what} {n}")
                  for n, g, w in zip(("da", "db"), got, want))
        del want
        leaves = [a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
        ref = torch.autograd.grad(SC.mamba_scan_plain(*leaves), leaves,
                                  (dh, dl))
        ag = max(compare(torch, g, w, f32, f"{what} {n} vs autograd")
                 for n, g, w in zip(("da", "db"), got, ref))
        del ref, leaves, got
        line = (f"[kernels] {what}: max_abs_err {err:.3e} vs the plain "
                f"backward, {ag:.3e} vs autograd through the plain forward; "
                f"da, db the same bits twice")
        if shape in ((4, 1024, 8192, 16), (4, 4, 5120, 64)):
            ms = time_ms(torch, lambda: torch.ops.repro_torch.mamba_scan_bwd(
                a, h, dh, dl), 5)
            plain_ms = time_ms(torch, lambda: SC.mamba_scan_bwd_plain(
                a, h, dh, dl), 2)
            # a, h_all, dh_all, dh_last read once; da, db written once
            nbytes = 5 * a.numel() * 4 + dl.numel() * 4
            t_bytes, t_ops = nbytes / H100_HBM_BW, 3 * a.numel() \
                / H100_F32_FLOPS
            bound = max(t_bytes, t_ops) * 1e3
            by = "bytes" if t_bytes > t_ops else "operations"
            line += (f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, no "
                     f"library call, bound {bound:.4f} ms ({by}), "
                     f"{nbytes / ms / 1e6:.1f} GB/s = "
                     f"{100 * bound / ms:.1f}% of the bound")
            entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=None)
            if shape[1] == 4:
                table["mamba_scan_bwd"]["zamba2_case"] = dict(
                    shape=list(shape), **entry)
            else:
                table["mamba_scan_bwd"] = dict(
                    name="mamba_scan_bwd", route="cuda",
                    source="src/repro_torch/kernels/csrc/mamba_scan.cu",
                    replaces="src/repro/models/ssm.py:47",
                    backward_of="src/repro/kernels/mamba_scan.py:73",
                    **entry,
                    kernels="mamba_scan_bwd_kernel: a reverse scan, a "
                            "thread's channels walked from the end, 16-byte "
                            "streaming loads of 8 steps in flight")
        print(line, flush=True)
        del a, b, h, dh, dl

    def operands(t, d, f, sizes, dtype, dy_scale=1.0):
        x = randn((t, d), dtype)
        ws = [randn((len(sizes), d, f), dtype, d ** -0.5) for _ in range(2)]
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        return x, ws, gs, randn((t, f), dtype, dy_scale)

    def kernel(act, dy, x, ws, gs, route=None):
        """(dx, dw), or gated (dx, dwi, dwg, dpre); ``route`` forced, or
        through the op on the route it picks."""
        if route is not None:
            gate = {} if act is None else dict(wg=ws[1], act=act)
            return MG._launch_bwd(dy, x, ws[0], gs, route=route, **gate)
        if act is None:
            return torch.ops.repro_torch.moe_gmm_bwd(dy, x, ws[0], gs)
        return torch.ops.repro_torch.moe_gmm_gated_bwd(dy, x, ws[0], ws[1],
                                                       gs, act)

    def plain(act, dy, x, ws, gs):
        if act is None:
            return MG.moe_gmm_bwd_plain(dy, x, ws[0], gs)
        return MG.moe_gmm_gated_bwd_plain(dy, x, ws[0], ws[1], gs, act)

    def autograd(act, dy, x, ws, gs):
        """Autograd through the plain forward in f32: the gradients of x and
        the weights, and for the gated pair those of its pre-activations
        and a function giving the gradients of x and the weights from any
        pre-activation gradients (the products' chain rule alone)."""
        leaves = [t.detach().float().requires_grad_(True)
                  for t in (x, *ws[:1 if act is None else 2])]
        if act is None:
            out = MG.moe_gmm_plain(leaves[0], leaves[1], gs)
            return torch.autograd.grad(out, leaves, dy.float()), None, None
        a, g = (MG.moe_gmm_plain(leaves[0], w, gs) for w in leaves[1:])
        out = MG.gated_act(a, act) * g
        grads = torch.autograd.grad(out, [a, g, *leaves], dy.float(),
                                    retain_graph=True)

        def products(dpre):
            return torch.autograd.grad((a, g), leaves, tuple(dpre.float()),
                                       retain_graph=True)
        return grads[2:], torch.stack(grads[:2]), products

    def names(act):
        return ("dx", "dw") if act is None else ("dx", "dwi", "dwg")

    def held(act, dtype, got, want, ref, what):
        """The kernels' gradients against the plain backward's and
        autograd's: (max error vs plain, vs autograd). The gated pair's
        dpre is held against both too; in bf16 the kernels round it (as the
        plain version does), and an element whose f32 value lies at a
        rounding boundary may round one bf16 unit apart in the two, which dw
        carries times x: so there the products are held against the plain
        products and the autograd of the products on the kernels' own dpre,
        the same inputs."""
        ns = names(act)
        want_g, ref_g = want, ref[0]
        errs, ags = [0.0], [0.0]
        if act is not None and got[3].numel():
            dpre = got[3]
            errs.append(compare(torch, dpre, want[3], dtype, f"{what} dpre"))
            ags.append(compare(torch, dpre, ref[1], dtype,
                               f"{what} dpre vs autograd"))
            if dtype == bf16:
                want_g = MG.moe_gmm_gated_bwd_products_plain(
                    dpre, x, ws[0], ws[1], gs)
                ref_g = ref[2](dpre)
        errs += [compare(torch, g, w, dtype, f"{what} {n}")
                 for n, g, w in zip(ns, got, want_g) if g.numel()]
        ags += [compare(torch, g, w, dtype, f"{what} {n} vs autograd")
                for n, g, w in zip(ns, got, ref_g) if g.numel()]
        return max(errs), max(ags)

    # groups of 0, 1, 63, 64, 65 and 127 rows (dw's last 64-row slice holds
    # the next expert's rows, or runs past T), every row in one expert, and
    # rows past the groups
    for label, t, d, f, sizes in [
            ("mid", 1024, 512, 1024, [300, 0, 1, 129, 200, 77, 250, 60]),
            ("straddling, many tiles", 2048, 1024, 1024,
             [300, 700, 129, 500, 400]),
            ("ragged, empty expert, rows past", 200, 72, 136,
             [0, 64, 1, 100]),
            ("groups of 0, 1, 63, 64, 65, 127, rows past", 400, 136, 200,
             [63, 0, 64, 1, 65, 127]),
            ("all rows in one", 300, 128, 256, [0, 300, 0]),
            ("groups of 1", 4, 64, 64, [1, 1, 1, 1]),
            ("T below 64", 40, 128, 264, [17, 0, 20]),
            ("widths off 8", 77, 50, 70, [13, 0, 33, 31]),
            ("no rows", 0, 64, 64, [0, 0])]:
        for dtype in (f32, bf16):
            x, ws, gs, dy = operands(t, d, f, sizes, dtype)
            routes = ["f32"] if dtype == f32 else ["cuda_cores"] + (
                ["wgmma"] if MG.gmm_bwd_route(bf16, t, d, f, True)
                == "wgmma" else [])
            for act in GMM_ACTS:
                want = plain(act, dy, x, ws, gs)
                ref = autograd(act, dy, x, ws, gs)
                what = (f"moe_gmm backward {act or 'plain'} {label} ({t}, "
                        f"{d}, {f}) groups {sizes} {str(dtype)[6:]}")
                err, ag = 0.0, 0.0
                for route in routes + [None]:
                    on = f"{what} route {route or 'of the op'}"
                    got = kernel(act, dy, x, ws, gs, route)
                    again = kernel(act, dy, x, ws, gs, route)
                    torch.cuda.synchronize()
                    if not all(torch.equal(g, g2) for g, g2 in zip(got, again)):
                        fail(f"{on}: the gradients differ between two calls")
                    if bool(got[0][sum(sizes):].ne(0).any()):
                        fail(f"{on}: dx is not zero past the groups")
                    for e, z in enumerate(sizes):
                        if z == 0 and any(bool(g[e].ne(0).any())
                                          for g in got[1:len(names(act))]):
                            fail(f"{on}: dw of empty expert {e} is not zero")
                    e1, e2 = held(act, dtype, got, want, ref, on)
                    err, ag = max(err, e1), max(ag, e2)
                    del got, again
                print(f"[kernels] {what}: routes {routes} and the op's "
                      f"({MG.gmm_bwd_route(dtype, t, d, f, True)}), "
                      f"max_abs_err {err:.3e} vs the plain backward, "
                      f"{ag:.3e} vs autograd through the plain forward; the "
                      f"same bits twice", flush=True)
                del want, ref
            del x, ws, gs, dy

    # mixtral-8x7b's training shape: 4 x 1024 tokens top-2, a few slots
    # dropped past the groups; wi's plain product (d 4096 -> 14336) and the
    # gated pair
    prefill = [1100, 950, 1280, 1005, 870, 1200, 760, 1020]  # 8185 rows
    t, d, f = 8192, 4096, 14336
    n, used = sum(prefill), sum(1 for z in prefill if z)
    for dtype in (f32, bf16):
        # dy scaled so that dw, a sum over an expert's ~1000 rows, is of
        # order 1, as the weights are scaled by d^-0.5 so that y is
        x, ws, gs, dy = operands(t, d, f, prefill, dtype,
                                 (t / len(prefill)) ** -0.5)
        for act in (None, "silu_gated"):
            n_w = 1 if act is None else 2
            got = kernel(act, dy, x, ws, gs)
            torch.cuda.synchronize()
            what = (f"moe_gmm backward {act or 'plain'} mixtral-8x7b "
                    f"training ({t}, {d}, {f}) {str(dtype)[6:]}")
            want = plain(act, dy, x, ws, gs)
            ns = names(act)
            if act is not None and dtype == bf16:  # as held() says
                err = max(compare(torch, got[3], want[3], dtype,
                                  f"{what} dpre"), *(
                    compare(torch, g, w, dtype, f"{what} {nm}")
                    for nm, g, w in zip(ns, got, MG
                                        .moe_gmm_gated_bwd_products_plain(
                                            got[3], x, ws[0], ws[1], gs))))
            else:
                err = max(compare(torch, g, w, dtype, f"{what} {nm}")
                          for nm, g, w in zip(ns, got, want))
            del got, want
            ms = time_ms(torch, lambda: kernel(act, dy, x, ws, gs), 2)
            plain_ms = time_ms(torch, lambda: plain(act, dy, x, ws, gs), 1)
            # each of its kernels' device time
            device_breakdown(torch, what, lambda: kernel(act, dy, x, ws, gs),
                             top=3)
            e = x.element_size()
            # x, dy and the used experts' weights read; dx and every dw
            # written; the dx and dw products of the rows in the groups and
            # (gated) the pair's recompute, two flops a multiply-add
            nbytes = e * (t * d + t * f + n_w * used * d * f + t * d
                          + n_w * len(prefill) * d * f)
            flops = (6 if act else 4) * n_w * n * d * f
            peak = H100_BF16_FLOPS if dtype == bf16 else H100_F32_FLOPS
            t_bytes = nbytes / H100_HBM_BW
            t_ops = flops / peak
            bound = max(t_bytes, t_ops) * 1e3
            by = "bytes" if t_bytes > t_ops else "operations"
            lib, lib_ms = None, None
            if act is None and dtype == bf16:
                call = grouped_mm_library(torch, x, ws[0], gs)
                if call is not None:
                    xl = x.detach().clone().requires_grad_(True)
                    wl = ws[0].detach().clone().requires_grad_(True)
                    offs = torch.cumsum(gs, 0).to(torch.int32)
                    try:
                        lib_ms, _ = time_grad_ms(
                            torch, lambda: torch._grouped_mm(xl, wl,
                                                             offs=offs),
                            (xl, wl), dy, 2)
                        lib = "torch._grouped_mm backward"
                    except RuntimeError as exc:
                        lib = (f"torch._grouped_mm backward refused: "
                               f"{str(exc).splitlines()[0][:80]}")
                    del xl, wl
            print(f"[kernels] {what}: max_abs_err {err:.3e}, kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  + (f"{lib} {lib_ms:.4f} ms, " if lib_ms else
                     f"{lib}, " if lib else "no library call in "
                     f"{str(dtype)[6:]}, ")
                  + f"bound {bound:.4f} ms ({by}), "
                  f"{flops / ms / 1e9:.1f} TFLOP/s = "
                  f"{100 * bound / ms:.1f}% of the bound", flush=True)
            entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=lib_ms,
                         library=lib)
            name = "moe_gmm_bwd" if act is None else "moe_gmm_gated_bwd"
            if dtype == f32:
                table[name] = dict(
                    name=name, route="cuda",
                    source="src/repro_torch/kernels/csrc/moe_gmm.cu",
                    replaces="src/repro/models/moe.py:80",
                    backward_of="src/repro/kernels/moe_gmm.py:54",
                    **entry, kernels=(
                        "f32 and bf16 off TMA's conditions: "
                        + ("" if act is None else "gmm_bwd_gate_kernel "
                           "(recomputes the gated pair) + ")
                        + "gmm_bwd_dx_kernel + gmm_bwd_dw_kernel: CUDA "
                        "cores, register-blocked 128 x 128 tiles, 8 x 8 a "
                        "thread, cp.async into two buffers; bf16: "
                        + ("" if act is None else "gmm_bwd_gate_tma_kernel + ")
                        + "gmm_bwd_dx_tma_kernel + gmm_bwd_dw_tma_kernel: "
                        "wgmma fed by TMA, dw's ragged slice zeroed in "
                        "shared memory"))
            else:
                table[name]["bf16_case"] = entry
        del x, ws, gs, dy


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
    from repro_torch.bench import preempt as bench_preempt
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
    # preemptive EDF against waiting and shedding on the overload trace
    # (synthetic vectors, the virtual clock: nothing runs on the card)
    bench_preempt.run()


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
            "mamba_scan_bwd": SC.BWD_LAUNCHES,
            "moe_gmm_bwd": MG.BWD_LAUNCHES,
            "moe_gmm_gated_bwd": MG.GATED_BWD_LAUNCHES,
            "graph_captures": SD.CAPTURES, "graph_replays": SD.REPLAYS,
            "prefill_captures": SD.PREFILL_CAPTURES,
            "prefill_replays": SD.PREFILL_REPLAYS}


def read_counts() -> dict:
    return {name: c.value for name, c in counters().items()}


def expected_launches(cfg, prefills: int, steps: int) -> dict:
    """Each kernel's launches on a serve path: per prefill, one scan per
    Mamba layer or one flash attention per attention layer; per prefill and
    per decode step, one RMSNorm per norm of a layer plus the final norm,
    and for an MoE layer two grouped-matmul launches (``moe_gmm`` counts
    both): the gated one (wi, wg) and wo, or wi and wo ungated. A hybrid
    of G groups of k layers: per prefill one flash attention a group and
    one scan (the recurrence across chunks) a Mamba-2 layer; per prefill
    and per decode step two RMSNorms a Mamba-2 layer (the pre-norm and the
    gated norm) and two a group's shared block, plus the final norm. No
    backward runs."""
    bwd = dict.fromkeys(BWD_KERNELS, 0)
    if cfg.family == "hybrid":
        k = cfg.hybrid_shared_every
        g = cfg.n_layers // k
        return {"rmsnorm": (g * (2 * (k - 1) + 2) + 1) * (prefills + steps),
                "flash_attention": g * prefills,
                "mamba_scan": g * (k - 1) * prefills,
                "moe_gmm": 0, "moe_gmm_gated": 0, **bwd}
    if cfg.family == "ssm":
        return {"rmsnorm": (cfg.n_layers + 1) * (prefills + steps),
                "flash_attention": 0, "mamba_scan": cfg.n_layers * prefills,
                "moe_gmm": 0, "moe_gmm_gated": 0, **bwd}
    moe_layers = 0 if cfg.moe is None else cfg.n_layers
    gated = moe_layers if cfg.mlp_act.endswith("gated") else 0
    return {"rmsnorm": (2 * cfg.n_layers + 1) * (prefills + steps),
            "flash_attention": cfg.n_layers * prefills, "mamba_scan": 0,
            "moe_gmm": 2 * moe_layers * (prefills + steps),
            "moe_gmm_gated": gated * (prefills + steps), **bwd}


def expected_train_launches(cfg, steps: int, micro: int = 1) -> dict:
    """Each kernel's launches over ``steps`` train steps of ``micro``
    microbatches under ``remat_policy="full"``: every forward launch of a
    layer (of a hybrid's group) twice (the forward and the recompute in
    the backward) and each op's backward once. Per microbatch and layer: an
    attention layer runs two RMSNorms and one flash attention, and an MoE
    layer two grouped matmuls (the gated one, wi and wg, and wo), each
    backward once (``moe_gmm_bwd`` counts both backward ops,
    ``moe_gmm_gated_bwd`` its own); a Mamba-1 layer one RMSNorm and one
    scan; a hybrid group the launches of a prefill (``expected_launches``).
    The final norm runs once a microbatch, and its backward once."""
    n = cfg.n_layers
    assert cfg.remat_policy == "full"
    out = {"rmsnorm": 1, "flash_attention": 0, "mamba_scan": 0, "moe_gmm": 0,
           "moe_gmm_gated": 0, "flash_attention_bwd": 0, "rmsnorm_bwd": 1,
           "mamba_scan_bwd": 0, "moe_gmm_bwd": 0, "moe_gmm_gated_bwd": 0}
    if cfg.family == "hybrid":
        fwd = expected_launches(cfg, 1, 0)
        norms = fwd["rmsnorm"] - 1
        out.update(rmsnorm=2 * norms + 1,
                   flash_attention=2 * fwd["flash_attention"],
                   mamba_scan=2 * fwd["mamba_scan"], rmsnorm_bwd=norms + 1,
                   flash_attention_bwd=fwd["flash_attention"],
                   mamba_scan_bwd=fwd["mamba_scan"])
    elif cfg.family == "ssm":
        out.update(rmsnorm=2 * n + 1, mamba_scan=2 * n, rmsnorm_bwd=n + 1,
                   mamba_scan_bwd=n)
    else:
        assert cfg.family == "dense" or cfg.moe is not None
        out.update(rmsnorm=4 * n + 1, flash_attention=2 * n,
                   flash_attention_bwd=n, rmsnorm_bwd=2 * n + 1)
        if cfg.moe is not None:
            gated = cfg.mlp_act.endswith("gated")
            out.update(moe_gmm=4 * n, moe_gmm_gated=2 * n if gated else 0,
                       moe_gmm_bwd=2 * n, moe_gmm_gated_bwd=n if gated else 0)
    return {k: v * steps * micro for k, v in out.items()}


def check_launches(what: str, cfg, counts: dict, prefills: int,
                   steps: int, captures: int, replays: int,
                   prefill_captures: int = 0, prefill_replays: int = 0
                   ) -> dict:
    """A path's launches, replays included. A decode step or a prefill
    replayed from a CUDA graph runs its kernels without their wrappers, so
    the counters see the warm-up and the capture of each graph (both
    counted as a step, or a prefill, here) and no replay: they must equal
    the formula for ``prefills - prefill_replays + prefill_captures``
    prefills and ``steps - replays + captures`` steps exactly, the capture
    and replay counts must be the ones given, and the launches that ran are
    the counted ones plus replays x the launches of one step, and prefill
    replays x those of one prefill, taken at capture (the formula's).
    Returns the launches by kernel, replays included."""
    got = {k: counts[k] for k in expected_launches(cfg, 0, 0)}
    want = expected_launches(cfg, prefills - prefill_replays
                             + prefill_captures, steps - replays + captures)
    print(f"[launches] {what}: counted {got}, expected {want}; decode "
          f"graphs captured {counts['graph_captures']} (expected "
          f"{captures}), replayed {counts['graph_replays']} (expected "
          f"{replays}); prefill graphs captured "
          f"{counts['prefill_captures']} (expected {prefill_captures}), "
          f"replayed {counts['prefill_replays']} (expected "
          f"{prefill_replays})", flush=True)
    if got != want or counts["graph_captures"] != captures \
            or counts["graph_replays"] != replays \
            or counts["prefill_captures"] != prefill_captures \
            or counts["prefill_replays"] != prefill_replays:
        fail(f"{what}: launches, captures or replays differ from expected")
    per_step, per_prefill = expected_launches(cfg, 0, 1), \
        expected_launches(cfg, 1, 0)
    return {k: got[k] + replays * per_step[k]
            + prefill_replays * per_prefill[k] for k in got}


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
    prefill (a captured prefill's input copy and replay) and each graph's
    warm-up and capture (decode steps' and prefills') made on a pool
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
        from repro_torch.serve import decode as SD
        self._saved = (SD.PrefillGraph.__call__, SD.StepGraph.__init__)
        SD.PrefillGraph.__call__ = self._timed("prefill",
                                               SD.PrefillGraph.__call__)
        SD.StepGraph.__init__ = self._timed("warm-up + capture",
                                            SD.StepGraph.__init__)
        return self

    def __exit__(self, *exc):
        from repro_torch.serve import decode as SD
        SD.PrefillGraph.__call__, SD.StepGraph.__init__ = self._saved

    def summary(self) -> str:
        def mean(v, i):
            return sum(x[i] for x in v) / len(v) * 1e3
        return "; ".join(
            f"{k} {mean(v, 0):.1f}/{mean(v, 1):.1f}/{mean(v, 2):.1f} "
            f"({len(v)})" for k, v in self.spent.items() if v)


def phase_serve(torch, arch: str, prompt_len: int, wide: bool,
                n_layers=None, requests: int = 32):
    """One main path: ``arch`` at every published width (depth cut to
    ``n_layers`` if given) in bf16 through ``serve()``, the prefill and
    each pool worker's decode step replayed from CUDA graphs, with every
    kernel's launch count checked exactly; then one batch alone (the probe
    and the pool's reserve against the observed peak: fails below 1.0)
    and, with ``wide``, the same requests on four pool workers sharing the
    card (fails where they serve fewer tokens/s than one)."""
    from repro_torch.launch.serve import serve
    cfg = full_cfg(arch, n_layers)
    kw = dict(full=True, param_dtype=torch.bfloat16, batch=4,
              prompt_len=prompt_len, gen_len=32, num_devices=1,
              n_layers=n_layers)
    fresh_card(torch)
    for c in counters().values():
        c.reset()
    with PhaseClock(torch) as one_clock:
        res = serve(arch, requests=requests, **kw)
    counts = read_counts()
    steps = res["batches"] * (kw["gen_len"] - 1)
    # each prefill graph's warm-up ran a prefill of its own; every batch's
    # prefill is a replay
    launches = check_launches(
        f"serve {arch}", cfg, counts, res["batches"] + res["prefill_graphs"],
        steps, captures=res["decode_graphs"],
        replays=steps - res["decode_graphs"],
        prefill_captures=res["prefill_graphs"],
        prefill_replays=res["batches"])
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
    kept, shared = res["kept_per_worker"], res["kept_per_card"]
    print(f"[serve] {arch} probe per batch (a replayed prefill's first "
          f"tokens; the weights as its arguments): hbm {vec.hbm_bytes} B "
          f"({vec.hbm_bytes / 2**30:.3f} GiB); kept by each pool worker "
          f"(its decoder: padded cache, buffers, one step; cuBLAS "
          f"workspace): {kept.hbm_bytes} B, {kept.flops:.4e} flops a "
          f"decode step; kept once by the card (the captured prefill's "
          f"pool, the prefill's peak; its stream's cuBLAS workspace): "
          f"{shared.hbm_bytes} B, {shared.flops:.4e} flops a prefill; "
          f"{res['prefill_graphs']} prefill and "
          f"{res['decode_graphs']} decode graph(s) captured for "
          f"{res['batches']} batches", flush=True)
    for err in res["errors"]:
        print(f"[serve] error: {err}", flush=True)
    if res["crashed"] or res["completed"] < res["batches"] \
            or res["batches"] != requests // 4:
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
    # pool worker that runs it and the card keep (``pool_reserve``)
    charged = alone["probe"].hbm_bytes + alone["kept_per_worker"].hbm_bytes \
        + alone["kept_per_card"].hbm_bytes
    ratio = charged / peak
    print(f"[serve] {arch} one batch alone: probe hbm "
          f"{alone['probe'].hbm_bytes} B + kept by its worker "
          f"{alone['kept_per_worker'].hbm_bytes} B + by the card "
          f"{alone['kept_per_card'].hbm_bytes} B = {charged} B vs observed "
          f"max_memory_allocated {peak} B ({left} B allocated before the "
          f"run; probe/observed {ratio:.4f}); batch wall "
          f"{alone['wall_s']:.2f} s, TTFT "
          f"{alone['p50_ttft_s'] * 1e3:.1f} ms, TPOT "
          f"{alone['p50_tpot_s'] * 1e3:.2f} ms", flush=True)
    if ratio < 1.0:
        fail(f"serve {arch}: the probe and the pool's reserve ({charged} "
             f"B) are below the observed peak ({peak} B)")
    if not wide:
        return launches

    # the same requests on four pool workers, each on its own stream,
    # taking turns on the card's captured prefill: 4 probed reservations
    # fit the card, so 4 batches share it at once
    del alone
    fresh_card(torch)
    free = torch.cuda.mem_get_info()[0]
    need = 4 * (vec.hbm_bytes + kept.hbm_bytes) + shared.hbm_bytes
    print(f"[serve] {arch} 4 workers, reckoned before serving: 4 x (probe "
          f"{vec.hbm_bytes} B + kept {kept.hbm_bytes} B) + the card's "
          f"{shared.hbm_bytes} B = {need} B against {free} B free",
          flush=True)
    with PhaseClock(torch) as four_clock:
        wide_res = serve(arch, requests=requests, workers=4, **kw)
    print(f"[serve] {arch} per-batch phases, host/stream/wall ms (count): "
          f"1 worker {one_clock.summary()}; 4 workers "
          f"{four_clock.summary()} (eager prefills on 4 workers, before "
          f"they were captured: 382.0-988.0 ms of host time, PERF.md)",
          flush=True)
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


def device_breakdown(torch, label: str, fn, top: int = 8):
    """Run ``fn()`` once under ``torch.profiler``, the ops' input shapes
    recorded, and print the device time by kernel: the busy total against
    the host wall time, the ``top`` kernels, and the port's own kernels
    below them. The profiler's own cost inflates the wall time, not the
    kernels' device times. Returns the rows, (device ms, launches, kernel
    name), and the profile."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
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
    return rows, prof


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


# bf16 training's tolerances, card vs CPU: the CPU parity test's
# (``tests/test_torch_train.py::BF16_TOL``, bf16 parameters, 2 microbatches,
# "dots", against the jitted JAX step), 10x where absolute (the loss), as
# the f32 ones are
BF16_TOL = {"loss": 1e-1, "grad_norm": 1e-3, "moments": 5e-2, "far": 1e-2}


def phase_train_reduced(torch, arch: str, seq: int = 128, steps: int = 3,
                        param_dtype=None, micro=None, remat=None,
                        batch: int = 2) -> None:
    """A reduced model trained ``steps`` steps on the card (hand kernels
    and their backward kernels) and on the CPU (plain versions) from one
    seed, on the same ``TokenPipeline`` batches. In f32 (the default) it is
    held to the CPU parity tests' tolerances (``tests/test_torch_train.py``)
    widened 10x for the card's summation order where they are absolute:
    losses within 1e-3, grad norms within 1e-3 relative, moments within
    1e-3 of their largest magnitude; parameters as there, relative to lr
    (every element within lr, all but 1e-3 of them within 1e-2 lr: an
    element whose gradient is a rounding error's size may move up to ~lr
    either way). With bf16 parameters (``param_dtype``, optionally
    ``micro`` microbatches and a ``remat`` policy) it is held to
    ``BF16_TOL``: every parameter within 2 x steps x lr + 2^-7 |w| of the
    CPU's, all but 1% within lr + 2^-8 |w| (one bf16 rounding apart)."""
    import dataclasses
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.pipeline import to_device as batch_to
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    cfg = get_arch(arch).reduced()
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    dtype = param_dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    start = init_params(cfg, torch.Generator().manual_seed(0), dtype)
    runs = {}
    for dev in (torch.device("cpu"), torch.device("cuda", 0)):
        params = tree_map(lambda t: t.clone().to(dev), start)
        state = adamw.init_state(opt, params)
        step = make_train_step(cfg, opt, num_microbatches=micro)
        pipe = TokenPipeline(cfg, ShapeConfig("t", seq, batch, "train"),
                             seed=0)
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
    g = torch.cat([x.float().flatten() for x in tree_leaves(gpu_p)])
    w = torch.cat([x.float().flatten() for x in tree_leaves(cpu_p)])
    errs = (g - w).abs()
    if bf16:
        far = int((errs > TRAIN_LR + 2 ** -8 * w.abs()).sum())
        over = int((errs > 2 * steps * TRAIN_LR + 2 ** -7 * w.abs()).sum())
    else:
        far = int((errs > 1e-2 * TRAIN_LR).sum())
        over = int((errs > TRAIN_LR).sum())
    d_mom = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for key in ("mu", "nu") for a, b in
                zip(tree_leaves(gpu_s[key]), tree_leaves(cpu_s[key])))
    what = (f"{cfg.name}, {steps} steps of {batch} x {seq}"
            + (f", {str(dtype).split('.')[-1]} parameters" if bf16 else "")
            + (f", {micro} microbatches" if micro else "")
            + (f", remat {cfg.remat_policy}" if remat else ""))
    print(f"[train-reduced] {what}, card vs CPU: losses "
          f"{[round(m[0], 6) for m in gpu_m]} / "
          f"{[round(m[0], 6) for m in cpu_m]} (max diff {d_loss:.3e}), grad "
          f"norm max rel diff {d_gn:.3e}, parameters max diff "
          f"{float(errs.max()) / TRAIN_LR:.3e} lr with {far} of "
          f"{errs.numel()} beyond "
          f"{'lr + 2^-8 |w|' if bf16 else '1e-2 lr'} and {over} beyond "
          f"{'2 x steps x lr + 2^-7 |w|' if bf16 else 'lr'}, moments max "
          f"rel diff {d_mom:.3e}", flush=True)
    tol = BF16_TOL if bf16 else {"loss": 1e-3, "grad_norm": 1e-3,
                                 "moments": 1e-3, "far": 1e-3}
    if d_loss > tol["loss"] or d_gn > tol["grad_norm"] or over \
            or far > tol["far"] * errs.numel() or d_mom > tol["moments"]:
        fail(f"reduced {arch} ({what}): training on the card disagrees "
             f"with the CPU")


def train_probe(torch, cfg, dev, micro=None):
    """The probe of one train step of ``cfg`` (f32, the trainer's batch,
    ``micro`` microbatches) on specs of the state: nothing allocated."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.probe import probe_fn
    from repro_torch.launch.specs import input_specs
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (abstract_train_state,
                                              make_train_step)
    opt = adamw.AdamWConfig(moment_dtype=cfg.optimizer_moment_dtype)
    params, state = abstract_train_state(cfg, opt, torch.float32, dev)
    shape = ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH, "train")
    return probe_fn(make_train_step(cfg, opt, num_microbatches=micro),
                    params, state, input_specs(cfg, shape, dev))


# the depth a train phase runs: gemma2-9b's fixed cut, or for the
# others the deepest whose one-step probe fits TRAIN_FIT of the memory free
# on the card, at most this many layers (zamba2-2.7b: all 54)
TRAIN_DEPTH = {"gemma2-9b": TRAIN_LAYERS}
TRAIN_MOST = {"falcon-mamba-7b": 16, "mixtral-8x7b": 8, "zamba2-2.7b": 54}
TRAIN_FIT = 0.9
# the train phases that run a step in their config's ``num_microbatches``
# (zamba2-2.7b: 4); the others run one
TRAIN_IN_MICROBATCHES = ("zamba2-2.7b",)
# the kernels whose device time a train step's profile sums, by arch
TRAIN_PROFILED = {
    "gemma2-9b": (("flash forward", ("flash_fwd_kernel",)),
                  ("RMSNorm backward", ("rmsnorm_bwd_kernel",
                                        "rmsnorm_dscale_kernel"))),
    "falcon-mamba-7b": (("scan forward", ("mamba_scan_kernel",)),
                        ("scan backward", ("mamba_scan_bwd_kernel",)),
                        ("RMSNorm backward", ("rmsnorm_bwd_kernel",
                                              "rmsnorm_dscale_kernel"))),
    "mixtral-8x7b": (("grouped matmul forward", ("gmm_f32_kernel",)),
                     ("grouped matmul backward", ("gmm_bwd_gate_kernel",
                                                  "gmm_bwd_dx_kernel",
                                                  "gmm_bwd_dw_kernel")),
                     ("flash forward", ("flash_fwd_kernel",)),
                     ("flash backward", ("flash_bwd_delta_kernel",
                                         "flash_bwd_dkdv_kernel",
                                         "flash_bwd_dq_kernel"))),
    "zamba2-2.7b": (("scan forward", ("mamba_scan_kernel",)),
                    ("scan backward", ("mamba_scan_bwd_kernel",)),
                    ("flash forward", ("flash_fwd_kernel",)),
                    ("flash backward", ("flash_bwd_delta_kernel",
                                        "flash_bwd_dkdv_kernel",
                                        "flash_bwd_dq_kernel")),
                    ("RMSNorm backward", ("rmsnorm_bwd_kernel",
                                          "rmsnorm_dscale_kernel")))}


def train_micro(arch: str):
    """The microbatches of ``arch``'s train phase: its config's
    ``num_microbatches`` where ``TRAIN_IN_MICROBATCHES`` names it, else
    None (one)."""
    if arch in TRAIN_IN_MICROBATCHES:
        return full_cfg(arch).num_microbatches
    return None


def train_depth(torch, arch: str, dev, free: int) -> int:
    """The depth of ``arch``'s train phase (``TRAIN_DEPTH``, or from the
    probe: at 1 and 2 units, extrapolated to the deepest that fits
    ``TRAIN_FIT`` of ``free``, at most ``TRAIN_MOST``, then checked); the
    probe at that depth and, where the published configuration is deeper,
    two units more printed against ``free``. A
    unit is a layer, or a hybrid's group (zamba2-2.7b: 6 layers), whose
    depth must be a multiple of it."""
    unit = full_cfg(arch).hybrid_shared_every or 1
    micro = train_micro(arch)
    probed = {}

    def probe(n):
        if n not in probed:
            t = time.perf_counter()
            vec = train_probe(torch, full_cfg(arch, n), dev, micro)
            probed[n] = vec, time.perf_counter() - t
        return probed[n]
    n = TRAIN_DEPTH.get(arch)
    if n is None:
        one, two = probe(unit)[0].hbm_bytes, probe(2 * unit)[0].hbm_bytes
        per_unit = two - one
        n = unit * int((TRAIN_FIT * free - (one - per_unit)) // per_unit)
        n = max(unit, min(n, TRAIN_MOST[arch]))
        while n > unit and probe(n)[0].hbm_bytes > TRAIN_FIT * free:
            n -= unit
        print(f"[train] depth of {arch}: one step probed at {unit} and "
              f"{2 * unit} layers, {one} and {two} B ({per_unit} B a "
              f"{'group' if unit > 1 else 'layer'}); the deepest that "
              f"fits {TRAIN_FIT:g} of {free} B free, at most "
              f"{TRAIN_MOST[arch]}: {n} layers", flush=True)
    # two units deeper, where the published configuration has them
    for m in (n, n + 2 * unit)[:1 if n == full_cfg(arch).n_layers else 2]:
        vec, took = probe(m)
        print(f"[train] depth: the probe of one {arch} step at {m} layers, "
              f"f32, batch {TRAIN_BATCH} x {TRAIN_SEQ}"
              + (f" in {micro} microbatches" if micro else "")
              + f": hbm {vec.hbm_bytes} "
              f"B ({vec.hbm_bytes / 1e9:.2f} GB) against {free} B free on "
              f"the card: "
              f"{'fits' if vec.hbm_bytes <= free else 'does not fit'} "
              f"(traced in {took:.1f} s)", flush=True)
        if m == n and vec.hbm_bytes > free:
            fail(f"train {arch}: {n} layers do not fit the card")
    return n


# each train phase's result (``launch.train.train``), for ``phase_dist``
TRAIN_RUNS = {}


def phase_train(torch, arch: str) -> dict:
    """A training main path: ``arch`` at every published width, depth cut
    by ``train_depth``, f32, batch 4 x 1024, ``remat_policy="full"``,
    through ``launch.train.train``: probe of one step -> MGB admission ->
    executor on the card, 5 steps (each of ``train_micro`` microbatches),
    each kernel's launches checked exactly, the probe's flops at least 2.5x
    the analytic forward. Then one step alone after ``fresh_card``: the
    probe's hbm must be at least the observed peak (fails below 1.0). Then
    a ``torch.profiler`` breakdown of one step, with the device ms a step
    of the kernels of ``TRAIN_PROFILED``, and for a hybrid the SSD's
    einsums' (``ssd_einsum_ms``)."""
    import dataclasses
    import math
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.pipeline import to_device as batch_to
    from repro_torch.launch.flops import forward_flops
    from repro_torch.launch.train import train
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    dev = torch.device("cuda", 0)
    fresh_card(torch)
    free = torch.cuda.mem_get_info(dev)[0]
    n_layers = train_depth(torch, arch, dev, free)
    cfg = full_cfg(arch, n_layers)
    if cfg.remat_policy != "full":
        cfg = dataclasses.replace(cfg, remat_policy="full")
    micro = train_micro(arch)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, reduced=False,
              n_layers=n_layers, lr=TRAIN_LR, log_every=1,
              num_microbatches=micro)
    for c in counters().values():
        c.reset()
    res = train(arch, steps=TRAIN_STEPS, **kw)
    counts = read_counts()
    want = expected_train_launches(cfg, TRAIN_STEPS, micro or 1)
    got = {k: counts[k] for k in want}
    print(f"[launches] train {arch}: counted {got}, expected {want}",
          flush=True)
    if got != want:
        fail(f"train {arch}: launches differ from expected")
    vec = res["probe"]
    host = res["step_ms"][1:]
    dms = res["device_ms"][1:]
    print(f"[train] {arch}, every published width, reduced: "
          f"{'; '.join(res['reduced']) or 'nothing'}; f32, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}"
          + (f" in {micro} microbatches" if micro else "")
          + f", remat full, one task through probe -> MGB -> "
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
    if res["steps"] != TRAIN_STEPS or not all(
            math.isfinite(x) for x in res["losses"] + res["grad_norms"]):
        fail(f"train {arch}: {res['steps']} steps, losses {res['losses']}")
    TRAIN_RUNS[arch] = res
    # the probe traced the backward and the recompute too (the autograd
    # engine runs a card's backward on its own thread)
    fwd = forward_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    print(f"[train] {arch} probe flops {vec.flops:.4e} = "
          f"{vec.flops / fwd:.2f}x the analytic forward ({fwd:.4e})",
          flush=True)
    if vec.flops < 2.5 * fwd:
        fail(f"train {arch}: the probe did not trace the backward")
    launches = dict(got)

    del res
    left = fresh_card(torch)
    alone = train(arch, steps=1, **kw)
    peak = torch.cuda.max_memory_allocated(dev)
    ratio = alone["probe"].hbm_bytes / peak
    print(f"[train] {arch} one step alone: probe hbm "
          f"{alone['probe'].hbm_bytes} B vs observed max_memory_allocated "
          f"{peak} B ({left} B allocated before; probe/observed "
          f"{ratio:.4f}); step {alone['step_ms'][0]:.1f} ms host, "
          f"{alone['device_ms'][0]:.1f} ms device", flush=True)
    if ratio < 1.0:
        fail(f"train {arch}: the probe ({alone['probe'].hbm_bytes} B) is "
             f"below the observed peak ({peak} B)")
    TRAIN_RUNS[arch]["alone"] = (alone["probe"].hbm_bytes, peak)
    del alone

    fresh_card(torch)
    opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10,
                            moment_dtype=cfg.optimizer_moment_dtype)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         torch.float32, dev)
    state = adamw.init_state(opt, params)
    step = make_train_step(cfg, opt, num_microbatches=micro)
    pipe = TokenPipeline(cfg, ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH,
                                          "train"), seed=0)
    batch = batch_to(pipe.batch_at(0), dev)
    step(params, state, batch)  # warm-up
    label = (f"{arch} train step, {n_layers} layers, f32, batch "
             f"{TRAIN_BATCH} x {TRAIN_SEQ}")
    rows, prof = device_breakdown(torch, label,
                                  lambda: step(params, state, batch), top=12)
    busy = sum(r[0] for r in rows)
    for what, names in TRAIN_PROFILED[arch]:
        mine = [(ms, n) for ms, n, name in rows
                if any(k in name for k in names)]
        ms = sum(m for m, _ in mine)
        print(f"[profile] {label}: {what} {ms:.3f} ms a step over "
              f"{sum(n for _, n in mine)} launches, {100 * ms / busy:.1f}% "
              f"of the step's device busy time", flush=True)
    if cfg.family == "hybrid":
        ms = ssd_einsum_ms(prof)
        print(f"[profile] {label}: the SSD's einsums (batched products, "
              f"forward, recompute and backward) {ms:.3f} ms a step, "
              f"{100 * ms / busy:.1f}% of the step's device busy time",
              flush=True)
    del params, state, batch
    return launches


DIST_ARCH = "gemma2-9b"
DIST_COMPRESSED_LAYERS, DIST_COMPRESSED_STEPS = 2, 4
# the checkpointed sharded run: falcon-mamba-7b at every width and 2 of 64
# layers (about 0.5e9 parameters, 6e9 B of f32 state a checkpoint), 4 steps
# uninterrupted against 2, a checkpoint, and 2 resumed
DIST_CKPT_ARCH, DIST_CKPT_LAYERS = "falcon-mamba-7b", 2
DIST_CKPT_STEPS, DIST_CKPT_AT = 4, 2
# the one-stage pipeline: gemma2-9b's first 2 layers in 4 microbatches
DIST_PIPE_LAYERS, DIST_PIPE_MICRO = 2, 4


def params_close(got, want, lr: float):
    """(max abs diff / lr, elements beyond 1e-2 lr, elements) of two
    parameter trees on the host, leaf by leaf."""
    from torch.utils._pytree import tree_leaves
    top, far, n = 0.0, 0, 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        e = (a.float() - b.float()).abs()
        top = max(top, float(e.max()))
        far += int((e > 1e-2 * lr).sum())
        n += e.numel()
    return top / lr, far, n


def dist_checkpoints(torch) -> dict:
    """Leg (a) of ``phase_dist``: checkpointed sharded training on the
    (1, 1) mesh (module docstring, 13). Returns the resumed runs' launches."""
    import math
    import shutil
    import tempfile
    from repro_torch.launch.train import train
    dev = torch.device("cuda", 0)
    arch, steps, at = DIST_CKPT_ARCH, DIST_CKPT_STEPS, DIST_CKPT_AT
    cfg = full_cfg(arch, DIST_CKPT_LAYERS)
    kw = dict(steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ, reduced=False,
              n_layers=DIST_CKPT_LAYERS, lr=TRAIN_LR, log_every=1,
              ckpt_dir=tempfile.mkdtemp(prefix="chip_smoke_ckpt_"),
              keep_state=True)
    launches = {}
    try:
        fresh_card(torch)
        full = train(arch, mesh_shape=(1, 1), ckpt_every=at,
                     scheduler=sharded_scheduler(torch, dev), **kw)
        del full["opt_state"]
        ck = full["checkpoint"]
        print(f"[dist] checkpoints of {arch}, every published width, "
              f"{DIST_CKPT_LAYERS} of 64 layers, at steps {at} and {steps} "
              f"on the (1, 1) mesh: {ck['nbytes']} B each, written by rank "
              f"0; the last: gather {ck['gather_s']:.3f} s, copy to the host "
              f"{ck['copy_s']:.3f} s (the gather included), write "
              f"{ck['write_s']:.3f} s; run {full['wall_s']:.1f} s (set-up, "
              f"steps, saves and the state's copy to the host)", flush=True)
        for name, mesh_shape in (("mesh", (1, 1)), ("unsharded", None)):
            # the run before committed step 4 beside step 2
            shutil.rmtree(os.path.join(kw["ckpt_dir"], f"step_{steps:08d}"))
            left = fresh_card(torch)
            for c in counters().values():
                c.reset()
            more = ({"scheduler": sharded_scheduler(torch, dev)}
                    if mesh_shape else {})
            res = train(arch, mesh_shape=mesh_shape, resume=True, **more,
                        **kw)
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated(dev)
            want = expected_train_launches(cfg, steps - at)
            got = {k: counts[k] for k in want}
            launches[name] = got
            d_loss = max(abs(a - b) for a, b in zip(
                res["losses"], full["losses"][at:]))
            d_gn = max(abs(a - b) / b for a, b in zip(
                res["grad_norms"], full["grad_norms"][at:]))
            top, far, n = params_close(res["params"], full["params"],
                                       TRAIN_LR)
            bits = (res["losses"] == full["losses"][at:]
                    and res["grad_norms"] == full["grad_norms"][at:]
                    and top == 0.0)
            ratio = res["probe"].hbm_bytes / peak
            print(f"[dist] {arch} resumed from step "
                  f"{res['start_step']} to {steps} "
                  + ("on the (1, 1) mesh" if mesh_shape else "unsharded")
                  + f": {res['status']}; run {res['wall_s']:.1f} s, "
                  f"restore "
                  f"{res['attempts'][0].get('restore_s', float('nan')):.3f} "
                  f"s; losses {[round(x, 6) for x in res['losses']]} "
                  f"(uninterrupted {[round(x, 6) for x in full['losses']]}, "
                  f"max diff {d_loss:.3e}), grad norm max rel diff "
                  f"{d_gn:.3e}, parameters max diff {top:.3e} lr with {far} "
                  f"of {n} beyond 1e-2 lr; bits "
                  f"{'match' if bits else 'differ'}; probe hbm "
                  f"{res['probe'].hbm_bytes} B vs observed "
                  f"max_memory_allocated {peak} B over the run ({left} B "
                  f"allocated before; probe/observed {ratio:.4f}); "
                  f"launches {got} (expected {want}); crashed 0", flush=True)
            if res["status"] != "done" or res["start_step"] != at \
                    or got != want or d_loss > 1e-3 or d_gn > 1e-3 \
                    or top > 1.0 or far > 1e-3 * n or ratio < 1.0 \
                    or not all(math.isfinite(x) for x in res["losses"]):
                fail(f"dist: the run resumed {name} disagrees with the "
                     f"uninterrupted one, or its launches or probe are off")
            del res
    finally:
        shutil.rmtree(kw["ckpt_dir"], ignore_errors=True)
    return {k: launches["mesh"][k] + launches["unsharded"][k]
            for k in launches["mesh"]}


def dist_pipeline(torch) -> dict:
    """Leg (b) of ``phase_dist``: gemma2-9b's first 2 layers as the one
    stage of ``dist.pipeline`` on a (1,) mesh, forward and backward
    (module docstring, 13). Returns its launches."""
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.dist.pipeline import (make_pipeline_forward,
                                           stack_stage_params)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.model import init_params
    dev = torch.device("cuda", 0)
    fresh_card(torch)
    cfg = full_cfg("gemma2-9b", DIST_PIPE_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         torch.float32, dev)
    layers = tree_map(lambda *ls: torch.stack(ls), *params["layers"])
    del params
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, generator=gen,
                    device=dev)
    positions = torch.arange(TRAIN_SEQ, device=dev)

    def attn_layers(sp, h):
        for j in range(len(sp["norm1"])):
            h, _ = M._attn_layer(tree_map(lambda t: t[j], sp), h, cfg, j,
                                 positions, "flash_kernel", None)
        return h

    def grads(fn, w):
        w = tree_map(lambda t: t.detach().requires_grad_(), w)
        h = x.clone().requires_grad_()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss = (fn(w, h) ** 2).mean()
        loss.backward()
        ev[1].record()
        torch.cuda.synchronize()
        return (tree_map(lambda t: t.grad, w), h.grad,
                ev[0].elapsed_time(ev[1]))
    grads(attn_layers, layers)  # warm-up, not counted
    pipe = make_pipeline_forward(attn_layers, make_mesh((1,), ("stage",)),
                                 n_micro=DIST_PIPE_MICRO)
    for c in counters().values():
        c.reset()
    g_w, g_x, pipe_ms = grads(pipe, stack_stage_params(layers, 1))
    counts = read_counts()
    r_w, r_x, plain_ms = grads(attn_layers, layers)
    n, m = DIST_PIPE_LAYERS, DIST_PIPE_MICRO
    # per microbatch: a forward, a recompute, a backward; per layer two
    # RMSNorms and one flash attention
    want = dict.fromkeys(expected_train_launches(cfg, 0), 0)
    want.update(rmsnorm=2 * m * 2 * n, flash_attention=2 * m * n,
                rmsnorm_bwd=m * 2 * n, flash_attention_bwd=m * n)
    got = {k: counts[k] for k in want}
    worst = max(float((a[0] - b).abs().max()) / float(b.abs().max())
                for a, b in zip(tree_leaves(g_w), tree_leaves(r_w)))
    d_x = float((g_x - r_x).abs().max()) / float(r_x.abs().max())
    print(f"[dist] pipeline of one stage on a (1,) mesh: gemma2-9b's first "
          f"{n} layers, every published width, f32, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} in {m} microbatches, loss mean(y^2): gradients "
          f"against autograd through the same layers unpipelined: stage "
          f"params max diff {worst:.3e}, x {d_x:.3e} of the largest; "
          f"device ms forward and backward {pipe_ms:.1f} (unpipelined "
          f"{plain_ms:.1f}); launches {got} (expected {want})", flush=True)
    if got != want or worst > 1e-3 or d_x > 1e-3 \
            or not bool(torch.isfinite(g_x).all()):
        fail("dist: the pipeline's gradients or launches are off")
    del layers, g_w, g_x, r_w, r_x, x
    return got


def sharded_scheduler(torch, dev):
    """A ``ShardedScheduler`` of one chip over the memory free on ``dev``,
    less the pool's reserve."""
    from repro_torch.core.scheduler import ShardedScheduler
    from repro_torch.launch.serve import pool_reserve
    free = torch.cuda.mem_get_info(dev)[0]
    return ShardedScheduler(pods=1, rows=1, cols=1,
                            hbm_per_chip=free - pool_reserve([dev], 1))


def phase_dist(torch) -> dict:
    """The sharded control plane and the distributed train step, world
    size 1 (module docstring, 13). Returns the launches of its paths: the
    sharded run, the checkpointed runs and the pipeline."""
    import math
    import shutil
    import tempfile
    import torch.distributed as dist
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.pipeline import to_device as batch_to
    from repro_torch.dist import compression as C
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import init_file_group, make_mesh
    from repro_torch.launch.train import train
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    init_file_group(os.path.join(store_dir, "store"), 0, 1)
    try:
        print(f"[dist] process group {dist.get_backend()} over a FileStore, "
              f"world {dist.get_world_size()}; mesh (1, 1) (data, model) "
              f"on {dev}", flush=True)
        ref = TRAIN_RUNS[DIST_ARCH]
        kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, reduced=False,
                  n_layers=TRAIN_LAYERS, lr=TRAIN_LR, log_every=1,
                  mesh_shape=(1, 1))

        fresh_card(torch)
        sched = sharded_scheduler(torch, dev)
        for c in counters().values():
            c.reset()
        t0 = time.perf_counter()
        res = train(DIST_ARCH, steps=TRAIN_STEPS, scheduler=sched, **kw)
        wall = time.perf_counter() - t0
        counts = read_counts()
        cfg = full_cfg(DIST_ARCH, TRAIN_LAYERS)
        want = expected_train_launches(cfg, TRAIN_STEPS)
        got = {k: counts[k] for k in want}
        print(f"[launches] dist {DIST_ARCH}: counted {got}, expected "
              f"{want}", flush=True)
        if got != want:
            fail("dist: launches differ from expected")
        d_loss = max(abs(a - b) for a, b in zip(res["losses"],
                                                ref["losses"]))
        d_gn = max(abs(a - b) / b for a, b in zip(res["grad_norms"],
                                                  ref["grad_norms"]))
        bits = (res["losses"] == ref["losses"]
                and res["grad_norms"] == ref["grad_norms"])
        host, dms = res["step_ms"][1:], res["device_ms"][1:]
        rhost, rdms = ref["step_ms"][1:], ref["device_ms"][1:]
        stats = sched.queue_stats()
        print(f"[dist] {DIST_ARCH}, every published width, "
              f"{TRAIN_LAYERS} of 42 layers, f32, batch {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}, remat full, {TRAIN_STEPS} steps on the (1, 1) "
              f"mesh through ShardedScheduler -> gang executor: "
              f"{res['status']}, probe chips {res['probe'].chips}, hbm "
              f"{res['probe'].hbm_bytes} B; losses "
              f"{[round(x, 6) for x in res['losses']]} (train phase "
              f"{[round(x, 6) for x in ref['losses']]}, max diff "
              f"{d_loss:.3e}), grad norm max rel diff {d_gn:.3e}, bits "
              f"{'match' if bits else 'differ'}; steps 2-{TRAIN_STEPS}: "
              f"host {sum(host) / len(host):.1f} ms, device "
              f"{sum(dms) / len(dms):.1f} ms a step (train phase "
              f"{sum(rhost) / len(rhost):.1f} ms, "
              f"{sum(rdms) / len(rdms):.1f} ms); run {wall:.1f} s; "
              f"stragglers {res['stragglers']}; scheduler steals "
              f"{stats['steals']}, depth {stats['depth']}", flush=True)
        if res["status"] != "done" or res["probe"].chips != 1 \
                or d_loss > 1e-3 or d_gn > 1e-3 or not all(
                    math.isfinite(x) for x in res["losses"]):
            fail(f"dist: the sharded run disagrees with the train phase "
                 f"(loss diff {d_loss}, grad norm rel diff {d_gn})")
        launches = dict(got)
        del res

        left = fresh_card(torch)
        alone = train(DIST_ARCH, steps=1,
                      scheduler=sharded_scheduler(torch, dev), **kw)
        peak = torch.cuda.max_memory_allocated(dev)
        ratio = alone["probe"].hbm_bytes / peak
        print(f"[dist] {DIST_ARCH} one sharded step alone: probe hbm "
              f"{alone['probe'].hbm_bytes} B vs observed "
              f"max_memory_allocated {peak} B ({left} B allocated before; "
              f"probe/observed {ratio:.4f}); crashed 0", flush=True)
        if ratio < 1.0:
            fail(f"dist: the probe ({alone['probe'].hbm_bytes} B) is below "
                 f"the observed peak ({peak} B)")
        del alone

        # int8 compression with error feedback in the step, on the mesh
        fresh_card(torch)
        mesh = make_mesh((1, 1), ("data", "model"))
        ccfg = full_cfg(DIST_ARCH, DIST_COMPRESSED_LAYERS)
        opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
        params = init_params(ccfg, torch.Generator(device=dev).manual_seed(0),
                             torch.float32, dev)
        specs = SH.param_specs(ccfg, params, mesh)
        params = SH.distribute(params, specs, mesh)
        state = adamw.init_state(opt, params)
        err, comp_ms = {}, []

        def compressor(grads):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            if "e" not in err:
                err["e"] = C.init_error_state(grads)
            q, err["e"] = C.apply_with_error_feedback(grads, err["e"])
            ev[1].record()
            comp_ms.append(ev)
            return q
        step = make_train_step(ccfg, opt, grad_compressor=compressor)
        pipe = TokenPipeline(ccfg, ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH,
                                               "train"), seed=0)
        batch = batch_to(pipe.batch_at(0), dev)
        batch = SH.distribute(batch, SH.batch_specs(ccfg, batch, mesh), mesh)
        losses, step_ms = [], []
        with SH.activation_mesh(mesh):
            for _ in range(DIST_COMPRESSED_STEPS):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                params, state, m = step(params, state, batch)
                ev[1].record()
                losses.append(float(m["loss"]))
                step_ms.append(ev)
        torch.cuda.synchronize()
        comp = [a.elapsed_time(b) for a, b in comp_ms]
        steps = [a.elapsed_time(b) for a, b in step_ms]
        n_el = sum(p.numel() for p in tree_leaves(params))
        print(f"[dist] {DIST_ARCH}, every published width, "
              f"{DIST_COMPRESSED_LAYERS} layers, f32, batch {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}, {DIST_COMPRESSED_STEPS} steps on one batch with "
              f"int8 compression (blocks of {C.BLOCK}) and error feedback "
              f"over {n_el} gradient values: losses "
              f"{[round(x, 4) for x in losses]}; device ms a step "
              f"{[round(x, 2) for x in steps]}, of which the compression "
              f"{[round(x, 2) for x in comp]}", flush=True)
        if not losses[-1] < losses[0]:
            fail(f"dist: the compressed steps do not lower the loss "
                 f"{losses}")
        del params, state, batch, err

        t_leg = time.perf_counter()
        paths = {"dist": launches,
                 "dist checkpoint": dist_checkpoints(torch)}
        t_ckpt = time.perf_counter() - t_leg
        t_leg = time.perf_counter()
        paths["dist pipeline"] = dist_pipeline(torch)
        print(f"[dist] the checkpointed runs took {t_ckpt:.1f} s, the "
              f"pipeline {time.perf_counter() - t_leg:.1f} s", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    print(f"[dist] phase wall time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


# the dry run's cells (``phase_dryrun``): (arch, shape, multi-pod)
DRYRUN_CELLS = [("gemma2-9b", "train_4k", False),
                ("dbrx-132b", "train_4k", False),
                ("zamba2-2.7b", "long_500k", False),
                ("gemma2-9b", "decode_32k", True)]
# the very step ``phase_train("gemma2-9b")`` measures, dry-run on a fake
# (1, 1) mesh: 12 layers, f32, batch 4 x 1024, remat full
DRYRUN_ONE_CARD = f"""
import dataclasses, json, torch
from repro_torch.configs import registry as R
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_mesh
DR.fake_group(1)
DR.make_production_mesh = lambda multi_pod=False, device=None: make_mesh(
    (1, 1), ("data", "model"), device)
DR.get_arch = lambda name: dataclasses.replace(R.get_arch(name),
                                               n_layers={TRAIN_LAYERS},
                                               remat_policy="full")
DR.get_shape = lambda name: ShapeConfig(name, {TRAIN_SEQ}, {TRAIN_BATCH},
                                        "train")
print(json.dumps(DR.lower_cell("gemma2-9b", "train_one_card",
                               param_dtype=torch.float32)))
"""
DRYRUN_TIMEOUT_S = 900
# mixtral-8x7b's rows through the experts of m simulated ``model`` ranks
DRYRUN_EP_RANKS = (2, 4)
DRYRUN_EP_ROWS = {"prefill": (4, 1024), "decode": (4, 1)}


def start_dryrun(torch) -> dict:
    """Start the dry run's processes (module docstring, 14): one
    ``python -m repro_torch.launch.dryrun`` a cell of ``DRYRUN_CELLS`` on
    the fake production mesh of ``"cuda"`` devices, and the dry run of
    ``phase_train``'s gemma2-9b step on a fake (1, 1) mesh, all at once.
    They run on the host and allocate no tensor on the card;
    ``phase_dryrun`` reads them. Returns {cell: (process, its output files, start)}."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="1")
    cmds = {cell: [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", cell[0], "--shape", cell[1]]
            + (["--multi-pod"] if cell[2] else []) for cell in DRYRUN_CELLS}
    cmds["one card"] = [sys.executable, "-c", DRYRUN_ONE_CARD]
    procs = {}
    for i, (cell, cmd) in enumerate(cmds.items()):
        files = [open(os.path.join(out_dir, f"{i}.{k}"), "w+")
                 for k in ("out", "err")]
        procs[cell] = (subprocess.Popen(cmd, cwd=HERE, env=env,
                                        stdout=files[0], stderr=files[1],
                                        text=True),
                       files, time.perf_counter())
    print(f"[dryrun] started {len(procs)} dry-run processes", flush=True)
    return procs


def dryrun_result(cell, proc, files, t0) -> dict:
    """A dry-run process's result; its failure fails the run."""
    try:
        proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                              - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"dryrun {cell}: past {DRYRUN_TIMEOUT_S} s")
    out, err = (f.seek(0) or f.read() for f in files)
    for f in files:
        f.close()
    if proc.returncode:
        fail(f"dryrun {cell}: exit {proc.returncode}: {err[-3000:]}")
    res = json.loads(out[out.index("{"):])
    res["wall_s"] = time.perf_counter() - t0
    return res


def phase_dryrun(torch, procs: dict) -> dict:
    """The production-mesh dry run and the H100 roofline (module
    docstring, 14); returns the launches of the expert-slice path."""
    import math
    from repro_torch.configs.registry import get_arch
    t_phase = time.perf_counter()
    gb = 1e9
    for cell in DRYRUN_CELLS:
        r = dryrun_result(cell, *procs[cell])
        rl, mem = r["roofline"], r["memory"]
        print(f"[dryrun] {cell[0]} {cell[1]} on {r['mesh']} ({r['chips']} "
              f"ranks, {r['device']} mesh, fake group): {r['status']}; "
              f"compute {rl['compute_s']:.4f} s, memory "
              f"{rl['memory_s']:.4f} s, collective {rl['collective_s']:.4f}"
              f" s, dominant {rl['dominant']}; peak a device "
              f"{mem['peak_per_device'] / gb:.3f} GB (arguments "
              f"{mem['argument_bytes'] / gb:.3f}), fits 80 GB "
              f"{mem['fits_80GB']}; collective bytes by kind "
              f"{ {k: round(v) for k, v in rl['coll_breakdown'].items()} }, "
              f"by axis { {a: round(sum(v.values())) for a, v in r['collectives_by_axis'].items()} }"
              f"; {r['traces']} traces, {r['microbatches']} microbatches, "
              f"counted in {r['lower_s']} s, "
              f"wall {r['wall_s']:.1f} s; CUDA initialised "
              f"{r['cuda_initialized']}", flush=True)
        if r["status"] != "ok" or r["device"] != "cuda":
            fail(f"dryrun {cell}: {r['status']} on {r['device']}")
        cfg = get_arch(cell[0])
        if cfg.moe is not None:
            one = 3 * cfg.d_model * cfg.d_ff * 2  # wi, wg, wo in bf16
            print(f"[dryrun] {cell[0]}: expert weights in collectives over "
                  f"model {r['expert_bytes_over_model']} B (one expert's "
                  f"weights {one} B; E {cfg.moe.num_experts} on a 16-wide "
                  f"model axis: expert parallel)", flush=True)
            if r["expert_bytes_over_model"] > one:
                fail(f"dryrun {cell}: expert weights gathered over model")
        if cell[1] == "long_500k":
            print(f"[dryrun] {cell[0]} {cell[1]}: bytes of collectives over "
                  f"a cache's sequence {r['cache_bytes_in_collectives']}; "
                  f"largest collective by axis {r['largest_collective']}",
                  flush=True)
            if r["cache_bytes_in_collectives"]:
                fail(f"dryrun {cell}: a cache-sized tensor in a collective")
    # the roofline of phase_train's gemma2-9b step against the card
    r = dryrun_result("one card", *procs["one card"])
    rl, mem = r["roofline"], r["memory"]
    run = TRAIN_RUNS.get("gemma2-9b")
    if run is not None:
        dms = run["device_ms"][1:]
        step_ms = sum(dms) / len(dms)
        bound_ms = 1e3 * max(rl["compute_s"], rl["memory_s"])
        probe, peak = run["alone"]
        print(f"[dryrun] gemma2-9b, {TRAIN_LAYERS} layers, f32, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}, remat full, on a fake (1, 1) "
              f"mesh: peak a device {mem['peak_per_device']:.0f} B against "
              f"the train phase's probe {probe} B and measured "
              f"max_memory_allocated {peak} B (dry run / measured "
              f"{mem['peak_per_device'] / peak:.4f}); compute "
              f"{1e3 * rl['compute_s']:.1f} ms (f32 peak), memory "
              f"{1e3 * rl['memory_s']:.1f} ms, against the measured "
              f"{step_ms:.1f} ms device a step: roofline fraction "
              f"{bound_ms / step_ms:.4f}; traced flops "
              f"{rl['hlo_flops_per_device']:.4e}, analytic "
              f"{rl['analytic_flops_global']:.4e}; wall {r['wall_s']:.1f} s",
              flush=True)
    # the expert slices with the hand kernel: mixtral-8x7b's experts split
    # over m simulated ``model`` ranks, each rank's share summed
    from repro_torch.models.model import init_params
    from repro_torch.models.moe import expert_slice_apply, moe_apply
    fresh_card(torch)
    dev = torch.device("cuda", 0)
    cfg = full_cfg("mixtral-8x7b", 1)
    e = cfg.moe.num_experts
    checks, counted = [], dict.fromkeys(
        ("moe_gmm", "moe_gmm_gated"), 0)
    for dtype in (torch.bfloat16, torch.float32):
        p = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        dtype, dev)["layers"][0]["moe"]
        gen = torch.Generator(device=dev).manual_seed(1)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        for what, (b, s) in DRYRUN_EP_ROWS.items():
            x = torch.randn(b, s, cfg.d_model, generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
            whole, _ = moe_apply(p, x, cfg.moe, cfg.mlp_act)
            for m in DRYRUN_EP_RANKS:
                for c in counters().values():
                    c.reset()
                share = e // m
                total = torch.zeros(x.shape, dtype=torch.float32, device=dev)
                for r_ in range(m):
                    lo = r_ * share
                    local = {"router": p["router"],
                             **{k: p[k][lo:lo + share]
                                for k in ("wi", "wg", "wo")}}
                    total += expert_slice_apply(local, x, cfg.moe,
                                                cfg.mlp_act, lo, lo + share)
                torch.cuda.synchronize()
                counts = read_counts()
                got = {k: counts[k] for k in counted}
                if got != {"moe_gmm": 2 * m, "moe_gmm_gated": m}:
                    fail(f"dryrun expert slices: launches {got} for {m} "
                         f"ranks")
                for k in counted:
                    counted[k] += got[k]
                err = (total.to(dtype).float() - whole.float()).abs()
                bad = (err > tol + tol * whole.float().abs()).sum().item()
                checks.append((str(dtype).split(".")[-1], what, m,
                               float(err.max()), bad))
                if bad or not math.isfinite(float(err.max())):
                    fail(f"dryrun expert slices: {m} ranks, {what}, {dtype}:"
                         f" {bad} elements past {tol}")
        del p
    print(f"[dryrun] mixtral-8x7b's experts ({e}) split over 2 and 4 "
          f"simulated model ranks (expert_slice_apply, the hand grouped "
          f"matmul on each rank's experts), the shares summed against the "
          f"whole layer: (dtype, rows, ranks, max abs err, elements past "
          f"tolerance) {checks}; launches {counted}", flush=True)
    print(f"[dryrun] phase wall time {time.perf_counter() - t_phase:.1f} s "
          f"(the dry-run processes ran beside the earlier phases)",
          flush=True)
    return {k: counted.get(k, 0) for k in
            ("rmsnorm", "flash_attention", "mamba_scan", "moe_gmm",
             "moe_gmm_gated") + BWD_KERNELS}


def ssd_einsum_ms(prof) -> float:
    """Device ms of the batched matrix products of a profile recorded with
    the ops' shapes: in a hybrid's train step the ``aten::bmm`` calls whose
    batch exceeds one are the Mamba-2 SSD's einsums (its intra-chunk scores
    and outputs, the chunk states and the inter-chunk outputs) and their
    gradients; a projection's einsum reaches ``aten::bmm`` with a batch of
    one, if at all."""
    return sum(e.device_time_total for e in
               prof.key_averages(group_by_input_shape=True)
               if e.key == "aten::bmm" and e.input_shapes
               and e.input_shapes[0] and e.input_shapes[0][0] > 1) / 1e3


# the preemption path: a falcon-mamba-7b training task (f32, batch 4 x
# 1024, remat full, priority 0, no deadline) evicted after PREEMPT_AT of
# PREEMPT_STEPS steps by one urgent static mixtral-8x7b batch (24 layers,
# bf16, 4 x 1024 prompts, 32 tokens, priority 5, PREEMPT_DEADLINE_S), on
# PREEMPT_WORKERS pool workers so the eviction fence is crossed between two
# pool threads; the training task's depth is the least whose probe and the
# batch's exceed the scheduler's memory while each fits alone
PREEMPT_STEPS, PREEMPT_AT, PREEMPT_WORKERS = 6, 2, 2
PREEMPT_DEADLINE_S = 60.0


def _measured(torch, inner, log: list):
    """``inner`` as a runner that records, per attempt, the bytes allocated
    on the card at its BEGIN, its peak (the peak statistic reset at BEGIN:
    on this path nothing else runs on the card meanwhile, the fence and the
    memory see to it) and the monotonic times of its BEGIN and exit (its
    stream synchronised)."""
    def runner(device):
        rec = {"t_begin": time.monotonic(),
               "alloc_begin": torch.cuda.memory_allocated(device)}
        torch.cuda.reset_peak_memory_stats(device)
        log.append(rec)
        try:
            inner(device)
        finally:
            torch.cuda.current_stream(device).synchronize()
            rec["peak"] = torch.cuda.max_memory_allocated(device)
            rec["t_exit"] = time.monotonic()
    return runner


def phase_preempt(torch, gpu: str) -> dict:
    """Preemption on one card through probe -> ``PreemptiveAlg3Scheduler``
    -> executor (``PREEMPT_WORKERS`` pool workers): a full-width
    falcon-mamba-7b training task (``launch.train.train_job``) is evicted
    by an urgent mixtral-8x7b batch (``launch.serve.batch_job``, which
    makes its weights in the task) that does not fit beside it, submitted
    from the training task's step hook once step ``PREEMPT_AT`` has
    finished. The training task saves that step and returns; the batch
    begins only once it has (the executor's fence), is served, and the
    training task restores that step from its checkpoint's host copy and
    resumes. Fails unless: one eviction,
    of the training task, the batch admitted after it; nothing crashed and
    both DONE; the batch's tokens equal the same batch served alone; the
    resumed attempt starts at ``PREEMPT_AT`` and its losses, grad norms,
    parameters and moments equal an uninterrupted run's within the
    ``[train-reduced]`` f32 tolerances (the largest differences printed;
    bits expected); the card holds at most the pool's reserve at the
    batch's BEGIN; probe/observed >= 1.0 for the batch and the resumed
    attempt; the kernels' launches exactly the formula's, the resumed steps
    included. Prints the eviction latency, the checkpoint's bytes and
    times, and the batch's TTFT against waiting out the training task
    (reckoned from this run's step times, not run)."""
    import math
    import shutil
    import numpy as np
    from torch.utils._pytree import tree_leaves
    from repro_torch.core.cluster import Cluster, JobStatus
    from repro_torch.core.scheduler import (MGBAlg3Scheduler,
                                            PreemptiveAlg3Scheduler)
    from repro_torch.launch.serve import batch_job, pool_reserve
    from repro_torch.launch.train import train, train_job
    from repro_torch.obs.replay import admission_order, eviction_order
    dev = torch.device("cuda", 0)
    fresh_card(torch)
    free = torch.cuda.mem_get_info(dev)[0]
    reserve = pool_reserve([dev], PREEMPT_WORKERS)
    hbm = free - reserve
    ucfg = full_cfg("mixtral-8x7b", MIXTRAL_LAYERS)
    gen_len = 32
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, ucfg.vocab, (4, 1024), dtype=np.int64))

    def urgent_job(name):
        return batch_job(ucfg, prompts, gen_len=gen_len, seed=0,
                         param_dtype=torch.bfloat16, device=dev, name=name)

    t = time.perf_counter()
    urgent = urgent_job("urgent")
    u_vec = urgent.vec
    print(f"[preempt] {gpu}: the urgent batch, mixtral-8x7b at every "
          f"published width, {MIXTRAL_LAYERS} of 32 layers, bf16, 4 x 1024 "
          f"prompts, {gen_len} tokens, priority 5, deadline "
          f"{PREEMPT_DEADLINE_S:g} s, its weights made in the task: probe "
          f"hbm {u_vec.hbm_bytes} B (traced in {time.perf_counter() - t:.1f}"
          f" s); the scheduler's memory {hbm} B ({free} B free less the "
          f"pool's reserve {reserve} B for {PREEMPT_WORKERS} workers)",
          flush=True)
    if u_vec.hbm_bytes > hbm:
        fail(f"preempt: the urgent batch ({u_vec.hbm_bytes} B) does not fit "
             f"the card alone")
    ckpt_dir = os.path.join(HERE, "build", "preempt_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    box = {}

    def on_step(k):
        if k == PREEMPT_AT and "urgent" not in box:
            box["t_submit"] = time.monotonic()
            box["urgent"] = cluster.submit(urgent.ej, priority=5,
                                           deadline_s=PREEMPT_DEADLINE_S)

    kw = dict(steps=PREEMPT_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              reduced=False, lr=TRAIN_LR, log_every=1)
    n = 0
    while True:
        n += 1
        t = time.perf_counter()
        run = train_job("falcon-mamba-7b", n_layers=n, device=dev,
                        ckpt_dir=ckpt_dir, ckpt_every=10 ** 9,
                        on_step=on_step, keep_state=True, **kw)
        t_vec = run.vec
        print(f"[preempt] the training task at {n} layer(s), f32, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}, remat full: probe hbm "
              f"{t_vec.hbm_bytes} B (traced in "
              f"{time.perf_counter() - t:.1f} s); with the urgent batch "
              f"{t_vec.hbm_bytes + u_vec.hbm_bytes} B against {hbm} B",
              flush=True)
        if t_vec.hbm_bytes > hbm:
            fail("preempt: the training task does not fit the card alone")
        if t_vec.hbm_bytes + u_vec.hbm_bytes > hbm:
            break
    vcfg = run.cfg
    attempts, u_log = [], []
    run.ej.runners[0] = _measured(torch, run.ej.runners[0], attempts)
    urgent.ej.runners[0] = _measured(torch, urgent.ej.runners[0], u_log)
    sched = PreemptiveAlg3Scheduler(1, hbm_per_device=hbm)
    cluster = Cluster(sched, workers=PREEMPT_WORKERS, devices=[dev],
                      trace=True)
    for c in counters().values():
        c.reset()
    t0 = time.time()
    h_train = cluster.submit(run.ej, priority=0)
    cluster.drain()
    counts = read_counts()
    stats = cluster.stats()
    cluster.shutdown()
    run.close()
    res = run.result(h_train.status, h_train.job.error, time.time() - t0)
    h_urgent = box.get("urgent")
    events = cluster.trace.events()
    evicted, admitted = eviction_order(events), admission_order(events)
    print(f"[preempt] {gpu}: {stats['completed']} done, {stats['crashed']} "
          f"crashed, {stats['preemptions']} preemption(s) (evicted "
          f"{evicted}), {stats['migrations']} migration(s); admission order "
          f"{admitted}; training {res['status']}, urgent "
          f"{h_urgent.status.value if h_urgent else 'never submitted'}",
          flush=True)
    if h_urgent is None or h_train.status is not JobStatus.DONE \
            or h_urgent.status is not JobStatus.DONE or stats["crashed"]:
        fail(f"preempt: training {res['status']} ({res['error']}), urgent "
             f"{h_urgent and h_urgent.status} ({h_urgent and h_urgent.job.error})")
    if sched.preemptions != 1 or evicted != ["train"] \
            or admitted != ["train", "urgent", "train"]:
        fail(f"preempt: expected one eviction of the training task and the "
             f"urgent batch admitted after it: {evicted}, {admitted}")

    # launches: the 6 train steps over both attempts, and the batch's one
    # eager prefill and its decode (warm-up and capture counted, the rest
    # replayed)
    steps = gen_len - 1
    want = expected_train_launches(vcfg, PREEMPT_STEPS)
    serve_want = expected_launches(ucfg, 1, 2)
    want = {k: want[k] + serve_want[k] for k in want}
    got = {k: counts[k] for k in want}
    graphs = (counts["graph_captures"], counts["graph_replays"],
              counts["prefill_captures"], counts["prefill_replays"])
    print(f"[launches] preempt: counted {got}, expected {want}; decode "
          f"graphs captured/replayed, prefill graphs captured/replayed "
          f"{graphs}, expected (1, {steps - 1}, 0, 0)", flush=True)
    if got != want or graphs != (1, steps - 1, 0, 0):
        fail("preempt: launches differ from expected")
    per_step = expected_launches(ucfg, 0, 1)
    launches = {k: got[k] + (steps - 1) * per_step[k] for k in got}

    # the fence, the eviction and the checkpoint
    a1, a2 = res["attempts"]
    m1, m2 = attempts
    u = u_log[-1]
    latency = m1["t_exit"] - res["notices"][0]
    ck = res["checkpoint"]
    print(f"[preempt] {gpu}: eviction notice -> the training task's exit "
          f"(its stream synchronised) {latency * 1e3:.1f} ms; the urgent "
          f"batch's BEGIN {(u['t_begin'] - m1['t_exit']) * 1e3:.1f} ms after "
          f"that exit (the executor returns its blocks) and {(u['t_begin'] - res['notices'][0]) * 1e3:.1f}"
          f" ms after the notice; allocated on the card at its BEGIN "
          f"{u['alloc_begin']} B (the training task's probe "
          f"{t_vec.hbm_bytes} B; the pool's reserve {reserve} B)",
          flush=True)
    print(f"[preempt] {gpu}: checkpoint at step {a1.get('evicted_at')}: "
          f"{ck['nbytes']} B, copy to the host {a1.get('copy_s', 0) * 1e3:.1f}"
          f" ms at the eviction; the resumed attempt restored it from the "
          f"host copy in {a2.get('restore_s', 0) * 1e3:.1f} ms, then started"
          f" its write to the disk ({ck['write_s'] * 1e3:.1f} ms beside its "
          f"steps); resumed at step {a2['start']}", flush=True)
    if m1["t_exit"] > u["t_begin"] or u["alloc_begin"] > reserve:
        fail("preempt: the urgent batch began before the evicted attempt "
             "had left the card")
    if a1.get("evicted_at") != PREEMPT_AT or a2["start"] != PREEMPT_AT:
        fail(f"preempt: evicted at {a1.get('evicted_at')}, resumed at "
             f"{a2['start']}, expected {PREEMPT_AT}")
    for what, vec, rec in (("urgent batch", u_vec, u),
                           ("resumed training attempt", t_vec, m2)):
        used = rec["peak"] - rec["alloc_begin"]
        print(f"[preempt] {what}: probe hbm {vec.hbm_bytes} B vs observed "
              f"peak {rec['peak']} B less {rec['alloc_begin']} B held at its"
              f" BEGIN = {used} B (probe/observed "
              f"{vec.hbm_bytes / used:.4f})", flush=True)
        if vec.hbm_bytes < used:
            fail(f"preempt: the {what}'s probe is below its observed peak")

    res_u = urgent.result
    ttft = res_u["t_first"][-1] - box["t_submit"]
    # the steps that are neither an attempt's first (its allocations; on
    # the resume also the checkpoint's write beside it)
    steady = [ms for i, ms in enumerate(res["step_ms"])
              if i not in (0, a2["start"])]
    step_s = sum(steady) / max(len(steady), 1) / 1e3
    del run, urgent

    # the same batch alone, and the same training uninterrupted
    fresh_card(torch)
    alone = urgent_job("alone")
    c = Cluster(MGBAlg3Scheduler(1, hbm_per_device=hbm), workers=1,
                devices=[dev])
    h = c.submit(alone.ej, priority=5)
    c.drain()
    c.shutdown()
    if h.status is not JobStatus.DONE or alone.result["tokens"] is None:
        fail(f"preempt: the batch alone ended {h.status}: {h.job.error}")
    same = np.array_equal(res_u["tokens"], alone.result["tokens"])
    own = alone.result["t_first"][0] - alone.result["t_begin"][0]
    print(f"[preempt] the urgent batch's tokens {res_u['tokens'].shape} "
          f"equal the batch served alone: {same}; alone, BEGIN -> first "
          f"tokens {own * 1e3:.1f} ms (with the eviction "
          f"{(res_u['t_first'][-1] - res_u['t_begin'][-1]) * 1e3:.1f} ms)",
          flush=True)
    # TTFT with the eviction, against waiting out the training task: its
    # remaining steps at this run's mean steady step, then the batch's own
    # BEGIN -> first tokens on a card it has alone
    wait = (PREEMPT_STEPS - PREEMPT_AT) * step_s + own
    print(f"[preempt] {gpu}: the urgent batch's TTFT {ttft * 1e3:.1f} ms "
          f"with the eviction; waiting out the training task instead "
          f"{wait * 1e3:.1f} ms (its {PREEMPT_STEPS - PREEMPT_AT} remaining "
          f"steps at {step_s * 1e3:.1f} ms, the mean of this run's steps but "
          f"each attempt's first, then the batch's BEGIN -> first tokens "
          f"alone); training steps {[round(x, 1) for x in res['step_ms']]} "
          f"ms, the resumed attempt's first with the write beside it",
          flush=True)
    if not same:
        fail("preempt: the urgent batch's tokens differ from the batch "
             "served alone")
    del alone
    fresh_card(torch)
    want = train("falcon-mamba-7b", n_layers=vcfg.n_layers, keep_state=True,
                 **kw)
    d_loss = max(abs(a - b) for a, b in zip(res["losses"], want["losses"]))
    d_gn = max(abs(a - b) / b for a, b in zip(res["grad_norms"],
                                              want["grad_norms"]))
    pg = tree_leaves(res["params"])
    pw = tree_leaves(want["params"])
    d_par = max(float((a - b).abs().max()) for a, b in zip(pg, pw))
    far = sum(int(((a - b).abs() > 1e-2 * TRAIN_LR).sum())
              for a, b in zip(pg, pw))
    n_par = sum(a.numel() for a in pg)
    d_mom = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for key in ("mu", "nu") for a, b in
                zip(tree_leaves(res["opt_state"][key]),
                    tree_leaves(want["opt_state"][key])))
    bits = all((torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b) for a, b in zip(
        tree_leaves((res["params"], res["opt_state"])),
        tree_leaves((want["params"], want["opt_state"])))) \
        and res["losses"] == want["losses"] \
        and res["grad_norms"] == want["grad_norms"]
    print(f"[preempt] resumed training vs an uninterrupted "
          f"{PREEMPT_STEPS}-step run from the same seed: losses "
          f"{[round(x, 6) for x in res['losses']]} / "
          f"{[round(x, 6) for x in want['losses']]}, largest differences: "
          f"loss {d_loss:.3e}, grad norm {d_gn:.3e} relative, parameters "
          f"{d_par:.3e} ({d_par / TRAIN_LR:.3e} lr; {far} of {n_par} beyond "
          f"1e-2 lr), moments {d_mom:.3e} of their largest; the same bits: "
          f"{bits}", flush=True)
    if not all(math.isfinite(x) for x in res["losses"]) \
            or len(res["losses"]) != PREEMPT_STEPS or d_loss > 1e-3 \
            or d_gn > 1e-3 or d_par > TRAIN_LR or far > 1e-3 * n_par \
            or d_mom > 1e-3:
        fail("preempt: the resumed training differs from the uninterrupted "
             "run")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del res, want
    return launches


# the observability phase: (arch, layers, prompt length) of each resource
# class, one batch shape a class, and the order its batches are submitted
# in: each inner list is submitted together and drained before the next
# (the first batch of each class alone on the card, so that its high-water
# is measured; a class's fourth completion comes before its later batches)
OBS_CLASSES = {"gemma2-9b": (12, 1000), "falcon-mamba-7b": (16, 1024)}
OBS_WAVES = [["gemma2-9b"], ["falcon-mamba-7b"],
             ["gemma2-9b", "falcon-mamba-7b"],
             ["gemma2-9b", "falcon-mamba-7b"],
             ["gemma2-9b"], ["falcon-mamba-7b"],
             ["gemma2-9b", "falcon-mamba-7b"]]
OBS_WORKERS = 2


def phase_obs(torch, gpu: str) -> dict:
    """The observability plane on one card: ``Cluster(MGBAlg3Scheduler,
    workers=OBS_WORKERS, trace=True, calibrate=True, flight_path=...)``
    serves static batches that make their weights in the task
    (``launch.serve.batch_job``, bf16, 4 prompts, 32 tokens) of two
    resource classes at every published width and a cut depth
    (``OBS_CLASSES``: gemma2-9b's flash attention and RMSNorm,
    falcon-mamba-7b's scan and RMSNorm), in ``OBS_WAVES``. The executor
    measures the high-water and duration of each attempt that had the card
    to itself (ROADMAP C16); the calibration store learns each class's
    observed/predicted runtime and its high-water and corrects the
    vectors of later batches. Fails unless nothing crashed, every batch's
    tokens are in range, the exported trace validates, at least one
    high-water was measured and none is above its reservation (the
    store's violations, the profiles' memory violations), a corrected
    vector was applied, the flight recorder's file loads, and the
    launches are exactly the formula's. Prints each task's profile, the
    store's accuracy per class (the probe's runtime ratio, the measured
    high-water against the probe and against the probe less
    ``CUDA_UNSEEN_BYTES``, raw against corrected error), the device's
    occupancy, the SLO monitor's drift stream, a ``launch.top`` frame, and
    the card run's submissions replayed on the sim backend under MGB
    Algorithm 3 and SA (``obs.whatif``). Returns the launches by kernel."""
    import numpy as np
    from repro_torch.core.cluster import Cluster, JobStatus
    from repro_torch.core.probe import CUDA_UNSEEN_BYTES
    from repro_torch.core.scheduler import MGBAlg3Scheduler, SAScheduler
    from repro_torch.launch import top
    from repro_torch.launch.serve import batch_job, pool_reserve
    from repro_torch.obs import whatif
    from repro_torch.obs.export import trace_summary, validate_chrome_trace
    from repro_torch.obs.profile import device_occupancy, format_profile
    from repro_torch.obs.replay import load_flight
    from repro_torch.obs.slo import SLOMonitor
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    fresh_card(torch)
    hbm = torch.cuda.mem_get_info(dev)[0] - pool_reserve([dev], OBS_WORKERS)
    gen_len = 32
    cfgs = {arch: full_cfg(arch, layers)
            for arch, (layers, _) in OBS_CLASSES.items()}
    rng = np.random.default_rng(0)
    made = {arch: 0 for arch in cfgs}

    def make(arch):
        cfg, prompt_len = cfgs[arch], OBS_CLASSES[arch][1]
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, prompt_len),
                                               dtype=np.int64))
        made[arch] += 1
        return batch_job(cfg, tokens, gen_len=gen_len, seed=0,
                         param_dtype=torch.bfloat16, device=dev,
                         name=f"{arch}#{made[arch]}")

    flight = os.path.join(HERE, "build", "obs_flight.json")
    os.makedirs(os.path.dirname(flight), exist_ok=True)
    cluster = Cluster(MGBAlg3Scheduler(1, hbm_per_device=hbm),
                      workers=OBS_WORKERS, devices=[dev], trace=True,
                      calibrate=True, flight_path=flight)
    store = cluster.calibration
    # subscribed before the first completion: it reads every observation,
    # and a subscriber makes the store fold each completion at once, so an
    # admission after it sees the class's statistics
    slo = SLOMonitor.for_calibration(store, window=32)
    for c in counters().values():
        c.reset()
    jobs, handles, frame = [], [], None
    t0 = time.time()
    for i, wave in enumerate(OBS_WAVES):
        for arch in wave:
            bj = make(arch)
            jobs.append((arch, bj))
            handles.append(cluster.submit(bj.ej))
        if i == len(OBS_WAVES) - 1:
            frame = top.render(cluster.sched, slo=slo,
                               stats=cluster.stats(),
                               title=f"repro-top on {gpu}, the last wave")
        cluster.drain()
    wall = time.time() - t0
    counts = read_counts()
    stats = cluster.stats()
    cluster.shutdown()
    errors = [h.job.error for h in handles if h.job.error]
    print(f"[obs] {gpu}: {len(handles)} batches in {len(OBS_WAVES)} waves, "
          f"{stats['completed']} done, {stats['crashed']} crashed in "
          f"{wall:.1f} s; the scheduler's memory {hbm} B, {OBS_WORKERS} "
          f"workers", flush=True)
    if stats["crashed"] or errors or any(
            h.status is not JobStatus.DONE for h in handles):
        fail(f"obs: a batch did not complete: {errors}")
    for arch, cfg in cfgs.items():
        check_tokens(f"obs {arch}", [bj.result["tokens"] for a, bj in jobs
                                     if a == arch], (4, gen_len), cfg.vocab)

    # launches: each batch's eager prefill and its decode (warm-up and
    # capture counted, the rest replayed)
    steps = gen_len - 1
    n = {arch: sum(a == arch for a, _ in jobs) for arch in cfgs}
    want = {k: sum(n[a] * expected_launches(cfg, 1, 2)[k]
                   for a, cfg in cfgs.items())
            for k in expected_launches(cfgs["gemma2-9b"], 0, 0)}
    got = {k: counts[k] for k in want}
    graphs = (counts["graph_captures"], counts["graph_replays"],
              counts["prefill_captures"], counts["prefill_replays"])
    print(f"[launches] obs: counted {got}, expected {want}; decode graphs "
          f"captured/replayed, prefill graphs captured/replayed {graphs}, "
          f"expected ({len(jobs)}, {len(jobs) * (steps - 1)}, 0, 0)",
          flush=True)
    if got != want or graphs != (len(jobs), len(jobs) * (steps - 1), 0, 0):
        fail("obs: launches differ from expected")
    launches = {k: got[k] + sum(n[a] * (steps - 1)
                                * expected_launches(cfg, 0, 1)[k]
                                for a, cfg in cfgs.items()) for k in got}

    # per task: predicted -> observed, parked/dispatch, reserved vs
    # high-water (measured where the attempt had the card to itself)
    measured = []
    for (arch, bj), h in zip(jobs, handles):
        (p,) = h.profile().values()
        task = h.job.tasks[0]
        tv = task.true_vec
        if tv is not None:
            measured.append((arch, task, tv))
        print(f"[obs] {format_profile(p)}; "
              + (f"measured alone: {tv.hbm_bytes} B in {tv.est_seconds:.3f}"
                 f" s, reserved {task.resources.hbm_bytes} B"
                 if tv is not None else "shared the card: not measured"),
              flush=True)
    for arch in cfgs:
        first = next(h for (a, _), h in zip(jobs, handles) if a == arch)
        if first.job.tasks[0].true_vec is None:
            fail(f"obs: the first {arch} batch was not measured alone")
    rep = store.accuracy_report()
    prof = cluster.profile()
    print(f"[obs] calibration: {rep['classes']} classes, "
          f"{rep['observations']} observations, {rep['corrections']} "
          f"corrected vectors applied, {rep['violations']} high-water(s) "
          f"above the reservation; paired error over "
          f"{rep['paired']['n']} corrected completions: raw probe "
          f"{rep['paired']['mae_raw_s']:.4f} s, corrected "
          f"{rep['paired']['mae_used_s']:.4f} s "
          f"({rep['paired']['improvement']:.1f}x); uncorrected warm-up "
          f"{rep['uncalibrated']['n']} at {rep['uncalibrated']['mae_s']:.4f}"
          f" s; profiles' memory violations {prof['memory_violations']}",
          flush=True)
    rows = {(r["est_s"], r["hbm_gb"]): r for r in store.rows()}
    for arch in cfgs:
        vec = next(bj.vec for a, bj in jobs if a == arch)
        row = rows[(vec.est_seconds, vec.hbm_bytes / 1e9)]
        mine = [v for a, _, v in measured if a == arch]
        hw = max(v.hbm_bytes for v in mine)
        print(f"[obs] {arch} ({OBS_CLASSES[arch][0]} layers, 4 x "
              f"{OBS_CLASSES[arch][1]} prompts, {gen_len} tokens) on {gpu}: "
              f"probe est {vec.est_seconds:.5f} s, observed alone "
              f"{', '.join(f'{v.est_seconds:.4f}' for v in mine)} s, "
              f"learned observed/predicted x{row['ratio']:.2f} over "
              f"{row['n']} completions, mean abs error raw "
              f"{row['mae_raw_s']:.4f} s -> used {row['mae_used_s']:.4f} s; "
              f"probe hbm {vec.hbm_bytes} B, measured high-water "
              f"{', '.join(str(v.hbm_bytes) for v in mine)} B in "
              f"{len(mine)} lone attempt(s) (probe/measured "
              f"{vec.hbm_bytes / hw:.4f}, margin {vec.hbm_bytes - hw} B; "
              f"less the {CUDA_UNSEEN_BYTES} B unseen "
              f"{(vec.hbm_bytes - CUDA_UNSEEN_BYTES) / hw:.4f}); the store's "
              f"high-water {store.highwater(vec)} B (a completion that "
              f"shared the card reports the probe's bytes), violations "
              f"{row['violations']}", flush=True)
    for d, o in device_occupancy(cluster.trace.events()).items():
        print(f"[obs] device {d} occupancy: busy {o['busy_frac']:.4f} of the "
              f"run, mean demand-weighted {o['mean_occupancy']:.4f}",
              flush=True)
    print(f"[obs] SLO (drift stream from the store): {slo.status()}",
          flush=True)
    print(frame, flush=True)
    if rep["violations"] or prof["memory_violations"] or any(
            v.hbm_bytes > t.resources.hbm_bytes for _, t, v in measured):
        fail("obs: a measured high-water is above its reservation")
    if not rep["corrections"]:
        fail("obs: no corrected vector was applied")

    # the trace, the flight recorder, and the run replayed on the sim
    doc = cluster.export_trace(os.path.join(HERE, "build", "obs_trace.json"))
    problems = validate_chrome_trace(doc)
    print(f"[obs] Chrome trace: {trace_summary(doc)}, problems {problems}",
          flush=True)
    if problems:
        fail(f"obs: the exported trace is invalid: {problems[:5]}")
    dumps = cluster.flight.dumps
    if not dumps or not os.path.exists(dumps[-1][1]):
        fail("obs: the flight recorder wrote no file")
    try:
        flown = load_flight(dumps[-1][1])
    except (OSError, ValueError, KeyError, TypeError) as e:
        fail(f"obs: the flight recorder's file does not load: {e!r}")
    print(f"[obs] flight recorder: {len(dumps)} dump(s), the last "
          f"({dumps[-1][0]}) {len(flown)} events", flush=True)
    if not flown:
        fail("obs: the flight recorder's file holds no event")
    events = cluster.trace.events()
    start = events[0].t
    events = [e._replace(t=e.t - start) for e in events]
    report = whatif.compare(
        events,
        {"MGB Alg. 3": {},
         "SA": {"scheduler_factory": lambda: SAScheduler(
             1, hbm_per_device=hbm)}},
        scheduler_factory=lambda: MGBAlg3Scheduler(1, hbm_per_device=hbm),
        workers=OBS_WORKERS)
    print(f"[obs] what-if, the card run's submissions replayed on the sim "
          f"backend (the probe's est_seconds as each task's work): "
          f"recorded {report['baseline']}; "
          + "; ".join(f"{k}: makespan {v['makespan_s']:.4f} s, p99 queueing "
                      f"{v['p99_queueing_s']:.4f} s, first divergence "
                      f"{v['first_divergence']}"
                      for k, v in report["policies"].items()), flush=True)
    print(f"[obs] phase time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# the kernels the examples' path launches: every forward and the flash and
# RMSNorm backwards (no example trains a Mamba or MoE model)
EXAMPLES_KERNELS = ("rmsnorm", "flash_attention", "mamba_scan", "moe_gmm",
                    "moe_gmm_gated", "flash_attention_bwd", "rmsnorm_bwd")


def phase_examples(torch, gpu: str) -> dict:
    """The six examples (``repro_torch.examples``) on the card, in this
    process, each through its ``main`` as a user runs it, with the launch
    counters zeroed just before the first and read after the last. Each
    that has a device-independent part also runs on the CPU
    (``--device cpu``), and that part must equal the card's: quickstart's
    results within 1e-4 relative, the sim sections of gang_placement,
    preemptive_cluster and trace_viewer exactly. Fails where an example's
    own assertion fails (it raises), where quickstart's jobs do not both
    complete or the card's gang is not bound as 4 devices, where
    shared_cluster crashes a job outside its fault-injection section or its
    fleet completes fewer than 65, where a kernel of the path (every one
    but the scan's and the grouped matmul's backward) was never launched,
    or where train_100m (lm-100m at its full width and depth, f32, 300
    steps of 8 x 256, a checkpoint every 50) launches other than 300 steps
    of the formula's kernels, its loss does not fall, or its ``--resume``
    does not restore step 300 and run no step. Then one lm-100m step
    profiled (``profile_100m``). Returns the launches by kernel."""
    import shutil
    from repro_torch.examples import (
        gang_placement, preemptive_cluster, quickstart, shared_cluster,
        trace_viewer, train_100m,
    )
    t_phase = time.perf_counter()
    fresh_card(torch)
    cpu = ["--device", "cpu"]
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    for c in counters().values():
        c.reset()

    card = quickstart.main([])
    ref = quickstart.main(cpu)
    err = max(abs(card["results"][k] - v) / abs(v)
              for k, v in ref["results"].items())
    print(f"[examples] quickstart on {gpu}: results "
          f"{ {k: round(v, 3) for k, v in sorted(card['results'].items())} }"
          f" (CPU {round(ref['results']['app1'], 3)}, largest relative "
          f"difference {err:.3e}); placements {card['placements']}; probe A "
          f"{card['probe_a'].hbm_bytes} B, {card['probe_a'].flops:.4e} flops",
          flush=True)
    if set(card["results"]) != set(ref["results"]) or err > 1e-4 \
            or card["stats"]["completed"] != 2 or card["stats"]["crashed"] \
            or {d for _, d in card["placements"]} != {0, 1}:
        fail("examples: quickstart on the card differs from the CPU run")

    card = gang_placement.main([])
    ref = gang_placement.main(cpu)
    print(f"[examples] gang_placement on {gpu}: all jobs done at virtual "
          f"t={card['t']:.1f} s (CPU {ref['t']:.1f}); the live gang bound "
          f"as {len(card['bound'])} devices {sorted(set(map(str, card['bound'])))}"
          f"; shedding {card['shed_stats']}", flush=True)
    if (card["t"], card["placements"], card["shed_stats"]) != (
            ref["t"], ref["placements"], ref["shed_stats"]) \
            or card["bound"] != [torch.device("cuda", 0)] * 4:
        fail("examples: gang_placement's sim differs from the CPU's or the "
             "gang was not bound as 4 devices of the card")

    card = preemptive_cluster.main([])
    ref = preemptive_cluster.main(cpu)
    sim = card["sim"]
    print(f"[examples] preemptive_cluster on {gpu}: urgent deadlines met "
          f"{sim['met']}/{sim['total']} admission-only, "
          f"{sim['met_preemptive']}/{sim['total_preemptive']} preemptive, "
          f"{sim['preemptions']} preemptions, {sim['migrations']} "
          f"migrations; live events {card['live']['events']}", flush=True)
    if sim != ref["sim"] or card["live"]["preemptions"] != 1 \
            or any(s != "done" for _, s in card["live"]["statuses"]):
        fail("examples: preemptive_cluster differs from the CPU run")

    card = trace_viewer.main(["--out", os.path.join(build,
                                                    "trace_viewer.json")])
    ref = trace_viewer.main(cpu + ["--out", os.path.join(
        build, "trace_viewer_cpu.json")])
    s = card["summary"]
    print(f"[examples] trace_viewer on {gpu}: {s['slices']} slices, "
          f"{s['flows']} flows ({s['cross_device_flows']} cross-device), "
          f"{s['counter_samples']} counter samples, queueing delay p99 "
          f"{card['queueing_delay']['p99']:.3f} s", flush=True)
    # a verdict names its preemptor by task uid, which counts on across
    # runs in one process
    for r in (card, ref):
        r["verdicts"] = [(n, re.sub(r"by=\d+", "by=#", v))
                         for n, v in r["verdicts"]]
    if card != ref:
        fail("examples: trace_viewer differs from the CPU run")

    res = shared_cluster.main([])
    fl = res["fleet"]
    print(f"[examples] shared_cluster on {gpu}: MGB {res['mgb']['completed']}"
          f" completed / {res['mgb']['crashed']} crashed, makespan "
          f"{res['mgb']['makespan_s']:.3f} s; SA {res['sa']['completed']} / "
          f"{res['sa']['crashed']}, makespan {res['sa']['makespan_s']:.3f} s "
          f"({res['speedup']:.2f}x); device 0 dead: {res['evicted']} "
          f"evicted, {res['fault']['completed']} completed / "
          f"{res['fault']['crashed']} crashed; fleet {fl['done']}/"
          f"{shared_cluster.FLEET_REQUESTS} + "
          f"background {fl['background']}, {fl['stats']['completed']} "
          f"completed / {fl['stats']['crashed']} crashed in "
          f"{fl['wall_s']:.2f} s", flush=True)
    if res["mgb"]["completed"] != 6 or res["mgb"]["crashed"] \
            or res["sa"]["completed"] != 6 or res["sa"]["crashed"] \
            or res["fault"]["completed"] + res["fault"]["crashed"] != 6 \
            or not res["evicted"] \
            or fl["stats"]["completed"] != shared_cluster.FLEET_REQUESTS + 1 \
            or fl["stats"]["crashed"]:
        fail("examples: shared_cluster crashed a job, left one undone or "
             "evicted nothing when device 0 died")

    # lm-100m from a fresh directory, then resumed from it
    ckpt = os.path.join(build, "examples_100m_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    before = read_counts()
    res = train_100m.main(["--ckpt-dir", ckpt])
    again = train_100m.main(["--ckpt-dir", ckpt, "--resume"])
    counts = read_counts()
    cfg = train_100m.CONFIG_100M
    n, steps = cfg.n_layers, len(res["losses"])
    # remat "nothing": each forward kernel once a layer, each backward once;
    # the final norm once each way
    want = {"rmsnorm": (2 * n + 1) * steps, "flash_attention": n * steps,
            "flash_attention_bwd": n * steps,
            "rmsnorm_bwd": (2 * n + 1) * steps}
    got = {k: counts[k] - before[k] for k in want}
    step_ms = sorted(res["step_ms"])[len(res["step_ms"]) // 2]
    ck = res["checkpoint"]
    print(f"[examples] train_100m on {gpu}: lm-100m, {cfg.param_count()} "
          f"parameters, {n} layers, f32, {steps} steps of 8 x 256: loss "
          f"{res['losses'][0]:.4f} -> {res['final_loss']:.4f}; "
          f"{steps / res['wall_s']:.2f} steps/s over the run "
          f"({res['wall_s']:.1f} s, probe and saves included), median "
          f"step {step_ms:.2f} ms host, "
          f"{sorted(res['device_ms'])[steps // 2]:.2f} ms device; the last "
          f"checkpoint {ck['nbytes']} B, copy {ck['copy_s']:.3f} s, write "
          f"{ck['write_s']:.3f} s; --resume restored step "
          f"{again['start_step']} in {again['attempts'][0]['restore_s']:.3f}"
          f" s and ran {len(again['losses'])} steps; launches {got}",
          flush=True)
    if steps != 300 or res["final_loss"] >= res["losses"][0] \
            or again["start_step"] != 300 or again["losses"] or got != want:
        fail("examples: train_100m did not train, resume or launch as "
             f"expected (launches {got}, expected {want})")
    shutil.rmtree(ckpt, ignore_errors=True)
    profile_100m(torch, cfg, len(res["losses"]))

    launches = {k: counts[k] for k in dict.fromkeys(EXAMPLES_KERNELS
                                                   + BWD_KERNELS)}
    missing = [k for k in EXAMPLES_KERNELS if not launches[k]]
    print(f"[launches] examples: {launches}", flush=True)
    if missing:
        fail(f"examples: {missing} never launched")
    print(f"[examples] phase time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# the kernel classes of an lm-100m step's profile: (what, name parts)
PROFILE_100M = (("flash forward", ("flash_fwd_kernel",)),
                ("flash backward", ("flash_bwd_delta_kernel",
                                    "flash_bwd_dkdv_kernel",
                                    "flash_bwd_dq_kernel")),
                ("RMSNorm forward", ("rmsnorm_kernel",)),
                ("RMSNorm backward", ("rmsnorm_bwd_kernel",
                                      "rmsnorm_dscale_kernel")),
                ("GEMMs (cuBLAS)", ("gemm", "xmma", "cutlass")))


def profile_100m(torch, cfg, steps: int) -> None:
    """One lm-100m step as train_100m's launcher builds it (f32, 8 x 256,
    AdamW at lr 1e-3 with the launcher's warm-up over ``steps``, the hand
    kernels), from a seeded init: five steps timed between CUDA events,
    host and device, then one under ``torch.profiler`` (``device_breakdown``),
    with each class of ``PROFILE_100M``'s share of the device busy time and
    the device's idle share of the timed steps' mean device span."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.pipeline import to_device as batch_to
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    dev = torch.device("cuda", 0)
    fresh_card(torch)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=min(20, steps // 5 + 1),
                            total_steps=steps,
                            moment_dtype=cfg.optimizer_moment_dtype)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         torch.float32, dev)
    state = adamw.init_state(opt, params)
    step = make_train_step(cfg, opt, attn_impl="flash_kernel")
    pipe = TokenPipeline(cfg, ShapeConfig("train", 256, 8, "train"), seed=0)
    batch = batch_to(pipe.batch_at(0), dev)
    step(params, state, batch)  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(5):
        step(params, state, batch)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / 5
    span_ms = start.elapsed_time(end) / 5
    label = "lm-100m train step, 12 layers, f32, batch 8 x 256"
    rows, _ = device_breakdown(torch, label,
                               lambda: step(params, state, batch), top=12)
    busy = sum(r[0] for r in rows)
    print(f"[profile] {label}: unprofiled {host_ms:.2f} ms host, "
          f"{span_ms:.2f} ms device span a step (5 steps); device busy "
          f"{busy:.2f} ms a step, idle {100 * (1 - busy / span_ms):.1f}% of "
          f"the span", flush=True)
    for what, names in PROFILE_100M:
        mine = [(ms, n) for ms, n, name in rows
                if any(k in name.lower() for k in names)]
        ms = sum(m for m, _ in mine)
        print(f"[profile] {label}: {what} {ms:.3f} ms a step over "
              f"{sum(n for _, n in mine)} launches, {100 * ms / busy:.1f}% "
              f"of the device busy time", flush=True)
    del params, state, batch


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


def time_phases(mod) -> None:
    """Wrap every ``phase_*`` function of ``mod`` (this script, or another
    commit's ``chip_smoke.py`` loaded as a module, so two commits' phases
    are timed alike) to print each call's wall seconds as ``[time] <phase>
    [arch] <s> s``; a phase that calls another prints both."""
    for name in [n for n in vars(mod) if n.startswith("phase_")]:
        def timed(*args, _fn=getattr(mod, name), _name=name, **kw):
            arch = [a for a in args if isinstance(a, str) and " " not in a]
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                print(f"[time] {' '.join([_name] + arch[:1])} "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
        setattr(mod, name, timed)


def main() -> None:
    t_run = time.perf_counter()
    time_phases(sys.modules[__name__])
    torch = setup()
    print(f"[card] {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)
    gpu = card_line()
    phase_build(torch)
    dryrun = start_dryrun(torch)
    phase_paper(torch, gpu)
    phase_paper_nn(torch, gpu)
    phase_twin(torch)
    table = phase_kernels(torch)
    phase_reduced(torch, "gemma2-9b", 100)
    phase_reduced(torch, "falcon-mamba-7b", 128)
    phase_reduced(torch, "mixtral-8x7b", 128)
    phase_reduced(torch, "zamba2-2.7b", 128)
    phase_continuous_reduced(torch, "gemma2-9b", 100)
    phase_continuous_reduced(torch, "falcon-mamba-7b", 128)
    phase_continuous_reduced(torch, "mixtral-8x7b", 128)
    phase_continuous_reduced(torch, "zamba2-2.7b", 128)
    phase_train_reduced(torch, "gemma2-9b")
    phase_train_reduced(torch, "qwen1.5-32b")
    phase_train_reduced(torch, "falcon-mamba-7b")
    phase_train_reduced(torch, "mixtral-8x7b")
    phase_train_reduced(torch, "zamba2-2.7b")
    phase_train_reduced(torch, "gemma2-9b", param_dtype=torch.bfloat16,
                        micro=2, remat="dots", batch=4)
    by_path = {"gemma2-9b": phase_serve(torch, "gemma2-9b", 1000, True),
               "falcon-mamba-7b": phase_serve(torch, "falcon-mamba-7b",
                                              1024, False),
               "mixtral-8x7b": phase_serve(torch, "mixtral-8x7b", 1024,
                                           False, MIXTRAL_LAYERS),
               "nemotron-4-340b": phase_serve(torch, "nemotron-4-340b", 1024,
                                              False, NEMOTRON_LAYERS,
                                              requests=4),
               "zamba2-2.7b": phase_serve(torch, "zamba2-2.7b", 1024, False),
               "gemma2-9b continuous": phase_continuous(
                   torch, "gemma2-9b", 1000),
               "falcon-mamba-7b continuous": phase_continuous(
                   torch, "falcon-mamba-7b", 1024),
               "mixtral-8x7b continuous": phase_continuous(
                   torch, "mixtral-8x7b", 1024, MIXTRAL_LAYERS),
               "zamba2-2.7b continuous": phase_continuous(
                   torch, "zamba2-2.7b", 1024)}
    phase_decode(torch, "gemma2-9b", 1000, streams=4)
    phase_decode(torch, "falcon-mamba-7b", 1024)
    phase_decode(torch, "mixtral-8x7b", 1024, MIXTRAL_LAYERS)
    phase_decode(torch, "zamba2-2.7b", 1024)
    for arch in ("gemma2-9b", "falcon-mamba-7b", "mixtral-8x7b",
                 "zamba2-2.7b"):
        by_path[f"{arch} train"] = phase_train(torch, arch)
    by_path.update(phase_dist(torch))
    by_path["dryrun"] = phase_dryrun(torch, dryrun)
    by_path["preempt"] = phase_preempt(torch, gpu)
    by_path["obs"] = phase_obs(torch, gpu)
    by_path["examples"] = phase_examples(torch, gpu)
    for name, entry in table.items():
        entry["launches_by_path"] = {arch: launches[name]
                                     for arch, launches in by_path.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if not entry["launches"]:
            fail(f"{name} was never launched on a main path")
    print(f"[time] chip_smoke {time.perf_counter() - t_run:.1f} s",
          flush=True)
    print(gpu)
    print(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
