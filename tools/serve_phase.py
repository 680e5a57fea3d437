"""gemma2-9b's static serving phase of ``chip_smoke``, on the card, for one
source tree.

    python3 tools/serve_phase.py [SRC] [REPEATS]

Builds the kernels of the ``repro_torch`` under SRC (default: this
repository's ``src``; an older tree unpacked with ``git archive`` works as
well, its libraries built under its own ``build/``), then runs
``chip_smoke.phase_serve(torch, "gemma2-9b", 1000, True)`` REPEATS times
(default 1): every published width, bf16, 32 requests on one pool worker
with exact launch counts, one batch alone against the probe, and the same
requests on four pool workers, each printing its tokens/s. To compare two
trees, run it on each in turns in one call to the card (parent, change,
change, parent): the custom ops of one tree are registered once a process.
Needs one CUDA card; imports no JAX.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    src = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                          else os.path.join(ROOT, "src"))
    repeats = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    torch = CS.setup()
    # the tree to measure comes first, whatever chip_smoke put on the path
    sys.path.insert(0, src)
    for name in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[name]
    from repro_torch.kernels import build
    if not build.__file__.startswith(src):
        CS.fail(f"repro_torch came from {build.__file__}, not {src}")
    print(f"[serve-phase] src {src}; card {CS.card_line()}", flush=True)
    start = time.time()
    build.build_all()
    print(f"[serve-phase] built in {time.time() - start:.1f} s", flush=True)
    for i in range(repeats):
        start = time.time()
        CS.phase_serve(torch, "gemma2-9b", 1000, True)
        print(f"[serve-phase] run {i + 1} took {time.time() - start:.1f} s",
              flush=True)
    print("[serve-phase] ok", flush=True)


if __name__ == "__main__":
    main()
