"""RMSNorm's forward at every main-path row, on the card, for one source tree.

    python3 tools/rmsnorm_rows.py [SRC] [REPEATS]

Builds ``csrc/rmsnorm.cu`` of the ``repro_torch`` under SRC (default: this
repository's ``src``; an older tree unpacked with ``git archive`` works as
well, its library built under its own ``build/``), prints ptxas' register
and spill lines, then runs ``chip_smoke.phase_rmsnorm`` REPEATS times
(default 1): every row of ``chip_smoke.RMSNORM_ROWS`` held against the
plain version, two calls the same bits, and the kernel, the plain version
and ``F.rms_norm`` timed warm and, for prefill and train rows, cold. To
compare two trees, run it on each in turns in one call to the card
(parent, change, change, parent). Needs one CUDA card; imports no JAX.
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
    print(f"[rms] src {src}; card {CS.card_line()}", flush=True)
    start = time.time()
    logs = build.build_all(["rmsnorm"])
    print(f"[rms] built in {time.time() - start:.1f} s", flush=True)
    for log in logs.values():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry")):
                print(f"[build] {line.strip()[:160]}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(dtype)

    for _ in range(repeats):
        CS.phase_rmsnorm(torch, randn, {})
    print("[rms] ok", flush=True)


if __name__ == "__main__":
    main()
