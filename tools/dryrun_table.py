"""The dry run's cells as a markdown table, from the JSON files
``python -m repro_torch.launch.dryrun --all`` writes (one a cell).

    python3 tools/dryrun_table.py [--rows] DIR [DIR ...]

By default one row an arch and one column a (shape, mesh), each cell
"compute / memory / collective s; dominant; peak a device GB, fit"
(``fits`` against the card's 80e9 B, ``over`` past it), the terms on one
NVIDIA H100 80GB HBM3's data-sheet rates; with ``--rows`` one row a cell.
A failed cell shows its error, a skipped one SKIP.
"""
import glob
import json
import os
import sys

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load(dirs):
    cells = {}
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "*.json"))):
            arch, shape, mesh = os.path.basename(path)[:-5].split("__")
            with open(path) as f:
                cells[(arch, shape, mesh)] = json.load(f)
    return cells


def text(r) -> str:
    if r.get("status") == "SKIP":
        return "SKIP"
    if r.get("status") != "ok":
        return f"FAIL: {r.get('error', '')[:60]}"
    rl, mem = r["roofline"], r["memory"]
    return (f"{rl['compute_s']:.3g} / {rl['memory_s']:.3g} / "
            f"{rl['collective_s']:.3g}; {rl['dominant']}; "
            f"{mem['peak_per_device'] / 1e9:.1f} GB "
            f"{'fits' if mem['fits_80GB'] else 'over'}")


def main():
    args = sys.argv[1:]
    by_rows = "--rows" in args
    cells = load([a for a in args if a != "--rows"] or ["build/dryrun"])
    if by_rows:
        print("| arch | shape | mesh | compute / memory / collective s; "
              "dominant; peak, fit |")
        print("| --- | --- | --- | --- |")
        for (arch, shape, mesh), r in sorted(cells.items()):
            print(f"| {arch} | {shape} | {mesh} | {text(r)} |")
        return
    cols = [(s, "16x16") for s in SHAPES] + [
        (s, "2x16x16") for s in SHAPES
        if any(k[1:] == (s, "2x16x16") for k in cells)]
    print("| arch | " + " | ".join(f"{s} {m}" for s, m in cols) + " |")
    print("| --- |" + " --- |" * len(cols))
    for arch in sorted({k[0] for k in cells}):
        print(f"| {arch} | " + " | ".join(
            text(cells[(arch, s, m)]) if (arch, s, m) in cells else "not run"
            for s, m in cols) + " |")


if __name__ == "__main__":
    main()
