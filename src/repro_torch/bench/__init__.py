"""The paper's evaluation scripts on the port's probes and simulator: Table
II (CG crashes), Table III (turnaround), Table IV (kernel slowdown), Fig. 4
(Algorithm 3 against 2) and Fig. 5 (throughput against SA and CG). Each
runs as ``python -m repro_torch.bench.<name> [--device cpu]`` and writes
its JSON under ``results/`` beside it."""
