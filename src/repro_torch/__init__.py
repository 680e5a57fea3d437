"""PyTorch/CUDA port of ``repro``: the paper's live loop (probe -> MGB
admission -> executor) serving the dense model family on NVIDIA Hopper, with
hand-written CUDA kernels for RMSNorm and flash attention.

The layout mirrors ``src/repro/`` (``repro/X.py`` -> ``repro_torch/X.py``).
The package imports ``torch`` and never ``jax`` or ``repro``: modules that
need no framework are copies of the reference, each naming its source.
Entry points run on CUDA unless the caller asks for ``device="cpu"``.
"""
