"""The dense decoder model in PyTorch (port of ``src/repro/models/``)."""
