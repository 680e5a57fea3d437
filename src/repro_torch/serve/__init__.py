"""Serving steps (port of ``src/repro/serve/``)."""
