"""Entry points (port of ``src/repro/launch/``)."""
