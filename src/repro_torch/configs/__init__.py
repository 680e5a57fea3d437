"""Architecture configurations, copied from ``src/repro/configs/``."""
