"""Schedulers copied from ``src/repro/core/scheduler/`` so far: the base
substrate and MGB Algorithms 2 and 3."""
from repro_torch.core.scheduler.base import (  # noqa: F401
    DEADLINE_SHED, DeviceState, Scheduler,
)
from repro_torch.core.scheduler.mgb import (  # noqa: F401
    MGBAlg2Scheduler, MGBAlg3Scheduler,
)
