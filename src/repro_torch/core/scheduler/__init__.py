"""Schedulers copied from ``src/repro/core/scheduler/`` so far: the base
substrate, the paper's baselines (SA, CG, schedGPU's memory-only policy),
MGB Algorithms 2 and 3, and the reference (oracle) engine of Algorithms 2
and 3."""
from repro_torch.core.scheduler.base import (  # noqa: F401
    DEADLINE_SHED, DeviceState, Scheduler,
)
from repro_torch.core.scheduler.baselines import (  # noqa: F401
    CGScheduler, MemOnlyScheduler, SAScheduler,
)
from repro_torch.core.scheduler.mgb import (  # noqa: F401
    MGBAlg2Scheduler, MGBAlg3Scheduler,
)
from repro_torch.core.scheduler.reference import (  # noqa: F401
    ReferenceAlg2Scheduler, ReferenceAlg3Scheduler,
)
