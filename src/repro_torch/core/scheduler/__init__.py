"""Schedulers copied from ``src/repro/core/scheduler/`` so far: the base
substrate, the paper's baselines (SA, CG, schedGPU's memory-only policy),
MGB Algorithms 2 and 3, the reference (oracle) engine of Algorithms 2 and
3, gang placement (``GangScheduler``) and the preemptive layer
(``PreemptionMixin`` and the preemptive Algorithm 2, Algorithm 3 and gang
schedulers). The sharded and slice schedulers are not copied yet."""
from repro_torch.core.scheduler.base import (  # noqa: F401
    DEADLINE_SHED, DeviceState, Scheduler,
)
from repro_torch.core.scheduler.baselines import (  # noqa: F401
    CGScheduler, MemOnlyScheduler, SAScheduler,
)
from repro_torch.core.scheduler.gang import GangScheduler  # noqa: F401
from repro_torch.core.scheduler.mgb import (  # noqa: F401
    MGBAlg2Scheduler, MGBAlg3Scheduler,
)
from repro_torch.core.scheduler.preempt import (  # noqa: F401
    GangPreemptionMixin, PreemptionMixin, PreemptiveAlg2Scheduler,
    PreemptiveAlg3Scheduler, PreemptiveGangScheduler,
)
from repro_torch.core.scheduler.reference import (  # noqa: F401
    ReferenceAlg2Scheduler, ReferenceAlg3Scheduler,
)
