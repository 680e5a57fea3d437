"""GPU tasks and resource vectors — the paper's basic scheduling unit.

Paper §III-A: a *GPU task* is a kernel launch bundled with the memory
operations (alloc / h2d copy / free) required to execute it correctly, so the
whole unit can be bound to ANY device. Here the "kernel launch" is a jitted
JAX computation; the bundled memory objects are the task's input/state buffers
(``repro_torch.core.lazy.LazyBuffer``), and the resource vector is derived from the
XLA compiled artifact (``repro_torch.core.probe``) instead of interpreting
instrumented symbols — strictly better information than the paper's probes.

Copy of ``src/repro/core/task.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

_task_ids = itertools.count()


@dataclasses.dataclass(frozen=True)
class ResourceVector:
    """The probe payload: everything the scheduler knows about a task.

    Paper: (global-memory bytes, thread blocks, warps/SMs). TPU adaptation
    (DESIGN.md §2): thread-block/warp demand becomes ``core_demand`` — the
    roofline-estimated fraction of one chip's TensorCore-seconds the task
    needs per wall-second while running.
    """
    hbm_bytes: int                 # peak device memory while resident
    flops: float                   # compute work (global)
    bytes_accessed: float          # HBM traffic
    collective_bytes: float = 0.0  # ICI traffic (multi-chip tasks)
    est_seconds: float = 0.0       # roofline duration estimate, solo
    core_demand: float = 1.0       # in (0, 1]: compute-seconds per second
    bw_demand: float = 1.0         # in (0, 1]: HBM-bandwidth-seconds per second
    chips: int = 1                 # devices the task spans (1 = single chip)

    @property
    def demand(self) -> float:
        """Scalar load metric for schedulers — the dominant resource share
        (the paper's 'warps in use' rolled compute and issue slots into one
        number the same way)."""
        return max(self.core_demand, self.bw_demand)

    def scaled(self, work_scale: float) -> "ResourceVector":
        """Same kernel shape, ``work_scale``x the iterations (duration only)."""
        return dataclasses.replace(
            self, flops=self.flops * work_scale,
            bytes_accessed=self.bytes_accessed * work_scale,
            collective_bytes=self.collective_bytes * work_scale,
            est_seconds=self.est_seconds * work_scale)


@dataclasses.dataclass
class UnitTask:
    """One kernel launch + the memory objects it touches (paper Alg. 1 input)."""
    fn: Optional[Callable]            # jitted computation (None in simulation)
    memobjs: FrozenSet[str]           # buffer names (pseudo-addresses)
    resources: ResourceVector
    name: str = ""
    uid: int = dataclasses.field(default_factory=lambda: next(_task_ids))


@dataclasses.dataclass
class Task:
    """A schedulable GPU task: >=1 unit tasks merged over shared memobjs.

    The merge (paper Alg. 1) guarantees every computation touching a given
    buffer lands on the same device, so no cross-device moves are ever paid.
    """
    units: List[UnitTask]
    name: str = ""
    uid: int = dataclasses.field(default_factory=lambda: next(_task_ids))
    # admission class (read by the scheduler's waiter queue): higher priority
    # is admitted first; within a priority class, earlier absolute deadline
    # first (EDF), then submission order. Stamped job-wide by Cluster.submit.
    priority: int = 0
    deadline_t: Optional[float] = None
    # gang identity: multi-chip tasks (resources.chips > 1) carry a label
    # naming the gang they belong to, propagated job -> task -> ExecRecord
    # so a trace can be grouped by gang end to end. None for solo tasks
    # (the executor backfills the job's gang_id at submit).
    gang_id: Optional[str] = None
    # resident-growth binding (continuous batching, serve.engine): when set,
    # this task is a resource DELTA against an already-admitted resident —
    # a decode slot joining a running batch. Admission then only considers
    # the devices currently hosting one of these host tasks (the slot's KV
    # bytes must land next to its batch), still memory/slot-checked, so the
    # memory-hard guarantee covers batch GROWTH, not just task admission.
    grow_hosts: Optional[Tuple["Task", ...]] = None
    # host-side row budget: max concurrent grow-slots this resident can hold
    # (a decode loop has exactly max_batch physical cache rows). Checked by
    # the scheduler's grow admission against `grown_now`, which it maintains
    # (incremented on grow-admit, decremented by DeviceState.release via the
    # slot's `placed_host` back-pointer — so evictions settle it too). None
    # means no per-host cap beyond the device-wide compute-slot ledger.
    slot_budget: Optional[int] = None
    grown_now: int = 0
    placed_host: Optional["Task"] = None
    # preemption bookkeeping: times this task was evicted by the preemptive
    # scheduler layer, counted against PreemptionPolicy.budget (a task at
    # budget is immune to further eviction). Each eviction also adds
    # aging_step to age_boost — an ADMISSION-rank bonus (the waiter queue
    # ranks by priority + age_boost) so a repeatedly-bumped job eventually
    # outranks the arrivals displacing it. Deliberately NOT folded into
    # `priority`: the eviction decision rule compares raw priorities, and an
    # aged victim must never start preempting its own original class.
    preempt_count: int = 0
    age_boost: int = 0
    # runtime bookkeeping (filled by scheduler/executor)
    device: Optional[int] = None
    arrival_t: float = 0.0
    start_t: float = -1.0
    finish_t: float = -1.0
    # -- observed-vs-predicted calibration (obs.calibrate) -------------------
    # probe_vec: the probe's ORIGINAL prediction, stamped by the calibration
    # layer at the task's first admission probe, BEFORE any correction — it
    # is both the ground truth for prediction-error accounting and the
    # calibration store's class key (corrected vectors must not mint new
    # waiter classes or feed back into their own statistics).
    probe_vec: Optional[ResourceVector] = None
    # calibrated_vec: the corrected vector admission actually uses when a
    # CalibrationStore is attached (EWMA-scaled est_seconds, safety-margin
    # memory). When set, `resources` returns it — every reservation,
    # release, and feasibility check then sees the same corrected footprint.
    calibrated_vec: Optional[ResourceVector] = None
    # true_vec: ground truth for studies — the simulator runs the task for
    # true_vec.est_seconds (not the possibly-stale probe estimate) and the
    # profiler reads true_vec.hbm_bytes as the observed memory high-water.
    # None outside synthetic drift workloads (live tasks ARE ground truth).
    true_vec: Optional[ResourceVector] = None

    @property
    def memobjs(self) -> FrozenSet[str]:
        out: FrozenSet[str] = frozenset()
        for u in self.units:
            out |= u.memobjs
        return out

    @property
    def resources(self) -> ResourceVector:
        """Aggregate vector: memory is the UNION footprint (buffers shared),
        work is the sum; core_demand is the duration-weighted mean. A
        calibration-corrected vector (``calibrated_vec``) takes precedence —
        admission, release, and feasibility all see the same correction."""
        if self.calibrated_vec is not None:
            return self.calibrated_vec
        if len(self.units) == 1:
            return self.units[0].resources
        rs = [u.resources for u in self.units]
        tot_s = sum(r.est_seconds for r in rs)
        mem = _union_hbm(self.units)
        return ResourceVector(
            hbm_bytes=mem,
            flops=sum(r.flops for r in rs),
            bytes_accessed=sum(r.bytes_accessed for r in rs),
            collective_bytes=sum(r.collective_bytes for r in rs),
            est_seconds=tot_s,
            core_demand=(sum(r.core_demand * r.est_seconds for r in rs) / tot_s
                         if tot_s else max(r.core_demand for r in rs)),
            bw_demand=(sum(r.bw_demand * r.est_seconds for r in rs) / tot_s
                       if tot_s else max(r.bw_demand for r in rs)),
            chips=max(r.chips for r in rs),
        )

    def __repr__(self) -> str:
        r = self.resources
        return (f"Task({self.name or self.uid}, mem={r.hbm_bytes / 1e9:.2f}GB, "
                f"demand={r.demand:.2f}, est={r.est_seconds:.3f}s, "
                f"units={len(self.units)})")


def _union_hbm(units: Sequence[UnitTask]) -> int:
    """Union footprint: shared buffers counted once. Without per-buffer sizes
    we take max(unit footprints) + sum of each unit's private excess estimate;
    conservatively: max when all buffers shared, sum when disjoint. We use the
    fraction of shared memobjs as the interpolation weight."""
    if not units:
        return 0
    mems = [u.resources.hbm_bytes for u in units]
    all_objs = set().union(*(u.memobjs for u in units))
    if not all_objs:
        return sum(mems)
    counts = sum(len(u.memobjs) for u in units)
    shared_frac = 1.0 - len(all_objs) / max(counts, 1)
    return int(max(mems) + (1.0 - shared_frac) * (sum(mems) - max(mems)))


@dataclasses.dataclass
class Job:
    """A queued batch job = an ordered sequence of GPU tasks from one process.

    In the paper's evaluation a job is one Rodinia/Darknet process; its tasks
    all run on the device the scheduler picks for the first task-begin (the
    lazy runtime re-binds buffers there).
    """
    tasks: List[Task]
    name: str = ""
    uid: int = dataclasses.field(default_factory=lambda: next(_task_ids))
    arrival_t: float = 0.0
    finish_t: float = -1.0
    crashed: bool = False
    # why the job crashed, when the scheduler can say (e.g. the
    # infeasible-placement fast-fail); empty for runner exceptions/OOMs
    error: str = ""
    # admission class for every task in the job (see Task.priority)
    priority: int = 0
    deadline_t: Optional[float] = None
    # gang label stamped onto every task lacking one (see Task.gang_id)
    gang_id: Optional[str] = None

    @property
    def total_seconds(self) -> float:
        return sum(t.resources.est_seconds for t in self.tasks)

    @property
    def peak_hbm(self) -> int:
        return max((t.resources.hbm_bytes for t in self.tasks), default=0)


def true_work_seconds(task: Task) -> float:
    """Ground-truth solo work for ``task`` — what the simulator should RUN,
    as opposed to what admission PREDICTS. Precedence: an explicit
    ``true_vec`` (synthetic drift workloads), then the stamped original
    probe estimate, then the current vector. Keeping this separate from
    ``task.resources.est_seconds`` is what lets calibration correct the
    prediction without changing the simulated physics."""
    tv = task.true_vec
    if tv is not None:
        return tv.est_seconds
    pv = task.probe_vec
    if pv is not None:
        return pv.est_seconds
    return task.resources.est_seconds


def observed_highwater(task: Task) -> int:
    """Observed peak device memory for ``task``: the ground-truth vector's
    footprint when one exists, else the original probe's (a probe-exact
    prediction — the compiled artifact's actual buffer plan — IS the
    observation for live runs)."""
    tv = task.true_vec
    if tv is not None:
        return tv.hbm_bytes
    pv = task.probe_vec
    if pv is not None:
        return pv.hbm_bytes
    return task.resources.hbm_bytes
