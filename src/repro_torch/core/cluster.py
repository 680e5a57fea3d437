"""Open-arrival submission front-end: the ``Cluster`` object jobs arrive at.

Port of ``src/repro/core/cluster.py``. The paper's scheduler is a daemon —
probes submit tasks whenever a process reaches a launch point. ``submit``
may be called at any time (including while earlier jobs are mid-flight) and
returns a future-like ``JobHandle``; ``drain`` is the barrier; ``shutdown``
tears the engine down.

    cluster = Cluster(MGBAlg3Scheduler(1, hbm_per_device=...), workers=1)
    h = cluster.submit(ej, priority=5, deadline_s=2.0)
    recs = h.result(timeout=30)    # per-task ExecRecords
    cluster.drain()

Two interchangeable backends sit behind the same API:

  * ``backend="live"`` — the event-driven ``Executor``: real PyTorch work on
    the card (or the CPU), wall-clock time, a bounded execution pool;
  * ``backend="sim"``  — the discrete-event ``Simulator``: virtual clock,
    processor-sharing interference model, no real execution. ``step()``
    advances the clock so submissions can interleave with simulated
    progress.

Both route admission through the scheduler's own priority/deadline waiter
queue: higher ``priority`` first, EDF within a class, arrival order last, so
the same submission trace produces the same admission order live and
simulated. With ``shed_late=True`` a job still parked when its deadline
passes is failed with ``JobStatus.SHED``. ``trace=True`` (or a ``Tracer``)
attaches an ``obs.events.Tracer`` that the scheduler and both backends emit
into. ``preempt=`` turns the eviction half of deadline/priority enforcement
on or off on a preemption-capable scheduler (``scheduler.preempt``), and
``stats()`` then counts the cluster's own ``preemptions`` and
``migrations``. Explain, calibration, profiling and trace export come in
later slices.
"""
from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

from repro_torch.core.executor import ExecJob, ExecRecord, Executor, _JobRun
from repro_torch.core.scheduler.base import Scheduler
from repro_torch.core.scheduler.preempt import PreemptionMixin
from repro_torch.core.simulator import Simulator, _JobState
from repro_torch.core.task import Job
from repro_torch.obs.events import Tracer, attach_tracer


class JobStatus(enum.Enum):
    QUEUED = "queued"        # submitted, not yet executing
    RUNNING = "running"      # at least one task started
    DONE = "done"            # all tasks completed
    CRASHED = "crashed"      # OOM / runner exception / never feasible
    CANCELLED = "cancelled"  # ended by JobHandle.cancel()
    SHED = "shed"            # parked past its deadline, failed at a drain


class JobHandle:
    """Future-like view of one submitted job, valid on either backend.

    ``result(timeout)`` blocks (live: wall clock; sim: advances the virtual
    clock) until the job resolves and returns its per-task ``ExecRecord``
    list; check ``status`` to distinguish DONE from CRASHED/CANCELLED.
    """

    def __init__(self, cluster: "Cluster", job: Job,
                 state: Union[_JobRun, _JobState]):
        self._cluster = cluster
        self.job = job
        self._state = state

    @property
    def status(self) -> JobStatus:
        s = self._state
        finished = s.done.is_set() if isinstance(s, _JobRun) else s.done
        if finished:
            if s.cancelled:
                return JobStatus.CANCELLED
            if s.shed:
                return JobStatus.SHED
            if self.job.crashed:
                return JobStatus.CRASHED
            return JobStatus.DONE
        return JobStatus.RUNNING if s.started else JobStatus.QUEUED

    @property
    def records(self) -> List[ExecRecord]:
        """Per-task execution records accumulated so far (live wall times or
        virtual-clock times, matching the backend)."""
        return list(self._state.records)

    def result(self, timeout: Optional[float] = None) -> List[ExecRecord]:
        """Wait until the job resolves; returns its ``ExecRecord`` list.
        Live backend: blocks up to ``timeout`` wall seconds (raises
        ``TimeoutError`` on expiry). Sim backend: advances the virtual clock
        until the job resolves (``timeout`` bounds virtual seconds)."""
        s = self._state
        if isinstance(s, _JobRun):
            if not s.done.wait(timeout):
                raise TimeoutError(f"job {self.job.name!r} still "
                                   f"{self.status.value} after {timeout}s")
        else:
            sim = self._cluster._sim
            limit = sim.now + timeout if timeout is not None else None
            while not s.done:
                if limit is not None and sim.now > limit:
                    raise TimeoutError(f"job {self.job.name!r} still "
                                       f"{self.status.value} at virtual "
                                       f"t={sim.now:.3f}")
                if not sim.step():
                    break  # simulation idle: job crashed-at-drain or stuck
            if not s.done:
                raise TimeoutError(
                    f"job {self.job.name!r} cannot make progress")
        return self.records

    def cancel(self) -> bool:
        """Cancel the job: a parked/queued job ends immediately; a running
        task finishes its current kernel first. False iff the job had
        already finished."""
        return self._cluster._cancel(self._state)


class Cluster:
    """The open-arrival submission surface over a scheduler and a backend.
    ``devices`` is the live executor's device table (default: every CUDA
    card); ``poll_interval`` and ``crash_delay`` are the simulator's."""

    def __init__(self, scheduler: Scheduler, *, workers: Optional[int] = None,
                 backend: str = "live",
                 devices: Optional[Sequence[object]] = None,
                 poll_interval: float = 0.05, crash_delay: float = 8.0,
                 shed_late: bool = False, preempt: Optional[bool] = None,
                 trace: Union[None, bool, Tracer] = None):
        self.sched = scheduler
        self.backend = backend
        scheduler.shed_expired = shed_late
        # preempt=True lets an arriving waiter that strictly outranks a
        # resident evict it (scheduler.preempt); the scheduler must be
        # preemption-capable. False disables it on a capable scheduler;
        # None keeps the scheduler's own setting (preemptive classes enable
        # themselves at construction)
        if preempt is not None:
            if preempt and not isinstance(scheduler, PreemptionMixin):
                raise ValueError(
                    f"preempt=True needs a preemption-capable scheduler, "
                    f"got {type(scheduler).__name__} — use "
                    f"PreemptiveAlg2Scheduler / PreemptiveAlg3Scheduler / "
                    f"PreemptiveGangScheduler from "
                    f"repro_torch.core.scheduler")
            scheduler.preempt_enabled = bool(preempt)
        n_workers = workers if workers is not None \
            else len(scheduler.devices)
        self._ex: Optional[Executor] = None
        self._sim: Optional[Simulator] = None
        if backend == "live":
            # a scheduler previously driven by a Simulator has its _clock
            # bound to that sim's (now frozen) virtual time: restore wall
            # monotonic so deadline shedding judges live deadlines correctly
            scheduler._clock = time.monotonic
            self._ex = Executor(scheduler, workers=n_workers,
                                devices=devices)
        elif backend == "sim":
            self._sim = Simulator(scheduler, workers=n_workers,
                                  poll_interval=poll_interval,
                                  crash_delay=crash_delay)
        else:
            raise ValueError(f"unknown backend {backend!r} "
                             "(expected 'live' or 'sim')")
        # attached after the backend: attach_tracer binds the tracer's clock
        # to the scheduler's _clock late, so it follows the sim's virtual
        # clock. Identity checks, not truthiness: an empty Tracer is falsy
        self.trace: Optional[Tracer] = None
        if trace is not None and trace is not False:
            self.trace = trace if isinstance(trace, Tracer) else Tracer()
            attach_tracer(scheduler, self.trace)
        self.handles: List[JobHandle] = []
        # scheduler counters are lifetime totals: a cluster over a reused
        # scheduler reports only its own activity
        self._attempts0 = getattr(scheduler, "begin_attempts", 0)
        self._preempt0 = getattr(scheduler, "preemptions", 0)
        self._migr0 = getattr(scheduler, "migrations", 0)
        self._submit_lock = threading.Lock()
        # aggregate counters, maintained at submit and by each job's
        # resolution callback, so stats() never scans the handles
        self._stats_lock = threading.Lock()
        self._n_jobs = 0
        self._t0 = float("inf")    # earliest arrival over ALL jobs
        self._t1 = float("-inf")   # latest finish over RESOLVED jobs
        self._n_done = 0
        self._n_crashed = 0
        self._n_cancelled = 0
        self._n_shed = 0
        self._turnaround_sum = 0.0  # over DONE jobs only

    # -- submission ----------------------------------------------------------
    def submit(self, job: Union[Job, ExecJob], *,
               runners: Optional[List[Callable]] = None,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None,
               on_done: Optional[Callable[["JobHandle"], None]] = None
               ) -> JobHandle:
        """Submit ``job`` now. ``priority`` (higher first) and
        ``deadline_s`` (seconds from now on the backend's clock; EDF within
        a class) rank it in the admission queue. The live backend wants an
        ``ExecJob`` (or a ``Job`` plus ``runners``); the sim backend takes
        a plain ``Job``. ``on_done(handle)`` fires once when the job
        resolves (live: on a backend thread)."""
        done_cb = self._on_job_resolved if on_done is None \
            else self._chain_on_done(on_done)
        with self._submit_lock:
            if self._ex is not None:
                ej = self._as_execjob(job, runners)
                deadline_t = (time.monotonic() + deadline_s
                              if deadline_s is not None else None)
                state: Union[_JobRun, _JobState] = self._ex.submit(
                    ej, priority=priority, deadline_t=deadline_t,
                    on_done=done_cb)
                handle = JobHandle(self, ej.job, state)
            else:
                plain = job.job if isinstance(job, ExecJob) else job
                deadline_t = (self._sim.now + deadline_s
                              if deadline_s is not None else None)
                state = self._sim.submit(plain, priority=priority,
                                         deadline_t=deadline_t,
                                         on_done=done_cb)
                handle = JobHandle(self, plain, state)
            with self._stats_lock:
                self._n_jobs += 1
                self._t0 = min(self._t0, handle.job.arrival_t)
            self.handles.append(handle)
            return handle

    def _chain_on_done(self, user_cb: Callable[["JobHandle"], None]
                       ) -> Callable[[Union[_JobRun, _JobState]], None]:
        """The backend may resolve an (e.g. empty) job inside ``submit``,
        before the public handle exists, so the handle is built from the
        backend state."""
        def cb(state: Union[_JobRun, _JobState]) -> None:
            self._on_job_resolved(state)
            job = state.ej.job if isinstance(state, _JobRun) else state.job
            user_cb(JobHandle(self, job, state))
        return cb

    def _on_job_resolved(self, state: Union[_JobRun, _JobState]) -> None:
        """Fold the job's terminal status into the aggregate counters:
        cancel beats shed beats crash beats done."""
        job = state.ej.job if isinstance(state, _JobRun) else state.job
        with self._stats_lock:
            if job.finish_t >= 0:
                self._t1 = max(self._t1, job.finish_t)
            if state.cancelled:
                self._n_cancelled += 1
            elif state.shed:
                self._n_shed += 1
            elif job.crashed:
                self._n_crashed += 1
            else:
                self._n_done += 1
                self._turnaround_sum += job.finish_t - job.arrival_t

    @staticmethod
    def _as_execjob(job: Union[Job, ExecJob],
                    runners: Optional[List[Callable]]) -> ExecJob:
        if isinstance(job, ExecJob):
            return job
        if runners is None:
            # placement/ordering studies: tasks place, run instantly, release
            runners = [(lambda device: None)] * len(job.tasks)
        if len(runners) != len(job.tasks):
            raise ValueError(f"{len(runners)} runners for "
                             f"{len(job.tasks)} tasks")
        return ExecJob(job=job, runners=list(runners))

    def _cancel(self, state: Union[_JobRun, _JobState]) -> bool:
        if isinstance(state, _JobRun):
            return self._ex.cancel(state)
        return self._sim.cancel(state)

    # -- barriers / clock ----------------------------------------------------
    def drain(self) -> None:
        """Barrier: block (live) or advance the virtual clock (sim) until
        every job submitted so far has resolved. A sim drain that hits its
        virtual time limit with work still pending raises: a capped run
        must not read as a completed one."""
        if self._ex is not None:
            self._ex.drain()
        else:
            self._sim_drain_checked()

    def _sim_drain_checked(self) -> None:
        res = self._sim.drain()
        if res.truncated:
            raise RuntimeError(
                f"simulation drain truncated at virtual t={self._sim.now:.0f}s "
                f"with work still pending ({res.completed} completed) — the "
                f"time limit was hit, not the end of the trace")

    def step(self) -> bool:
        """Sim backend: advance the virtual clock one event (False when
        idle). Live backend: no-op False — wall time advances on its own."""
        if self._sim is not None:
            return self._sim.step()
        return False

    def run_until(self, t: float) -> None:
        """Sim backend: advance the virtual clock to exactly ``t`` (submit,
        run_until the next arrival, submit). Live backend: no-op."""
        if self._sim is not None:
            self._sim.run_until(t)

    def inject_failure(self, device) -> None:
        """Declare ``device`` dead now on either backend (sim: residents'
        virtual runs stop and re-park; live: the scheduler's mark_dead
        path)."""
        if self._sim is not None:
            self._sim.inject_failure(device)
        else:
            self.sched.mark_dead(device)

    def revive(self, device) -> None:
        """Bring ``device`` back in service on either backend."""
        if self._sim is not None:
            self._sim.revive_device(device)
        else:
            self.sched.revive(device)

    @property
    def now(self) -> float:
        """Current time on the backend's clock (virtual for sim)."""
        return self._sim.now if self._sim is not None else time.monotonic()

    def shutdown(self) -> None:
        """Drain, then stop the live execution pool (sim: just drains). The
        next ``submit`` restarts the pool."""
        if self._ex is not None:
            self._ex.shutdown()
        else:
            self._sim_drain_checked()

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- metrics -------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Aggregate metrics over every job submitted so far (wall seconds
        live, virtual seconds sim), read from maintained counters."""
        with self._stats_lock:
            attempts = getattr(self.sched, "begin_attempts", 0) \
                - self._attempts0
            preemptions = getattr(self.sched, "preemptions", 0) \
                - self._preempt0
            migrations = getattr(self.sched, "migrations", 0) - self._migr0
            if not self._n_jobs:
                return {"makespan_s": 0.0, "throughput_jobs_per_s": 0.0,
                        "completed": 0, "crashed": 0, "cancelled": 0,
                        "shed": 0, "mean_turnaround_s": 0.0,
                        "sched_attempts": attempts,
                        "preemptions": preemptions,
                        "migrations": migrations}
            t1 = self._t1 if self._t1 > float("-inf") else self._t0
            makespan = max(t1 - self._t0, 1e-9)
            return {
                "makespan_s": makespan,
                "throughput_jobs_per_s": self._n_done / makespan,
                "completed": self._n_done,
                "crashed": self._n_crashed,
                "cancelled": self._n_cancelled,
                "shed": self._n_shed,
                "preemptions": preemptions,
                "migrations": migrations,
                "mean_turnaround_s":
                    self._turnaround_sum / max(self._n_done, 1),
                "sched_attempts": attempts,
            }
