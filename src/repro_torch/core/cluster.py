"""Open-arrival submission front-end: the ``Cluster`` object jobs arrive at.

Port of ``src/repro/core/cluster.py``, live backend only. The paper's
scheduler is a daemon — probes submit tasks whenever a process reaches a
launch point. ``submit`` may be called at any time (including while earlier
jobs are mid-flight) and returns a future-like ``JobHandle``; ``drain`` is
the barrier; ``shutdown`` tears the engine down.

    cluster = Cluster(MGBAlg3Scheduler(1, hbm_per_device=...), workers=1)
    h = cluster.submit(ej, priority=5, deadline_s=2.0)
    recs = h.result(timeout=30)    # per-task ExecRecords
    cluster.drain()

Admission goes through the scheduler's own priority/deadline waiter queue:
higher ``priority`` first, EDF within a class, arrival order last. With
``shed_late=True`` a job still parked when its deadline passes is failed with
``JobStatus.SHED``. The simulator backend, preemption, tracing, explain,
calibration and profiling come in later slices.
"""
from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

from repro_torch.core.executor import ExecJob, ExecRecord, Executor, _JobRun
from repro_torch.core.scheduler.base import Scheduler
from repro_torch.core.task import Job


class JobStatus(enum.Enum):
    QUEUED = "queued"        # submitted, not yet executing
    RUNNING = "running"      # at least one task started
    DONE = "done"            # all tasks completed
    CRASHED = "crashed"      # OOM / runner exception / never feasible
    CANCELLED = "cancelled"  # ended by JobHandle.cancel()
    SHED = "shed"            # parked past its deadline, failed at a drain


class JobHandle:
    """Future-like view of one submitted job."""

    def __init__(self, executor: Executor, job: Job, state: _JobRun):
        self._ex = executor
        self.job = job
        self._state = state

    @property
    def status(self) -> JobStatus:
        s = self._state
        if s.done.is_set():
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
        """Per-task execution records accumulated so far."""
        return list(self._state.records)

    def result(self, timeout: Optional[float] = None) -> List[ExecRecord]:
        """Wait up to ``timeout`` wall seconds for the job to resolve
        (``TimeoutError`` on expiry); returns its ``ExecRecord`` list."""
        if not self._state.done.wait(timeout):
            raise TimeoutError(f"job {self.job.name!r} still "
                               f"{self.status.value} after {timeout}s")
        return self.records

    def cancel(self) -> bool:
        """Cancel the job; False iff it had already finished."""
        return self._ex.cancel(self._state)


class Cluster:
    """The open-arrival submission surface over a scheduler and the live
    executor. ``devices`` is the executor's device table (default: every
    CUDA card)."""

    def __init__(self, scheduler: Scheduler, *, workers: Optional[int] = None,
                 devices: Optional[Sequence[object]] = None,
                 shed_late: bool = False):
        self.sched = scheduler
        # the reference's backend switch; the port has the live one only
        self.backend = "live"
        scheduler.shed_expired = shed_late
        scheduler._clock = time.monotonic
        n_workers = workers if workers is not None \
            else len(scheduler.devices)
        self._ex = Executor(scheduler, workers=n_workers, devices=devices)
        self.handles: List[JobHandle] = []
        self._attempts0 = getattr(scheduler, "begin_attempts", 0)
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
        """Submit ``job`` now (an ``ExecJob``, or a ``Job`` plus
        ``runners``). ``priority`` (higher first) and ``deadline_s``
        (seconds from now; EDF within a class) rank it in the admission
        queue. ``on_done(handle)`` fires once when the job resolves, on a
        backend thread."""
        done_cb = self._on_job_resolved if on_done is None \
            else self._chain_on_done(on_done)
        with self._submit_lock:
            ej = self._as_execjob(job, runners)
            deadline_t = (time.monotonic() + deadline_s
                          if deadline_s is not None else None)
            state = self._ex.submit(ej, priority=priority,
                                    deadline_t=deadline_t, on_done=done_cb)
            handle = JobHandle(self._ex, ej.job, state)
            with self._stats_lock:
                self._n_jobs += 1
                self._t0 = min(self._t0, handle.job.arrival_t)
            self.handles.append(handle)
            return handle

    def _chain_on_done(self, user_cb: Callable[["JobHandle"], None]
                       ) -> Callable[[_JobRun], None]:
        def cb(state: _JobRun) -> None:
            self._on_job_resolved(state)
            user_cb(JobHandle(self._ex, state.ej.job, state))
        return cb

    def _on_job_resolved(self, state: _JobRun) -> None:
        """Fold the job's terminal status into the aggregate counters:
        cancel beats shed beats crash beats done."""
        job = state.ej.job
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

    # -- barriers ------------------------------------------------------------
    def drain(self) -> None:
        """Block until every job submitted so far has resolved."""
        self._ex.drain()

    @property
    def now(self) -> float:
        """Current time on the backend's clock (the live one: monotonic
        wall seconds)."""
        return time.monotonic()

    def shutdown(self) -> None:
        """Drain, then stop the execution pool. The next ``submit``
        restarts it."""
        self._ex.shutdown()

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- metrics -------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Aggregate metrics over every job submitted so far (wall
        seconds), read from maintained counters."""
        with self._stats_lock:
            attempts = getattr(self.sched, "begin_attempts", 0) \
                - self._attempts0
            if not self._n_jobs:
                return {"makespan_s": 0.0, "throughput_jobs_per_s": 0.0,
                        "completed": 0, "crashed": 0, "cancelled": 0,
                        "shed": 0, "mean_turnaround_s": 0.0,
                        "sched_attempts": attempts}
            t1 = self._t1 if self._t1 > float("-inf") else self._t0
            makespan = max(t1 - self._t0, 1e-9)
            return {
                "makespan_s": makespan,
                "throughput_jobs_per_s": self._n_done / makespan,
                "completed": self._n_done,
                "crashed": self._n_crashed,
                "cancelled": self._n_cancelled,
                "shed": self._n_shed,
                "mean_turnaround_s":
                    self._turnaround_sum / max(self._n_done, 1),
                "sched_attempts": attempts,
            }
