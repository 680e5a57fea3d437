"""Live executor: an event-driven engine running real PyTorch computations
under a scheduler — the end-to-end path probe -> admit/enqueue -> wakeup ->
lazy bind -> launch -> release (paper §IV prototype).

Port of ``src/repro/core/executor.py``: the event-driven ``Executor`` with
its cooperative preemption surface, and ``PollingExecutor``, the baseline
that spins ``task_begin``. Engine shape, as in the reference:

  * **open arrival**: ``submit(ej)`` may be called at any time, including
    while earlier jobs are mid-flight;
  * a blocked task holds NO thread: it waits in the scheduler's
    priority/deadline admission queue (``admit_or_enqueue``);
  * every ``task_end`` re-drives admission (the paper's *notify*), and the
    admission callback hands (task, placement) to a **bounded execution
    pool** sized to the device count, not the job count;
  * ``drain()`` is the barrier, ``shutdown()`` tears the pool down.

What PyTorch changes:

  * **device table**: the caller's ``devices`` (the tests pass the CPU), or
    ``torch.device("cuda", i)`` for every card. With no card and no devices
    given it raises; it never falls back to the CPU on its own. Scheduler
    devices map round-robin onto that table.
  * **streams**: PyTorch launches asynchronously. Each pool thread runs its
    tasks on its own ``torch.cuda.Stream`` (the current stream is per
    thread), so tasks sharing a card overlap, and the executor synchronises
    that stream before ``task_end``: the reservation is released only after
    the task's kernels have finished.
  * **failures**: a runner's exception (a kernel that fails to build or
    launch, ``torch.cuda.OutOfMemoryError``) crashes the job with a record,
    and its repr is kept in ``job.error``;
  * **the eviction fence** (ROADMAP C14): under a preemptive scheduler an
    eviction releases the victim's reservation in the scheduler's ledger at
    once, while the victim's runner is still running on its own stream and
    holds its tensors until it notices ``ExecJob.preempted`` and returns.
    The reference lets the preemptor begin meanwhile; on a card that is an
    out-of-memory crash. Here an attempt whose epoch was superseded while
    it ran stays registered on its devices until its runner has returned
    and its stream is synchronised, and no attempt begins on a device that
    holds such an attempt: ``_execute`` waits for it between DISPATCH and
    BEGIN. Only BEGIN times move; admissions and evictions are the
    scheduler's, as in the reference. When the evicted attempt exits on a
    card, the executor returns the blocks it freed, which sit in its own
    stream's pool of the caching allocator, to the device
    (``torch.cuda.empty_cache``) before the fence opens: the allocator
    hands one stream's cached blocks to another only after a failed
    ``cudaMalloc`` and a retry that synchronises the device, in the middle
    of the preemptor's first allocation.
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import lazy
from repro_torch.core.scheduler.base import DEADLINE_SHED, Scheduler
from repro_torch.core.task import Job, Task
from repro_torch.core.topology import placement_devices
from repro_torch.obs import events as obs


class OOMError(RuntimeError):
    """Raised when an admitted task exceeds its device's memory (CG path)."""


# ``ExecRecord.t_start`` sentinel: the task crashed BEFORE its kernel ever
# launched. Check ``rec.started``, not ``rec.crashed``.
NEVER_STARTED = -1.0


@dataclasses.dataclass
class ExecRecord:
    job: str
    task: str
    device: int          # lead device of the placement (-1 = never placed)
    t_queue: float
    t_start: float       # NEVER_STARTED if the task crashed pre-launch
    t_end: float
    crashed: bool = False
    gang_chips: int = 1

    @property
    def started(self) -> bool:
        """True iff the task actually began executing."""
        return self.t_start >= 0.0


@dataclasses.dataclass
class ExecJob:
    """A live job: ordered (task, runner) pairs. ``runner(device)`` executes
    the task's computation after the lazy buffers are bound to ``device``."""
    job: Job
    runners: List[Callable[[object], None]]
    buffers: Dict[str, lazy.LazyBuffer] = dataclasses.field(default_factory=dict)
    # cooperative preemption surface (used only under a preemptive
    # scheduler): ``preempted`` is SET when the scheduler evicts this job's
    # in-flight task and CLEARED at each (re)dispatch; a cooperative runner
    # checks it between steps and returns early (the eviction already
    # released the reservation and the epoch fence voids this attempt's
    # completion). ``on_preempt`` (optional) fires once per eviction with
    # the evicted Task, on the thread that delivers the scheduler's notice,
    # while the runner may still be running: it must not touch the runner's
    # tensors. A training runner saves its checkpoint itself when it sees
    # ``preempted`` (``launch.train``).
    preempted: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    on_preempt: Optional[Callable[[Task], None]] = None


def _empty_stats() -> Dict[str, float]:
    return {"makespan_s": 0.0, "throughput_jobs_per_s": 0.0,
            "completed": 0, "crashed": 0, "mean_turnaround_s": 0.0,
            "sched_attempts": 0}


def default_devices() -> List[torch.device]:
    """Every CUDA card; raises when there is none (no silent CPU fallback)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=[torch.device('cpu')] "
                           "to run the executor on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass
class _JobRun:
    """Dispatcher-side job state plus the lifecycle bits ``JobHandle``
    observes."""
    ej: ExecJob
    next_task: int = 0
    t_queue: float = 0.0
    started: bool = False
    cancel_requested: bool = False
    cancelled: bool = False
    shed: bool = False      # parked past its deadline and shed at a drain
    on_done: Optional[Callable[["_JobRun"], None]] = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    records: List[ExecRecord] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Ready:
    """An admitted task waiting for an execution-pool thread."""
    jr: _JobRun
    task_idx: int
    placement: object
    epoch: int


class Executor:
    """Event-driven executor: open-arrival submission, admission wakeups,
    bounded execution pool."""

    def __init__(self, scheduler: Scheduler, *, workers: int,
                 devices: Optional[Sequence[object]] = None,
                 poll_interval: float = 0.002):
        self.sched = scheduler
        self.workers = workers
        self.poll = poll_interval  # PollingExecutor's retry interval
        n = len(scheduler.devices)
        real = [torch.device(d) for d in devices] if devices is not None \
            else default_devices()
        self.device_map = [real[i % len(real)] for i in range(n)]
        self.records: List[ExecRecord] = []
        self._rec_lock = threading.Lock()
        self._jr_by_uid: Dict[int, _JobRun] = {}
        # a re-dispatched incarnation (after an eviction or mark_dead) must
        # not run concurrently with its superseded attempt: they share
        # buffers and the one ``preempted`` event
        self._attempt_locks: Dict[int, threading.Lock] = {}
        # uid -> epoch of the attempt armed on ExecJob.preempted, guarded by
        # _signal_lock: a notice older than the armed attempt is dropped, or
        # it would stop the fresh attempt and turn its early return into a
        # current-epoch completion
        self._armed_epoch: Dict[int, int] = {}
        self._signal_lock = threading.Lock()
        # the eviction fence: scheduler device -> {uid: (task, epoch)} of
        # the attempts inside their runner there. An attempt whose epoch is no
        # longer its task's admission epoch was evicted and still holds its
        # memory; nothing begins on its devices until it has left
        self._fence = threading.Condition()
        self._inside: Dict[int, Dict[int, tuple]] = {}
        if hasattr(scheduler, "add_preempt_listener"):
            scheduler.add_preempt_listener(self._on_preempt)
        self._ready: Optional["queue_mod.Queue[Optional[_Ready]]"] = None
        self._threads: List[threading.Thread] = []
        self._running = False
        self._lifecycle = threading.Lock()     # guards start/shutdown
        self._state = threading.Condition()    # guards _inflight
        self._inflight = 0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Spin up the execution pool; idempotent (``submit`` auto-starts)."""
        with self._lifecycle:
            self._start_locked()

    def _start_locked(self) -> None:
        if self._running:
            return
        self._ready = queue_mod.Queue()
        self._threads = [threading.Thread(target=self._pool_worker,
                                          daemon=True)
                         for _ in range(self.workers)]
        for t in self._threads:
            t.start()
        self._running = True

    def drain(self) -> None:
        """Barrier: block until every job submitted so far has resolved."""
        with self._state:
            while self._inflight:
                self._state.wait()

    def shutdown(self) -> None:
        """Drain, then stop the pool threads. ``submit`` restarts it."""
        while True:
            self.drain()
            with self._lifecycle:
                if not self._running:
                    return
                with self._state:
                    if self._inflight:
                        continue  # a submit raced the drain: wait again
                for _ in self._threads:
                    self._ready.put(None)
                for t in self._threads:
                    t.join()
                self._threads = []
                self._running = False
                return

    # -- open-arrival API ----------------------------------------------------
    def submit(self, ej: ExecJob, *, priority: Optional[int] = None,
               deadline_t: Optional[float] = None,
               on_done: Optional[Callable[[_JobRun], None]] = None
               ) -> _JobRun:
        """Enter ``ej`` into the admission path now. ``priority`` /
        ``deadline_t`` stamp every task of the job (None keeps stamps
        already on the job)."""
        job = ej.job
        if priority is not None:
            job.priority = priority
        if deadline_t is not None:
            job.deadline_t = deadline_t
        for t in job.tasks:
            t.priority = job.priority
            t.deadline_t = job.deadline_t
            if t.gang_id is None:
                t.gang_id = job.gang_id
        jr = _JobRun(ej, on_done=on_done)
        job.arrival_t = time.monotonic()
        with self._lifecycle:
            self._start_locked()
            with self._state:
                self._inflight += 1
        if not job.tasks:
            now = time.monotonic()
            self._record(jr, ExecRecord(job.name, "", -1, now, now, now))
            self._finish(jr, crashed=False)
        else:
            self._submit_next(jr)
        return jr

    def cancel(self, jr: _JobRun) -> bool:
        """Cancel: a parked waiter leaves the admission queue at once; a
        running task finishes, then the job stops. False iff the job had
        already finished."""
        with self._state:
            if jr.done.is_set():
                return jr.cancelled
            jr.cancel_requested = True
        idx = jr.next_task
        tasks = jr.ej.job.tasks
        if idx < len(tasks) and self.sched.cancel_wait(tasks[idx]):
            self._finish(jr, crashed=False, cancelled=True)
        return True

    # -- compatibility shim ---------------------------------------------------
    def run(self, jobs: Sequence[ExecJob]) -> Dict[str, float]:
        """Closed-batch protocol: submit every job in the order given,
        drain, report."""
        if not jobs:
            return _empty_stats()
        attempts0 = getattr(self.sched, "begin_attempts", 0)
        self.start()
        for ej in jobs:
            self.submit(ej)
        self.drain()
        self.shutdown()
        return self._stats(jobs, attempts0)

    # -- engine internals -----------------------------------------------------
    def _record(self, jr: _JobRun, rec: ExecRecord) -> None:
        with self._rec_lock:
            self.records.append(rec)
            jr.records.append(rec)

    def _finish(self, jr: _JobRun, *, crashed: bool,
                cancelled: bool = False, shed: bool = False) -> None:
        for t in jr.ej.job.tasks:
            self._jr_by_uid.pop(t.uid, None)
            self._attempt_locks.pop(t.uid, None)
            self._armed_epoch.pop(t.uid, None)
        with self._state:
            if jr.done.is_set():
                return  # double-finish guard (cancel raced a completion)
            if jr.cancel_requested and not crashed:
                cancelled = True
            jr.ej.job.crashed = jr.ej.job.crashed or crashed
            jr.cancelled = cancelled
            jr.shed = shed and not cancelled
            jr.ej.job.finish_t = time.monotonic()
            jr.done.set()
            self._inflight -= 1
            if self._inflight == 0:
                self._state.notify_all()
        lazy.free_all(jr.ej.buffers)
        # fires once; dropping it breaks the job -> callback -> cluster ->
        # handles -> job cycle, so a finished run frees its tensors at once
        on_done, jr.on_done = jr.on_done, None
        if on_done is not None:
            on_done(jr)

    def _on_preempt(self, victims) -> None:
        """Eviction notice from the scheduler: signal the running attempt to
        stop cooperatively and call the job's ``on_preempt``. Each notice
        names the victim's superseded epoch; a notice that arrives after a
        fresh attempt has armed itself with a newer epoch is dropped. The
        superseded attempt's ``task_end`` is epoch-fenced either way."""
        for t, epoch in victims:
            jr = self._jr_by_uid.get(t.uid)
            if jr is None:
                continue
            with self._signal_lock:
                stale = self._armed_epoch.get(t.uid, -1) > epoch
                if not stale:
                    jr.ej.preempted.set()
            if not stale and jr.ej.on_preempt is not None:
                try:
                    jr.ej.on_preempt(t)
                except Exception:
                    # a failing callback must not poison the scheduler's
                    # notify path; the task restarts from its last
                    # committed state
                    pass

    # -- the eviction fence ----------------------------------------------------
    def _evicted_on(self, devs) -> bool:
        """Whether an evicted attempt is still inside its runner on any of
        ``devs`` (call under ``_fence``)."""
        return any(self.sched.admission_epoch(t) != e
                   for d in devs for t, e in self._inside.get(d, {}).values())

    def _enter(self, task: Task, epoch: int, devs) -> bool:
        """Register this attempt on its devices once no evicted attempt is
        left there; False (nothing registered) if the attempt itself was
        superseded meanwhile. The epoch check and the registration are one
        step under ``_fence``, so an eviction either voids this attempt
        before it registers or finds it registered, and then whatever was
        admitted into its memory waits for it here."""
        with self._fence:
            while True:
                if self.sched.admission_epoch(task) != epoch:
                    return False
                if not self._evicted_on(devs):
                    break
                self._fence.wait()
            for d in devs:
                self._inside.setdefault(d, {})[task.uid] = (task, epoch)
            return True

    def _leave(self, task: Task, epoch: int, devs,
               device: torch.device) -> None:
        """Deregister an attempt whose runner has returned (its stream is
        synchronised). An evicted one first gives the blocks it freed back
        to the device, then opens the fence."""
        if (device.type == "cuda"
                and self.sched.admission_epoch(task) != epoch):
            with torch.cuda.device(device):
                torch.cuda.empty_cache()
        with self._fence:
            for d in devs:
                self._inside.get(d, {}).pop(task.uid, None)
            self._fence.notify_all()

    def _submit_next(self, jr: _JobRun) -> None:
        if jr.cancel_requested:
            self._finish(jr, crashed=False, cancelled=True)
            return
        idx = jr.next_task
        task = jr.ej.job.tasks[idx]
        self._jr_by_uid[task.uid] = jr
        jr.t_queue = time.monotonic()
        tr = getattr(self.sched, "_trace", None)
        if tr is not None:
            tr.emit(obs.SUBMIT, task.uid, task.name,
                    data=obs.submit_data(task, jr.ej.job.name,
                                         jr.ej.job.uid))
        if not self.sched.can_ever_fit(task):
            # never feasible on any alive device: crash at submit with the
            # scheduler's explanation instead of waiting forever
            jr.ej.job.error = self.sched.infeasible_reason(task)
            if tr is not None:
                tr.emit(obs.CRASH, task.uid, task.name,
                        data={"reason": "infeasible"})
            self._record(jr, ExecRecord(
                jr.ej.job.name, task.name, -1, jr.t_queue, NEVER_STARTED,
                time.monotonic(), crashed=True))
            self._finish(jr, crashed=True)
            return

        def on_admit(t: Task, placement, epoch: int,
                     jr=jr, idx=idx) -> None:
            # placement None: the fleet shrank to where this task can never
            # run; DEADLINE_SHED: the parked waiter passed its deadline
            if placement is DEADLINE_SHED:
                self._finish(jr, crashed=False, shed=True)
                return
            if placement is None:
                jr.ej.job.error = self.sched.infeasible_reason(t)
                self._record(jr, ExecRecord(
                    jr.ej.job.name, t.name, -1, jr.t_queue, NEVER_STARTED,
                    time.monotonic(), crashed=True))
                self._finish(jr, crashed=True)
                return
            self._ready.put(_Ready(jr, idx, placement, epoch))

        self.sched.admit_or_enqueue(task, on_admit)

    def _run_on_device(self, runner: Callable, bound, device: torch.device,
                       streams: Dict[torch.device, "torch.cuda.Stream"]
                       ) -> None:
        """Run ``runner(bound)`` on this pool thread's own stream of
        ``device`` and wait for the stream, so the task's kernels are done
        before its reservation is released."""
        if device.type != "cuda":
            runner(bound)
            return
        stream = streams.get(device)
        if stream is None:
            stream = streams[device] = torch.cuda.Stream(device)
        try:
            with torch.cuda.device(device), torch.cuda.stream(stream):
                runner(bound)
        finally:
            # a failed runner's queued kernels must finish before its
            # reservation is released too
            stream.synchronize()

    def _execute(self, item: _Ready, streams) -> None:
        jr, task = item.jr, item.jr.ej.job.tasks[item.task_idx]
        devs = placement_devices(item.placement)
        lead = devs[0]
        # evicted while queued for the pool (device died): the re-admitted
        # incarnation owns this task now — drop the stale work item
        if self.sched.admission_epoch(task) != item.epoch:
            return
        tr = getattr(self.sched, "_trace", None)
        if tr is not None:
            tr.emit(obs.DISPATCH, task.uid, task.name, lead, item.epoch,
                    data={"chips": len(devs)})
        if jr.cancel_requested:
            if self.sched.task_end(task, epoch=item.epoch):
                self._finish(jr, crashed=False, cancelled=True)
            return
        # a memory-unsafe scheduler may have oversubscribed: OOM crash if
        # ANY member device of the group is past capacity
        if any(self.sched.devices[d].oom() for d in devs):
            if not self.sched.task_end(task, epoch=item.epoch):
                return
            if tr is not None:
                tr.emit(obs.CRASH, task.uid, task.name, lead, item.epoch,
                        data={"reason": "oom"})
            self._record(jr, ExecRecord(
                jr.ej.job.name, task.name, lead, jr.t_queue, NEVER_STARTED,
                time.monotonic(), crashed=True, gang_chips=len(devs)))
            self._finish(jr, crashed=True)
            return
        if task.uid not in self._jr_by_uid:
            return  # job already resolved: stale straggler dispatch
        # serialise with any still-running superseded attempt of this task,
        # then arm the cooperative-preemption surface: clear first, then
        # re-check the epoch (in _enter). An eviction racing this dispatch
        # lands on one side or the other: before the re-check its epoch
        # bump voids this attempt; after it, the notice finds the cleared
        # event and stops the runner below
        lock = self._attempt_locks.setdefault(task.uid, threading.Lock())
        crashed = False
        t_start = None
        device = self.device_map[lead]
        with lock:
            with self._signal_lock:
                jr.ej.preempted.clear()
                self._armed_epoch[task.uid] = item.epoch
            # the fence: wait out every evicted attempt on these devices
            if self._enter(task, item.epoch, devs):
                t_start = time.monotonic()
                task.start_t = t_start
                jr.started = True
                if tr is not None:
                    tr.emit(obs.BEGIN, task.uid, task.name, lead,
                            item.epoch)
                try:
                    lazy.kernel_launch_prepare(jr.ej.buffers, device)
                    bound = (device if len(devs) == 1
                             else [self.device_map[d] for d in devs])
                    self._run_on_device(jr.ej.runners[item.task_idx], bound,
                                        device, streams)
                except Exception as e:  # the runner's failure is the job's
                    crashed = True
                    jr.ej.job.error = f"{task.name}: {e!r}"
                finally:
                    self._leave(task, item.epoch, devs, device)
        if t_start is None:
            # superseded between pool pickup and BEGIN; if the fresh
            # incarnation meanwhile finished the job, reap what _finish
            # could no longer see
            if jr.done.is_set():
                self._attempt_locks.pop(task.uid, None)
                self._armed_epoch.pop(task.uid, None)
            return
        # epoch fence: a completion of a task evicted mid-run (device died)
        # is stale; the fresh incarnation owns the job's progress
        if not self.sched.task_end(task, epoch=item.epoch):
            return
        if crashed:
            if tr is not None:
                tr.emit(obs.CRASH, task.uid, task.name, lead, item.epoch,
                        data={"reason": "runner"})
            self._record(jr, ExecRecord(
                jr.ej.job.name, task.name, lead, jr.t_queue, t_start,
                time.monotonic(), crashed=True, gang_chips=len(devs)))
            self._finish(jr, crashed=True)
            return
        self._record(jr, ExecRecord(
            jr.ej.job.name, task.name, lead, jr.t_queue, t_start,
            time.monotonic(), gang_chips=len(devs)))
        jr.next_task += 1
        if jr.next_task >= len(jr.ej.job.tasks):
            self._finish(jr, crashed=False)
        else:
            self._submit_next(jr)

    def _pool_worker(self) -> None:
        streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        while True:
            item = self._ready.get()
            if item is None:
                return
            self._execute(item, streams)

    def _stats(self, jobs: Sequence[ExecJob], attempts0: int
               ) -> Dict[str, float]:
        done = [j.job for j in jobs if not j.job.crashed]
        t0 = min(j.job.arrival_t for j in jobs)
        t1 = max(j.job.finish_t for j in jobs)
        makespan = max(t1 - t0, 1e-9)
        return {
            "makespan_s": makespan,
            "throughput_jobs_per_s": len(done) / makespan,
            "completed": len(done),
            "crashed": sum(1 for j in jobs if j.job.crashed),
            "mean_turnaround_s": sum(
                j.job.finish_t - j.job.arrival_t for j in jobs
                if not j.job.crashed) / max(len(done), 1),
            "sched_attempts":
                getattr(self.sched, "begin_attempts", 0) - attempts0,
        }


class PollingExecutor(Executor):
    """The previous protocol: one worker thread per in-flight job, each
    spinning ``task_begin`` in a sleep(poll) retry loop. Kept as the baseline
    the event-driven engine is measured against: concurrency is capped at
    ``workers`` and blocked jobs burn a thread and poll attempts each. Each
    worker thread runs its tasks on its own stream, synchronised before
    ``task_end``, as the event-driven pool does."""

    def run(self, jobs: Sequence[ExecJob]) -> Dict[str, float]:
        if not jobs:
            return _empty_stats()
        attempts0 = getattr(self.sched, "begin_attempts", 0)
        q: "queue_mod.Queue[ExecJob]" = queue_mod.Queue()
        for j in jobs:
            j.job.arrival_t = time.monotonic()
            q.put(j)

        def worker(_wid: int) -> None:
            streams: Dict[torch.device, "torch.cuda.Stream"] = {}
            while True:
                try:
                    ej = q.get_nowait()
                except queue_mod.Empty:
                    return
                try:
                    self._run_job(ej, streams)
                except OOMError:
                    ej.job.crashed = True
                finally:
                    lazy.free_all(ej.buffers)  # crash paths must free too
                ej.job.finish_t = time.monotonic()

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(self.workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return self._stats(jobs, attempts0)

    def _run_job(self, ej: ExecJob, streams) -> None:
        for task, runner in zip(ej.job.tasks, ej.runners):
            t_queue = time.monotonic()
            # probe -> scheduler (task_begin), retry while infeasible
            placement = self.sched.task_begin(task)
            while placement is None:
                if not self.sched.can_ever_fit(task):
                    raise OOMError(f"{task.name}: never feasible")
                time.sleep(self.poll)
                placement = self.sched.task_begin(task)
            devs = placement_devices(placement)
            lead = devs[0]
            # a memory-unsafe scheduler may have oversubscribed: OOM crash
            if any(self.sched.devices[d].oom() for d in devs):
                self.sched.task_end(task)
                with self._rec_lock:
                    self.records.append(ExecRecord(
                        ej.job.name, task.name, lead, t_queue,
                        NEVER_STARTED, time.monotonic(), crashed=True,
                        gang_chips=len(devs)))
                raise OOMError(
                    f"{task.name}: {task.resources.hbm_bytes} B exceeded "
                    f"device {lead} capacity")
            t_start = time.monotonic()
            device = self.device_map[lead]
            try:
                lazy.kernel_launch_prepare(ej.buffers, device)
                bound = (device if len(devs) == 1
                         else [self.device_map[d] for d in devs])
                self._run_on_device(runner, bound, device, streams)
            finally:
                self.sched.task_end(task)
            with self._rec_lock:
                self.records.append(ExecRecord(
                    ej.job.name, task.name, lead, t_queue, t_start,
                    time.monotonic(), gang_chips=len(devs)))
