"""Discrete-event simulator for job mixes under a scheduler.

Reproduces the paper's evaluation protocol (§V-A) and doubles as the
virtual-clock backend of ``repro_torch.core.cluster.Cluster``: jobs may be
submitted at any virtual time (``submit``), the clock advances event by
event (``step`` / ``drain``), and a pool of workers each dequeue a job, run
its GPU tasks under the scheduler, and pull the next. ``run(jobs)`` is the
closed-batch compatibility wrapper (everything arrives at t=0). Task progress
follows the processor-sharing interference model (repro_torch.core.interference):
residents of an oversubscribed chip dilate by the total core demand. A gang
task (multi-chip reservation) occupies every member chip, advances at its
slowest member's rate, and is further dilated by ICI link contention when
co-resident gangs oversubscribe a shared link (``interference.ici_slowdown``
over the scheduler's link ledger).

Admission goes through the scheduler's OWN waiter queue — the same
priority/deadline-ordered wakeup path the live executor uses — so simulated
and live submissions of one trace produce the same admission order. Under a
preemptive scheduler (``repro_torch.core.scheduler.preempt``) that extends to
EVICTION order: the scheduler's preemption notices interrupt the victim's
virtual-clock run, its exact remaining work is banked in the progress
ledger, and the resumed attempt (possibly on a different device — that is
migration) runs for remaining + checkpoint penalty instead of from scratch,
so preempted work is conserved.

Crash semantics (paper Table II): a memory-oblivious scheduler (CG) may admit
a task whose footprint exceeds the device's free HBM — the job then dies with
OOM, exactly like a failed cudaMalloc. Memory-safe schedulers (SA, MGB,
schedGPU) never trigger this path.

The simulator is deterministic given (submission trace, scheduler, workers)
and is the engine behind benchmarks/fig4, fig5, table2, table3, table4, fig6.

Copy of ``src/repro/core/simulator.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import interference
from repro_torch.core.executor import NEVER_STARTED, ExecRecord
from repro_torch.core.scheduler.base import DEADLINE_SHED, Scheduler
from repro_torch.core.task import Job, Task, true_work_seconds
from repro_torch.core.topology import placement_devices
from repro_torch.obs import events as obs

_EPS = 1e-12


@dataclasses.dataclass
class SimResult:
    makespan: float
    throughput: float              # completed jobs per second
    completed: int
    crashed: int
    turnaround: Dict[str, float]   # per-job turnaround seconds
    slowdowns: Dict[str, float]    # per-KERNEL execution dilation (Table IV)
    dilations: Dict[str, float]    # per-task wall dilation incl. sharing
    device_busy: List[float]       # per-device busy seconds
    utilization: float             # mean busy fraction over makespan
    cancelled: int = 0             # jobs ended by JobHandle.cancel()
    shed: int = 0                  # parked jobs failed past their deadline
    # True iff drain() hit its time_limit with work still pending — a capped
    # run must not masquerade as a completed one (callers check this instead
    # of trusting `completed`)
    truncated: bool = False

    @property
    def mean_turnaround(self) -> float:
        vals = list(self.turnaround.values())
        return sum(vals) / len(vals) if vals else 0.0

    @property
    def mean_slowdown_pct(self) -> float:
        vals = list(self.slowdowns.values())
        return (sum(vals) / len(vals) - 1.0) * 100 if vals else 0.0


@dataclasses.dataclass
class _Running:
    task: Task
    job: "_JobState"
    remaining: float       # seconds of solo work left
    # every device of the reservation (1 entry for single-chip tasks; a
    # gang's synchronized shards advance at the SLOWEST member's rate and
    # occupy every member chip for busy accounting)
    devices: Tuple[int, ...]
    # integral of per-kernel overhead d(work): MPS interleaves at kernel
    # granularity, so an individual kernel's execution dilates only by the
    # co-residency overhead (cache/queue, interference.ETA_PER_RESIDENT);
    # the sharing factor shows up as wait time between kernels instead.
    kwork: float = 0.0

    @property
    def lead(self) -> int:
        return self.devices[0]


@dataclasses.dataclass
class _JobState:
    job: Job
    next_task: int = 0
    t_queue: float = 0.0   # virtual time the current task entered admission
    started: bool = False
    done: bool = False
    cancelled: bool = False
    cancel_requested: bool = False
    shed: bool = False     # parked past its deadline and shed at a drain
    # resolution hook, fired exactly once when the job resolves (done,
    # crashed, cancelled or shed) — the Cluster front-end maintains its
    # aggregate stats counters here instead of re-scanning every handle
    on_done: Optional[Callable[["_JobState"], None]] = None
    records: List[ExecRecord] = dataclasses.field(default_factory=list)


class Simulator:
    """Event-driven processor-sharing simulation of the worker-pool protocol
    with an open-arrival front door (``submit`` / ``step`` / ``drain``)."""

    def __init__(self, scheduler: Scheduler, *, workers: int,
                 poll_interval: float = 0.05, crash_delay: float = 8.0):
        self.sched = scheduler
        self.workers = workers
        # preemptive scheduler: observe evictions so the victim's in-flight
        # virtual run is stopped and its EXACT remaining work banked (the
        # scheduler's own estimate is residency-based and ignores dilation)
        if hasattr(scheduler, "add_preempt_listener"):
            scheduler.add_preempt_listener(self._on_preempt)
        self.poll = poll_interval  # retry cadence when no device is feasible
        # a job that dies of OOM still burned startup time (process launch,
        # data load) before the failed alloc — without this, crash cascades
        # are instantaneous and the unsafe scheduler's crash rate is inflated
        self.crash_delay = crash_delay
        self.reset()

    # -- lifecycle ----------------------------------------------------------
    def reset(self) -> None:
        """Fresh virtual clock and empty state (``run`` calls this; open-
        arrival users call it to reuse the object across traces)."""
        self.now = 0.0
        # deadline shedding (if the scheduler opts in) must judge "now" on
        # the VIRTUAL clock the deadlines were stamped with. Bound weakly:
        # a scheduler that outlives this simulator must not pin it (and its
        # records) in memory through the clock closure
        ref = weakref.ref(self)
        self.sched._clock = \
            lambda: s.now if (s := ref()) is not None else time.monotonic()
        self.records: List[ExecRecord] = []
        self._queue: List[_JobState] = []   # jobs waiting for a sim worker
        # admissions fired by the scheduler's waiter queue (the SAME wakeup
        # path the live executor uses, so sim and executor agree on placement
        # sequence): callbacks append here with their admission epoch,
        # _try_start drains and drops entries a later eviction superseded
        self._admitted_buf: List[
            Tuple[_JobState, Task, Optional[int], int]] = []
        self._blocked: Dict[int, _JobState] = {}  # task uid -> parked job
        self._jobs_by_task: Dict[int, _JobState] = {}  # uid -> owning job
        self._running: Dict[int, _Running] = {}   # task uid -> running record
        self._idle_workers = self.workers
        self._busy: List[float] = [0.0] * len(self.sched.devices)
        self._slowdowns: Dict[str, float] = {}
        self._dilations: Dict[str, float] = {}
        self._solo: Dict[int, float] = {}
        self._started_at: Dict[int, float] = {}
        self._completed = 0
        self._crashed = 0
        self._cancelled = 0
        self._shed = 0
        self._crashing: List[Tuple[float, _JobState]] = []  # (free time, job)
        self._turnaround: Dict[str, float] = {}
        self._failure_pending: Optional[Tuple[float, int]] = None
        self._truncated = False

    # -- open-arrival API ----------------------------------------------------
    def submit(self, job: Job, *, priority: Optional[int] = None,
               deadline_t: Optional[float] = None,
               on_done: Optional[Callable[[_JobState], None]] = None
               ) -> _JobState:
        """Submit ``job`` at the CURRENT virtual time — legal at any point,
        including while earlier jobs are mid-flight (call ``step`` between
        submissions to advance the clock). ``deadline_t`` is an absolute
        virtual-clock deadline; the scheduler's admission queue enforces the
        priority/EDF ordering. ``on_done`` fires exactly once when the job
        resolves (done/crashed/cancelled/shed)."""
        if priority is not None:
            job.priority = priority
        if deadline_t is not None:
            job.deadline_t = deadline_t
        for t in job.tasks:
            t.priority = job.priority
            t.deadline_t = job.deadline_t
            if t.gang_id is None:
                t.gang_id = job.gang_id
        job.arrival_t = self.now
        js = _JobState(job, on_done=on_done)
        if not job.tasks:
            # empty job: completes instantly with a zeroed record, holding no
            # worker (mirrors the live executor's empty-tasks path)
            rec = ExecRecord(job.name, "", -1, self.now, self.now, self.now)
            js.records.append(rec)
            self.records.append(rec)
            js.done = True
            job.finish_t = self.now
            self._completed += 1
            self._turnaround[job.name or str(job.uid)] = 0.0
            if js.on_done is not None:
                js.on_done(js)
            return js
        self._queue.append(js)
        self._try_start()
        return js

    def cancel(self, js: _JobState) -> bool:
        """Cancel a submitted job: a job still waiting for a worker or parked
        in the admission queue ends immediately (no scheduler state leaks); a
        running task finishes its current kernel first. True iff the job will
        end (or ended) cancelled."""
        if js.done:
            return js.cancelled
        js.cancel_requested = True
        if js in self._queue:               # never reached a worker
            self._queue.remove(js)
            self._end_cancelled(js, held_worker=False)
            return True
        idx = js.next_task
        tasks = js.job.tasks
        if idx < len(tasks):
            t = tasks[idx]
            if t.uid in self._blocked and self.sched.cancel_wait(t):
                del self._blocked[t.uid]
                self._end_cancelled(js, held_worker=True)
                return True
        # running (or admitted): the completion path honours the flag
        return True

    def step(self, limit: Optional[float] = None) -> bool:
        """Advance the virtual clock to the next event (a task completion, a
        crash reap, an injected failure, or a poll tick when everything is
        parked). With ``limit``, never advance past that virtual time —
        running work makes partial progress instead (the open-arrival
        driver's tool: submissions between events land at exact times).
        Returns False when nothing is pending."""
        if not self.pending():
            return False
        if not self._running and self._crashing:
            reap_t = min(t for t, _ in self._crashing)
            if limit is not None and reap_t > limit:
                self.now = max(self.now, limit)
                return True
            self.now = reap_t
            self._reap_crashed()
            self._try_start()
            return True
        if not self._running:
            # nothing progresses: either a failure is pending or every
            # submitted task is parked in the admission queue
            prev = self.now
            if self._failure_pending is not None \
                    and self._failure_pending[0] <= self.now + self.poll:
                self.now = max(self.now, self._failure_pending[0])
            else:
                self.now += self.poll
            if limit is not None and limit >= prev:
                self.now = min(self.now, limit)
            self._maybe_fail()
            self._try_start()
            if not self._running and self._failure_pending is None \
                    and not self._queue and not self._admitted_buf \
                    and self._blocked:
                # waiting tasks can never start (nothing running holds the
                # capacity they need): count them as crashed-at-submit to
                # avoid livelock
                tr = getattr(self.sched, "_trace", None)
                for t in self.sched.cancel_all_waiters():
                    js = self._blocked.pop(t.uid, None)
                    if js is not None:
                        js.job.crashed = True
                        js.job.finish_t = self.now
                        if tr is not None:
                            tr.emit(obs.CRASH, t.uid, t.name,
                                    data={"reason": "stuck"})
                        self._finish_job(js, crashed_job=True)
                self._blocked.clear()
                return False
            return True
        rt = self._rates()
        # next event: earliest task completion at current rates (a
        # completion's task_end IS the wakeup that re-drives admission —
        # no poll tick needed for waiters), or the injected failure
        dt = min((r.remaining / rt[uid][0]
                  for uid, r in self._running.items()),
                 default=float("inf"))
        if self._crashing:
            dt = min(dt, max(min(t for t, _ in self._crashing) - self.now,
                             0.0))
        if self._failure_pending is not None:
            dt = min(dt, max(self._failure_pending[0] - self.now, 0.0))
        dt = max(dt, _EPS)
        if limit is not None:
            # bounded step: stop AT the limit, applying partial progress
            dt = min(dt, max(limit - self.now, _EPS))
        # advance; accumulate per-kernel overhead against work done
        for uid, r in self._running.items():
            rate_t, overhead_t = rt[uid]
            work = dt * rate_t
            r.remaining -= work
            r.kwork += work * overhead_t
        for d in {d for r in self._running.values() for d in r.devices}:
            self._busy[d] += dt
        self.now += dt
        self._reap_crashed()
        self._maybe_fail()
        self._complete_finished()
        self._try_start()
        return True

    def pending(self) -> bool:
        """True while any submitted work is unresolved."""
        return bool(self._running or self._queue or self._crashing
                    or self._blocked or self._admitted_buf)

    def run_until(self, t: float) -> None:
        """Advance the virtual clock to EXACTLY ``t``, processing every event
        on the way (events never overshoot it). The open-arrival driver:
        ``submit(a); run_until(t_b); submit(b); ...`` lands each submission
        at its intended arrival time, progress interleaving in between."""
        while self.now < t - 1e-9:
            if not self.step(limit=t):
                self.now = t  # idle: nothing to process, jump the clock
                return

    def drain(self, time_limit: float = 1e7) -> "SimResult":
        """Barrier: advance the clock until every submitted job resolved
        (or ``time_limit`` virtual seconds passed); returns the result so
        far. Parked waiters that can never start are crashed, mirroring the
        closed-batch protocol. Hitting the limit with work still pending
        marks the result ``truncated`` — capped runs must not masquerade as
        completed ones, so callers check the flag (Cluster.drain raises).
        Stepping is bounded, so the clock never overshoots the limit; the
        flag describes THIS drain (a later uncapped drain that finishes the
        work reports truncated=False)."""
        self._truncated = False
        while self.pending():
            if self.now >= time_limit:
                self._truncated = True
                break
            if not self.step(limit=time_limit):
                break
        return self.result()

    def result(self) -> SimResult:
        """Metrics snapshot at the current virtual time. Safe on an empty or
        partially-drained simulation: all means are guarded against empty
        completion sets."""
        makespan = self.now
        n_dev = max(len(self._busy), 1)
        util = (sum(self._busy) / (n_dev * makespan)) if makespan > 0 else 0.0
        return SimResult(
            makespan=makespan,
            throughput=self._completed / makespan if makespan > 0 else 0.0,
            completed=self._completed, crashed=self._crashed,
            turnaround=dict(self._turnaround),
            slowdowns=dict(self._slowdowns),
            dilations=dict(self._dilations),
            device_busy=list(self._busy), utilization=util,
            cancelled=self._cancelled, shed=self._shed,
            truncated=self._truncated)

    # -- compatibility wrapper ------------------------------------------------
    def run(self, jobs: Sequence[Job], *, time_limit: float = 1e7,
            failure_at: Optional[Tuple[float, int]] = None) -> SimResult:
        """Closed-batch protocol: every job arrives at t=0, drain to the end.
        ``failure_at``: (time, device) — kill a device mid-run; its resident
        jobs' tasks re-enter the queue (fault-tolerance path)."""
        self.reset()
        self._failure_pending = failure_at
        for j in jobs:
            self.submit(j)
        return self.drain(time_limit)

    # -- engine internals -----------------------------------------------------
    def _rates(self) -> Dict[int, Tuple[float, float]]:
        """task uid -> (progress rate, per-kernel overhead factor).

        A single-chip task progresses at its device's processor-sharing rate.
        A gang's shards are synchronized, so the gang advances at its
        SLOWEST member chip's rate, further dilated by ICI contention when a
        soft-link policy let co-resident gangs oversubscribe a shared link
        (``interference.ici_slowdown`` via the scheduler's link ledger)."""
        by_dev: Dict[int, List[tuple]] = {}
        for r in self._running.values():
            res = r.task.resources
            for d in r.devices:
                by_dev.setdefault(d, []).append(
                    (res.core_demand, res.bw_demand))
        dev_rate = {d: (interference.rate(ds),
                        1.0 + interference.ETA_PER_RESIDENT * (len(ds) - 1))
                    for d, ds in by_dev.items()}
        link_pressure = getattr(self.sched, "link_pressure", None)
        out: Dict[int, Tuple[float, float]] = {}
        for uid, r in self._running.items():
            rate = min(dev_rate[d][0] for d in r.devices)
            overhead = max(dev_rate[d][1] for d in r.devices)
            if link_pressure is not None and r.task.resources.chips > 1:
                rate /= link_pressure(r.task)
            out[uid] = (rate, overhead)
        return out

    def _submit_task(self, js: _JobState) -> None:
        """Hand the job's next task to the scheduler's admission path:
        admitted now (callback fires inline) or parked in the waiter
        queue — wakeups on task_end/mark_dead/revive re-drive it."""
        task = js.job.tasks[js.next_task]
        js.t_queue = self.now
        # read at emit time (attach_tracer may run after construction);
        # submission is per-task, not the hot admission inner loop
        tr = getattr(self.sched, "_trace", None)
        if tr is not None:
            tr.emit(obs.SUBMIT, task.uid, task.name,
                    data=obs.submit_data(task, js.job.name, js.job.uid))
        if not self.sched.can_ever_fit(task):
            # never feasible (oversized footprint, or a gang shape the
            # topology cannot hold): fail fast with the scheduler's
            # explanation instead of parking forever — mirrors the live
            # executor's crash-at-submit
            js.job.crashed = True
            js.job.error = self.sched.infeasible_reason(task)
            js.job.finish_t = self.now
            if tr is not None:
                tr.emit(obs.CRASH, task.uid, task.name,
                        data={"reason": "infeasible"})
            rec = ExecRecord(js.job.name, task.name, -1, self.now,
                             NEVER_STARTED, self.now, crashed=True)
            js.records.append(rec)
            self.records.append(rec)
            self._finish_job(js, crashed_job=True)
            return
        self._blocked[task.uid] = js
        self._jobs_by_task[task.uid] = js

        def cb(t: Task, placement: Optional[int], epoch: int,
               js=js) -> None:
            self._admitted_buf.append((js, t, placement, epoch))

        self.sched.admit_or_enqueue(task, cb)

    def _on_preempt(self, victims: Sequence[Tuple[Task, int]]) -> None:
        """Preemption notice from the scheduler: stop the victims' virtual
        runs, bank their EXACT remaining work (overwriting the scheduler's
        residency-based estimate), and re-park their jobs — the banked value
        is what the resumed attempt starts from, so no completed virtual
        work is ever re-run. (The notice's superseded-epoch tag matters only
        to the multi-threaded live backend; the sim is single-threaded, so
        delivery is always timely.)"""
        for t, _epoch in victims:
            rec = self._running.pop(t.uid, None)
            if rec is not None:
                self.sched.ledger.set_remaining(t.uid, max(rec.remaining, 0.0))
            # evicted while still in the admission buffer: the stale entry is
            # dropped by _try_start's epoch check; either way the job is
            # parked again until the re-admission callback fires
            js = rec.job if rec is not None else self._jobs_by_task.get(t.uid)
            if js is not None and not js.done:
                self._blocked[t.uid] = js

    def _try_start(self) -> None:
        # workers pick jobs from the queue while any are idle
        while self._idle_workers > 0 and self._queue:
            js = self._queue.pop(0)
            self._idle_workers -= 1
            self._submit_task(js)
        # drain admissions (task_end inside this loop can fire more)
        while self._admitted_buf:
            js, task, placement, epoch = self._admitted_buf.pop(0)
            if placement is not None and placement is not DEADLINE_SHED \
                    and self.sched.admission_epoch(task) != epoch:
                # superseded between admission and start (preempted or
                # mark_dead-evicted while buffered): the resources were
                # already released and the task re-enqueued — the fresh
                # incarnation's callback owns it now
                continue
            self._blocked.pop(task.uid, None)
            if js.cancel_requested and placement is not None \
                    and placement is not DEADLINE_SHED:
                # cancelled while parked-then-admitted: release the admission
                self.sched.task_end(task)
                self._end_cancelled(js, held_worker=True)
                continue
            if placement is DEADLINE_SHED:
                # parked past its deadline: the scheduler shed it at the
                # drain — the job fails with SHED status, not CRASHED. A
                # cancel that raced the shed wins (matches the live
                # backend's _finish, where cancel_requested beats shed)
                if js.cancel_requested:
                    self._end_cancelled(js, held_worker=True)
                else:
                    self._end_shed(js)
                continue
            if placement is None:
                # mark_dead shrank the fleet below this task's needs:
                # the scheduler gave up on it — crashed at submit
                js.job.crashed = True
                js.job.error = js.job.error \
                    or self.sched.infeasible_reason(task)
                js.job.finish_t = self.now
                self._finish_job(js, crashed_job=True)
                continue
            devs = placement_devices(placement)
            # memory-unsafe scheduler: admitted past capacity on any member
            # -> OOM crash after the startup delay (worker stays occupied)
            tr = getattr(self.sched, "_trace", None)
            if any(self.sched.devices[d].oom() for d in devs):
                self.sched.task_end(task)
                js.job.crashed = True
                if tr is not None:
                    tr.emit(obs.CRASH, task.uid, task.name, devs[0],
                            data={"reason": "oom"})
                self._crashing.append((self.now + self.crash_delay, js))
                continue
            task.start_t = self.now
            js.started = True
            if tr is not None:
                tr.emit(obs.BEGIN, task.uid, task.name, devs[0], epoch)
            self._started_at[task.uid] = self.now
            # the simulated PHYSICS run ground-truth work (true_vec when a
            # drift workload supplies one, else the original probe estimate)
            # — never the calibration-corrected prediction, which must only
            # change what admission RESERVES, not what the task DOES
            work = true_work_seconds(task)
            ledger = getattr(self.sched, "ledger", None)
            if ledger is not None:
                banked = ledger.remaining_or_none(task.uid)
                if banked is not None:
                    # work-conserving resume after preemption: remaining
                    # work plus the checkpoint/restore penalty, not a
                    # from-scratch restart — migration (a different device
                    # group than last time) costs the same penalty
                    work = banked + \
                        self.sched.preempt_policy.checkpoint_penalty_s
            self._solo[task.uid] = work
            self._running[task.uid] = _Running(task, js, work, devs)

    def _drop_job_maps(self, js: _JobState) -> None:
        # a resolved job's task entries are dead weight (uids never recur)
        for t in js.job.tasks:
            self._jobs_by_task.pop(t.uid, None)

    def _finish_job(self, js: _JobState, crashed_job: bool = False) -> None:
        js.done = True
        self._drop_job_maps(js)
        if crashed_job:
            self._crashed += 1
        else:
            self._completed += 1
            js.job.finish_t = self.now
            self._turnaround[js.job.name or str(js.job.uid)] = \
                self.now - js.job.arrival_t
        self._idle_workers += 1
        if js.on_done is not None:
            js.on_done(js)

    def _end_cancelled(self, js: _JobState, *, held_worker: bool) -> None:
        js.done = True
        self._drop_job_maps(js)
        js.cancelled = True
        js.job.finish_t = self.now
        self._cancelled += 1
        if held_worker:
            self._idle_workers += 1
        if js.on_done is not None:
            js.on_done(js)

    def _end_shed(self, js: _JobState) -> None:
        # a shed waiter was parked (holding a sim worker) but never admitted
        js.done = True
        self._drop_job_maps(js)
        js.shed = True
        js.job.finish_t = self.now
        self._shed += 1
        self._idle_workers += 1
        if js.on_done is not None:
            js.on_done(js)

    def _reap_crashed(self) -> None:
        done = [(t, js) for t, js in self._crashing if t <= self.now + _EPS]
        self._crashing = [(t, js) for t, js in self._crashing
                          if t > self.now + _EPS]
        for _, js in done:
            js.job.finish_t = self.now
            self._finish_job(js, crashed_job=True)

    def _maybe_fail(self) -> None:
        if self._failure_pending is None \
                or self.now < self._failure_pending[0] - _EPS:
            return
        _, dead = self._failure_pending
        self._failure_pending = None
        self._fail_device(dead)

    def _fail_device(self, dead) -> None:
        # mark_dead re-enqueues evicted tasks through the waiter queue with
        # eviction-restart priority; their admission callback may already
        # have fired onto a surviving device (admitted_buf)
        evicted = self.sched.mark_dead(dead)
        for t in evicted:
            rec = self._running.pop(t.uid, None)
            if rec is not None:
                # restart from scratch on another device (task-level
                # checkpoint/restart is the executor's job)
                self._blocked.setdefault(t.uid, rec.job)

    def inject_failure(self, device) -> None:
        """Kill ``device`` at the CURRENT virtual time — the external
        fault-injection hook (``obs.whatif`` replays recorded MARK_DEAD
        events through this; unlike ``_failure_pending`` it supports any
        number of deaths per run). Same semantics as the scheduled path:
        residents are evicted, stop progressing, and re-park."""
        self._fail_device(device)
        self._try_start()

    def revive_device(self, device) -> None:
        """Bring ``device`` back at the current virtual time (the REVIVE
        counterpart of ``inject_failure``)."""
        self.sched.revive(device)
        self._try_start()

    def _complete_finished(self) -> None:
        done = [uid for uid, r in self._running.items()
                if r.remaining <= 1e-9]
        for uid in done:
            # the FIRST completion's task_end re-drives admission, which can
            # preempt a co-completing resident before ITS task_end runs —
            # the eviction notice already removed it from _running and
            # re-parked it (it resumes for its ~zero banked remainder plus
            # the restore penalty), so it is simply no longer ours to end
            rec = self._running.pop(uid, None)
            if rec is None:
                continue
            self.sched.task_end(rec.task)
            rec.task.finish_t = self.now
            dur = self.now - self._started_at[uid]
            if self._solo[uid] > 0:
                key = rec.task.name or str(uid)
                self._dilations[key] = dur / self._solo[uid]
                self._slowdowns[key] = rec.kwork / self._solo[uid]
            js = rec.job
            record = ExecRecord(js.job.name, rec.task.name, rec.lead,
                                js.t_queue, self._started_at[uid], self.now,
                                gang_chips=len(rec.devices))
            js.records.append(record)
            self.records.append(record)
            if js.cancel_requested:
                self._end_cancelled(js, held_worker=True)
                continue
            js.next_task += 1
            if js.next_task >= len(js.job.tasks):
                self._finish_job(js)
            else:
                self._submit_task(js)
