"""Preemptive scheduling layer: checkpoint-based eviction of running work.

``PreemptionMixin`` upgrades any waiter-queue scheduler (the flat MGB
policies) — and ``GangPreemptionMixin`` the gang scheduler — from
admission-only to preemptive: when a waiter strictly outranks a resident
(priority class desc, EDF within a class — ``repro_torch.core.preemption.outranks``)
and cannot be admitted from free capacity, the scheduler selects a
**min-cost victim set** (cost = remaining work x held memory), evicts it,
and admits the waiter in its place. The hook rides the existing admission
paths (``admit_or_enqueue`` for urgent arrivals, the ``_drain_locked`` scan
for parked waiters whose victims matured), so both backends replay identical
eviction decisions from one submission trace.

Eviction reuses the waiter-queue substrate end to end:

  * victims re-enter the admission queue at the **front of their priority
    class** (the eviction-restart path device failures already use) with
    their epoch bumped, so the superseded run's ``task_end`` is a fenced
    no-op;
  * each victim's **remaining work is banked** in the progress ledger —
    the simulator resumes it at remaining + checkpoint penalty (work
    conserving), and because re-admission goes through normal placement,
    a victim resuming on a *different* device IS live migration (counted
    in ``migrations``);
  * a **gang is evicted whole or not at all** — eviction releases its
    entire reservation (all member chips and link charges) through the
    gang scheduler's atomic-release path, so partial reservations never
    exist even mid-preemption;
  * guardrails (``PreemptionPolicy``): ``min_runtime_s`` residency before
    a task is preemptible, a per-job eviction ``budget`` after which it is
    immune, and ``aging_step`` priority escalation per eviction so
    repeatedly-bumped low-priority work eventually outranks its bullies.

Victim selection is greedy cheapest-first per device (per candidate group
for gangs): trial-evict in increasing cost order until the waiter's own
feasibility predicate passes, roll the trial back exactly, and commit the
cheapest feasible plan found. Trial + rollback run under the scheduler lock,
so concurrent admissions never observe a half-evicted fleet.

Copy of ``src/repro/core/scheduler/preempt.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.preemption import (
    PreemptionPolicy, ProgressLedger, outranks, preemption_cost,
    remaining_estimate,
)
from repro_torch.core.scheduler.gang import GangScheduler
from repro_torch.core.scheduler.mgb import MGBAlg2Scheduler, MGBAlg3Scheduler
from repro_torch.core.scheduler.base import slots_needed
from repro_torch.core.task import Task
from repro_torch.obs import events as obs
from repro_torch.obs import explain as obsx

# a preemption notice batch: (evicted task, its SUPERSEDED admission epoch)
# in eviction order. The epoch lets a backend reject a late-delivered notice
# whose victim has already been re-admitted and re-armed — without it, a
# stale notice could stop the fresh attempt and turn its early return into
# a current-epoch (i.e. real) completion.
PreemptListener = Callable[[List[Tuple[Task, int]]], None]


class PreemptionMixin:
    """Adds `_preempt_admit_locked` (the base-class hook) over any flat
    ``Scheduler`` host. Host contract: ``self.devices`` / ``device_feasible``
    (victim planning), ``self._lock`` / ``_clock`` / ``_admit_cbs`` /
    ``_requeue_evicted_locked`` (the waiter-queue substrate).

    ``preempt_policy=`` names the knob bundle (``preempt_`` prefix because
    the gang host already uses ``policy=`` for its alg2/alg3 compute
    policy). Constructing a preemptive class enables preemption;
    ``Cluster(preempt=...)`` can override either way.
    """

    def __init__(self, *args, preempt_policy: Optional[PreemptionPolicy] = None,
                 **kw):
        super().__init__(*args, **kw)
        self.preempt_policy = preempt_policy or PreemptionPolicy()
        self.ledger = ProgressLedger()
        self.preempt_enabled = True
        self.preemptions = 0          # committed evictions
        self.migrations = 0           # evicted tasks re-admitted elsewhere
        # (victim uid, preemptor uid) in decision order — the eviction-order
        # parity artifact the live/sim tests compare
        self.preempt_log: List[Tuple[int, int]] = []
        self._resident_since: Dict[int, float] = {}
        self._evicted_from: Dict[int, int] = {}   # uid -> lead device index
        # weak refs to backend observers (see add_preempt_listener): each
        # entry is a zero-arg resolver returning the listener or None
        self._preempt_listeners: List[
            Callable[[], Optional[PreemptListener]]] = []

    # -- backend notification -------------------------------------------------
    def add_preempt_listener(self, fn: PreemptListener) -> None:
        """Register an eviction observer (the executor signals the running
        task's cooperative checkpoint; the simulator banks exact remaining
        work). Notices are delivered outside the lock, always before the
        victim's re-admission callback can fire. Bound methods are held
        WEAKLY: a scheduler reused across backends must not keep every
        Executor/Simulator ever attached to it alive (dead refs are swept
        on the next register/notify)."""
        try:
            ref: Callable[[], Optional[PreemptListener]] = \
                weakref.WeakMethod(fn)
        except TypeError:
            ref = (lambda fn=fn: fn)   # plain callable: hold strongly
        with self._lock:
            self._preempt_listeners = [
                r for r in self._preempt_listeners if r() is not None]
            if not any(r() == fn for r in self._preempt_listeners):
                self._preempt_listeners.append(ref)

    # -- admission bookkeeping ------------------------------------------------
    def _admit_locked(self, task: Task):
        placement = super()._admit_locked(task)
        if placement is not None:
            self._resident_since[task.uid] = self._clock()
            prev = self._evicted_from.pop(task.uid, None)
            if prev is not None and prev != task.device:
                # the evicted task resumed on a DIFFERENT device: requeue +
                # placement just performed a live migration
                self.migrations += 1
        return placement

    def task_end(self, task: Task, *, epoch: Optional[int] = None) -> bool:
        ok = super().task_end(task, epoch=epoch)
        if ok:
            # current-epoch completion: drop the residency stamp and any
            # banked progress (GIL-atomic pops; stale completions keep both
            # for the live re-admitted incarnation)
            self._resident_since.pop(task.uid, None)
            self.ledger.clear(task.uid)
        return ok

    def _drop_preempt_state(self, task: Task) -> None:
        """A waiter leaving for good (cancelled, shed, impossible after the
        fleet shrank) never resumes: its banked progress and migration
        breadcrumb would otherwise leak forever (uids are never reused, so
        the entries are pure dead weight)."""
        self.ledger.clear(task.uid)
        self._evicted_from.pop(task.uid, None)
        self._resident_since.pop(task.uid, None)

    def _forget_task_locked(self, task: Task) -> None:
        self._drop_preempt_state(task)

    def cancel_wait(self, task: Task) -> bool:
        ok = super().cancel_wait(task)
        if ok:
            self._drop_preempt_state(task)
        return ok

    def cancel_all_waiters(self) -> List[Task]:
        out = super().cancel_all_waiters()
        for t in out:
            self._drop_preempt_state(t)
        return out

    # -- victim eligibility / cost --------------------------------------------
    def _victim_ok_locked(self, waiter: Task, resident: Task,
                          now: float) -> bool:
        if resident.uid not in self._admit_cbs:
            return False   # legacy task_begin resident: no requeue path
        if resident.preempt_count >= self.preempt_policy.budget:
            return False   # eviction budget spent: immune from here on
        since = self._resident_since.get(resident.uid, now)
        if now - since < self.preempt_policy.min_runtime_s:
            return False   # too fresh: anti-thrash residency guard
        return outranks(waiter, resident)

    def _victim_cost_locked(self, resident: Task, now: float) -> float:
        since = self._resident_since.get(resident.uid, now)
        return preemption_cost(
            resident, remaining_estimate(resident, self.ledger, now - since))

    # -- evict / restore primitives (flat host; gang mixin overrides) ---------
    def _evict_locked(self, victim: Task):
        tok = victim.device
        self.devices[tok].release(victim)
        victim.device = None
        return tok

    def _restore_locked(self, victim: Task, tok) -> None:
        self.devices[tok].admit(victim)
        victim.device = tok

    def _tok_lead(self, tok) -> int:
        return tok

    # -- victim planning ------------------------------------------------------
    def _greedy_plan_locked(self, cands: List[Task],
                            feasible: Callable[[], bool], now: float,
                            best_cost: float,
                            useful: Optional[Callable[[Task], bool]] = None
                            ) -> Optional[Tuple[List[Task], float]]:
        """Greedy min-cost victim cover against a feasibility predicate:
        trial-evict candidates cheapest-first until ``feasible()`` passes,
        then PRUNE — restore each taken victim in turn and keep only those
        whose restoration breaks feasibility (a cheap bystander evicted on
        the way to the resident that actually makes room is given back).
        Everything is restored before returning; the caller re-evicts the
        committed plan. Returns (victims, cost) or None."""
        cands = sorted(cands, key=lambda t: self._victim_cost_locked(t, now))
        taken: List[Task] = []
        toks: List[object] = []
        cost = 0.0
        ok = feasible()
        for v in cands:
            if ok or cost >= best_cost:
                break
            if useful is not None and not useful(v):
                continue  # evicting this victim frees nothing we need
            toks.append(self._evict_locked(v))
            taken.append(v)
            cost += self._victim_cost_locked(v, now)
            ok = feasible()
        plan: Optional[Tuple[List[Task], float]] = None
        if ok and taken:
            kept: List[Task] = []
            kept_toks: List[object] = []
            for v, tok in zip(taken, toks):
                self._restore_locked(v, tok)
                if not feasible():
                    self._evict_locked(v)
                    kept.append(v)
                    kept_toks.append(tok)
            taken, toks = kept, kept_toks
            cost = sum(self._victim_cost_locked(v, now) for v in taken)
            if taken and cost < best_cost:
                plan = (list(taken), cost)
        for v, tok in zip(reversed(taken), reversed(toks)):
            self._restore_locked(v, tok)
        return plan

    # bound on recorded considered-plan entries per preemption attempt (the
    # explain collector must not grow with fleet size)
    _PLANS_CAP = 16

    def _plan_victims_locked(self, task: Task,
                             explain_out: Optional[List[dict]] = None
                             ) -> Optional[List[Task]]:
        """Min-cost victim set on ONE device (flat host): per alive device,
        greedy-cover against that device's own ``device_feasible`` predicate,
        keep the cheapest feasible plan across devices. Greedy + prune, not
        optimal subset-sum — the cost model only has to rank victims.

        With ``explain_out`` (a list, explain enabled), every per-device
        planning outcome is appended: feasible plans with their victim uids
        and cost, infeasible/over-budget attempts with the eligible-victim
        count — the "considered and rejected" record of a preemption
        verdict."""
        now = self._clock()
        best: Optional[List[Task]] = None
        best_cost = float("inf")
        for dev in self.devices:
            if not dev.alive:
                continue
            cands = [t for t in dev.residents.values()
                     if self._victim_ok_locked(task, t, now)]
            if not cands:
                continue
            plan = self._greedy_plan_locked(
                cands, lambda d=dev: self.device_feasible(task, d),
                now, best_cost)
            if explain_out is not None and len(explain_out) < self._PLANS_CAP:
                if plan is not None:
                    explain_out.append(
                        {"device": dev.index + self._trace_dev_off,
                         "victims": [v.uid for v in plan[0]],
                         "cost_s": plan[1]})
                else:
                    explain_out.append(
                        {"device": dev.index + self._trace_dev_off,
                         "eligible": len(cands), "rejected": True})
            if plan is not None:
                best, best_cost = plan
        return best

    # -- the hook -------------------------------------------------------------
    def _preempt_admit_locked(self, task: Task):
        ex = self._explain
        considered: Optional[List[dict]] = [] if ex is not None else None
        plan = self._plan_victims_locked(task, explain_out=considered)
        if not plan:
            if ex is not None:
                # collapse: a parked waiter retrying every drain keeps ONE
                # no-plan verdict with a bumped repeat count (the first
                # attempt's considered-plan record is retained)
                ex.record(task.uid, task.name, obsx.PREEMPT_REJECTED,
                          reasons=({"reason": obsx.R_NO_VICTIM_PLAN},),
                          data={"considered": considered}
                          if considered else None,
                          collapse=True)
            return None
        toks = [self._evict_locked(v) for v in plan]
        placement = self._admit_locked(task)
        if placement is None:
            # the plan was feasibility-checked, so this should not happen;
            # restore exactly rather than trusting that it cannot
            for v, tok in zip(reversed(plan), reversed(toks)):
                self._restore_locked(v, tok)
            return None
        now = self._clock()
        if ex is not None:
            ex.record(task.uid, task.name, obsx.PREEMPT_PLANNED,
                      device=getattr(placement, "lead", placement)
                      + self._trace_dev_off,
                      data={"victims": [v.uid for v in plan],
                            "cost_s": sum(self._victim_cost_locked(v, now)
                                          for v in plan),
                            "considered": considered})
        for v, tok in zip(plan, toks):
            since = self._resident_since.pop(v.uid, now)
            # bank remaining work BEFORE mutating the ledger entry it reads;
            # an estimate from residency time — the simulator's listener
            # overwrites it with the exact value
            rem = remaining_estimate(v, self.ledger, now - since)
            if ex is not None:
                ex.record(v.uid, v.name, obsx.EVICTED,
                          device=self._tok_lead(tok) + self._trace_dev_off,
                          reasons=({"reason": "preempted", "by": task.uid,
                                    "by_name": task.name,
                                    "cost_s": preemption_cost(v, rem)},))
            self.ledger.set_remaining(v.uid, rem)
            v.preempt_count += 1
            if self.preempt_policy.aging_step:
                # anti-starvation aging: each eviction raises the victim's
                # ADMISSION rank, so a repeatedly-bumped job eventually
                # outranks the stream of arrivals displacing it (and, past
                # budget, is immune). An admission bonus only — raw
                # task.priority is what eviction decisions compare, so an
                # aged victim never starts bullying its own class
                v.age_boost += self.preempt_policy.aging_step
            self._evicted_from[v.uid] = self._tok_lead(tok)
            self.preemptions += 1
            self.preempt_log.append((v.uid, task.uid))
            tr = self._trace
            if tr is not None:
                # fires after the preemptor's ADMIT (emitted inside
                # _admit_locked above) — the same order on both backends,
                # and per-victim lifecycle legality is unaffected
                tr.emit(obs.EVICT, v.uid, v.name,
                        self._tok_lead(tok) + self._trace_dev_off,
                        self._epochs.get(v.uid, 0),
                        data={"by": task.uid, "cause": "preempt"})
        # capture each victim's pre-bump epoch BEFORE the requeue bumps it:
        # the notice is addressed to that superseded attempt only
        note = [(v, self._epochs.get(v.uid, 0)) for v in plan]
        self._requeue_evicted_locked(plan)
        if self._preempt_listeners:
            listeners = [fn for fn in
                         (r() for r in self._preempt_listeners)
                         if fn is not None]
            self._deferred.append(
                lambda: [fn(note) for fn in listeners])
        return placement


class GangPreemptionMixin(PreemptionMixin):
    """Preemption over the gang scheduler: victims are whole reservations.

    Planning ranges over the topology's candidate groups for the waiter's
    shape; a victim overlapping the chosen group is evicted WHOLE (its
    entire reservation — all member chips and link charges — through
    ``_release_locked``), so no partial reservation ever exists. Solo tasks
    hold 1-cell reservations and ride the same path.
    """

    def _evict_locked(self, victim: Task):
        group = self.bound[victim.uid]
        self._release_locked(victim)
        victim.device = None
        return group

    def _restore_locked(self, victim: Task, group) -> None:
        self._reserve_group_locked(victim, group)

    def _tok_lead(self, group) -> int:
        return group.lead

    def _group_admissible_locked(self, group, per_chip: int, need: int,
                                 resources) -> bool:
        if not all(self._member_ok(c, per_chip, need)
                   for c in group.cells()):
            return False
        # self.policy is the gang host's alg2/alg3 COMPUTE policy string
        return self.policy != "alg2" \
            or self.topo.link_headroom_ok(group, resources)

    def _plan_victims_locked(self, task: Task,
                             explain_out: Optional[List[dict]] = None
                             ) -> Optional[List[Task]]:
        r = task.resources
        k = max(r.chips, 1)
        per_chip = r.hbm_bytes // k
        need = slots_needed(task)
        now = self._clock()
        # cheap pre-gate: with no eligible victim anywhere on the fleet, no
        # candidate group can assemble one — skip the group enumeration
        # (groups x cells) that dominates the cost of a doomed plan
        if not any(self._victim_ok_locked(task, t, now)
                   for d in self.devices if d.alive
                   for t in d.residents.values()):
            if explain_out is not None:
                explain_out.append({"eligible": 0, "rejected": True})
            return None
        best: Optional[List[Task]] = None
        best_cost = float("inf")
        for group in self.topo.candidate_groups(k):
            cells = list(group.cells())
            if any(not self.topo.cells[c].alive for c in cells):
                continue
            cellset = set(cells)
            cands: List[Task] = []
            seen = set()
            for c in cells:
                for t in self.topo.cells[c].residents.values():
                    if t.uid not in seen:
                        seen.add(t.uid)
                        if self._victim_ok_locked(task, t, now):
                            cands.append(t)
            if not cands:
                continue

            def useful(v: Task, cellset=cellset) -> bool:
                # a victim helps iff it occupies a group cell that is not yet
                # member-feasible, or (alg2, links hard) holds link charges
                # whose release could restore headroom
                overlap = [c for c in self.bound[v.uid].cells()
                           if c in cellset]
                return any(not self._member_ok(c, per_chip, need)
                           for c in overlap) \
                    or (self.policy == "alg2"
                        and v.resources.collective_bytes > 0)

            plan = self._greedy_plan_locked(
                cands,
                lambda g=group: self._group_admissible_locked(
                    g, per_chip, need, r),
                now, best_cost, useful=useful)
            if explain_out is not None and len(explain_out) < self._PLANS_CAP:
                if plan is not None:
                    explain_out.append(
                        {"device": group.lead + self._trace_dev_off,
                         "victims": [v.uid for v in plan[0]],
                         "cost_s": plan[1]})
                else:
                    explain_out.append(
                        {"device": group.lead + self._trace_dev_off,
                         "eligible": len(cands), "rejected": True})
            if plan is not None:
                best, best_cost = plan
        return best


class PreemptiveAlg2Scheduler(PreemptionMixin, MGBAlg2Scheduler):
    """Alg. 2 (memory + compute slots hard) with preemptive admission."""
    name = "MGB-Alg2-preempt"


class PreemptiveAlg3Scheduler(PreemptionMixin, MGBAlg3Scheduler):
    """Alg. 3 (memory hard, compute soft) with preemptive admission."""
    name = "MGB-Alg3-preempt"


class PreemptiveGangScheduler(GangPreemptionMixin, GangScheduler):
    """Gang scheduler with whole-reservation preemptive admission."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.name += "-preempt"
