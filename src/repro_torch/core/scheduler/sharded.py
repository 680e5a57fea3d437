"""Sharded control plane: one admission engine per pod, stitched into a
single scheduler surface with cross-pod work stealing.

A single global scheduler serializes every probe, wakeup and drain on one
lock; at fleet scale (tens of pods, 1e4+ chips, 1e5 parked waiters) that lock
is the control plane's bottleneck even with the indexed queue. The paper's
daemon shards naturally along the hardware: placement is intra-pod (ICI),
only *data* movement crosses pods (DCN), so admission state factors into
per-pod engines that never need each other's locks on the hot path.

``ShardedScheduler`` owns N shard engines (by default one single-pod
``GangScheduler`` each) and presents the standard scheduler surface —
``admit_or_enqueue`` / ``task_end`` / ``mark_dead`` / ``cancel_wait`` / the
waiter-queue introspection — to the executor, simulator and ``Cluster``:

  * **routing**: a task is owned by exactly one shard at a time
    (``_owner``); every lifecycle call (``task_end``, ``cancel_wait``,
    ``admission_epoch``, ``link_pressure``) goes straight to the owner and
    takes only that shard's lock. Shard locks are NEVER nested;
  * **placement translation**: shards speak shard-local device indices;
    the wrapper translates placements (ints and ``GangReservation``
    device_indices/rect pods) by the shard's flat-index offset, so callers
    index the concatenated ``devices`` table exactly as with a global
    scheduler. ``task.device`` stays shard-local — only the owner shard
    ever dereferences it;
  * **work stealing**: when a ``task_end`` frees capacity on a shard whose
    own queue is empty, the shard steals the best-ranked *portable* waiter
    from the most-loaded shard (portable = single-chip, or a gang whose
    collective stream would fit a DCN edge — a cheap proxy for "its inputs
    can migrate across pods without drowning the interconnect"). The steal
    carries the waiter object whole (rank, seq, callback), transfers the
    task's admission-epoch history via ``adopt_epoch`` — so a superseded
    run's stale ``task_end`` stays fenced after the move — and is
    admit-or-nothing on the target (``try_admit``): a refused waiter is
    restored to its exact source position, so no task is ever lost or
    reordered by a failed steal;
  * **re-homing**: a shard that shrinks (``mark_dead``) until a parked
    waiter can never run there sweeps it with ``placement=None``; the
    wrapper intercepts that verdict and re-parks the waiter on a shard that
    still fits it, only reporting infeasibility to the caller when NO shard
    can ever take it — shard-local death is not fleet-local death.

Pod-spanning gangs (``chips`` beyond one shard) are rejected fast via
``can_ever_fit``/``infeasible_reason``: spanning placement needs the global
``GangScheduler``. Preemptive shards are likewise out of scope (``Cluster``
already requires a ``PreemptionMixin`` host for ``preempt=True``).

Copy of ``src/repro/core/scheduler/sharded.py`` with its imports rewritten
to ``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from repro_torch.core.scheduler.base import (
    DEADLINE_SHED, DEFAULT_HBM, AdmitCallback, DeviceState,
)
from repro_torch.core.scheduler.gang import GangScheduler
from repro_torch.core.task import Task
from repro_torch.core.topology import DCN_BW, ICI_BW, Cell, GangReservation
from repro_torch.obs import events as obs
from repro_torch.obs import explain as obsx

DeviceRef = Union[int, Cell]


class ShardedScheduler:
    """Per-pod sharded admission: N independent engines behind one surface.

    ``shard_factory(shard_index)`` builds each engine (default: a single-pod
    ``GangScheduler`` with the given grid/policy). Shards must expose the
    ``WaiterQueueMixin`` surface and a uniform ``devices`` length — the
    global flat device index is ``shard_index * shard_devices + local``."""

    preempt_enabled = False

    def __init__(self, pods: int = 2, rows: int = 4, cols: int = 4, *,
                 policy: str = "alg3", hbm_per_chip: int = DEFAULT_HBM,
                 ici_bw: float = ICI_BW, dcn_bw: float = DCN_BW,
                 shard_factory: Optional[Callable[[int], Any]] = None):
        if shard_factory is None:
            def shard_factory(si: int, *, _rows=rows, _cols=cols):
                return GangScheduler(1, _rows, _cols, policy=policy,
                                     hbm_per_chip=hbm_per_chip,
                                     ici_bw=ici_bw, dcn_bw=dcn_bw)
        self.shards: List[Any] = [shard_factory(si) for si in range(pods)]
        if not self.shards:
            raise ValueError("ShardedScheduler needs at least one shard")
        counts = {len(sh.devices) for sh in self.shards}
        if len(counts) != 1:
            raise ValueError(f"shards must be uniform, got device counts "
                             f"{sorted(counts)}")
        self._shard_devs = counts.pop()
        # pods per shard (for re-podding gang rects into the global grid);
        # flat shards have no topology and never emit rect placements
        self._shard_pods = {
            si: getattr(getattr(sh, "topo", None), "pods", 1)
            for si, sh in enumerate(self.shards)}
        self.dcn_bw = dcn_bw
        self.name = f"MGB-sharded-{policy}x{pods}"
        # global device table: shard-major concatenation; executor/simulator
        # index it positionally (DeviceState.index stays shard-local — flat
        # shards use it as their placement value, so it must not be rewritten)
        self._devices: List[DeviceState] = [
            d for sh in self.shards for d in sh.devices]
        # task uid -> owning shard index; guards under _lock, read lock-free
        # on hot paths (a task's owner only moves while it is PARKED, and
        # stale task_ends that race a move are epoch-fenced on either shard)
        self._owner: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.steals = 0          # waiters successfully re-homed by stealing
        self.steal_attempts = 0  # steal probes (including refused ones)
        self.rehomes = 0         # waiters migrated off a shrunken shard
        # wrapper-level tracer (steal/restore events); obs.events.
        # attach_tracer also fans the tracer out to every shard with its
        # global device-index offset; explain.attach_explainer does the
        # same for the verdict rings
        self._trace = None
        self._explain = None

    # -- global views ---------------------------------------------------------
    @property
    def devices(self) -> List[DeviceState]:
        return self._devices

    @property
    def begin_attempts(self) -> int:
        return sum(sh.begin_attempts for sh in self.shards)

    @property
    def hint_skips(self) -> int:
        return sum(sh.hint_skips for sh in self.shards)

    @property
    def placements(self) -> List[tuple]:
        out: List[tuple] = []
        for si, sh in enumerate(self.shards):
            off = si * self._shard_devs
            out.extend((uid, lead + off) for uid, lead in sh.placements)
        return out

    @property
    def shed_expired(self) -> bool:
        return self.shards[0].shed_expired

    @shed_expired.setter
    def shed_expired(self, value: bool) -> None:
        for sh in self.shards:
            sh.shed_expired = value

    @property
    def _clock(self) -> Callable[[], float]:
        return self.shards[0]._clock

    @_clock.setter
    def _clock(self, fn: Callable[[], float]) -> None:
        # the simulator repoints the scheduler clock at its virtual time;
        # every shard sheds deadlines on the same timeline
        for sh in self.shards:
            sh._clock = fn

    def alive_devices(self) -> List[DeviceState]:
        return [d for d in self._devices if d.alive]

    def utilization(self) -> float:
        busy = sum(1 for d in self._devices if d.residents)
        return busy / max(len(self._devices), 1)

    # -- routing helpers ------------------------------------------------------
    def _route_device(self, device: DeviceRef) -> Tuple[int, DeviceRef]:
        """Global device reference -> (shard index, shard-local reference)."""
        if isinstance(device, int):
            return device // self._shard_devs, device % self._shard_devs
        p, r, c = device
        sp = self._shard_pods[0]
        return p // sp, (p % sp, r, c)

    def _translate(self, si: int, placement: Any) -> Any:
        """Shard-local placement -> global (flat indices + re-podded rects)."""
        if placement is None or placement is DEADLINE_SHED:
            return placement
        off = si * self._shard_devs
        if isinstance(placement, GangReservation):
            pod_off = si * self._shard_pods[si]
            rects = tuple(dataclasses.replace(rc, pod=rc.pod + pod_off)
                          for rc in placement.rects)
            return GangReservation(
                rects, tuple(d + off for d in placement.device_indices))
        return placement + off

    def _portable(self, task: Task) -> bool:
        """May this waiter be stolen across pods? Single-chip tasks always;
        a gang only when its steady collective stream would fit one DCN edge
        (a proxy for 'migrating its inputs will not drown the interconnect').
        Depends only on the task's resource vector, as ``steal_best_waiter``
        requires — and takes no locks (it runs under the source's)."""
        r = task.resources
        if r.chips <= 1 or r.collective_bytes <= 0:
            return True
        return r.collective_bytes / max(r.est_seconds, 1e-12) <= self.dcn_bw

    def _make_cb(self, user_cb: AdmitCallback) -> AdmitCallback:
        """Wrap an admission callback with owner-relative placement
        translation. The owner is resolved at FIRE time, not capture time,
        so the same wrapper stays correct when a steal moves the waiter."""
        def wrapped(t: Task, placement: Any, epoch: int) -> None:
            si = self._owner.get(t.uid, 0)
            if placement is None:
                # the owning shard shrank until t can never run THERE; that
                # is not a fleet verdict — re-park on a shard that still
                # fits it, carrying the epoch history for the fence
                for tsi, sh in enumerate(self.shards):
                    if tsi == si or not sh.can_ever_fit(t):
                        continue
                    sh.adopt_epoch(t, epoch)
                    with self._lock:
                        self._owner[t.uid] = tsi
                        self.rehomes += 1
                    ex = self._explain
                    if ex is not None:
                        ex.record(t.uid, t.name, obsx.REHOMED,
                                  data={"src": si, "dst": tsi})
                    sh.admit_or_enqueue(t, wrapped)
                    return
                user_cb(t, None, epoch)
                return
            user_cb(t, self._translate(si, placement), epoch)
        return wrapped

    # -- admission ------------------------------------------------------------
    def admit_or_enqueue(self, task: Task, callback: AdmitCallback) -> bool:
        """Probe every shard for immediate capacity (shard order — the same
        first-fit determinism a global scheduler's enumeration gives); park
        on the least-loaded shard that could ever run the task otherwise.
        Returns True iff admitted immediately."""
        wrapped = self._make_cb(callback)
        for si, sh in enumerate(self.shards):
            with self._lock:
                self._owner[task.uid] = si
            if sh.try_admit(task, wrapped) is not None:
                return True
        eligible = [si for si, sh in enumerate(self.shards)
                    if sh.can_ever_fit(task)]
        pool = eligible or list(range(len(self.shards)))
        si = min(pool, key=lambda s: self.shards[s].waiting_count())
        with self._lock:
            self._owner[task.uid] = si
        return self.shards[si].admit_or_enqueue(task, wrapped)

    def try_admit(self, task: Task, callback: AdmitCallback) -> Any:
        """Admit-or-nothing across the shards (never parks)."""
        wrapped = self._make_cb(callback)
        for si, sh in enumerate(self.shards):
            with self._lock:
                self._owner[task.uid] = si
            p = sh.try_admit(task, wrapped)
            if p is not None:
                return self._translate(si, p)
        return None

    def task_begin(self, task: Task) -> Any:
        """Legacy probe API: first shard that takes it (placement is
        translated; ``task_end`` routes by the recorded owner)."""
        for si, sh in enumerate(self.shards):
            p = sh.task_begin(task)
            if p is not None:
                with self._lock:
                    self._owner[task.uid] = si
                return self._translate(si, p)
        return None

    def task_end(self, task: Task, *, epoch: Optional[int] = None) -> bool:
        si = self._owner.get(task.uid)
        if si is None:
            return False
        ok = self.shards[si].task_end(task, epoch=epoch)
        if ok:
            # freed capacity + an empty local queue = steal opportunity
            self._steal_into(si)
        return ok

    # -- feasibility -----------------------------------------------------------
    def can_ever_fit(self, task: Task) -> bool:
        return any(sh.can_ever_fit(task) for sh in self.shards)

    def infeasible_reason(self, task: Task) -> str:
        r = task.resources
        k = max(r.chips, 1)
        if k > self._shard_devs:
            return (f"infeasible placement: gang {task.name or task.uid!r} "
                    f"needs {k} chips but the sharded control plane places "
                    f"each gang within ONE pod shard ({self._shard_devs} "
                    f"chips); pod-spanning gangs need the global "
                    f"GangScheduler")
        return self.shards[0].infeasible_reason(task)

    # -- work stealing ---------------------------------------------------------
    def _steal_into(self, target_si: int) -> None:
        """Pull portable waiters from the most-loaded shard into
        ``target_si`` while its own queue is empty and the steals land.
        Admit-or-nothing: a refused waiter goes back to its exact source
        position. No shard lock is ever held across a cross-shard call."""
        target = self.shards[target_si]
        while not target.waiting_count():
            src_si = max(
                (s for s in range(len(self.shards)) if s != target_si),
                key=lambda s: self.shards[s].waiting_count(), default=None)
            if src_si is None or not self.shards[src_si].waiting_count():
                return
            source = self.shards[src_si]
            w = source.steal_best_waiter(
                lambda t: self._portable(t) and target.can_ever_fit(t))
            if w is None:
                return
            self.steal_attempts += 1
            tr = self._trace
            if tr is not None:
                # STEAL precedes the target's ADMIT (emitted inside its
                # try_admit) so the lifecycle reads park -> steal -> admit
                tr.emit(obs.STEAL, w.task.uid, w.task.name,
                        data={"src": src_si, "dst": target_si})
            # fence transfer BEFORE the admit: the waiter may be an eviction
            # restart whose superseded run is still in flight — its stale
            # task_end must keep failing on the new owner too
            target.adopt_epoch(w.task, source.admission_epoch(w.task))
            with self._lock:
                self._owner[w.task.uid] = target_si
            if target.try_admit(w.task, w.callback) is None:
                with self._lock:
                    self._owner[w.task.uid] = src_si
                source.adopt_epoch(w.task, target.admission_epoch(w.task))
                source.restore_waiter(w)
                if tr is not None:
                    tr.emit(obs.RESTORE, w.task.uid, w.task.name,
                            data={"src": src_si, "dst": target_si})
                ex = self._explain
                if ex is not None:
                    ex.record(w.task.uid, w.task.name, obsx.STEAL_REFUSED,
                              reasons=({"reason": "target_refused",
                                        "src": src_si,
                                        "dst": target_si},),
                              data={"src": src_si, "dst": target_si},
                              collapse=True)
                return
            self.steals += 1
            ex = self._explain
            if ex is not None:
                ex.record(w.task.uid, w.task.name, obsx.STOLEN,
                          data={"src": src_si, "dst": target_si})

    # -- fault tolerance -------------------------------------------------------
    def mark_dead(self, device: DeviceRef) -> List[Task]:
        si, local = self._route_device(device)
        evicted = self.shards[si].mark_dead(local)
        # the shrunken shard's survivors were re-queued locally; idle shards
        # with capacity should pick up its (portable) backlog now rather
        # than at their next task_end
        for tsi in range(len(self.shards)):
            if tsi != si:
                self._steal_into(tsi)
        return evicted

    def revive(self, device: DeviceRef) -> None:
        si, local = self._route_device(device)
        self.shards[si].revive(local)
        self._steal_into(si)

    # -- waiter queue surface --------------------------------------------------
    def notify(self) -> int:
        fired = sum(sh.notify() for sh in self.shards)
        for si in range(len(self.shards)):
            self._steal_into(si)
        return fired

    def waiting_count(self) -> int:
        return sum(sh.waiting_count() for sh in self.shards)

    def queue_stats(self) -> Dict[str, Any]:
        """O(shards) merge of the per-shard O(1) counters, plus the
        per-shard depth vector (the balance the stealing works against)."""
        depth = 0
        classes = 0
        per_class: Dict[int, int] = {}
        per_shard: List[int] = []
        gang_front = None
        for sh in self.shards:
            s = sh.queue_stats()
            depth += s["depth"]
            classes += s["classes"]
            per_shard.append(s["depth"])
            for k, v in s["per_class"].items():
                per_class[k] = per_class.get(k, 0) + v
            if gang_front is None:
                gang_front = s.get("gang_front")
        return {"depth": depth, "per_class": per_class, "classes": classes,
                "hint_skips": self.hint_skips, "per_shard": per_shard,
                "steals": self.steals, "gang_front": gang_front}

    def waiting_tasks(self) -> List[Task]:
        # shard-major snapshot (rank-ordered within each shard)
        return [t for sh in self.shards for t in sh.waiting_tasks()]

    def explain_queue(self, task: Task) -> Optional[Tuple[dict, ...]]:
        """Live rejection probe routed to the owner shard (None when the
        task is not parked anywhere in the fleet)."""
        si = self._owner.get(task.uid)
        if si is None:
            return None
        eq = getattr(self.shards[si], "explain_queue", None)
        return eq(task) if eq is not None else None

    def cancel_wait(self, task: Task) -> bool:
        si = self._owner.get(task.uid)
        if si is None:
            return False
        return self.shards[si].cancel_wait(task)

    def cancel_all_waiters(self) -> List[Task]:
        return [t for sh in self.shards for t in sh.cancel_all_waiters()]

    def admission_epoch(self, task: Task) -> int:
        si = self._owner.get(task.uid)
        if si is None:
            return 0
        return self.shards[si].admission_epoch(task)

    def adopt_epoch(self, task: Task, epoch: int) -> None:
        si = self._owner.get(task.uid)
        if si is not None:
            self.shards[si].adopt_epoch(task, epoch)

    # -- runtime contention (simulator dilation input) -------------------------
    def link_pressure(self, task: Task) -> float:
        si = self._owner.get(task.uid)
        if si is None:
            return 1.0
        lp = getattr(self.shards[si], "link_pressure", None)
        return lp(task) if lp is not None else 1.0
