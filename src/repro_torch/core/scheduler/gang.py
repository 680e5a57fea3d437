"""Gang placement: topology-aware atomic reservation of device groups.

The paper's schedulers place one task on one device. The flagship multi-chip
workloads (sharded train steps, pipeline stages) declare ``chips > 1`` and
need a *gang*: a contiguous, ICI-connected device group reserved **all at
once**. ``GangScheduler`` is that layer, built on the pod/mesh model in
``repro_torch.core.topology`` and the waiter queue in ``scheduler.base``:

  * a gang either gets ALL its chips or parks as ONE waiter — partial
    reservations never exist, so two half-admitted gangs can never deadlock
    against each other holding pieces the other needs;
  * per member chip, memory is checked HARD (the MGB guarantee extends to
    every device a job touches — Reaño et al.'s intra-node memory-safety
    condition, at pod scale) and compute follows the paper's policy split:
    ``policy="alg2"`` requires free slots on every member (exact),
    ``policy="alg3"`` is optimistic — min aggregate demand over candidate
    groups (fewest in-use warps, summed over the group);
  * ICI/DCN **link headroom** is part of admission: a gang's collectives put
    ``collective_bytes / est_seconds / link_bw`` of steady load on every
    link internal to its group (ring model). Under alg2 a group whose links
    would oversubscribe is rejected (links hard); under alg3 link pressure
    is the placement tie-break and oversubscription is tolerated — the
    simulator then dilates the sharing gangs (``interference.ici_slowdown``),
    mirroring how alg3 treats compute;
  * ``task_end`` / ``cancel`` / ``mark_dead`` release the WHOLE reservation
    (chips + links) under the existing epoch fence, and ``task_end`` hints
    the waiter-queue drain with the freed cells so heterogeneous queues skip
    waiters those cells cannot satisfy;
  * a gang whose shape can never exist (more chips than the fleet, or no
    feasible slice factorization, e.g. 5 chips on a 4x4 pod) fails fast via
    ``can_ever_fit`` + ``infeasible_reason`` instead of parking forever.

Single-chip tasks ride the same path as 1x1 groups, so one scheduler serves
a mixed single-chip / multi-chip open-arrival stream.

Copy of ``src/repro/core/scheduler/gang.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core import interference
from repro_torch.core.scheduler.base import (
    DEFAULT_HBM, SLOTS, DeviceState, WaiterQueueMixin, slots_needed,
)
from repro_torch.core.task import Task, observed_highwater
from repro_torch.core.topology import (
    DCN_BW, ICI_BW, Cell, GangReservation, Topology,
)
from repro_torch.obs import events as obs
from repro_torch.obs import explain as obsx

CellOrIndex = Union[Cell, int]


class GangScheduler(WaiterQueueMixin):
    """Atomic gang reservation over a ``Topology``, through the shared
    priority/deadline waiter queue. The admission callback receives a
    ``GangReservation`` (``device_indices`` has the whole group, ``lead`` is
    the audit-log index); single-chip tasks get a 1-cell group."""

    def __init__(self, pods: int = 1, rows: int = 4, cols: int = 4, *,
                 policy: str = "alg3", hbm_per_chip: int = DEFAULT_HBM,
                 ici_bw: float = ICI_BW, dcn_bw: float = DCN_BW,
                 topology: Optional[Topology] = None):
        if policy not in ("alg2", "alg3"):
            raise ValueError(f"unknown gang policy {policy!r} "
                             "(expected 'alg2' or 'alg3')")
        if topology is None:
            topology = Topology(pods, rows, cols, hbm_per_chip,
                                ici_bw=ici_bw, dcn_bw=dcn_bw)
        self.topo = topology
        self.pods, self.rows, self.cols = \
            topology.pods, topology.rows, topology.cols
        self.policy = policy
        self.name = f"MGB-gang-{policy}"
        # legacy slice-scheduler surface: cell -> DeviceState (the same dict
        # the topology owns, not a copy)
        self.chips: Dict[Cell, DeviceState] = topology.cells
        # flat-index device-table view, built once (the cell set is fixed
        # after construction); executor/simulator hot paths index this per
        # gang member, so it must not be rebuilt per access
        self._device_list: List[DeviceState] = topology.device_list()
        self.bound: Dict[int, GangReservation] = {}   # task uid -> group
        self._lock = threading.Lock()
        self.begin_attempts = 0
        self.placements: List[tuple] = []   # (task uid, lead device) audit
        self._init_waiters()

    # -- device-table view (what the executor/simulator index) ---------------
    @property
    def devices(self) -> List[DeviceState]:
        return self._device_list

    def _as_cell(self, cell: CellOrIndex) -> Cell:
        return self.topo.cell_of(cell) if isinstance(cell, int) else cell

    # -- feasibility ---------------------------------------------------------
    def _member_ok(self, cell: Cell, per_chip: int, need: int) -> bool:
        """Is this cell admissible as a gang member RIGHT NOW? Memory hard
        always; compute slots hard only under alg2."""
        d = self.topo.cells[cell]
        if not d.alive or per_chip > d.free_hbm:
            return False
        if self.policy == "alg2" and d.used_slots + need > SLOTS:
            return False
        return True

    def _member_ever_ok(self, cell: Cell, per_chip: int, need: int) -> bool:
        """Same predicate against an EMPTY cell (the can_ever_fit check)."""
        d = self.topo.cells[cell]
        if not d.alive or per_chip > d.total_hbm:
            return False
        if self.policy == "alg2" and need > SLOTS:
            return False
        return True

    def _find_group(self, task: Task) -> Optional[GangReservation]:
        """Best feasible group for ``task``, evaluating candidates in the
        same enumeration order (and with the same tie-breaks) as the
        historical full scan, but against the topology's incremental tile
        index: infeasible tiles cost O(1) via cached aggregates instead of
        O(tile size) member walks, and a completely-free tile returns
        immediately — its key is provably the unbeatable (0.0, 0.0), since
        every link internal to a free group has both endpoints resident-free
        and therefore carries no charge."""
        r = task.resources
        k = max(r.chips, 1)
        per_chip = r.hbm_bytes // k
        need = slots_needed(task)
        best: Optional[GangReservation] = None
        best_key: Tuple[float, float] = (float("inf"), float("inf"))
        if k > self.topo.pod_size:
            # whole-pod windows: candidates are O(pods), keep the direct walk
            for group in self.topo.candidate_groups(k):
                if not all(self._member_ok(c, per_chip, need)
                           for c in group.cells()):
                    continue
                if self.policy == "alg2" \
                        and not self.topo.link_headroom_ok(group, r):
                    continue
                key = (sum(self.topo.cells[c].in_use_demand
                           for c in group.cells()),
                       self.topo.max_link_load(group))
                if key < best_key:
                    best, best_key = group, key
                if key == (0.0, 0.0):
                    return group
            return best
        for (sr, sc) in self.topo.shapes_for(k):
            idx = self.topo.shape_index(sr, sc)
            for pos in idx.positions:
                if idx.dead[pos]:
                    continue
                min_free, max_slots, sum_demand = self.topo.tile_agg(idx, pos)
                if per_chip > min_free:
                    continue
                if self.policy == "alg2" and max_slots + need > SLOTS:
                    continue
                group = self.topo.tile_group(sr, sc, pos)
                if not idx.busy[pos]:
                    # free group on idle links: cannot do better (and the
                    # alg2 link-headroom check passes trivially — per-task
                    # share is clamped to one link)
                    return group
                if self.policy == "alg2" \
                        and not self.topo.link_headroom_ok(group, r):
                    continue  # links hard: collectives must not oversubscribe
                # Alg. 3 tie-break, summed over the group: fewest in-use
                # warps first, then least-contended links (soft pressure)
                key = (sum_demand, self.topo.max_link_load(group))
                if key < best_key:
                    best, best_key = group, key
                if key == (0.0, 0.0):
                    return group  # idle group on idle links
        return best

    def can_ever_fit(self, task: Task) -> bool:
        # O(shapes) against the maintained alive-tile counters instead of a
        # full candidate enumeration per submission
        r = task.resources
        k = max(r.chips, 1)
        per_chip = r.hbm_bytes // k
        if self.policy == "alg2" and slots_needed(task) > SLOTS:
            return False
        return self.topo.any_alive_group(k, per_chip)

    def infeasible_reason(self, task: Task) -> str:
        r = task.resources
        k = max(r.chips, 1)
        topo = (f"{self.topo.pods} pod(s) x {self.topo.rows}x"
                f"{self.topo.cols}")
        if not self.topo.has_feasible_shape(k):
            return (f"infeasible placement: gang {task.name or task.uid!r} "
                    f"needs {k} chips but no {k}-chip contiguous group "
                    f"shape exists on the {topo} topology "
                    f"({self.topo.total_chips} chips total)")
        alive = self.topo.alive_count()
        if k > alive:
            return (f"infeasible placement: gang {task.name or task.uid!r} "
                    f"needs {k} chips but only {alive} of "
                    f"{self.topo.total_chips} are alive on the {topo} "
                    f"topology")
        return (f"infeasible placement: gang {task.name or task.uid!r} "
                f"needs {r.hbm_bytes / max(k, 1) / 1e9:.2f} GB HBM per chip "
                f"across {k} chips, beyond every feasible group on the "
                f"{topo} topology ({alive} alive chips)")

    # -- admission / release --------------------------------------------------
    def _admit_locked(self, task: Task) -> Optional[GangReservation]:
        # calibration correction at the first admission probe (idempotent —
        # apply() stamps probe_vec), mirroring Scheduler._admit_locked
        calib = self._calib
        if calib is not None and task.probe_vec is None:
            calib.apply(task)
        self.begin_attempts += 1
        group = self._find_group(task)
        if group is None:
            ex = self._explain
            if ex is not None:
                ex.reject(task.uid, task.name,
                          lambda: self._reject_reasons_locked(task))
            return None
        self._reserve_group_locked(task, group)
        self.placements.append((task.uid, group.lead))
        tr = self._trace
        if tr is not None:
            off = self._trace_dev_off
            tr.emit(obs.ADMIT, task.uid, task.name, group.lead + off,
                    self._epochs.get(task.uid, 0))
            if max(task.resources.chips, 1) > 1:
                tr.emit(obs.GANG_RESERVE, task.uid, task.name,
                        group.lead + off, self._epochs.get(task.uid, 0),
                        data={"devices": tuple(
                            d + off for d in group.device_indices)})
        ex = self._explain
        if ex is not None:
            off = self._trace_dev_off
            data = None
            if max(task.resources.chips, 1) > 1:
                data = {"devices": tuple(
                    d + off for d in group.device_indices)}
            ex.record(task.uid, task.name, obsx.ADMITTED,
                      device=group.lead + off, data=data)
        return group

    def _reject_reasons_locked(self, task: Task) -> Tuple[dict, ...]:
        """Why no group was feasible: one entry per refusing member cell
        (dead / memory-short / alg2 slots-full, mirroring ``_member_ok``),
        plus — when every member of some candidate group passes yet the
        group is still rejected under alg2 — a ``link_headroom`` entry
        naming the first such group. Falls back to ``no_feasible_group``
        when every cell passes individually but no contiguous tile exists."""
        r = task.resources
        k = max(r.chips, 1)
        per_chip = r.hbm_bytes // k
        need = slots_needed(task)
        off = self._trace_dev_off
        out: List[dict] = []
        omitted = 0
        cap = self._REASONS_CAP
        for cell, d in self.topo.cells.items():
            reason = None
            if not d.alive:
                reason = {"device": d.index + off,
                          "reason": obsx.R_DEVICE_DEAD}
            elif per_chip > d.free_hbm:
                reason = {"device": d.index + off,
                          "reason": obsx.R_MEMORY_SHORT,
                          "short_bytes": per_chip - d.free_hbm}
            elif self.policy == "alg2" and d.used_slots + need > SLOTS:
                reason = {"device": d.index + off,
                          "reason": obsx.R_SLOTS_FULL,
                          "short_slots": d.used_slots + need - SLOTS}
            if reason is None:
                continue
            if len(out) < cap:
                out.append(reason)
            else:
                omitted += 1
        if omitted:
            out.append({"reason": "truncated", "omitted": omitted})
        if self.policy == "alg2":
            # a group whose members all fit can still lose on link headroom
            for group in self.topo.candidate_groups(k):
                if all(self._member_ok(c, per_chip, need)
                       for c in group.cells()) \
                        and not self.topo.link_headroom_ok(group, r):
                    out.append({"device": group.lead + off,
                                "reason": obsx.R_LINK_HEADROOM,
                                "devices": tuple(
                                    d + off for d in group.device_indices)})
                    break
        if not out:
            out.append({"reason": obsx.R_NO_FEASIBLE_GROUP, "chips": k})
        return tuple(out)

    def _reserve_group_locked(self, task: Task,
                              group: GangReservation) -> None:
        """Apply the reservation bookkeeping for a KNOWN group: per-chip
        memory/slot charges, link charges, the bound map. Shared by
        admission and by the preemption layer's exact rollback (restoring a
        trial-evicted victim to the group it held)."""
        r = task.resources
        per_chip = r.hbm_bytes // max(r.chips, 1)
        need = slots_needed(task)
        for cell in group.cells():
            d = self.topo.cells[cell]
            # not DeviceState.admit(): a gang charges each member its
            # per-chip share, not the whole-gang footprint
            d.used_hbm += per_chip
            d.used_slots += need
            d.residents[task.uid] = task
        self.topo.reserve_links(task.uid, group, r)
        self.topo.note_cells(group.cells())  # keep the tile index exact
        self.bound[task.uid] = group
        task.device = group.lead

    def _release_locked(self, task: Task) -> Optional[GangReservation]:
        group = self.bound.pop(task.uid, None)
        if group is None:
            return None
        r = task.resources
        per_chip = r.hbm_bytes // max(r.chips, 1)
        need = slots_needed(task)
        for cell in group.cells():
            d = self.topo.cells[cell]
            if task.uid in d.residents:
                del d.residents[task.uid]
                d.used_hbm -= per_chip
                d.used_slots -= need
        self.topo.release_links(task.uid)
        self.topo.note_cells(group.cells())  # keep the tile index exact
        return group

    # -- paper API at gang granularity ----------------------------------------
    def task_begin(self, task: Task) -> Optional[GangReservation]:
        with self._lock:
            return self._admit_locked(task)

    def task_end(self, task: Task, *, epoch: Optional[int] = None) -> bool:
        """Release the WHOLE reservation (chips + links) and re-drive the
        waiter queue, hinting the drain with the freed cells so waiters no
        freed cell can satisfy are skipped without a probe."""
        with self._lock:
            if self._stale_locked(task, epoch):
                return False
            group = self._release_locked(task)
            self._admit_cbs.pop(task.uid, None)
            calib = self._calib
            if calib is not None and group is not None:
                calib.note_end(task, self._clock())
            tr = self._trace
            if tr is not None and group is not None:
                off = self._trace_dev_off
                epoch = self._epochs.get(task.uid, 0)
                if max(task.resources.chips, 1) > 1:
                    tr.emit(obs.GANG_RELEASE, task.uid, task.name,
                            group.lead + off, epoch)
                tr.emit(obs.END, task.uid, task.name,
                        group.lead + off, epoch,
                        data={"hw": observed_highwater(task)}
                        if calib is not None else None)
            freed = tuple(group.cells()) if group is not None else None
            fired = self._drain_locked(freed=freed)
        self._fire(fired)
        return True

    def _hint_may_fit(self, task: Task, freed: Tuple[Cell, ...]) -> bool:
        # sound: a newly feasible group must contain at least one freed cell
        # (all other cells — and all links, whose endpoints are freed cells —
        # are unchanged since the waiter parked), and that cell must itself
        # pass the member check
        r = task.resources
        per_chip = r.hbm_bytes // max(r.chips, 1)
        need = slots_needed(task)
        return any(self._member_ok(c, per_chip, need) for c in freed)

    # -- fault tolerance ------------------------------------------------------
    def mark_dead(self, cell: CellOrIndex) -> List[Task]:
        """Fail one chip: every gang overlapping it is evicted WHOLE (its
        entire reservation — all member chips and link charges — is
        released under the epoch fence, then it re-enters the waiter queue
        at the front of its priority class)."""
        cell = self._as_cell(cell)
        with self._lock:
            self.topo.set_alive(cell, False)
            tr = self._trace
            off = self._trace_dev_off
            if tr is not None:
                tr.emit(obs.MARK_DEAD,
                        device=self.topo.cells[cell].index + off)
            evicted: List[Task] = []
            for uid, group in list(self.bound.items()):
                if cell not in set(group.cells()):
                    continue
                task = None
                for c2 in group.cells():
                    task = self.topo.cells[c2].residents.get(uid)
                    if task is not None:
                        break
                if tr is not None:
                    tr.emit(obs.EVICT, task.uid, task.name,
                            group.lead + off,
                            self._epochs.get(task.uid, 0),
                            data={"cause": "device_dead"})
                    if max(task.resources.chips, 1) > 1:
                        # whole-gang eviction releases the reservation too:
                        # reserve/release must pair across every exit path
                        tr.emit(obs.GANG_RELEASE, task.uid, task.name,
                                group.lead + off,
                                self._epochs.get(task.uid, 0))
                ex = self._explain
                if ex is not None:
                    ex.record(task.uid, task.name, obsx.EVICTED,
                              device=group.lead + off,
                              reasons=({"reason": obsx.R_DEVICE_DEAD,
                                        "device":
                                            self.topo.cells[cell].index
                                            + off},))
                self._release_locked(task)
                task.device = None
                evicted.append(task)
            self._requeue_evicted_locked(evicted)
            fired = self._drain_locked()  # waiters may fit on survivors
            fired += self._fail_impossible_locked()
        self._fire(fired)
        return evicted

    def revive(self, cell: CellOrIndex) -> None:
        cell = self._as_cell(cell)
        with self._lock:
            self.topo.set_alive(cell, True)
            tr = self._trace
            if tr is not None:
                tr.emit(obs.REVIVE, device=self.topo.cells[cell].index
                        + self._trace_dev_off)
            fired = self._drain_locked(freed=(cell,))
        self._fire(fired)

    # -- runtime contention (the simulator's dilation inputs) -----------------
    def link_pressure(self, task: Task) -> float:
        """ICI-contention dilation factor for a RESIDENT task: processor
        sharing on the busiest link its collectives traverse (1.0 when its
        links have headroom or it runs no collectives)."""
        with self._lock:
            loads = self.topo.task_link_loads(task.uid)
        return interference.ici_slowdown(loads)

    # -- introspection --------------------------------------------------------
    def utilization(self) -> float:
        busy = sum(1 for d in self.topo.cells.values() if d.residents)
        return busy / len(self.topo.cells)
