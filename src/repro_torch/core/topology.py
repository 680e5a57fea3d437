"""Pod/mesh topology model: the device-group substrate for gang placement.

The paper schedules single-GPU tasks inside one node. At pod scale the
schedulable unit for a multi-chip task is a *device group*: a contiguous,
ICI-connected block of a (rows x cols) chip grid inside one pod, or — for
tasks larger than a pod — a window of whole pods bridged by DCN. This module
owns ALL of the grid math that ``scheduler/slice.py`` used to carry privately,
plus the piece the schedulers never had: **per-link bandwidth accounting**.

Model (TPU v5e-like, DESIGN.md §2):

  * a chip is a ``DeviceState`` cell at ``(pod, row, col)``; flat device
    index ``(pod * rows + row) * cols + col`` matches the executor's device
    table;
  * **ICI links** connect orthogonally adjacent cells within a pod (a mesh;
    wraparound torus links are deliberately not modelled — contiguous slices
    never need them);
  * **DCN edges** connect consecutive pods (one aggregate edge per pod pair,
    ~4x slower than an ICI link);
  * a multi-chip task with ``collective_bytes`` puts a steady per-link load
    on every link *internal* to its group: ring collectives move ~the full
    payload through each link of the ring once per pass, so the per-link
    share is ``collective_bytes / est_seconds / link_bw`` — the fraction of
    that link's bandwidth the task occupies per wall-second while running.
    ``reserve``/``release`` maintain the aggregate share per link so a
    scheduler can check headroom at admission and a simulator can dilate
    co-resident gangs that oversubscribe a shared link.

Candidate enumeration is shape-aligned (a k-chip task considers near-square
factorizations of k tiled at multiples of the shape), which keeps the search
cheap and the torus unfragmented — the same policy the old slice scheduler
used, now shared by every topology client.

Copy of ``src/repro/core/topology.py`` with its imports rewritten to
``repro_torch`` and two comments reworded (the bandwidths', and
``_ShapeIndex``'s); keep the two in step. The TPU ICI/DCN bandwidths stay
until the H100 fleet model (ROADMAP A).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler.base import DEFAULT_HBM, DeviceState
from repro_torch.core.task import ResourceVector

# bandwidth constants (the reference probe's TPU roofline): one ICI link of a
# v5e-class chip, and one aggregate DCN edge between two pods
ICI_BW = 50e9
DCN_BW = 12.5e9

Cell = Tuple[int, int, int]            # (pod, row, col)
# ("ici", cell_a, cell_b) with cell_a < cell_b, or ("dcn", pod_a, pod_b)
Link = Tuple


@dataclasses.dataclass(frozen=True)
class SliceRect:
    """A contiguous rectangle of chips on one pod's (rows x cols) grid."""
    pod: int
    r0: int
    c0: int
    rows: int
    cols: int

    @property
    def chips(self) -> int:
        return self.rows * self.cols

    def cells(self) -> Iterator[Cell]:
        for r in range(self.r0, self.r0 + self.rows):
            for c in range(self.c0, self.c0 + self.cols):
                yield (self.pod, r, c)


@dataclasses.dataclass(frozen=True)
class GangReservation:
    """An atomically-held device group: one rect (intra-pod gang) or a window
    of whole-pod rects bridged by DCN. Duck-compatible with the old bare
    ``SliceRect`` placement (``chips``, ``cells()``), plus the flat
    ``device_indices`` the executor's device table and the simulator's busy
    accounting consume."""
    rects: Tuple[SliceRect, ...]
    device_indices: Tuple[int, ...]

    @property
    def chips(self) -> int:
        return len(self.device_indices)

    @property
    def lead(self) -> int:
        """Flat index of the group's first cell — the placement an audit log
        or a single-device consumer reports."""
        return self.device_indices[0]

    def cells(self) -> Iterator[Cell]:
        for rect in self.rects:
            yield from rect.cells()


def placement_devices(placement) -> Tuple[int, ...]:
    """Normalize a scheduler placement to flat device indices: an int from
    the flat schedulers becomes a 1-tuple, a ``GangReservation`` contributes
    its whole group."""
    idx = getattr(placement, "device_indices", None)
    if idx is not None:
        return tuple(idx)
    return (placement,)


def slice_shapes(chips: int, rows: int, cols: int) -> List[Tuple[int, int]]:
    """Near-square factorizations of ``chips`` that fit the grid (preferred
    first: square slices minimize ring hop count for both mesh axes)."""
    shapes = []
    for r in range(1, chips + 1):
        if chips % r:
            continue
        c = chips // r
        if r <= rows and c <= cols:
            shapes.append((r, c))
    shapes.sort(key=lambda rc: abs(rc[0] - rc[1]))
    return shapes


TilePos = Tuple[int, int, int]         # (pod, r0, c0) of an aligned tile


class _ShapeIndex:
    """Incremental per-shape tile index (the sub-linear placement substrate).

    Aligned tiles of one (sr x sc) shape are DISJOINT — the tiling steps by
    the shape itself — so every cell belongs to at most one tile per shape
    and a cell-state flip updates exactly one tile's counters. Maintains,
    per tile position (enumeration order = ``candidate_groups`` order):

      * ``busy``  — member cells that are dead or hold residents; 0 means
        the tile is a completely free group;
      * ``dead``  — member cells marked dead; ``alive_tiles`` counts tiles
        at dead == 0 (the O(1) ``can_ever_fit`` input);
      * ``free_heap`` — a lazy min-heap of tile positions that became fully
        free (a per-shape free list; stale entries are skimmed on
        peek);
      * ``agg``  — cached (min_free_hbm, max_used_slots, sum_demand) per
        tile, EVICTED whenever a member cell changes and recomputed on
        demand in the same cell order the full enumeration used, so float
        tie-breaks match the historical scan bit-for-bit.
    """

    __slots__ = ("sr", "sc", "rows", "cols", "positions", "busy", "dead",
                 "agg", "alive_tiles", "free_heap")

    def __init__(self, topo: "Topology", sr: int, sc: int):
        self.sr, self.sc = sr, sc
        self.rows, self.cols = topo.rows, topo.cols
        self.positions: List[TilePos] = [
            (p, r0, c0)
            for p in range(topo.pods)
            for r0 in range(0, topo.rows - sr + 1, sr)
            for c0 in range(0, topo.cols - sc + 1, sc)]
        self.busy: Dict[TilePos, int] = {}
        self.dead: Dict[TilePos, int] = {}
        self.agg: Dict[TilePos, Tuple[int, int, float]] = {}
        for pos in self.positions:
            b = d = 0
            for cell in self.tile_cells(pos):
                dev = topo.cells[cell]
                if not dev.alive:
                    d += 1
                if not dev.alive or dev.residents:
                    b += 1
            self.busy[pos] = b
            self.dead[pos] = d
        self.alive_tiles = sum(1 for pos in self.positions
                               if not self.dead[pos])
        self.free_heap: List[TilePos] = [pos for pos in self.positions
                                         if not self.busy[pos]]
        heapq.heapify(self.free_heap)

    def tile_cells(self, pos: TilePos) -> Iterator[Cell]:
        p, r0, c0 = pos
        for r in range(r0, r0 + self.sr):
            for c in range(c0, c0 + self.sc):
                yield (p, r, c)

    def tile_of(self, cell: Cell) -> Optional[TilePos]:
        """The unique tile containing ``cell`` (None for remainder cells
        beyond the last aligned tile of an axis)."""
        p, r, c = cell
        r0 = r - r % self.sr
        c0 = c - c % self.sc
        if r0 + self.sr > self.rows or c0 + self.sc > self.cols:
            return None
        return (p, r0, c0)

    def peek_free(self) -> Optional[TilePos]:
        """Earliest-enumeration fully-free tile, or None (lazy heap skim)."""
        h = self.free_heap
        while h and self.busy[h[0]]:
            heapq.heappop(h)
        return h[0] if h else None


class Topology:
    """A multi-pod chip grid with per-chip state and per-link bandwidth
    accounting. Schedulers are clients: they decide *policy* (which candidate
    group to take, what counts as feasible); the topology owns *structure*
    (cells, shapes, links) and the link ledger.

    **Placement index.** Beyond enumeration (``candidate_groups``), the
    topology maintains incremental per-shape tile indexes (built lazily on
    first query for a shape, then updated on every occupancy/liveness change
    via ``note_cells`` / ``set_alive``) so a placement pass costs O(1) per
    candidate tile instead of O(tile size), ``can_ever_fit``-style checks
    are O(shapes), and completely-free groups come off a maintained free
    list. Contract: all cell-state mutation after the first indexed query
    must go through the owning scheduler's reserve/release paths (which call
    ``note_cells``) or ``set_alive`` — out-of-band mutation should call
    ``invalidate_index()``. Cells are uniform-HBM (``hbm_per_chip``), which
    the O(1) feasibility shortcuts rely on."""

    def __init__(self, pods: int = 1, rows: int = 4, cols: int = 4,
                 hbm_per_chip: int = DEFAULT_HBM,
                 ici_bw: float = ICI_BW, dcn_bw: float = DCN_BW):
        self.pods, self.rows, self.cols = pods, rows, cols
        self.ici_bw, self.dcn_bw = ici_bw, dcn_bw
        self.cells: Dict[Cell, DeviceState] = {
            (p, r, c): DeviceState(index=self.flat_index((p, r, c)),
                                   total_hbm=hbm_per_chip)
            for p in range(pods) for r in range(rows) for c in range(cols)}
        self.hbm_per_chip = hbm_per_chip
        # link -> aggregate bandwidth share ([0, n) — may exceed 1 when a
        # soft-link policy oversubscribes; the simulator dilates then)
        self.link_used: Dict[Link, float] = {}
        # task uid -> {link: share} charged at reserve time, so release is
        # exact even if the task's resources object is rebuilt meanwhile
        self._charges: Dict[int, Dict[Link, float]] = {}
        # placement index state (see class docstring): per-shape tile
        # indexes built lazily, plus per-cell busy/dead snapshots so a
        # note_cells call can turn "cell changed" into exact tile deltas
        self._shape_indexes: Dict[Tuple[int, int], _ShapeIndex] = {}
        self._shape_cache: Dict[int, List[Tuple[int, int]]] = {}
        self._cell_busy: Dict[Cell, bool] = {c: False for c in self.cells}
        self._cell_dead: Dict[Cell, bool] = {c: False for c in self.cells}
        self._pod_dead: List[int] = [0] * pods

    # -- indexing -----------------------------------------------------------
    @property
    def pod_size(self) -> int:
        return self.rows * self.cols

    @property
    def total_chips(self) -> int:
        return self.pods * self.pod_size

    def flat_index(self, cell: Cell) -> int:
        p, r, c = cell
        return (p * self.rows + r) * self.cols + c

    def cell_of(self, flat: int) -> Cell:
        c = flat % self.cols
        pr = flat // self.cols
        return (pr // self.rows, pr % self.rows, c)

    def device_list(self) -> List[DeviceState]:
        """Cells in flat-index order — the executor's device table view."""
        return list(self.cells.values())

    # -- candidate enumeration ----------------------------------------------
    def _reservation(self, rects: Sequence[SliceRect]) -> GangReservation:
        idx = tuple(self.flat_index(c) for rect in rects
                    for c in rect.cells())
        return GangReservation(tuple(rects), idx)

    def candidate_groups(self, chips: int) -> Iterator[GangReservation]:
        """Every device group a ``chips``-sized gang could hold: contiguous
        rects inside one pod (shape-aligned tiling, near-square shapes
        first), or — past one pod's capacity — windows of whole pods. The
        caller filters by its own feasibility policy."""
        if chips <= self.pod_size:
            for (sr, sc) in slice_shapes(chips, self.rows, self.cols):
                for pod in range(self.pods):
                    for r0 in range(0, self.rows - sr + 1, sr):
                        for c0 in range(0, self.cols - sc + 1, sc):
                            yield self._reservation(
                                [SliceRect(pod, r0, c0, sr, sc)])
            return
        if chips % self.pod_size:
            return  # pod-spanning gangs are whole-pod multiples only
        m = chips // self.pod_size
        for p0 in range(0, self.pods - m + 1):
            yield self._reservation(
                [SliceRect(p, 0, 0, self.rows, self.cols)
                 for p in range(p0, p0 + m)])

    def has_feasible_shape(self, chips: int) -> bool:
        """Does ANY candidate group of this size exist on the grid at all
        (alive or not)? False means the gang shape itself is impossible —
        e.g. 5 chips on a 4x4 pod (no 1x5 fits), or a non-pod-multiple
        spanning request — and a scheduler should fail it fast rather than
        park it forever."""
        return next(iter(self.candidate_groups(chips)), None) is not None

    # -- incremental placement index -----------------------------------------
    def shapes_for(self, chips: int) -> List[Tuple[int, int]]:
        """``slice_shapes`` memoized per gang size (the list is a pure
        function of the static grid)."""
        s = self._shape_cache.get(chips)
        if s is None:
            s = slice_shapes(chips, self.rows, self.cols)
            self._shape_cache[chips] = s
        return s

    def shape_index(self, sr: int, sc: int) -> _ShapeIndex:
        idx = self._shape_indexes.get((sr, sc))
        if idx is None:
            idx = _ShapeIndex(self, sr, sc)
            self._shape_indexes[(sr, sc)] = idx
        return idx

    def tile_group(self, sr: int, sc: int, pos: TilePos) -> GangReservation:
        p, r0, c0 = pos
        return self._reservation([SliceRect(p, r0, c0, sr, sc)])

    def tile_agg(self, idx: _ShapeIndex,
                 pos: TilePos) -> Tuple[int, int, float]:
        """Cached per-tile (min free HBM, max used slots, sum of in-use
        demand). Recomputed on demand after eviction; the demand sum walks
        cells in rect order — the exact float-add sequence of the historical
        per-candidate scan — so placement tie-breaks cannot drift."""
        a = idx.agg.get(pos)
        if a is None:
            min_free: Optional[int] = None
            max_slots = 0
            sum_demand = 0.0
            for cell in idx.tile_cells(pos):
                d = self.cells[cell]
                free = d.free_hbm
                if min_free is None or free < min_free:
                    min_free = free
                if d.used_slots > max_slots:
                    max_slots = d.used_slots
                sum_demand += d.in_use_demand
            a = (min_free if min_free is not None else 0,
                 max_slots, sum_demand)
            idx.agg[pos] = a
        return a

    def note_cells(self, cells_changed: Iterable[Cell]) -> None:
        """Occupancy/liveness of these cells may have changed: update every
        built shape index incrementally. O(changed cells x built shapes) —
        tiles are disjoint per shape, so each cell touches exactly one tile
        per shape. Reserve/release paths call this; see the class docstring
        for the out-of-band-mutation contract."""
        for cell in cells_changed:
            d = self.cells[cell]
            dead = not d.alive
            busy = dead or bool(d.residents)
            old_dead = self._cell_dead[cell]
            old_busy = self._cell_busy[cell]
            if dead != old_dead:
                self._cell_dead[cell] = dead
                self._pod_dead[cell[0]] += 1 if dead else -1
            if busy != old_busy:
                self._cell_busy[cell] = busy
            for idx in self._shape_indexes.values():
                pos = idx.tile_of(cell)
                if pos is None:
                    continue
                idx.agg.pop(pos, None)
                if busy != old_busy:
                    n = idx.busy[pos] + (1 if busy else -1)
                    idx.busy[pos] = n
                    if n == 0:
                        heapq.heappush(idx.free_heap, pos)
                if dead != old_dead:
                    n = idx.dead[pos] + (1 if dead else -1)
                    idx.dead[pos] = n
                    if dead and n == 1:
                        idx.alive_tiles -= 1
                    elif not dead and n == 0:
                        idx.alive_tiles += 1

    def set_alive(self, cell: Cell, alive: bool) -> None:
        """Liveness flips route through here so the index stays exact."""
        self.cells[cell].alive = alive
        self.note_cells((cell,))

    def invalidate_index(self) -> None:
        """Drop all built shape indexes (rebuilt lazily from true cell
        state). Escape hatch for callers that mutated cells out-of-band."""
        self._shape_indexes.clear()
        for cell, d in self.cells.items():
            self._cell_dead[cell] = not d.alive
            self._cell_busy[cell] = not d.alive or bool(d.residents)
        self._pod_dead = [0] * self.pods
        for (p, _, _), dead in self._cell_dead.items():
            if dead:
                self._pod_dead[p] += 1

    def any_alive_group(self, chips: int, per_chip: int) -> bool:
        """O(shapes) ``can_ever_fit`` input: does a candidate group exist
        whose members are ALL alive and could each hold ``per_chip`` bytes
        when empty? (Uniform ``hbm_per_chip`` makes the memory test
        group-independent.)"""
        if per_chip > self.hbm_per_chip:
            return False
        if chips <= self.pod_size:
            return any(self.shape_index(sr, sc).alive_tiles > 0
                       for (sr, sc) in self.shapes_for(chips))
        if chips % self.pod_size:
            return False
        m = chips // self.pod_size
        return any(all(self._pod_dead[p] == 0 for p in range(p0, p0 + m))
                   for p0 in range(self.pods - m + 1))

    def free_groups(self, chips: int) -> Iterator[GangReservation]:
        """Completely-free candidate groups straight off the maintained
        free lists (preferred shapes first, enumeration order within a
        shape) — no grid re-enumeration. Spanning sizes fall back to the
        enumerated path (pod windows are few)."""
        if chips <= self.pod_size:
            for (sr, sc) in self.shapes_for(chips):
                idx = self.shape_index(sr, sc)
                for pos in sorted(p for p in set(idx.free_heap)
                                  if not idx.busy[p]):
                    yield self.tile_group(sr, sc, pos)
            return
        for group in self.candidate_groups(chips):
            if all(not self._cell_busy[c] for c in group.cells()):
                yield group

    # -- link model ----------------------------------------------------------
    @staticmethod
    def _ici_link(a: Cell, b: Cell) -> Link:
        return ("ici", a, b) if a < b else ("ici", b, a)

    def internal_links(self, res: GangReservation) -> List[Link]:
        """Links a gang's collectives traverse: every ICI link between
        adjacent cells inside each rect, plus the DCN edge between each
        consecutive pod pair of a spanning reservation."""
        links: List[Link] = []
        for rect in res.rects:
            for (p, r, c) in rect.cells():
                if r + 1 < rect.r0 + rect.rows:
                    links.append(self._ici_link((p, r, c), (p, r + 1, c)))
                if c + 1 < rect.c0 + rect.cols:
                    links.append(self._ici_link((p, r, c), (p, r, c + 1)))
        pods_used = sorted(rect.pod for rect in res.rects)
        for pa, pb in zip(pods_used, pods_used[1:]):
            links.append(("dcn", pa, pb))
        return links

    def link_share(self, resources: ResourceVector,
                   dcn: bool = False) -> float:
        """Steady-state fraction of one link's bandwidth the task's
        collectives occupy while it runs (ring model: the full payload
        crosses each ring link once per pass). Clamped to 1.0 — a task
        cannot use more than a link."""
        if resources.chips <= 1 or resources.collective_bytes <= 0:
            return 0.0
        est = max(resources.est_seconds, 1e-12)
        bw = self.dcn_bw if dcn else self.ici_bw
        return min(resources.collective_bytes / est / bw, 1.0)

    def link_charges(self, res: GangReservation,
                     resources: ResourceVector) -> Dict[Link, float]:
        """Per-link share this gang would add: ICI share on internal mesh
        links, DCN share on pod-bridging edges."""
        ici = self.link_share(resources)
        dcn = self.link_share(resources, dcn=True)
        return {link: (dcn if link[0] == "dcn" else ici)
                for link in self.internal_links(res)
                if (dcn if link[0] == "dcn" else ici) > 0.0}

    def link_headroom_ok(self, res: GangReservation,
                         resources: ResourceVector,
                         tolerance: float = 1e-9) -> bool:
        """Would reserving this group keep every affected link within its
        bandwidth? (The hard-link admission check.)"""
        for link, share in self.link_charges(res, resources).items():
            if self.link_used.get(link, 0.0) + share > 1.0 + tolerance:
                return False
        return True

    def max_link_load(self, res: GangReservation) -> float:
        """Highest aggregate share on any link of the group — the soft-link
        policy's tie-break input and the simulator's dilation input."""
        return max((self.link_used.get(link, 0.0)
                    for link in self.internal_links(res)), default=0.0)

    def reserve_links(self, uid: int, res: GangReservation,
                      resources: ResourceVector) -> None:
        charges = self.link_charges(res, resources)
        for link, share in charges.items():
            self.link_used[link] = self.link_used.get(link, 0.0) + share
        if charges:
            self._charges[uid] = charges

    def task_link_loads(self, uid: int) -> List[float]:
        """Current aggregate share on each link task ``uid`` is charged on —
        the simulator's ICI-dilation input (empty for link-free tasks)."""
        return [self.link_used.get(link, 0.0)
                for link in self._charges.get(uid, ())]

    def release_links(self, uid: int) -> None:
        for link, share in self._charges.pop(uid, {}).items():
            left = self.link_used.get(link, 0.0) - share
            if left <= 1e-12:
                self.link_used.pop(link, None)
            else:
                self.link_used[link] = left

    # -- liveness ------------------------------------------------------------
    def alive_count(self) -> int:
        return sum(1 for d in self.cells.values() if d.alive)
