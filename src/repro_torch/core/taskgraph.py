"""Task construction — paper Algorithm 1.

Unit tasks that share memory objects are merged into one schedulable Task so
they always land on the same device (no cross-device data movement). The paper
does this over LLVM def-use chains; here the memobj sets come either from the
lazy runtime (buffer pseudo-addresses a computation reads/writes) or from
explicit declarations on ``UnitTask``.

The merge is transitive closure over the "shares a buffer" relation —
implemented with union-find (the paper's doubly-nested visited loop is the
same closure, O(n^2); union-find keeps large job graphs cheap).

Copy of ``src/repro/core/taskgraph.py`` with its imports rewritten to
``repro_torch``; keep the two in step.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.core.task import Task, UnitTask


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, i: int) -> int:
        while self.parent[i] != i:
            self.parent[i] = self.parent[self.parent[i]]
            i = self.parent[i]
        return i

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_gpu_tasks(units: Sequence[UnitTask]) -> List[Task]:
    """Paper Alg. 1: group unit tasks whose memobj sets intersect."""
    n = len(units)
    uf = _UnionFind(n)
    owner: Dict[str, int] = {}  # memobj -> first unit index seen
    for i, u in enumerate(units):
        for obj in u.memobjs:
            if obj in owner:
                uf.union(owner[obj], i)
            else:
                owner[obj] = i
    groups: Dict[int, List[UnitTask]] = {}
    for i, u in enumerate(units):
        groups.setdefault(uf.find(i), []).append(u)
    tasks = []
    for members in groups.values():
        name = "+".join(m.name or str(m.uid) for m in members[:3])
        if len(members) > 3:
            name += f"+{len(members) - 3}more"
        tasks.append(Task(units=members, name=name))
    # deterministic order: by first unit uid (program order)
    tasks.sort(key=lambda t: min(u.uid for u in t.units))
    return tasks
