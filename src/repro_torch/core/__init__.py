"""The paper's live loop in PyTorch: task construction (``taskgraph``,
Algorithm 1), probes (``probe``), lazy buffers (``lazy``), the schedulers
(``scheduler``: SA, CG, schedGPU's memory-only policy, MGB Algorithms 2
and 3), the live executor (``executor``), its virtual-clock twin
(``simulator``, over the ``interference`` model) and the open-arrival
front-end (``cluster``) over either; the paper's Rodinia jobs
(``workloads``).

Port of ``src/repro/core/__init__.py``: ``Cluster``/``JobHandle``/
``JobStatus`` are re-exported lazily (PEP 562), so task-only consumers do not
import torch's CUDA machinery through the executor.
"""
from repro_torch.core.task import Job, ResourceVector, Task, UnitTask  # noqa: F401
from repro_torch.core.taskgraph import build_gpu_tasks  # noqa: F401

_CLUSTER_EXPORTS = ("Cluster", "JobHandle", "JobStatus")


def __getattr__(name):
    if name in _CLUSTER_EXPORTS:
        from repro_torch.core import cluster
        return getattr(cluster, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
