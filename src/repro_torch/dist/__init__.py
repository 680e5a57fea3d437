"""Distribution substrate on ``torch.distributed``: sharding rules, gradient
compression, pipeline parallelism.

Port of ``src/repro/dist/__init__.py``. The model/train/launch layers use
these to turn single-device steps into multi-device ones on ``DeviceMesh``
and ``DTensor``: the genuinely multi-chip tasks (``ResourceVector.chips >
1``) the paper's schedulers place.

  * ``repro_torch.dist.sharding``    — logical-axis activation constraints
    and divisibility-aware parameter/batch/cache specs, as DTensor
    placements.
  * ``repro_torch.dist.compression`` — blockwise int8 gradient compression
    with error feedback.
  * ``repro_torch.dist.pipeline``    — GPipe-style microbatch pipeline over
    a ``stage`` mesh dimension (forward only).
  * ``repro_torch.dist.kernel_sharding`` — the hand kernels' DTensor
    sharding strategies.
"""
from repro_torch.dist import compression, pipeline, sharding  # noqa: F401
