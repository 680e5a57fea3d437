"""Event-sourced observability plane for the scheduler/executor stack, copied
from ``src/repro/obs/`` (each module names its source):

  * ``obs.events``  — the lifecycle event schema, the ``Tracer``, and
    ``attach_tracer``
  * ``obs.explain`` — per-task decision verdicts and ``attach_explainer``
  * ``obs.export``  — Chrome/Perfetto trace-event JSON
  * ``obs.metrics`` — log-bucketed histograms + counter/gauge registry
  * ``obs.profile`` — per-task observed-vs-predicted attribution joined
    from the event stream, per-device occupancy timelines
  * ``obs.calibrate`` — online probe calibration fed back into admission,
    never shrinking a reservation below the observed high-water (on a
    card the executor measures that high-water: ``core.executor``)
  * ``obs.replay``  — flight recorder, sim/live stream differ, lifecycle
    validator
  * ``obs.slo``     — rolling-window SLO burn rates, probe-drift alerts,
    Prometheus text exposition
  * ``obs.whatif``  — counterfactual replay of a recorded trace under
    alternate scheduler policies on the sim backend

Nothing here imports ``repro_torch.core`` at module load (``obs.whatif``
imports the core lazily), so the scheduler base imports the package without
cycles.
"""
from repro_torch.obs import (  # noqa: F401
    calibrate, events, explain, export, metrics, profile, replay, slo,
    whatif,
)
from repro_torch.obs.calibrate import (  # noqa: F401
    CalibratedScheduler, CalibrationStore, attach_calibrator,
)
from repro_torch.obs.events import Event, Tracer, attach_tracer  # noqa: F401
from repro_torch.obs.explain import (  # noqa: F401
    Explainer, Verdict, attach_explainer, format_verdicts,
)
from repro_torch.obs.profile import (  # noqa: F401
    Profiler, TaskProfile, device_occupancy, format_profile,
    profiles_from_events,
)
