"""Observability modules copied from ``src/repro/obs/`` so far: the event
schema and tracer (``events``) and decision verdicts (``explain``), which the
scheduler base emits into, the histograms and registry (``metrics``) the
serving engine records TTFT and TPOT into, and the flight recorder and
sim/live stream differ (``replay``). Export, profiling, calibration, SLOs
and what-if replay come in a later slice."""
from repro_torch.obs import events, explain, metrics, replay  # noqa: F401
from repro_torch.obs.events import Event, Tracer, attach_tracer  # noqa: F401
from repro_torch.obs.explain import Explainer, Verdict, attach_explainer  # noqa: F401
