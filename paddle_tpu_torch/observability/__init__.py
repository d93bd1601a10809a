"""paddle_tpu_torch.observability — the metrics/trace/postmortem substrate.

Counterpart of `paddle_tpu.observability`: the stdlib-only modules,
copied (the port imports nothing of the JAX package), with their schemas
and family names unchanged so the repo's tools grade the port's
artifacts as they grade the JAX package's:

  metrics.py         — Counter/Gauge/Histogram registry with label sets,
                       consistent snapshots, JSONL (metrics.v1) +
                       Prometheus text; rendered/compared by
                       tools/metrics_report.py
  tracecontext.py    — trace/span ids, thread+process propagation scope,
                       the 24-byte wire context, merge_chrome_traces()
  flight_recorder.py — bounded ring of recent spans + watchdog + SIGTERM
                       hook; postmortem.v1 artifacts
  faults.py          — deterministic fault injection at named sites,
                       armed through the API or `PTN_FAULTS`
  decisions.py       — the decisions.v1 audit record and its replay rules
  reqtimeline.py     — per-request phase trails and reqtimeline.v1
  fleet.py           — metrics federation across serving processes, the
                       SLO burn-rate watchdog, fleet postmortem bundles
  kvledger.py        — the KV-memory attribution plane: the kvledger.v1
                       block lifecycle log, per-tenant residency gauges,
                       the step-boundary reconciler
  numerics.py        — the numerics health plane: stats taps inside the
                       captured executables, the anomaly monitor, the
                       bisection localizer
  kineto.py          — stdlib-only reader of torch.profiler chrome traces
                       (the counterpart of the XSpace decoder xplane.py)
  deviceprof.py      — the device profile: one-shot torch.profiler
                       captures parsed into deviceprof.v1 records, joined
                       to the cost model's roofline; its CLI summarizes a
                       capture

Each module finds its siblings under the port's own names
(`paddle_tpu_torch.profiler`, `paddle_tpu_torch.observability.metrics`),
so the two packages' registries and tracers never see each other.
"""
# `deviceprof` is imported on first use, not here: its CLI runs as
# `python -m paddle_tpu_torch.observability.deviceprof`
from . import decisions, faults, fleet, flight_recorder, kineto  # noqa: F401
from . import metrics  # noqa: F401
from . import kvledger, numerics, reqtimeline, tracecontext  # noqa: F401
from .flight_recorder import dump_postmortem  # noqa: F401
from .metrics import registry  # noqa: F401
from .tracecontext import merge_chrome_traces, trace_scope  # noqa: F401

__all__ = ["metrics", "tracecontext", "flight_recorder", "faults",
           "decisions", "reqtimeline", "fleet", "kvledger", "numerics",
           "kineto", "deviceprof",
           "registry", "dump_postmortem",
           "trace_scope", "merge_chrome_traces"]
