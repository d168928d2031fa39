"""repro_torch.obs — the federation telemetry plane.

The port's own copy of ``repro/obs``, behaviour for behaviour (numpy and
the standard library only; it imports nothing of the reference):

  * :mod:`repro_torch.obs.metrics` — thread-safe counters / gauges /
    fixed-bucket histograms in a :class:`MetricsRegistry`, with a
    Prometheus text exposition and a plain-dict snapshot;
  * :mod:`repro_torch.obs.tracing` — monotonic-clock spans on a bounded
    ring buffer with parent/child nesting and a JSONL exporter;
  * :mod:`repro_torch.obs.telemetry` — the :class:`Telemetry` facade every
    constructor accepts (``telemetry=None`` → the shared :data:`NULL`
    no-op), with ``trace_dir=`` for a ``torch.profiler`` trace of
    ``RoundEngine.run_span``;
  * :mod:`repro_torch.obs.fedmetrics` — :class:`FedObserver`, per-round
    paper-level signals (participation, scheme weight mass, live
    Theorem 3.1 bound terms).

The families and their label sets are the reference's, so a dashboard
that reads one package's exposition reads the other's.
"""
from .metrics import (DEFAULT_BUCKETS, Counter, Family, Gauge, Histogram,
                      MetricsRegistry)
from .tracing import Span, Tracer
from .telemetry import NULL, NullTelemetry, Telemetry, resolve
from .fedmetrics import FedObserver, scheme_mass

__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Family", "Gauge", "Histogram",
    "MetricsRegistry", "Span", "Tracer", "NULL", "NullTelemetry",
    "Telemetry", "resolve", "FedObserver", "scheme_mass",
]
