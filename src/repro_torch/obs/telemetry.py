"""The `Telemetry` facade and its no-op null twin.

Counterpart of ``repro/obs/telemetry.py``.  One ``Telemetry`` object
threads through every constructor in the federation stack (engine →
scheduler → checkpoint).  It owns a
:class:`~repro_torch.obs.metrics.MetricsRegistry` and a
:class:`~repro_torch.obs.tracing.Tracer`, and wires them together: every
finished span's duration is also observed into the
``span_seconds{name=...}`` histogram family, so the prom exposition and
the JSONL trace describe the same events.

The default everywhere is :data:`NULL`, a ``NullTelemetry`` whose
metrics are shared no-op singletons and whose ``span()`` returns a
shared no-op context manager — no allocation, no clock reads, no locks.
Tests pin that a null-telemetry run is bit-identical to an
uninstrumented one.

Spans time the host.  On a CUDA device the work a span dispatches runs
asynchronously, so ``span_seconds`` measures the host's dispatch of it,
as the reference's spans do under jax; nothing here synchronises the
device to make a span "accurate", which would change what the scheduler
does.

The reference's ``Telemetry(jax_trace_dir=)`` wraps ``run_span`` in a
``jax.profiler`` trace.  Its counterpart here is ``Telemetry(trace_dir=)``:
``RoundEngine.run_span`` runs inside ``torch.profiler.profile`` (CPU and,
on a CUDA device, CUDA activities) and exports a Chrome trace,
``run_span-<tau>-<n>.json``, into that directory for every span.

Constructors accept ``telemetry=None`` and call :func:`resolve` so the
null default never needs importing at call sites.
"""
from __future__ import annotations

import json
import time
from typing import Optional

from .metrics import DEFAULT_BUCKETS, MetricsRegistry
from .tracing import Tracer


class Telemetry:
    """Live telemetry: metrics registry + span tracer + sinks."""

    enabled = True

    def __init__(self, span_capacity: int = 4096,
                 trace_dir: Optional[str] = None):
        self.registry = MetricsRegistry()
        self._span_seconds = self.registry.histogram(
            "span_seconds", "wall time of traced spans by name",
            labelnames=("name",), buckets=DEFAULT_BUCKETS)
        self.tracer = Tracer(
            capacity=span_capacity,
            on_finish=lambda name, dur:
                self._span_seconds.labels(name).observe(dur))
        # when set, RoundEngine.run_span runs under torch.profiler and
        # writes a Chrome trace of each span into this directory
        self.trace_dir = trace_dir

    # -- metric / span creation (delegates) -----------------------------------
    def counter(self, name: str, help: str = "", labelnames=()):
        return self.registry.counter(name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()):
        return self.registry.gauge(name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets=DEFAULT_BUCKETS):
        return self.registry.histogram(name, help, labelnames, buckets)

    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    # -- sinks ----------------------------------------------------------------
    def render_prom(self) -> str:
        return self.registry.render_prom()

    def write_prom(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.render_prom())

    def export_spans(self, path: str, append: bool = True) -> int:
        """Drain the span ring buffer to a JSONL file."""
        return self.tracer.export_jsonl(path, append=append)

    def dump_jsonl(self, path: str, append: bool = True) -> int:
        """One-stop JSONL sink: buffered spans (``{"kind": "span", ...}``)
        followed by a metrics snapshot (``{"kind": "metric", ...}`` per
        family).  Returns the number of lines written."""
        n = 0
        with open(path, "a" if append else "w") as f:
            for rec in self.tracer.drain():
                f.write(json.dumps({"kind": "span", **rec}) + "\n")
                n += 1
            t = time.monotonic()
            for name, fam in self.registry.snapshot().items():
                f.write(json.dumps(
                    {"kind": "metric", "t": t, "name": name, **fam}) + "\n")
                n += 1
        return n


class _NullMetric:
    """Absorbs every metric call; ``labels()`` returns itself so labeled
    and unlabeled call shapes both no-op."""
    __slots__ = ()

    def inc(self, v: float = 1.0) -> None: pass
    def dec(self, v: float = 1.0) -> None: pass
    def set(self, v: float) -> None: pass
    def observe(self, v: float) -> None: pass
    def observe_many(self, vs) -> None: pass
    def labels(self, *a, **kw): return self
    value = 0.0
    count = 0
    sum = 0.0
    def buckets(self): return []


class _NullSpan:
    """Shared no-op context manager; also quacks like a Span."""
    __slots__ = ()
    name = ""
    dur_s = 0.0
    attrs: dict = {}

    def __enter__(self): return self
    def __exit__(self, *exc): return False


_NULL_METRIC = _NullMetric()
_NULL_SPAN = _NullSpan()


class NullTelemetry:
    """Telemetry that does nothing — the default for every constructor.

    Shares the ``Telemetry`` call surface so instrumented code never
    branches on enablement; the few sites that must branch (e.g. to skip
    building an attrs dict) check ``telemetry.enabled``.
    """

    enabled = False
    registry = None
    tracer = None
    trace_dir = None

    def counter(self, name: str, help: str = "", labelnames=()):
        return _NULL_METRIC

    def gauge(self, name: str, help: str = "", labelnames=()):
        return _NULL_METRIC

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets=DEFAULT_BUCKETS):
        return _NULL_METRIC

    def span(self, name: str, **attrs):
        return _NULL_SPAN

    def render_prom(self) -> str:
        return ""

    def write_prom(self, path: str) -> None:
        pass

    def export_spans(self, path: str, append: bool = True) -> int:
        return 0

    def dump_jsonl(self, path: str, append: bool = True) -> int:
        return 0


NULL = NullTelemetry()


def resolve(telemetry) -> "Telemetry | NullTelemetry":
    """``None`` → the shared null singleton; anything else passes through."""
    return NULL if telemetry is None else telemetry
