"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

Counterpart of ``repro/obs/metrics.py``: the same families, bucket maths
and exposition, byte for byte.

The quantities the paper's theory cares about (participation rates,
scheme-weight mass, bound terms) and the quantities operations cares
about (span latency, ingest lag, MTTR) are all either monotone counts,
point-in-time values, or latency distributions — the three Prometheus
metric kinds.  This module implements them with zero dependencies beyond
numpy:

  * every metric family lives in a ``MetricsRegistry``; families are
    created idempotently (``registry.counter(name)`` twice returns the
    same object) and re-registration under a different kind or label set
    is an error;
  * locks are striped: metric instances draw their lock from a fixed
    pool instead of allocating one apiece, so a registry with hundreds
    of labeled children costs a handful of lock objects, and no two hot
    counters on different stripes ever contend;
  * histograms are numpy-backed with *fixed* bucket bounds chosen at
    registration: ``observe`` is one ``searchsorted`` + two adds, and
    ``observe_many`` ingests a whole span's worth of per-round samples
    in one vectorized ``bincount`` — the per-round instrumentation path
    (obs/fedmetrics.py) feeds (R, C) matrices through it;
  * ``render_prom()`` emits the Prometheus text exposition (counters as
    ``_total``-suffixed-by-caller names, histograms as cumulative
    ``_bucket{le=...}`` series plus ``_sum``/``_count``), and
    ``snapshot()`` returns the same data as plain dicts for JSONL sinks
    and the ``fed_top`` live view.

Usage::

    reg = MetricsRegistry()
    reg.counter("events_total", "events ingested").inc()
    lat = reg.histogram("span_seconds", "span wall time",
                        labelnames=("name",))
    lat.labels("engine.run_span").observe(0.004)
    print(reg.render_prom())
"""
from __future__ import annotations

import itertools
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# latency-oriented default bounds (seconds): 50us .. 30s
DEFAULT_BUCKETS = (50e-6, 100e-6, 250e-6, 500e-6, 1e-3, 2.5e-3, 5e-3,
                   10e-3, 25e-3, 50e-3, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0, 30.0)

# -- lock striping -------------------------------------------------------------
_N_STRIPES = 16
_STRIPES = tuple(threading.Lock() for _ in range(_N_STRIPES))
_stripe_counter = itertools.count()


def _stripe() -> threading.Lock:
    """Hand out locks round-robin from a fixed pool: thread safety without
    one lock object per metric instance."""
    return _STRIPES[next(_stripe_counter) % _N_STRIPES]


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


# -- metric instances ----------------------------------------------------------

class Counter:
    """Monotone float counter."""
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = _stripe()
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counters only go up, got inc({v})")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value."""
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = _stripe()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram: counts[i] observations with
    v <= bounds[i] (exclusive of lower buckets), counts[-1] the +Inf
    overflow.  numpy-backed so batch observation is vectorized."""
    __slots__ = ("_lock", "bounds", "_counts", "_sum")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        b = tuple(float(x) for x in buckets)
        if not b or any(y <= x for x, y in zip(b, b[1:])):
            raise ValueError(f"bucket bounds must be strictly "
                             f"increasing and non-empty, got {buckets}")
        self._lock = _stripe()
        self.bounds = np.asarray(b, np.float64)
        self._counts = np.zeros(len(b) + 1, np.int64)
        self._sum = 0.0

    def observe(self, v: float) -> None:
        i = int(np.searchsorted(self.bounds, v, side="left"))
        with self._lock:
            self._counts[i] += 1
            self._sum += v

    def observe_many(self, vs) -> None:
        """Vectorized batch observe: one searchsorted + bincount for a
        whole array of samples (the per-span instrumentation path)."""
        vs = np.asarray(vs, np.float64).ravel()
        if vs.size == 0:
            return
        idx = np.searchsorted(self.bounds, vs, side="left")
        add = np.bincount(idx, minlength=len(self._counts))
        with self._lock:
            self._counts += add
            self._sum += float(vs.sum())

    @property
    def count(self) -> int:
        with self._lock:
            return int(self._counts.sum())

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def buckets(self):
        """[(upper_bound, cumulative_count), ...] ending with +Inf —
        the Prometheus cumulative form."""
        with self._lock:
            cum = np.cumsum(self._counts)
        bounds = list(self.bounds) + [math.inf]
        return list(zip(bounds, (int(c) for c in cum)))


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric family, optionally labeled.  ``labels(...)``
    returns (creating on first use) the child instance for one label
    combination; unlabeled families have a single anonymous child."""
    __slots__ = ("kind", "name", "help", "labelnames", "buckets",
                 "_lock", "_children")

    def __init__(self, kind: str, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self._lock = _stripe()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make(self):
        return (Histogram(self.buckets) if self.kind == "histogram"
                else _KINDS[self.kind]())

    def labels(self, *values, **kv):
        if kv:
            values = values + tuple(kv[n] for n in
                                    self.labelnames[len(values):])
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {key}")
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make()
            return child

    def items(self):
        with self._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    """Idempotent family registration + text/dict exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}

    def _register(self, kind: str, name: str, help: str,
                  labelnames: Sequence[str],
                  buckets: Sequence[float]) -> Family:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, cannot re-register "
                        f"as {kind}{labelnames}")
                return fam
            fam = Family(kind, name, help, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()):
        fam = self._register("counter", name, help, labelnames, ())
        return fam if fam.labelnames else fam.labels()

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()):
        fam = self._register("gauge", name, help, labelnames, ())
        return fam if fam.labelnames else fam.labels()

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS):
        fam = self._register("histogram", name, help, labelnames, buckets)
        return fam if fam.labelnames else fam.labels()

    def get(self, name: str) -> Optional[Family]:
        with self._lock:
            return self._families.get(name)

    def families(self):
        with self._lock:
            return sorted(self._families.items())

    # -- exposition -----------------------------------------------------------
    def render_prom(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        out = []
        for name, fam in self.families():
            if fam.help:
                out.append(f"# HELP {name} {fam.help}")
            out.append(f"# TYPE {name} {fam.kind}")
            for key, child in fam.items():
                base = ",".join(
                    f'{n}="{_escape_label(v)}"'
                    for n, v in zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    for le, cum in child.buckets():
                        lbl = (base + "," if base else "") + \
                            f'le="{_fmt(le)}"'
                        out.append(f"{name}_bucket{{{lbl}}} {cum}")
                    sfx = f"{{{base}}}" if base else ""
                    out.append(f"{name}_sum{sfx} {child.sum}")
                    out.append(f"{name}_count{sfx} {child.count}")
                else:
                    sfx = f"{{{base}}}" if base else ""
                    out.append(f"{name}{sfx} {_fmt(child.value)}")
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self) -> dict:
        """Plain-data view of every family — the JSONL metrics sink and
        the ``fed_top`` renderer read this."""
        snap = {}
        for name, fam in self.families():
            samples = []
            for key, child in fam.items():
                labels = dict(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    samples.append({
                        "labels": labels, "count": child.count,
                        "sum": child.sum,
                        "buckets": [[b if b != math.inf else "+Inf", c]
                                    for b, c in child.buckets()]})
                else:
                    samples.append({"labels": labels,
                                    "value": child.value})
            snap[name] = {"kind": fam.kind, "help": fam.help,
                          "samples": samples}
        return snap
