"""Low-overhead monotonic-clock spans on a bounded ring buffer.

Counterpart of ``repro/obs/tracing.py``.

A ``Span`` is a context manager timing one operation::

    with tracer.span("sched.run_span", tau=12, rounds=4):
        ...

Finished spans land on a bounded ring buffer as plain dicts (oldest
evicted first — tracing never grows without bound under a long soak) and
are exported as JSONL.  Spans nest: a thread-local stack records the
active span per thread, so every record carries its parent's id and a
trace can be reassembled into the call tree.  All timestamps come from
``time.monotonic()`` — the same clock source the service supervisor's
heartbeat and the recovery MTTR records use, so span timings and
chaos-report latencies are directly comparable.

The per-span cost is two clock reads, a couple of attribute writes and
one deque append under a lock — cheap enough to leave on in production
spans (the reference pins its enabled-overhead budget in
tests/test_telemetry.py).  The *disabled* path never reaches this
module: the null telemetry object returns a shared no-op context
manager instead (obs/telemetry.py).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, List, Optional


class Span:
    """One timed operation; re-entrant use is not supported (make a new
    span per operation — ``Tracer.span`` always does)."""
    __slots__ = ("_tracer", "name", "attrs", "t0", "dur_s", "span_id",
                 "parent_id")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.dur_s = 0.0
        self.span_id = 0
        self.parent_id: Optional[int] = None

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        self.parent_id = stack[-1].span_id if stack else None
        with tr._lock:
            tr._next_id += 1
            self.span_id = tr._next_id
        stack.append(self)
        self.t0 = tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        self.dur_s = tr.clock() - self.t0
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        tr._finish(self)
        return False


class Tracer:
    """Bounded span recorder with nesting and a JSONL exporter."""

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 on_finish: Optional[Callable[[str, float], None]] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.clock = clock
        self.on_finish = on_finish
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self._tls = threading.local()
        self._next_id = 0
        self.recorded = 0           # finished spans, lifetime
        self.dropped = 0            # evicted from the ring unobserved

    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def _finish(self, span: Span) -> None:
        rec = {"name": span.name, "t0": span.t0,
               "dur_s": span.dur_s, "id": span.span_id,
               "parent": span.parent_id,
               "thread": threading.current_thread().name}
        if span.attrs:
            rec["attrs"] = span.attrs
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(rec)
            self.recorded += 1
        if self.on_finish is not None:
            self.on_finish(span.name, span.dur_s)

    # -- export ---------------------------------------------------------------
    def drain(self) -> List[dict]:
        """Remove and return every buffered span record (oldest first)."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
        return out

    def peek(self, n: Optional[int] = None) -> List[dict]:
        """The newest ``n`` buffered records (all when n is None),
        without consuming them."""
        with self._lock:
            out = list(self._buf)
        return out if n is None else out[-n:]

    def export_jsonl(self, path: str, append: bool = True,
                     clear: bool = True) -> int:
        """Write buffered spans as JSONL (one record per line); returns
        the number written."""
        recs = self.drain() if clear else self.peek()
        with open(path, "a" if append else "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        return len(recs)
