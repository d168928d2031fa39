"""FederationService: concurrent event ingestion over a live scheduler,
with optional crash supervision.

Counterpart of ``repro/fed/service.py``, name for name and lock for lock.
The StreamScheduler consumes events pushed between blocking ``run()``
calls, but nothing *produces* them while training runs.  This layer makes
the control plane live:

  * a worker thread runs scheduler spans (``span_rounds`` per iteration)
    while any number of producer threads ``submit()`` ParticipationEvents
    concurrently;
  * the inbox is a bounded queue — a full inbox blocks (or rejects, with
    ``block=False``) the producer: backpressure instead of unbounded
    memory growth under heavy traffic;
  * ``pause()``/``resume()`` gate span execution without stopping
    ingestion; ``drain()`` waits until every submitted event has been
    handed to the scheduler;
  * ``snapshot()`` captures a span-boundary-consistent checkpoint (the
    FedState dict + params, optionally persisted via
    ``StreamScheduler.save``) without tearing the service down — the
    mid-stream checkpoint/resume path for deployments.

Supervision (``supervise=True``, requires ``snapshot_dir``) hardens the
worker against arbitrary failure.  A supervisor thread watches for worker
death (exception) and span hangs (heartbeat older than ``span_timeout``)
and recovers:

  1. bump the generation, set the old generation's abort event (releases
     cooperative stalls), join the dead worker;
  2. restore a fresh scheduler from the newest periodic snapshot, falling
     back past corrupt ones (checksum failures raise
     CorruptCheckpointError) to older generations;
  3. re-push the event journal: every ingested event is tagged with the
     snapshot epoch current at ingest, so events not yet baked into the
     restored snapshot are replayed onto the restored queue — ingestion
     is never lost to a crash;
  4. swap in the restored scheduler with a NEW span lock (a truly hung
     worker may hold the old one forever), back off exponentially
     (``backoff0 * 2**streak``; streak resets on a successful span), and
     start a new worker — giving up with the original error after
     ``max_restarts`` consecutive failures.

Because per-round randomness is derived by folding the round index into a
never-split base key, a recovered run replays the lost rounds *exactly*:
the post-recovery trajectory is bit-identical to an uninterrupted one
(asserted by the chaos tests).

On the card: each worker generation's thread, and the supervisor while it
restores, enter ``torch.cuda.device(engine.device)`` (a new thread's
current device is device 0, and the engine's commit marks staged stacks as
used by the committing thread's current stream).  The engine writes its
slot buffers in place, so a warm engine is reused only after the dead
generation's worker was joined and its scheduler closed (its staging
thread retired, any cohort in flight on the staging stream finished):
the stager only ever fills stacks of its own, every slot write is queued
by the scheduler's thread on the device's current stream, and the
restore's evicts and re-admits queue behind whatever the dead span left
there.  The first span of a generation launches the round's kernels, and
the very first launch of a process builds them with nvcc
(``kernels.build``): ``launch.fed_serve`` builds them before the service
starts, so the watchdog's warmup grace never has to cover a compile.  A
worker error that was not injected (a failed launch, an illegal address)
is recovered from a snapshot like any other; nothing moves to the CPU or
to a kernel's plain version.

The scheduler's own event queue can additionally be bounded:
``queue_policy="merge-stale"`` drops, at ingest, any TraceShift whose tau
has already passed and that restates the target's *current* trace
(last-write-wins makes that a no-op), and compacts stale duplicates
whenever the queue tops ``max_queue`` — the absorbing policy for edges
that re-announce known availability laws on every retry.

All device work of the spans stays on the worker thread; producers only
touch the inbox.  Scheduler state is guarded by one lock the worker
releases between spans, so control calls (snapshot/pause/stats)
interleave at span granularity.

Usage::

    svc = FederationService(scheduler, span_rounds=4, eval_every=8,
                            max_rounds=200)
    with svc:                          # starts the worker
        svc.submit(Arrival(tau=12, client=new_client))   # any thread
        svc.wait_rounds(200)
    print(svc.stats())
"""
from __future__ import annotations

import contextlib
import os
import queue
import shutil
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.checkpoint import CorruptCheckpointError
from repro_torch.fed.events import ParticipationEvent, TraceShift
from repro_torch.fed.stream import StreamScheduler
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.telemetry import resolve as resolve_telemetry

_QUEUE_POLICIES = ("none", "merge-stale")


def _is_stale_noop(state, e) -> bool:
    """A TraceShift whose tau already passed and that restates the
    client's current trace: applying it is the identity (last-write-wins
    semantics), so merge-stale drops it at ingest."""
    return (isinstance(e, TraceShift) and e.tau <= state.next_tau
            and 0 <= e.client_id < len(state.clients)
            and e.trace == state.clients[e.client_id].trace)


def _on_device(sch: StreamScheduler):
    """The scheduler's card as this thread's current device (nothing on
    the CPU)."""
    dev = sch.engine.device
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class FederationService:
    """Thread-safe ingestion + span-execution service over one
    StreamScheduler, optionally supervised for auto-recovery."""

    def __init__(self, scheduler: StreamScheduler, *,
                 span_rounds: int = 4, eval_every: int = 1 << 30,
                 max_rounds: Optional[int] = None,
                 max_pending: int = 1024,
                 idle_sleep: float = 0.002,
                 supervise: bool = False,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 4,
                 keep_snapshots: int = 3,
                 max_restarts: int = 5,
                 backoff0: float = 0.05,
                 span_timeout: Optional[float] = None,
                 join_timeout: float = 5.0,
                 queue_policy: str = "none",
                 max_queue: int = 1024,
                 injector=None,
                 engine_factory: Optional[Callable] = None,
                 restore_kwargs: Optional[dict] = None,
                 warmup_factor: float = 10.0,
                 telemetry=None):
        if span_rounds < 1:
            raise ValueError(f"span_rounds must be >= 1, got {span_rounds}")
        if queue_policy not in _QUEUE_POLICIES:
            raise ValueError(f"queue_policy must be one of "
                             f"{_QUEUE_POLICIES}, got {queue_policy!r}")
        if supervise and snapshot_dir is None:
            raise ValueError("supervise=True requires snapshot_dir "
                             "(recovery restores from periodic snapshots)")
        self.scheduler = scheduler
        self.span_rounds = span_rounds
        self.eval_every = eval_every
        self.max_rounds = max_rounds
        # inbox items are (t_submit, event): the monotonic submit stamp
        # feeds the svc_ingest_lag_seconds histogram
        self._inbox: "queue.Queue[Tuple[float, ParticipationEvent]]" = \
            queue.Queue(maxsize=max_pending)
        self._idle_sleep = idle_sleep
        self.warmup_factor = warmup_factor
        # supervision config
        self._supervised = supervise
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = max(1, snapshot_every)
        self.keep_snapshots = max(1, keep_snapshots)
        self.max_restarts = max_restarts
        self.backoff0 = backoff0
        self.span_timeout = span_timeout
        self.join_timeout = join_timeout
        self.queue_policy = queue_policy
        self.max_queue = max_queue
        self._injector = (injector if injector is not None
                          else getattr(scheduler, "injector", None))
        self._engine_factory = engine_factory
        self._restore_kwargs = dict(restore_kwargs or {})
        # locking: _meta hands out the *current* (lock, scheduler,
        # generation, abort) quadruple — recovery swaps all four at once,
        # because a hung worker may never release the old span lock
        self._meta = threading.Lock()
        self._lock = threading.RLock()       # guards scheduler state
        self._abort = threading.Event()      # releases this generation
        self._gen = 0
        # waiters get their own condition so they never contend with (or
        # deadlock against a hung holder of) the span lock
        self._wait_cv = threading.Condition(threading.Lock())
        self._stop = threading.Event()
        # the worker parks on this instead of sleep-polling: submit(),
        # resume(), stop() and recovery set it, so an idle (paused or
        # budget-reached) worker reacts to news immediately instead of on
        # the next poll tick
        self._wake = threading.Event()
        self._paused = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._supervisor: Optional[threading.Thread] = None
        self._worker_died = threading.Event()
        # (generation, error, monotonic death time) — the stamp feeds the
        # recovery record's detect_latency_s
        self._died: Optional[Tuple[int, BaseException, float]] = None
        self._error: Optional[BaseException] = None
        self._heartbeat = time.monotonic()
        # spans completed by the CURRENT generation: the watchdog grants
        # a warmup grace (warmup_factor * span_timeout) until the first
        # span lands, because a first span legitimately spends seconds
        # warming up (cuDNN and cuBLAS handles, the allocator's pool) —
        # indistinguishable from a hang by heartbeat
        self._gen_spans = 0
        # snapshot/journal bookkeeping (guarded by _snap_lock)
        self._snap_lock = threading.Lock()
        self._snapshots: List[Tuple[int, str]] = []   # (epoch, path)
        self._epoch = 0
        self._journal: Optional[List[Tuple[int, ParticipationEvent]]] = \
            [] if (supervise and snapshot_dir is not None) else None
        self._delayed: List[ParticipationEvent] = []
        self._fail_streak = 0
        self.recoveries: List[dict] = []

        # telemetry: default to the scheduler's own telemetry so one
        # wiring point covers the whole stack.  The service counters are
        # *functional* state (drain() compares them), so with a null
        # telemetry they live on a private registry — same code path,
        # nothing rendered
        self.telemetry = tel = resolve_telemetry(
            telemetry if telemetry is not None
            else getattr(scheduler, "telemetry", None))
        reg = tel.registry if tel.enabled else MetricsRegistry()
        self._registry = reg
        if (tel.enabled and self._injector is not None
                and hasattr(self._injector, "attach_telemetry")):
            self._injector.attach_telemetry(tel)
        self._c_submitted = reg.counter(
            "svc_events_submitted_total", "events accepted by submit()")
        self._c_ingested = reg.counter(
            "svc_events_ingested_total",
            "events handed from the inbox to the scheduler")
        self._c_merged = reg.counter(
            "svc_events_merged_total",
            "events dropped/compacted by the merge-stale queue policy")
        self._c_duplicated = reg.counter(
            "svc_events_duplicated_total",
            "events delivered twice by an injected ingest fault")
        self._c_delayed = reg.counter(
            "svc_events_delayed_total",
            "events held back one ingest cycle by an injected fault")
        self._c_flooded = reg.counter(
            "svc_events_flooded_total",
            "stale events pushed by injected floods")
        self._c_spans = reg.counter(
            "svc_spans_total", "scheduler spans run by the worker")
        self._c_snap_failures = reg.counter(
            "svc_snapshot_failures_total",
            "periodic snapshots that failed to write")
        self._c_recoveries = reg.counter(
            "svc_recoveries_total", "supervised recoveries completed")
        self._c_busy = reg.counter(
            "svc_busy_seconds_total",
            "worker wall time inside scheduler spans")
        self._c_idle = reg.counter(
            "svc_idle_seconds_total",
            "worker wall time parked waiting for work")
        self._c_overhead = reg.counter(
            "svc_overhead_seconds_total",
            "worker wall time in per-iteration service bookkeeping "
            "(locking, ingest, notify) — neither spans nor idle waits")
        self._g_inbox = reg.gauge(
            "svc_inbox_depth", "events waiting in the bounded inbox")
        self._g_heartbeat = reg.gauge(
            "svc_heartbeat_age_s",
            "seconds since the worker's last heartbeat (set on read)")
        self._g_generation = reg.gauge(
            "svc_generation", "current worker generation")
        self._h_lag = reg.histogram(
            "svc_ingest_lag_seconds",
            "submit()-to-scheduler latency per event")
        self._h_recovery = reg.histogram(
            "svc_recovery_seconds", "supervised recovery wall time (MTTR)")

    # -- registry-backed counters (the pre-telemetry public surface) ----------
    @property
    def events_submitted(self) -> int:
        return int(self._c_submitted.value)

    @property
    def events_ingested(self) -> int:
        return int(self._c_ingested.value)

    @property
    def events_merged(self) -> int:
        return int(self._c_merged.value)

    @property
    def events_duplicated(self) -> int:
        return int(self._c_duplicated.value)

    @property
    def events_delayed(self) -> int:
        return int(self._c_delayed.value)

    @property
    def events_flooded(self) -> int:
        return int(self._c_flooded.value)

    @property
    def spans_run(self) -> int:
        return int(self._c_spans.value)

    @property
    def snapshot_failures(self) -> int:
        return int(self._c_snap_failures.value)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "FederationService":
        if self._stop.is_set():
            raise RuntimeError(
                "FederationService cannot be restarted after stop(); "
                "build a new service (restore from a snapshot to resume)")
        with self._meta:
            if self._worker is not None and self._worker.is_alive():
                return self
            gen, lock, abort, sch = (self._gen, self._lock,
                                     self._abort, self.scheduler)
        if self._supervised and not self._snapshots:
            os.makedirs(self.snapshot_dir, exist_ok=True)
            # generation-0 base snapshot: recovery always has somewhere to
            # roll back to, even if the first crash precedes the first
            # periodic snapshot.  A few attempts ride out injected or
            # transient write failures.
            for _ in range(3):
                if self._auto_snapshot(sch):
                    break
            else:
                raise RuntimeError(
                    "could not write the initial supervision snapshot "
                    f"to {self.snapshot_dir!r}")
        self._heartbeat = time.monotonic()
        self._worker = threading.Thread(
            target=self._loop, args=(gen, lock, abort, sch),
            name=f"federation-service-g{gen}", daemon=True)
        self._worker.start()
        if self._supervised and self._supervisor is None:
            self._supervisor = threading.Thread(
                target=self._supervise, name="federation-supervisor",
                daemon=True)
            self._supervisor.start()
        return self

    def stop(self, wait: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop the worker (and supervisor).  ``wait=True`` joins the
        threads — up to ``timeout`` seconds each when given — and raises
        if the worker died of an unrecovered error, or if it failed to
        stop in time (a wedged span)."""
        self._stop.set()
        with self._meta:
            abort, worker = self._abort, self._worker
        abort.set()                          # release cooperative stalls
        self._worker_died.set()              # kick the supervisor awake
        self._wake.set()                     # unpark an idle worker
        self._notify()                       # wake wait_rounds() callers
        if wait:
            if self._supervisor is not None:
                self._supervisor.join(timeout)
            if worker is not None:
                worker.join(timeout)
                if worker.is_alive():
                    raise RuntimeError(
                        f"federation worker failed to stop within "
                        f"{timeout}s")
            # the worker is down: retire the scheduler's prefetch
            # staging thread too (idempotent; no-op without a bank)
            self.scheduler.close()
        if self._error is not None:
            raise RuntimeError("federation worker died") from self._error

    def __enter__(self) -> "FederationService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(wait=True)

    @property
    def running(self) -> bool:
        with self._meta:
            worker = self._worker
        return (worker is not None and worker.is_alive()
                and not self._stop.is_set())

    @property
    def generation(self) -> int:
        return self._gen

    # -- ingestion (any thread) ------------------------------------------------
    def submit(self, *events: ParticipationEvent, block: bool = True,
               timeout: Optional[float] = None) -> bool:
        """Enqueue events for ingestion.  A full inbox applies
        backpressure: blocks (optionally up to ``timeout``) when
        ``block=True``, else returns False without enqueueing anything
        beyond the events already accepted.  Raises once the service has
        been stopped — those events would never be ingested."""
        if self._stop.is_set():
            raise RuntimeError("cannot submit to a stopped "
                               "FederationService")
        ok = True
        for e in events:
            try:
                self._inbox.put((time.monotonic(), e), block=block,
                                timeout=timeout)
            except queue.Full:
                ok = False
                break
            # the registry counter's own lock makes the increment atomic
            # under concurrent producers — drain() compares against it,
            # so a lost update would report drained with an event still
            # in flight
            self._c_submitted.inc()
        self._g_inbox.set(self._inbox.qsize())
        self._wake.set()                     # a parked worker has news
        return ok

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every submitted event has been handed to the
        scheduler (it may still be *pending* on the scheduler's own queue
        until its tau is reached).  True if drained within timeout."""
        def drained() -> bool:
            return (self._error is not None
                    or (self.events_ingested >= self.events_submitted
                        and self._inbox.empty() and not self._delayed))

        # condition-variable wait: the worker notifies after every ingest
        # cycle that moved events, so this parks instead of sleep-polling
        with self._wait_cv:
            ok = self._wait_cv.wait_for(drained, timeout=timeout)
        if self._error is not None:
            raise RuntimeError("federation worker died") from self._error
        return ok

    # -- control ---------------------------------------------------------------
    def pause(self) -> None:
        """Stop span execution (ingestion continues).  Returns once the
        in-flight span has finished, so scheduler state is boundary-
        consistent afterwards.  Generation-aware: if a recovery swaps the
        span lock while we wait, the barrier re-targets the new one."""
        self._paused.set()
        while True:
            with self._meta:
                gen, lock = self._gen, self._lock
            if lock.acquire(timeout=0.2):
                try:
                    with self._meta:
                        same = (gen == self._gen)
                finally:
                    lock.release()
                if same:
                    return                # barrier done at a boundary
            if self._stop.is_set():
                return

    def resume(self) -> None:
        self._paused.clear()
        self._wake.set()

    def wait_rounds(self, n: int, timeout: Optional[float] = None) -> bool:
        """Block until the scheduler clock reaches round n."""
        with self._wait_cv:
            ok = self._wait_cv.wait_for(
                lambda: self.scheduler._next_tau >= n
                or self._error is not None or self._stop.is_set(),
                timeout=timeout)
        if self._error is not None:
            raise RuntimeError("federation worker died") from self._error
        return ok and self.scheduler._next_tau >= n

    def snapshot(self, path: Optional[str] = None) -> dict:
        """Span-boundary-consistent control-plane snapshot.  With
        ``path``, also persists the full resumable checkpoint
        (StreamScheduler.save — params + FedState + history).  Returns
        the FedState dict."""
        was_paused = self._paused.is_set()
        self.pause()                  # settle at a span boundary
        try:
            with self._meta:
                lock, sch = self._lock, self.scheduler
            with lock:
                self._ingest(sch)     # fold already-submitted events in
                state = sch.state.to_dict()
                if path is not None:
                    sch.save(path)
        finally:
            if not was_paused:
                self.resume()
        return state

    def stats(self) -> dict:
        sch = self.scheduler
        # refresh the point-in-time gauges so a prom scrape taken right
        # after stats() agrees with it
        self._g_heartbeat.set(time.monotonic() - self._heartbeat)
        self._g_generation.set(self._gen)
        self._g_inbox.set(self._inbox.qsize())
        return {"rounds": sch._next_tau,
                "spans_run": self.spans_run,
                "events_submitted": self.events_submitted,
                "events_ingested": self.events_ingested,
                "events_applied": sch.events_applied,
                "events_pending": sch.pending,
                "events_merged": self.events_merged,
                "events_duplicated": self.events_duplicated,
                "events_delayed": self.events_delayed,
                "events_flooded": self.events_flooded,
                "inbox_depth": self._inbox.qsize(),
                "running": self.running,
                "paused": self._paused.is_set(),
                "supervised": self._supervised,
                "generation": self._gen,
                "recoveries": len(self.recoveries),
                "snapshot_failures": self.snapshot_failures,
                "snapshots_kept": len(self._snapshots),
                "journal_len": (len(self._journal)
                                if self._journal is not None else 0),
                "prefetch": sch.prefetch_stats()}

    def chaos_report(self) -> dict:
        """Supervision outcome summary: one record per recovery (cause,
        epoch restored, snapshots skipped as corrupt, events replayed,
        detection latency, MTTR seconds) plus aggregate counters — the
        payload behind ``fed_serve --chaos`` and
        BENCH_stream.json["chaos"].  All durations come from
        ``time.monotonic()`` — the same clock the tracing spans use, so
        MTTR figures line up with ``svc.recover`` span timings."""
        mttrs = [r["mttr_s"] for r in self.recoveries]
        detects = [r.get("detect_latency_s", 0.0)
                   for r in self.recoveries]
        rec_rounds = sum(max(0, r["tau_at_failure"] - r["tau_resumed"])
                         for r in self.recoveries)
        report = {
            "recoveries": list(self.recoveries),
            "n_recoveries": len(self.recoveries),
            "mttr_mean_s": (sum(mttrs) / len(mttrs)) if mttrs else 0.0,
            "mttr_max_s": max(mttrs) if mttrs else 0.0,
            "detect_latency_mean_s": (sum(detects) / len(detects)
                                      if detects else 0.0),
            "detect_latency_max_s": max(detects) if detects else 0.0,
            "recovered_rounds": int(rec_rounds),
            "snapshot_failures": self.snapshot_failures,
            "events_merged": self.events_merged,
            "final_rounds": int(self.scheduler._next_tau),
        }
        if self._injector is not None and hasattr(self._injector,
                                                  "summary"):
            report["faults"] = self._injector.summary()
        return report

    # -- worker ----------------------------------------------------------------
    def _notify(self) -> None:
        with self._wait_cv:
            self._wait_cv.notify_all()

    def _push_event(self, sch: StreamScheduler, e) -> None:
        """Hand one event to the scheduler, applying the queue policy."""
        if self.queue_policy == "merge-stale":
            if _is_stale_noop(sch.state, e):
                self._c_merged.inc()
                return
            sch.push(e)
            if sch.pending > self.max_queue:
                self._c_merged.inc(
                    sch.state.compact_stale_traceshifts())
        else:
            sch.push(e)

    def _accept(self, sch: StreamScheduler, e, count: bool = True) -> None:
        if self._journal is not None:
            with self._snap_lock:
                self._journal.append((self._epoch, e))
        self._push_event(sch, e)
        if count:
            self._c_ingested.inc()

    def _ingest(self, sch: StreamScheduler) -> int:
        """Move everything in the inbox (plus any fault-delayed holdbacks)
        onto the scheduler queue (caller holds the span lock)."""
        n = 0
        held, self._delayed = self._delayed, []
        for e in held:
            self._accept(sch, e)
            n += 1
        now = time.monotonic()
        while True:
            try:
                t_submit, e = self._inbox.get_nowait()
            except queue.Empty:
                break
            self._h_lag.observe(now - t_submit)
            f = (self._injector.fire("ingest")
                 if self._injector is not None else None)
            if f is not None and f.kind == "delay":
                self._delayed.append(e)      # out-of-order: next cycle
                self._c_delayed.inc()
                continue
            self._accept(sch, e)
            n += 1
            if f is not None and f.kind == "dup":
                self._accept(sch, e, count=False)   # delivered twice
                self._c_duplicated.inc()
        if n:
            self._g_inbox.set(self._inbox.qsize())
            self._notify()   # drain() waits on the ingest high-water mark
        return n

    def _maybe_flood(self, sch: StreamScheduler) -> None:
        f = self._injector.fire("flood")
        if f is not None and f.kind == "flood":
            from repro_torch.fed.faults import make_flood
            flood = make_flood(sch.state, f.size or 1,
                               self._injector._rng)
            for ev in flood:
                self._push_event(sch, ev)    # policy absorbs the stale
            self._c_flooded.inc(len(flood))

    def _loop(self, gen: int, lock, abort: threading.Event,
              sch: StreamScheduler) -> None:
        """One worker generation.  Everything scheduler-touching uses the
        captured (lock, sch) pair: after a recovery, a released zombie of
        an old generation can only ever touch its own (discarded) pair.
        The whole loop runs with the scheduler's card current."""
        try:
            with _on_device(sch):
                self._serve(gen, lock, abort, sch)
        except BaseException as e:
            if self._supervised:
                self._died = (gen, e, time.monotonic())
                self._worker_died.set()      # hand off to the supervisor
            else:
                self._error = e              # surface on control threads
            self._notify()

    def _serve(self, gen: int, lock, abort: threading.Event,
               sch: StreamScheduler) -> None:
        """The worker generation's loop: ingest, run a span, snapshot,
        park; returns when the service stops or the generation is
        aborted."""
        tel = self.telemetry
        while not self._stop.is_set() and not abort.is_set():
            t_iter = time.monotonic()
            if gen == self._gen:
                self._heartbeat = t_iter
            with lock:
                if abort.is_set():
                    break
                if not self._inbox.empty() or self._delayed:
                    with tel.span("svc.ingest"):
                        self._ingest(sch)
                done = (self.max_rounds is not None
                        and sch._next_tau >= self.max_rounds)
                if done:
                    # budget reached: wake waiters so wait_rounds(n)
                    # with an unreachable n re-checks its predicate
                    # instead of sleeping past a concurrent stop()
                    self._notify()
                elif not self._paused.is_set():
                    if self._injector is not None:
                        self._maybe_flood(sch)
                        self._injector.fire("worker", abort=abort)
                        if abort.is_set() or self._stop.is_set():
                            break        # hang released by recovery
                    n = self.span_rounds
                    if self.max_rounds is not None:
                        n = min(n, self.max_rounds - sch._next_tau)
                    t_span = time.monotonic()
                    self._c_overhead.inc(t_span - t_iter)
                    with tel.span("svc.span", gen=gen,
                                  tau=int(sch._next_tau), rounds=n):
                        sch.run(n, eval_every=self.eval_every)
                    self._c_busy.inc(time.monotonic() - t_span)
                    self._c_spans.inc()
                    self._gen_spans += 1
                    self._fail_streak = 0
                    self._notify()
                    if (self._supervised
                            and self.spans_run % self.snapshot_every
                            == 0):
                        self._auto_snapshot(sch)
                    continue
                self._c_overhead.inc(time.monotonic() - t_iter)
            # paused or round budget reached: park until submit()/
            # resume()/stop() wakes us (bounded fallback wait keeps
            # fault-delayed holdbacks and missed wakeups moving)
            t_park = time.monotonic()
            self._wake.wait(timeout=0.05 if self._delayed else 0.25)
            self._wake.clear()
            self._c_idle.inc(time.monotonic() - t_park)

    # -- snapshots / journal ---------------------------------------------------
    def _auto_snapshot(self, sch: StreamScheduler) -> bool:
        """Write the periodic snapshot for the current epoch; advance the
        epoch, enforce retention, and prune the journal entries that are
        now baked into every retained snapshot.  A write failure leaves
        the epoch unchanged (the journal keeps covering those events)."""
        with self._snap_lock:
            epoch = self._epoch
        path = os.path.join(self.snapshot_dir, f"snap-{epoch:06d}")
        try:
            with self.telemetry.span("svc.snapshot", epoch=epoch):
                sch.save(path)
        except OSError:
            self._c_snap_failures.inc()
            shutil.rmtree(path, ignore_errors=True)
            return False
        with self._snap_lock:
            self._snapshots.append((epoch, path))
            self._epoch = epoch + 1
            doomed = []
            while len(self._snapshots) > self.keep_snapshots:
                doomed.append(self._snapshots.pop(0)[1])
            oldest = self._snapshots[0][0]
            if self._journal is not None:
                # entries tagged <= oldest retained epoch are inside every
                # snapshot we could still restore from
                self._journal = [it for it in self._journal
                                 if it[0] > oldest]
        for p in doomed:
            shutil.rmtree(p, ignore_errors=True)
        return True

    # -- supervision -----------------------------------------------------------
    def _supervise(self) -> None:
        poll = (min(0.25, self.span_timeout / 4)
                if self.span_timeout is not None else 0.25)
        while not self._stop.is_set():
            self._worker_died.wait(timeout=poll)
            if self._stop.is_set():
                break
            if self._worker_died.is_set():
                self._worker_died.clear()
                died = self._died
                self._died = None
                if died is not None:
                    # detection latency: death stamp -> recovery start,
                    # same monotonic clock as the tracing spans
                    self._recover(died[0], died[1],
                                  detect_latency_s=time.monotonic()
                                  - died[2])
                continue
            if self.span_timeout is None:
                continue
            with self._meta:
                gen, worker = self._gen, self._worker
            # warmup grace: until this generation completes its first
            # span, heartbeat silence is more plausibly warm-up (a rebuilt
            # engine's first launches, the eval arrays' first upload) than
            # a hang — a tight span_timeout would otherwise fire a
            # false-positive recovery storm on slow hosts
            limit = (self.span_timeout if self._gen_spans > 0
                     else self.span_timeout * max(1.0, self.warmup_factor))
            stale = time.monotonic() - self._heartbeat
            if (worker is not None and worker.is_alive()
                    and stale > limit):
                self._recover(gen, TimeoutError(
                    f"span watchdog: no worker heartbeat for "
                    f"{stale:.2f}s (limit {limit}s)"),
                    detect_latency_s=stale - limit)

    def _give_up(self, err: BaseException) -> None:
        self._error = err
        self._stop.set()
        with self._meta:
            self._abort.set()
        self._notify()

    def _recover(self, gen: int, err: BaseException,
                 detect_latency_s: float = 0.0) -> None:
        """Supervisor-side recovery: abort+join generation ``gen``,
        restore the newest good snapshot, replay the journal tail, swap
        in a fresh (scheduler, lock) pair and start generation gen+1.
        ``detect_latency_s`` is how long the failure went unnoticed
        (death stamp / heartbeat limit -> now, monotonic clock)."""
        t0 = time.monotonic()
        with self._meta:
            if gen != self._gen or self._stop.is_set():
                return                       # stale report, already done
            self._gen = gen + 1
            old_abort, old_worker = self._abort, self._worker
            old_sch = self.scheduler
        with self.telemetry.span("svc.recover", gen=gen), \
                _on_device(old_sch):
            old_abort.set()
            self._notify()
            if old_worker is not None:
                old_worker.join(timeout=self.join_timeout)
            joined = old_worker is None or not old_worker.is_alive()
            if joined:
                # drop the dead scheduler's in-flight staging work; the
                # restored scheduler rebuilds its bank + hot set from
                # the snapshot's clients (StreamScheduler.restore)
                old_sch.close()
            tau_at_failure = int(old_sch._next_tau)

            if self._fail_streak >= self.max_restarts:
                self._give_up(err)
                return
            streak = self._fail_streak
            self._fail_streak = streak + 1

            # restore: newest snapshot first, fall back past corrupt ones
            with self._snap_lock:
                candidates = list(self._snapshots)
            rkw = dict(self._restore_kwargs)
            if self.telemetry.enabled:
                rkw.setdefault("telemetry", self.telemetry)
            # a scheduler that was logging span args keeps logging after
            # recovery (restore defaults log_spans off) — the fuzzer's
            # weight/LR forward-fill reads the log across restarts
            rkw.setdefault("log_spans", old_sch.span_log is not None)
            # an engine rebuilt by restore lives where the old one did:
            # recovery never moves the federation off its card
            rkw.setdefault("device", old_sch.engine.device)
            restored = None
            restored_epoch = None
            corrupt_skipped = []
            engine_reused = False
            for epoch, path in reversed(candidates):
                # reusing the warm engine is only safe once the old
                # worker is provably no longer driving it
                eng = (self._engine_factory()
                       if (joined and self._engine_factory is not None)
                       else None)
                try:
                    restored = StreamScheduler.restore(
                        path, engine=eng, injector=self._injector,
                        **rkw)
                    restored_epoch = epoch
                    engine_reused = eng is not None
                    break
                except CorruptCheckpointError as ce:
                    corrupt_skipped.append({"path": path,
                                            "error": str(ce)})
                    continue
                except Exception as re:
                    self._give_up(re)
                    return
            if restored is None:
                self._give_up(err if not corrupt_skipped else
                              CorruptCheckpointError(
                                  "no restorable snapshot: all "
                                  f"{len(candidates)} candidates "
                                  "corrupt"))
                return

            # replay the journal tail: events ingested after the restored
            # snapshot was written are not inside it — push them again
            # (the restored queue orders them by tau/seq exactly as
            # before)
            with self._snap_lock:
                replay = ([e for tag, e in self._journal
                           if tag > restored_epoch]
                          if self._journal is not None else [])
            for e in replay:
                self._push_event(restored, e)

            new_lock = threading.RLock()
            new_abort = threading.Event()
            with self._meta:
                self.scheduler = restored
                self._lock = new_lock
                self._abort = new_abort
            mttr = time.monotonic() - t0
            self.recoveries.append({
                "generation": gen + 1,
                "cause": repr(err),
                "detect_latency_s": max(0.0, float(detect_latency_s)),
                "tau_at_failure": tau_at_failure,
                "tau_resumed": int(restored._next_tau),
                "restored_epoch": restored_epoch,
                "corrupt_skipped": corrupt_skipped,
                "events_replayed": len(replay),
                "worker_joined": joined,
                "engine_reused": engine_reused,
                "backoff_s": self.backoff0 * (2 ** streak),
                "mttr_s": mttr,
            })
            self._c_recoveries.inc()
            self._h_recovery.observe(mttr)
        # exponential backoff before the restart (abortable by stop)
        if self._stop.wait(self.backoff0 * (2 ** streak)):
            return
        self._heartbeat = time.monotonic()
        self._gen_spans = 0          # re-arm the watchdog warmup grace
        worker = threading.Thread(
            target=self._loop,
            args=(gen + 1, new_lock, new_abort, restored),
            name=f"federation-service-g{gen + 1}", daemon=True)
        with self._meta:
            self._worker = worker
        worker.start()
        self._wake.set()
        self._notify()
