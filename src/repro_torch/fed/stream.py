"""Streaming participation: an event queue driving spans of rounds.

Counterpart of ``repro/fed/stream.py``'s ``StreamScheduler``, with its
checkpoint and resume, its tiered client bank and cohort prefetch
(``fed/bank.py``), its telemetry (``repro_torch.obs``) and its fault
hook (``injector=``, a ``fed/faults.FaultPlan``) and its span log
(``log_spans=True``, which ``fed/fuzz.py`` and ``fed/validate.py`` read).
At each span start the
scheduler pops every queued event with tau <= now, applies it to the
FedState and executes the slot actions it returns against the
RoundEngine (consecutive admits land as one burst; evicts and trace
writes in order); then it runs rounds until the next event tau, burst
expiry or eval round, whichever is first.  Events are applied at the
first span boundary with tau >= event.tau.  An event that raises
mid-boundary (a full engine, say) still leaves the admits already
recorded written to the engine, as the reference's does.

``bank=True`` (or a configured ``ClientBank``) keeps the whole fleet's
padded rows host-side; ``prefetch=True`` (implies a bank) stages the
queued arrivals' rows onto the device on a worker thread while spans
run, from pinned memory on a CUDA stream of its own, and the boundary
commits them from that stack (hits) or admits them synchronously
(misses).  Either way the same bytes reach the same slots: a banked run
is bit-identical to a resident one.

mode="device" (the reference's default) draws participation and batches
on the device from the state's key (``RoundEngine.run_span(key=...)``);
mode="plan" samples them on the host with the numpy RNG in the seed draw
order, sample-for-sample the reference's plan mode.

``save()``/``restore()`` write and read the reference's checkpoint format
(``checkpoint.io``): params in the reference's layout (the CNN's conv
weights HWIO, ``w1``'s rows in HWC order, by the engine's ``model_kind``),
the FedState dict with its pending events, RNG and key, the round history
and the engine geometry.  Because the key is never split and plan mode
draws per round in tau order, a run restored from disk replays the
remaining rounds as the uninterrupted run does, and a checkpoint written
by either package resumes in the other::

    sch.run(6, eval_every=4)
    sch.save("ckpt/")                                  # ... crash ...
    sch = StreamScheduler.restore("ckpt/", loss_fn=loss_fn, eval_fn=eval_fn)
    sch.run(6, eval_every=4)                           # round for round
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.io import load_fed_checkpoint, save_fed_checkpoint
from repro_torch.core.arrivals import RebootState
from repro_torch.core.departures import BoundTerms
from repro_torch.fed.bank import ClientBank, CohortStager
from repro_torch.fed.driver import Client, RoundRecord
from repro_torch.fed.engine import RoundEngine, trace_cdf_row
from repro_torch.fed.events import ParticipationEvent
from repro_torch.fed.state import FedState
from repro_torch.fed.task import ArrayTask
from repro_torch.obs.fedmetrics import FedObserver
from repro_torch.obs.telemetry import resolve as resolve_telemetry

# the reference's default scan chunk: the port runs a span's rounds one
# after another and has no chunks, but the reference's restore reads a
# chunk_size from every checkpoint's config
REFERENCE_CHUNK_SIZE = 16

# the reference's jax-only arguments: Pallas interpret mode and buffer
# donation have no meaning in the port (a CPU tensor takes a kernel's plain
# version; torch frees what it no longer references)
JAX_ONLY = ("interpret", "donate")


def refuse_unported(**given) -> None:
    """Raise ValueError for any of the reference's jax-only scheduler
    arguments (JAX_ONLY) unless it is at its null default (None or
    False)."""
    for name, value in given.items():
        if value is None or value is False:
            continue
        raise ValueError(f"{name}={value!r} is a jax-only argument of the "
                         f"reference; the port accepts only None")


class StreamScheduler:
    """Consumes a stream of ParticipationEvents while driving
    RoundEngine.run_span over the event-free gaps, with participation and
    batch indices drawn on the device (``mode="device"``) or sampled on
    the host in the seed draw order (``mode="plan"``).

    ``evaluate(params)`` (optional) returns (loss, acc); without it,
    ``eval_fn(params, x, y)`` runs on the held-out arrays of the
    objective's clients, concatenated on the engine's device once per
    objective membership (``FedState.objective_version``).  An eval runs
    on the last round of a span that ends on an eval round; rounds
    without one record NaN.  With the engine's ``with_metrics``,
    ``delta_norms`` holds each round's delta norm.  ``state`` (a
    ``FedState``, as ``restore`` passes) replaces the fresh one the other
    arguments would build, ``clients`` included.

    Without ``engine`` the scheduler builds its RoundEngine as the
    reference's does, from ``loss_fn`` or ``task``, ``capacity``,
    ``max_samples``, ``local_epochs``, ``batch_size``, ``scheme``,
    ``eta0``, ``agg``, ``compression``, ``with_metrics``, ``engine_mode``
    and ``sharding``, plus the port's ``device`` (the CUDA device unless
    ``"cpu"``) and ``model_kind``; ``chunk_size`` is accepted and has no
    effect (the port has no scan chunks).

    ``telemetry`` (``repro_torch.obs.Telemetry``; None is the null
    default) counts spans, eval-cache hits, prefetch hits and misses,
    feeds the FedObserver's paper gauges and times the spans
    ``sched.apply_events`` and ``sched.run_span``; a scheduler-built
    engine shares it.  ``bank`` (True, or a configured ``ClientBank``)
    and ``prefetch`` (implies a bank) are the reference's tiered store and
    cohort prefetch (``fed/bank.py``); ``close()`` stops the staging
    thread and ``prefetch_stats()`` reads its counters.  ``injector`` (a
    ``fed/faults.FaultPlan``, or anything with its ``fire(site, **ctx)``)
    is consulted at the site ``"sched_span"`` at the top of every span
    iteration of ``run``, where a crash leaves the scheduler torn as the
    reference's (the spans already run recorded, ``next_tau`` stale), and
    is handed to ``save``'s checkpoint writes (``"ckpt_save"``,
    ``"ckpt_written"``).  ``log_spans=True`` keeps ``span_log``, a list
    of ``(tau, p, active, lr_shift_tau)`` (numpy copies) appended each
    time the span arguments are recomputed, as the reference's; without
    it ``span_log`` is None.  ``interpret`` and ``donate`` (jax's) are
    accepted only at their null defaults: anything else raises ValueError
    (``refuse_unported``).
    """

    def __init__(self, *, clients: Sequence[Client] = (), init_params,
                 engine: Optional[RoundEngine] = None,
                 loss_fn: Optional[Callable] = None,
                 task=None, engine_mode: str = "client_parallel",
                 eval_fn: Optional[Callable] = None,
                 capacity: Optional[int] = None,
                 max_samples: Optional[int] = None,
                 sharding=None,
                 local_epochs: int = 5, batch_size: int = 10,
                 scheme: str = "C", eta0: float = 0.01,
                 chunk_size: int = REFERENCE_CHUNK_SIZE, agg: str = "auto",
                 interpret=None, donate: Optional[bool] = None,
                 compression=None, with_metrics: bool = False,
                 reboot_boost: float = 3.0, fast_reboot: bool = True,
                 horizon: Optional[int] = None,
                 bound_terms: Optional[BoundTerms] = None,
                 seed: int = 0, mode: str = "device",
                 rng: Optional[np.random.Generator] = None,
                 key=None, evaluate: Optional[Callable] = None,
                 history: Optional[List[RoundRecord]] = None,
                 reboots: Optional[List[RebootState]] = None,
                 objective: Optional[set] = None,
                 state: Optional[FedState] = None,
                 events: Sequence[ParticipationEvent] = (),
                 injector=None, log_spans: bool = False,
                 telemetry=None, bank=None, prefetch: bool = False,
                 device=None, model_kind: Optional[str] = None):
        if mode not in ("device", "plan"):
            raise ValueError(f"mode must be device|plan, got {mode!r}")
        refuse_unported(interpret=interpret, donate=donate)
        self.mode = mode
        self.injector = injector
        # the span-argument log the fuzzer's weight and LR checks and the
        # validator's per-round weights read; the service keeps it on
        # across a recovery
        self.span_log: Optional[List[tuple]] = [] if log_spans else None
        # telemetry: a reused engine keeps its own, a built one shares the
        # scheduler's
        self.telemetry = resolve_telemetry(telemetry)
        self.observer = FedObserver(self.telemetry)
        self._m_applied = self.telemetry.counter(
            "sched_spans_total", "event-free spans executed")
        self._m_cache_hit = self.telemetry.counter(
            "sched_eval_cache_hits_total",
            "eval-array cache hits (objective unchanged)")
        self._m_cache_miss = self.telemetry.counter(
            "sched_eval_cache_miss_total",
            "eval-array cache rebuilds (objective membership changed)")
        clients = list(clients) if state is None else state.clients
        if engine is None:
            # chunk_size has no effect: the port runs a span's rounds one
            # after another (engine_config records the reference's default)
            engine = RoundEngine(
                loss_fn=loss_fn, task=task, clients=clients,
                local_epochs=local_epochs, batch_size=batch_size,
                scheme=scheme, eta0=eta0, agg=agg, compression=compression,
                with_metrics=with_metrics, capacity=capacity,
                max_samples=max_samples, sharding=sharding, mode=engine_mode,
                device=device, model_kind=model_kind, telemetry=telemetry)
        self.engine = engine
        self.E = engine.E
        self.B = engine.B
        self.eta0 = engine.eta0
        self.params = init_params
        self._evaluate = evaluate
        self.eval_fn = eval_fn
        self._eval_cache = None         # (objective_version, x, y)
        if state is None:
            state = FedState(
                clients=clients, capacity=engine.capacity,
                reboot_boost=reboot_boost, fast_reboot=fast_reboot,
                horizon=horizon, bound_terms=bound_terms,
                local_epochs=engine.E, seed=seed, rng=rng, key=key,
                objective=objective, reboots=reboots)
        self.state = state
        self.history: List[RoundRecord] = (history if history is not None
                                           else [])
        self.delta_norms: List[float] = []
        # the tiered client store: bank=True builds one from the engine's
        # geometry, or pass a configured ClientBank (spill_dir, RAM
        # budget); prefetch=True also stages arrival cohorts on a worker
        # thread while spans run (and implies a bank)
        if prefetch and bank is None:
            bank = True
        if bank:
            self.bank = (bank if isinstance(bank, ClientBank)
                         else ClientBank(engine.task, engine.nmax))
            for i, c in enumerate(self.state.clients):
                self.bank.put(i, c)
        else:
            self.bank = None
        self._stager = (CohortStager(engine, self.bank)
                        if prefetch else None)
        self._prefetch_sig = None
        self._staged = None          # the retained cohort (spans boundaries)
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self._m_prefetch_hits = self.telemetry.counter(
            "sched_prefetch_hits_total",
            "admits served from a prefetched cohort")
        self._m_prefetch_miss = self.telemetry.counter(
            "sched_prefetch_misses_total",
            "admits that fell back to the synchronous staging path")
        self._span_args = None
        self._dirty = True
        self.push(*events)

    # -- control-plane views -------------------------------------------------
    @property
    def clients(self) -> List[Client]:
        return self.state.clients

    @property
    def objective(self) -> set:
        return self.state.objective

    @property
    def departed(self) -> set:
        return self.state.departed

    @property
    def slot_of(self):
        return self.state.slot_of

    @property
    def client_at(self):
        return self.state.client_at

    @property
    def free_slots(self):
        return self.state.free_slots

    @property
    def reboots(self) -> List[RebootState]:
        return self.state.reboots

    @property
    def lr_shift_tau(self) -> int:
        return self.state.lr_shift_tau

    @property
    def events_applied(self) -> int:
        return self.state.events_applied

    @property
    def rng(self) -> np.random.Generator:
        return self.state.rng

    @property
    def next_tau(self) -> int:
        """The round the next run() starts at."""
        return self.state.next_tau

    # the reference's private names for the same two views
    _next_tau = next_tau

    @property
    def _queue(self):
        return self.state.queue

    def data_weights(self) -> np.ndarray:
        return self.state.data_weights()

    @property
    def pending(self) -> int:
        return self.state.pending

    def push(self, *events: ParticipationEvent) -> None:
        """Enqueue participation events (any order, any time, including
        between run() calls).  With prefetch on, staging starts here, at
        ingestion: the boundary is the deadline, so the staging thread
        gets the whole span of lead time."""
        self.state.push(*events)
        if self._stager is not None:
            self._maybe_prefetch()

    # -- event application (executes FedState transitions on the engine) -----
    def _apply_events(self, tau: int) -> str:
        st = self.state
        if not st.due(tau):
            # nothing queued for this boundary (most boundaries): a burst
            # expiring here resumes its cohort, so the active mask is stale
            if st.expire(tau):
                self._dirty = True
            return ""
        with self.telemetry.span("sched.apply_events", tau=tau):
            return self._apply_due_events(tau)

    def _apply_due_events(self, tau: int) -> str:
        st = self.state
        ev = ""
        # consecutive admits land as one burst: slot writes are deferred
        # while admit actions accumulate, and flushed before any action
        # that may read or free a slot
        admits: List[tuple] = []

        def flush():
            if admits:
                try:
                    self._flush_admits(admits)
                finally:
                    admits.clear()

        try:
            while st.due(tau):
                e = st.pop_event()
                s, actions = st.apply(e, tau)
                self.observer.observe_event(e, tau)
                for act in actions:
                    if act[0] == "admit":
                        admits.append((act[1], act[2]))
                    elif act[0] == "evict":
                        flush()
                        self.engine.evict(act[1])
                    else:                       # ("set_trace", slot, trace)
                        flush()
                        self.engine.set_trace(act[1], act[2])
                ev += s
                st.events_applied += 1
        finally:
            # a raising event must not strand the admits already recorded:
            # FedState holds their slots, so the engine writes must land
            # even on the error path
            flush()
        if st.expire(tau) or ev:
            self._dirty = True
        return ev

    def _flush_admits(self, admits: List[tuple]) -> None:
        """Land a coalesced admit burst of (slot, client_id) pairs.  The
        clients a prefetched cohort covers commit from its device stack
        (one gather and scatter, ``commit_burst``); the rest take the
        synchronous ``admit_many``.  n and the s-law row always come from
        the live Client, so a staged row never publishes a stale law."""
        st = self.state
        pairs = [(slot, i, st.clients[i]) for slot, i in admits]
        staged = self._staged
        if self._stager is not None:
            fresh = self._stager.collect()
            if fresh is not None:
                # retained: later boundaries commit their subset of the
                # same stack without restaging (its rows do not change)
                staged = self._staged = fresh
        if self.bank is not None:
            # fresh arrivals enter the bank here (their client id exists
            # from now on); a staged client's host rows ride along, so the
            # span loop's thread never re-pads them
            for _, i, c in pairs:
                j = staged.index.get(id(c)) if staged is not None else None
                self.bank.put(i, c, rows=staged.rows[j] if j is not None
                              else None)
        hits, misses = [], []
        for slot, _, c in pairs:
            j = staged.index.get(id(c)) if staged is not None else None
            if j is not None:
                hits.append((slot, c, j))
            else:
                misses.append((slot, c))
        if hits:
            self.engine.commit_burst(
                staged.dev, slots=[slot for slot, _, _ in hits],
                ns=[c.n for _, c, _ in hits],
                cdfs=[trace_cdf_row(c.trace, self.engine.E)
                      for _, c, _ in hits],
                idx=[j for _, _, j in hits])
            self.prefetch_hits += len(hits)
            self._m_prefetch_hits.inc(len(hits))
        if misses:
            if self._stager is not None:
                self.prefetch_misses += len(misses)
                self._m_prefetch_miss.inc(len(misses))
            self.engine.admit_many(misses)

    def _eval_arrays(self):
        """The objective's held-out arrays on the engine's device, rebuilt
        only when objective membership changed."""
        version = self.state.objective_version
        if self._eval_cache is not None and self._eval_cache[0] == version:
            self._m_cache_hit.inc()
        else:
            self._m_cache_miss.inc()
            held = [self.clients[i] for i in sorted(self.objective)
                    if self.clients[i].x_test is not None]
            x = y = None
            if held:
                dev = self.engine.device
                x = torch.from_numpy(
                    np.concatenate([c.x_test for c in held])).to(dev)
                y = torch.from_numpy(
                    np.concatenate([c.y_test for c in held])).to(dev)
            self._eval_cache = (version, x, y)
        return self._eval_cache[1:]

    def evaluate(self):
        if self._evaluate is not None:
            return self._evaluate(self.params)
        if self.eval_fn is None:
            return float("nan"), float("nan")
        x, y = self._eval_arrays()
        if x is None:
            return float("nan"), float("nan")
        return self.eval_fn(self.params, x, y)

    def _args(self, tau: int) -> dict:
        """The span arguments on the engine's device, recomputed only when
        an event or a burst expiry dirtied them."""
        if self._span_args is None or self._dirty:
            dev = self.engine.device
            a = self.state.span_args(tau)
            if self.span_log is not None:
                self.span_log.append((tau, a["p"].copy(), a["active"].copy(),
                                      a["lr_shift_tau"]))
            self._span_args = dict(
                p=torch.as_tensor(a["p"], device=dev),
                active=torch.as_tensor(a["active"], device=dev),
                lr_shift_tau=a["lr_shift_tau"],
                reboot_tau0=torch.as_tensor(a["reboot_tau0"], device=dev),
                reboot_boost=torch.as_tensor(a["reboot_boost"], device=dev))
            self._dirty = False
        return self._span_args

    # -- main loop ------------------------------------------------------------
    def run(self, n_rounds: int, eval_every: int = 1):
        eng = self.engine
        st = self.state
        start = st.next_tau
        stop = start + n_rounds
        tau = start
        # per-span metrics stay on the device and are read back once,
        # after the loop: an evaluate() is the only sync inside it
        pending = []      # (tau, end, ev_label, device metrics, eval)
        try:
            while tau < stop:
                if self.injector is not None:
                    self.injector.fire("sched_span", tau=tau)
                ev = self._apply_events(tau)
                end = st.span_end(tau, stop, ev, eval_every)
                if self._stager is not None:
                    # the double buffer: while this span computes, the
                    # staging thread moves the next boundaries' arrival
                    # cohort from the bank to the device
                    self._maybe_prefetch()
                args = self._args(tau)
                with self.telemetry.span("sched.run_span", tau=tau,
                                         rounds=end - tau):
                    if self.mode == "device":
                        # the base key is never split: round tau folds tau
                        # in, so the draws do not depend on the span
                        # structure
                        self.params, m = eng.run_span(
                            self.params, tau, end - tau, key=st.key, **args)
                    else:
                        plans = [st.sample_plan(t, self.E, self.B)
                                 for t in range(tau, end)]
                        self.params, m = eng.run_span(
                            self.params, tau, end - tau,
                            plan=(np.stack([pl[0] for pl in plans]),
                                  np.stack([pl[1] for pl in plans])),
                            **args)
                self._m_applied.inc()
                eval_last = (end - 1) % eval_every == 0 or (
                    ev and end - tau == 1)
                pending.append((tau, end, ev, m,
                                self.evaluate() if eval_last else None))
                tau = end
            st.next_tau = stop
        finally:
            # spans that ran are recorded even if a later one raised
            self._flush_spans(pending)
        return self.history

    def _flush_spans(self, pending) -> None:
        """Device metrics -> host RoundRecords, observer signals and wire
        accounting, in span order, with one read-back for all spans."""
        if not pending:
            return
        eng = self.engine
        metrics = [m for _, _, _, m, _ in pending]
        s_all = torch.cat([m["s"] for m in metrics]).cpu().numpy()
        eta_all = torch.cat([m["eta"] for m in metrics]).cpu().numpy()
        if eng.with_metrics:
            self.delta_norms.extend(
                torch.cat([m["delta_norm"] for m in metrics]).tolist())
        row = 0
        for tau, end, ev, _, ev_result in pending:
            m = {"s": s_all[row:row + end - tau],
                 "eta": eta_all[row:row + end - tau]}
            eng.account_uploads(m["s"])
            self.observer.observe_span(self.state, tau, m, eng.scheme,
                                       self.E)
            for j, t in enumerate(range(tau, end)):
                loss = acc = float("nan")
                if ev_result is not None and t == end - 1:
                    loss, acc = ev_result
                s = m["s"][j]
                self.history.append(RoundRecord(
                    t, float(loss), float(acc), float(m["eta"][j]),
                    int((s > 0).sum()), s, ev if t == tau else ""))
            row += end - tau

    def _maybe_prefetch(self) -> None:
        """Submit the queued-arrival horizon as one staged cohort (not one
        per boundary): every Arrival now in the queue is padded, stacked
        and moved together, and successive boundaries commit their own
        subset of the retained stack.  Safe because the stack carries data
        rows only (n and the s-law are read from the live Client at
        commit).  Idempotent: skips when the retained cohort already
        covers the horizon; a new arrival set supersedes the in-flight
        staging."""
        st = self.state
        if not st.queue:
            self._staged = None                 # horizon drained
            return
        until = max(t for t, _, _ in st.queue)
        items = st.upcoming_arrivals(until)
        if not items:
            return
        staged = self._staged
        if staged is not None and all(id(c) in staged.index
                                      for _, c in items):
            return
        sig = tuple(sorted(id(c) for _, c in items))
        if sig == self._prefetch_sig:
            return
        self._prefetch_sig = sig
        self._stager.submit(items)

    def close(self) -> None:
        """Stop the prefetch staging thread (if any).  Idempotent; the
        scheduler stays usable: the next prefetch restages."""
        self._staged = None
        if self._stager is not None:
            self._stager.close()

    def prefetch_stats(self) -> dict:
        """Bank and stager counters (empty when the tiered store is
        off)."""
        out = {}
        if self.bank is not None:
            out["bank"] = self.bank.stats()
        if self._stager is not None:
            out["stager"] = self._stager.stats()
            out["hits"] = self.prefetch_hits
            out["misses"] = self.prefetch_misses
        return out

    # -- checkpoint / resume ---------------------------------------------------
    def engine_config(self) -> dict:
        """The engine's geometry, under every key the reference's
        ``restore`` reads (``chunk_size`` is the reference's default: the
        port has no scan chunks), plus ``model_kind``, which fixes the
        params' layout."""
        eng = self.engine
        return {"local_epochs": eng.E, "batch_size": eng.B,
                "scheme": eng.scheme, "eta0": eng.eta0,
                "chunk_size": REFERENCE_CHUNK_SIZE, "agg": eng.agg,
                "compression": eng.compression.name,
                "with_metrics": eng.with_metrics,
                "engine_mode": eng.mode, "capacity": eng.capacity,
                "max_samples": eng.nmax, "mode": self.mode,
                "bank": self.bank is not None,
                "prefetch": self._stager is not None,
                "model_kind": eng.model_kind}

    def save(self, path: str, extra: Optional[dict] = None,
             client_chunks: Optional[bool] = None) -> None:
        """Persist params, FedState, history and engine geometry in the
        reference's format (``checkpoint.io.save_fed_checkpoint``), the
        params in the reference's layout (the task's ``disk_params``).
        ``client_chunks`` (default: a bank-backed scheduler's) writes
        fed-checkpoint-v2, one checksummed npz per client.  Under sharding
        every rank holds the same params and state: save from one rank."""
        if client_chunks is None:
            client_chunks = self.bank is not None
        eng = self.engine
        save_fed_checkpoint(
            path, eng.task.disk_params(self.params, eng.model_kind),
            self.state.to_dict(),
            history=history_to_dict(self.history),
            config=self.engine_config(), extra=extra,
            injector=self.injector, telemetry=self.telemetry,
            client_chunks=client_chunks)

    @classmethod
    def restore(cls, path: str, *, loss_fn: Optional[Callable] = None,
                task=None, model_kind: Optional[str] = None, device=None,
                eval_fn: Optional[Callable] = None,
                evaluate: Optional[Callable] = None,
                engine: Optional[RoundEngine] = None, sharding=None,
                injector=None, log_spans: bool = False, telemetry=None,
                **overrides) -> "StreamScheduler":
        """Rebuild a scheduler from a checkpoint that either package's
        ``save()`` wrote.  The engine is rebuilt on ``device`` (the CUDA
        device unless ``device="cpu"``) from the persisted geometry, or
        ``engine`` (of the checkpoint's capacity and wire) is reused with
        every slot evicted first; every occupied slot is re-admitted in
        one ``admit_many`` in slot order; the FedState (queue, membership,
        reboots, RNG, key) and the history resume where they stopped.
        Only the callables (``loss_fn`` or ``task``, ``eval_fn`` or
        ``evaluate``) are the caller's to supply.  ``model_kind`` (the
        checkpoint's own, else None) fixes the layout the params are read
        in (the task's ``params_from_disk``); ``injector`` and
        ``log_spans`` go to the restored scheduler; ``overrides`` replace
        entries of the persisted geometry.  A reused ``engine`` must be
        driven by no other thread (the service's supervisor reuses one only
        after joining the worker that drove it).  The bank and the stager
        are rebuilt from the restored clients when the config says
        ``bank`` or ``prefetch`` (their contents are derived state, never
        persisted raw).

        Raises ``checkpoint.CorruptCheckpointError`` when the checkpoint
        fails its checksum."""
        params, state_dict, history, config, _extra = \
            load_fed_checkpoint(path, telemetry=telemetry)
        cfg = dict(config)
        cfg.update(overrides)
        state = FedState.from_dict(state_dict)
        if model_kind is None:
            model_kind = cfg.get("model_kind")
        compression = cfg.get("compression", "none")
        if engine is None:
            if task is None and loss_fn is not None and state.clients:
                task = ArrayTask(loss_fn,
                                 np.asarray(state.clients[0].x).shape[1:])
            engine = RoundEngine(
                task=task, clients=[], local_epochs=cfg["local_epochs"],
                batch_size=cfg["batch_size"], scheme=cfg["scheme"],
                eta0=cfg["eta0"], agg=cfg["agg"],
                with_metrics=cfg["with_metrics"], compression=compression,
                capacity=cfg["capacity"], max_samples=cfg["max_samples"],
                device=device, model_kind=model_kind, sharding=sharding,
                mode=cfg["engine_mode"], telemetry=telemetry)
        else:
            if engine.capacity != cfg["capacity"]:
                raise ValueError(
                    f"reused engine capacity {engine.capacity} != "
                    f"checkpoint capacity {cfg['capacity']}")
            if engine.compression.name != compression:
                raise ValueError(
                    f"reused engine compression "
                    f"{engine.compression.name!r} != checkpoint "
                    f"compression {compression!r}")
            if model_kind is not None and engine.model_kind != model_kind:
                raise ValueError(
                    f"reused engine model_kind {engine.model_kind!r} != "
                    f"{model_kind!r}")
            for slot in range(engine.capacity):
                engine.evict(slot)
        if engine.capacity != state.capacity:
            raise ValueError(
                f"the engine has {engine.capacity} slots (sharding pads to "
                f"whole slots per rank), the checkpoint's state "
                f"{state.capacity}: save with a capacity the ranks divide")
        engine.admit_many(sorted(
            ((slot, state.clients[i]) for i, slot in state.slot_of.items()),
            key=lambda sc: sc[0]))
        return cls(init_params=engine.task.params_from_disk(
                       params, engine.model_kind, engine.device),
                   engine=engine, state=state, mode=cfg["mode"],
                   eval_fn=eval_fn, evaluate=evaluate,
                   history=history_from_dict(history), telemetry=telemetry,
                   injector=injector, log_spans=log_spans,
                   bank=cfg.get("bank", False),
                   prefetch=cfg.get("prefetch", False))


# -- history (de)serialization -------------------------------------------------

def history_to_dict(history: Sequence[RoundRecord]) -> dict:
    """Columnar plain-data form of a RoundRecord list (numpy arrays and
    JSON-able lists), key for key the reference's; round-trips exactly
    through history_from_dict."""
    R = len(history)
    cap = len(history[0].s) if R else 0
    return {
        "tau": np.asarray([h.tau for h in history], np.int64),
        "loss": np.asarray([h.loss for h in history], np.float64),
        "acc": np.asarray([h.acc for h in history], np.float64),
        "eta": np.asarray([h.eta for h in history], np.float64),
        "n_active": np.asarray([h.n_active for h in history], np.int64),
        "s": (np.stack([np.asarray(h.s, np.float32) for h in history])
              if R else np.zeros((0, cap), np.float32)),
        "event": [h.event for h in history],
    }


def history_from_dict(d: Optional[dict]) -> List[RoundRecord]:
    if not d or len(d.get("tau", ())) == 0:
        return []
    return [RoundRecord(int(d["tau"][j]), float(d["loss"][j]),
                        float(d["acc"][j]), float(d["eta"][j]),
                        int(d["n_active"][j]), np.asarray(d["s"][j]),
                        str(d["event"][j]))
            for j in range(len(d["tau"]))]
