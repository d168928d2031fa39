"""Device-resident multi-round federated engine.

Counterpart of ``repro/fed/engine.py``.  Client datasets are padded to a
common length and live on the device once, as (capacity, Nmax, ...)
stacks; a round gathers its batches there from batch indices.  The alpha
masks and batch indices come from one of two samplers:

  * a *plan* (``run_span(plan=...)``): drawn on the host with the numpy RNG
    in the seed order, so the run is sample-for-sample the reference's
    plan mode;
  * the device draw (``run_span(key=...)``): an inverse-CDF draw of each
    slot's s from its row of the trace law's table (``trace_s_cdf``) and
    uniform batch indices, with round tau's key ``fold_in(key, tau)``
    (``device_sample_round``).  ``core.prng`` makes jax's threefry draws
    bit for bit, so given the same table the alphas and indices are the
    reference's device mode's, and round tau's draw never depends on how
    the rounds were cut into spans.

Scheme A/B/C coefficients, the fast-reboot boost (exact O((tau-tau0)^-2)
decay at every round) and the staircase LR are computed on the device, and
the round's deltas are reduced with one kernel launch (``agg="flat"``) or
leaf by leaf (``agg="tree"``), through the wire format of ``compression=``.
``mode="client_sequential"`` trains the clients one at a time into a
streaming accumulator instead (``core.fed_step.fed_round_sequential``).

Capacity slots: slots beyond the founding clients start empty (n = 1, the
s-law all mass at 0).  ``admit``/``admit_many``/``commit_burst``,
``evict`` and ``set_trace`` write a slot's data rows, its n and its row of
the s-law table, so a membership event never rebuilds the engine.
``put_burst(stacks, stream=)`` is the one call a staging thread makes
(``fed/bank.CohortStager``): on CUDA it queues pinned-memory copies on the
stager's own stream; ``commit_burst`` marks what it reads as used by the
current stream, so the caching allocator never hands a staged block back
to the staging stream while the scatter may still read it.

Telemetry (``telemetry=``, ``repro_torch.obs``; the null default costs
nothing): the reference's families ``engine_spans_total``,
``engine_rounds_total`` and ``fed_wire_bytes_total{wire}``, and
``engine_traces_total``, registered and left at 0 (the port compiles no
span); the spans ``engine.admit``, ``engine.admit_many``,
``engine.evict``, ``engine.set_trace`` and ``engine.run_span``.  A span's
metrics stay on the device, so the caller charges the wire with
``account_uploads`` once it has read ``s`` back (the scheduler does).
With ``Telemetry(trace_dir=)`` each span also runs under
``torch.profiler`` and writes a Chrome trace into that directory.

Sharding: with ``sharding=FedSharding(...)`` (``fed/sharding.py``) the
capacity is padded to whole slots per rank and this rank's data buffers
hold only its own slots; ``n`` and the s-law table stay whole on every
rank.  Every rank takes the same full plan, or draws the whole capacity
from the same key; ``s`` and the scheme coefficients (boost included) are
computed over the whole capacity, and only then is the rank's share of
alpha, the batch indices and the coefficients cut (``FedSharding.shard``).
So a sharded draw equals the unsharded one.  Each rank trains its own
clients and the aggregation ends in one all-reduce, so the params stay
replicated and the metrics are the whole federation's on every rank.
"""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.aggregation import scheme_coefficients
from repro_torch.core.compression import resolve_compression, wire_bytes
from repro_torch.core.fed_step import (fed_round_parallel,
                                       fed_round_sequential)
from repro_torch.device import resolve_device
from repro_torch.fed.task import ArrayTask
from repro_torch.obs.telemetry import resolve as resolve_telemetry

Params = Dict[str, torch.Tensor]


@functools.lru_cache(maxsize=1024)
def trace_cdf_row(trace, E: int) -> np.ndarray:
    """CDF table of completed epochs s for one trace: (E+1,) f32 with
    cdf[k] = P(s <= k).  Cached per (trace, E); callers must not mutate
    the returned array.

    s = round(frac * E) for frac ~ Beta(a, b) mixed with an inactivity
    atom at 0, so the s-law is a discrete distribution over {0..E} whose
    CDF is the regularized incomplete beta at the rounding boundaries
    (k + 1/2)/E, evaluated in float64 (``scipy.special.betainc``) and cast
    to f32 at the end.  The reference evaluates it with jax in f32, so its
    table differs from this one by up to ~2e-6; the draw from a given table
    is bit for bit the same.
    """
    from scipy.special import betainc

    ks = np.arange(E + 1)
    ab = trace._beta_params()
    if ab is None:
        # degenerate trace: frac == mean deterministically
        s0 = int(np.clip(np.round(trace.mean * E), 0, E))
        base = (ks >= s0).astype(np.float64)
    else:
        x = np.clip((ks + 0.5) / E, 0.0, 1.0)
        base = np.asarray(betainc(ab[0], ab[1], x), np.float64)
        base[-1] = 1.0
    q = trace.p_inactive
    if q > 0:
        # inactive rounds put an atom at s = 0
        row = q + (1.0 - q) * base
    else:
        # CPU-contention traces never produce zero epochs: the s = 0 mass
        # moves to s = 1 (Trace.sample_s's maximum(s, 1))
        row = base.copy()
        row[0] = 0.0
    row[-1] = 1.0
    return row.astype(np.float32)


def empty_slot_cdf(E: int) -> np.ndarray:
    """An empty slot's s-law: all mass at s = 0, so the slot never trains
    even before the scheduler's active mask is applied."""
    return np.ones(E + 1, np.float32)


def trace_s_cdf(clients, E: int) -> np.ndarray:
    """Per-client CDF table of completed epochs s: (C, E+1) with
    cdf[c, k] = P(s_c <= k).  See trace_cdf_row."""
    return np.stack([trace_cdf_row(cl.trace, E) for cl in clients]) \
        if clients else np.zeros((0, E + 1), np.float32)


def device_sample_round(key, active, n, s_cdf, E: int, B: int):
    """The device draw of participation and batch indices for one round,
    as the reference's ``device_sample_round``: ``ks, kb = split(key)``;
    s = #{k : u > cdf[k]} for u = uniform(ks, (C,)), times ``active``;
    alpha = (arange(E) < s); idx = min(int32(uniform(kb, (C, E, B)) * n),
    n - 1).

    key: (..., 2) int64 words, a batch of keys (the engine passes a span's
    per-round keys at once); active: (C,) 0/1 f32; n: (C,) int32 dataset
    sizes; s_cdf: (C, E+1) f32 (trace_s_cdf).  C is the whole capacity:
    the draws are counted over it, so another C draws other values.
    Returns alpha (..., C, E) f32 and idx (..., C, E, B) int32.
    """
    C = n.shape[0]
    keys = prng.split(key)
    u = prng.uniform(keys[..., 0, :], (C,))
    s = (u[..., None] > s_cdf).sum(-1).to(torch.float32) * active
    alpha = (torch.arange(E, dtype=torch.float32, device=s.device)
             < s[..., None]).to(torch.float32)
    ub = prng.uniform(keys[..., 1, :], (C, E, B))
    idx = torch.minimum(
        (ub * n.to(torch.float32)[:, None, None]).to(torch.int32),
        n[:, None, None] - 1)
    return alpha, idx


def device_sample_span(key, R: int, active, n, s_cdf, E: int, B: int, *,
                       tau0: int = 0):
    """R rounds of device_sample_round under the per-round keys
    ``fold_in(key, tau)``, tau = tau0 .. tau0+R-1: alphas (R, C, E) f32,
    idxs (R, C, E, B) int32.  The R keys are derived on the host in one
    pass and go to n's device in one copy."""
    taus = torch.arange(tau0, tau0 + R, dtype=torch.int64)
    keys = prng.fold_in(key.cpu(), taus).to(n.device)
    return device_sample_round(keys, active, n, s_cdf, E, B)


class RoundEngine:
    """Runs spans of federated rounds on device-resident client data.

    The model layer is a ClientTask (fed/task.py); ``loss_fn=`` wraps into
    the equivalent ArrayTask.  Membership, data weights p, the active
    mask, the LR-restart round and reboot state are constant within a span
    (the scheduler splits spans at every event) and enter ``run_span`` as
    arguments.

    ``agg="auto"`` picks ``"flat"``, the kernel path, on CUDA, and
    ``"tree"`` on the CPU, where the kernel's plain version loops over the
    clients and the per-leaf reduction is cheaper; on a quantized wire
    (``compression="int8"`` or ``"int8-topk"``) it picks ``"flat"`` on the
    CPU too, as the reference does: the plain version reduces the int8
    payload as it is.  ``model_kind`` (``PaperModelConfig.kind``) fixes
    the quantized wire's element order: the CNN's is gathered into the
    reference's (``core.aggregation.flatten_for_wire``).

    ``mode`` is ``"client_parallel"`` (all clients as one batch, then one
    reduction of their (C, D) deltas) or ``"client_sequential"`` (one
    client at a time into an f32 accumulator, memory-bounded; ``agg`` does
    not apply to it).  ``with_metrics`` adds each round's delta norm to
    the span's metrics (``core.fed_step``); without it the norm is 0.
    """

    def __init__(self, *, clients, local_epochs: int, batch_size: int,
                 loss_fn=None, task=None, scheme: str = "C",
                 eta0: float = 0.01, agg: str = "auto",
                 capacity: Optional[int] = None,
                 max_samples: Optional[int] = None, device=None,
                 compression=None, model_kind: Optional[str] = None,
                 sharding=None, mode: str = "client_parallel",
                 with_metrics: bool = False, telemetry=None):
        if mode not in ("client_parallel", "client_sequential"):
            raise ValueError(f"mode must be client_parallel|"
                             f"client_sequential, got {mode!r}")
        if mode == "client_sequential" and sharding is not None:
            raise ValueError("the client-sequential round is not sharded "
                             "yet (ROADMAP item 6): pass sharding= with "
                             "mode='client_parallel'")
        self.mode = mode
        self.with_metrics = with_metrics
        if (task is None) == (loss_fn is None):
            raise ValueError("pass exactly one of task= or loss_fn=")
        if task is None:
            if not clients:
                raise ValueError("RoundEngine needs at least one founding "
                                 "client (fixes the feature shape)")
            task = ArrayTask(loss_fn, np.asarray(clients[0].x).shape[1:])
        self.task = task
        self.loss_fn = task.loss_fn
        self.device = resolve_device(device)
        self.E = local_epochs
        self.B = batch_size
        self.scheme = scheme
        self.eta0 = eta0
        # a tensor, so eta0 / x is a true f32 division (a Python number
        # over a tensor is computed as eta0 * (1 / x), rounded twice)
        self._eta0 = torch.tensor(eta0, dtype=torch.float32,
                                  device=self.device)
        # the delta wire format (core/compression)
        self.compression = resolve_compression(compression)
        self.model_kind = model_kind
        if agg == "auto":
            agg = ("flat" if self.device.type == "cuda"
                   or self.compression.quantized else "tree")
        if agg not in ("tree", "flat"):
            raise ValueError(f"agg must be auto|tree|flat, got {agg!r}")
        self.agg = agg

        C = len(clients)
        if C == 0 and (capacity is None or max_samples is None):
            raise ValueError("RoundEngine without founding clients needs "
                             "explicit capacity= and max_samples=")
        if capacity is None:
            capacity = C
        if capacity < max(C, 1):
            raise ValueError(f"capacity {capacity} < {C} founding clients")
        self.sharding = sharding
        if sharding is not None:
            # every rank owns the same number of whole slots; the extra
            # ones are ordinary empty capacity slots (p = 0, never train)
            capacity = sharding.pad_capacity(capacity)
            self.local_slots = sharding.slots(capacity)
        else:
            self.local_slots = range(capacity)
        self.capacity = capacity
        nmax = max((c.n for c in clients), default=1)
        if max_samples is not None:
            nmax = max(nmax, max_samples)
        self.nmax = nmax
        lo, n_local = self.local_slots.start, len(self.local_slots)
        stacks = {name: np.zeros((n_local, nmax) + spec.shape, spec.dtype)
                  for name, spec in task.buffers.items()}
        for i, c in enumerate(clients):
            if i in self.local_slots:
                for name, arr in self._client_rows(c).items():
                    stacks[name][i - lo, :c.n] = arr
        # empty slots keep n = 1, so the draw's idx = min(u n, n - 1) stays
        # a valid gather (their alpha and coefficient are 0 regardless);
        # n and the s-law table cover the whole capacity on every rank:
        # the device draw is counted over all of it
        n = np.ones(capacity, np.int32)
        n[:C] = [c.n for c in clients]
        cdf = np.tile(empty_slot_cdf(self.E), (capacity, 1))
        cdf[:C] = trace_s_cdf(clients, self.E)
        # datasets move host->device exactly once, here; under sharding
        # each rank holds only the rows of the slots it owns
        self.data = {name: torch.from_numpy(buf).to(self.device)
                     for name, buf in stacks.items()}
        self.n = torch.from_numpy(n).to(self.device)
        self.s_cdf = torch.from_numpy(cdf).to(self.device)
        self._empty_cdf = torch.from_numpy(empty_slot_cdf(self.E)).to(
            self.device)
        self._slots = torch.arange(n_local, device=self.device)[:, None,
                                                                None]
        self.telemetry = tel = resolve_telemetry(telemetry)
        # the reference counts its scan compiles here; the port compiles
        # none, and keeps the family so that the reference's dashboards
        # find it
        self._m_traces = tel.counter(
            "engine_traces_total",
            "jitted chunk (re)traces — actual scan compiles")
        self._m_spans = tel.counter(
            "engine_spans_total", "run_span dispatches")
        self._m_rounds = tel.counter(
            "engine_rounds_total", "rounds executed by run_span")
        # analytic client->server traffic (core/compression.wire_bytes),
        # by wire format, charged per span from the realized s
        self._m_wire = tel.counter(
            "fed_wire_bytes_total",
            "client->server delta bytes (analytic, by wire format)",
            labelnames=("wire",))
        self._d_total: Optional[int] = None
        self._traces_written = 0

    def _client_rows(self, client):
        """The task's per-sample arrays for one client, shape-checked
        against the engine's buffer specs."""
        arrays = self.task.client_arrays(client)
        for name, arr in arrays.items():
            spec = self.task.buffers[name]
            if arr.shape != (client.n,) + spec.shape:
                raise ValueError(
                    f"feature shape {arr.shape[1:]} != engine feature "
                    f"shape {spec.shape} (buffer {name!r})")
        return arrays

    def _check_slot(self, slot: int) -> None:
        if not 0 <= slot < self.capacity:
            raise IndexError(f"slot {slot} out of range [0, {self.capacity})")

    def _check_burst(self, slots) -> None:
        for slot in slots:
            self._check_slot(slot)
        if len(set(slots)) != len(slots):
            # one slot written twice could mix two clients' rows
            raise ValueError(f"admit_many got duplicate slots: {slots}")

    # -- capacity-slot lifecycle ----------------------------------------------
    def admit(self, slot: int, client) -> None:
        """Write one client into a slot: a burst of one."""
        with self.telemetry.span("engine.admit", slot=slot):
            self._admit_many([(slot, client)])

    def admit_many(self, assignments) -> None:
        """Write a burst of (slot, client) pairs into their slots: the
        data rows are padded and stacked on the host, go up as one
        transfer per buffer (``put_burst``) and land with n and the
        clients' s-law rows in one ``commit_burst``.  Under sharding every
        rank checks the whole burst, stages only the rows of the slots it
        owns, and writes n and the s-law of every slot."""
        assignments = list(assignments)
        if not assignments:
            return
        with self.telemetry.span("engine.admit_many", k=len(assignments)):
            self._admit_many(assignments)

    def _admit_many(self, assignments) -> None:
        slots = [slot for slot, _ in assignments]
        for _, c in assignments:
            if c.n > self.nmax:
                raise ValueError(
                    f"client has {c.n} samples > slot capacity {self.nmax}; "
                    f"build the engine with max_samples >= {c.n}")
        local = [j for j, slot in enumerate(slots)
                 if slot in self.local_slots]
        stacks = {name: np.zeros((len(local), self.nmax) + spec.shape,
                                 spec.dtype)
                  for name, spec in self.task.buffers.items()}
        idx = [0] * len(slots)      # rows of slots this rank does not own
        for row, j in enumerate(local):     # are never read
            c = assignments[j][1]
            for name, arr in self._client_rows(c).items():
                stacks[name][row, :c.n] = arr
            idx[j] = row
        self.commit_burst(
            self.put_burst(stacks), slots=slots,
            ns=[c.n for _, c in assignments],
            cdfs=[trace_cdf_row(c.trace, self.E) for _, c in assignments],
            idx=idx)

    def put_burst(self, stacks, *, stream=None) -> dict:
        """Move pre-stacked (k, Nmax, *spec.shape) host buffers to the
        device, one transfer per buffer.  Pure transfer, no engine
        mutation, so a staging thread may call it while a span runs.

        Without ``stream`` the stacks are numpy arrays and the copies run
        on the calling thread's current stream (synchronous from pageable
        memory: the admit path).  With ``stream`` (a ``torch.cuda.Stream``,
        the CohortStager's) the stacks are pinned host tensors, and the
        copies are queued on that stream with ``non_blocking=True`` and
        allocated from its pool: the caller waits for them (an event
        recorded after them on the stream) before it reads the result or
        rewrites a stack."""
        if stream is None:
            return {name: torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device) for name, a in stacks.items()}
        with torch.cuda.stream(stream):
            return {name: t.to(self.device, non_blocking=True)
                    for name, t in stacks.items()}

    def commit_burst(self, dev_rows, *, slots, ns, cdfs, idx=None) -> None:
        """Land a staged burst: every data buffer's rows, n and the s-law
        rows of ``slots``.

        dev_rows: ``put_burst`` output, (K, Nmax, *spec.shape) device
        stacks; slots/ns/cdfs: per written slot, in slot order; idx: the
        row of dev_rows for each written slot (default: the identity), so
        a staged stack can be committed as a subset or reordered.  n and
        the s-law come from the caller (the live client), never from the
        stack.  Under sharding only the data rows of this rank's slots are
        written (and read); n and the s-law of every slot."""
        slots = list(slots)
        if not slots:
            return
        self._check_burst(slots)
        idx = list(range(len(slots))) if idx is None else list(idx)
        dev = self.device
        if dev.type == "cuda":
            # a staged stack was allocated on the stager's stream: mark it
            # as used by this one, so that once the scheduler drops it the
            # allocator waits for the gather below before reusing it
            current = torch.cuda.current_stream(dev)
            for t in dev_rows.values():
                t.record_stream(current)
        at = torch.tensor(slots, device=dev)
        self.n[at] = torch.tensor(list(ns), dtype=torch.int32, device=dev)
        self.s_cdf[at] = torch.from_numpy(np.stack(cdfs)).to(dev)
        lo = self.local_slots.start
        local = [(idx[j], slot - lo) for j, slot in enumerate(slots)
                 if slot in self.local_slots]
        if not local:
            return
        rows = torch.tensor([r for r, _ in local], device=dev)
        at = torch.tensor([s for _, s in local], device=dev)
        for name, buf in self.data.items():
            buf[at] = dev_rows[name][rows]

    def evict(self, slot: int) -> None:
        """Free a slot: n drops to 1 (keeps gathers valid) and its s-law
        collapses to the empty-slot atom at 0.  Its data stays on the
        device, unreachable (alpha = 0, coefficient 0), until the next
        admit overwrites it."""
        self._check_slot(slot)
        with self.telemetry.span("engine.evict", slot=slot):
            self.n[slot] = 1
            self.s_cdf[slot] = self._empty_cdf

    def set_trace(self, slot: int, trace) -> None:
        """Swap the availability law of an occupied slot (TraceShift)."""
        self._check_slot(slot)
        with self.telemetry.span("engine.set_trace", slot=slot):
            self.s_cdf[slot] = torch.from_numpy(
                trace_cdf_row(trace, self.E)).to(self.device)

    # -- one round ------------------------------------------------------------
    def _round_core(self, params, alpha, idx, tau, p, rb_tau0, rb_boost,
                    lr_shift: int):
        s = alpha.sum(-1)
        coeffs = scheme_coefficients(self.scheme, p, s, self.E)
        # fast-reboot boost, exact O((tau-tau0)^-2) decay at every tau;
        # rb_boost == 1 for never-rebooted clients => multiplier 1
        dt = torch.clamp(tau - rb_tau0, min=0).float()
        coeffs = coeffs * (1.0 + (rb_boost - 1.0) / (1.0 + dt).square())
        eta = self._eta0 / torch.clamp((tau + 1 - lr_shift).float(), min=1.0)
        if self.sharding is not None:
            # s and the coefficients are the whole capacity's (scheme A
            # normalises over every slot); only now is this rank's share
            # cut (idx came up already cut: run_span)
            alpha, coeffs = (self.sharding.shard(x) for x in (alpha, coeffs))
        batches = self.task.make_batch(
            {name: buf[self._slots, idx] for name, buf in self.data.items()})
        if self.mode == "client_sequential":
            params, m = fed_round_sequential(
                self.loss_fn, params, batches, alpha, coeffs, eta,
                compression=self.compression, model_kind=self.model_kind,
                with_metrics=self.with_metrics)
        else:
            params, m = fed_round_parallel(
                self.loss_fn, params, batches, alpha, coeffs, eta,
                agg=self.agg, compression=self.compression,
                model_kind=self.model_kind, sharding=self.sharding,
                with_metrics=self.with_metrics)
        return params, s, eta, m["delta_norm"]

    # -- host entry point -----------------------------------------------------
    def sample_span(self, key, tau_start: int, n_rounds: int, active):
        """The device draw of a span: alphas (R, capacity, E) f32 and batch
        indices (R, capacity, E, B) int64, round tau from ``fold_in(key,
        tau)`` (``device_sample_span``) over the whole capacity, before
        any sharding cut."""
        active = torch.as_tensor(active, dtype=torch.float32,
                                 device=self.device)
        alphas, idxs = device_sample_span(
            torch.as_tensor(key, dtype=torch.int64), n_rounds, active,
            self.n, self.s_cdf, self.E, self.B, tau0=tau_start)
        return alphas, idxs.long()

    def run_span(self, params: Params, tau_start: int, n_rounds: int, *,
                 p, lr_shift_tau: int, reboot_tau0, reboot_boost,
                 plan=None, key=None, active=None):
        """Run n_rounds starting at tau_start with fixed membership.

        Exactly one of ``plan`` or ``key`` is given.  plan: (alphas (R,
        capacity, E), idxs (R, capacity, E, B)) sampled on the host; key:
        a (2,) key (``core.prng``) for the device draw, with ``active``
        the (capacity,) 0/1 mask of slots that train this span (a plan
        already carries it).  Under sharding only this rank's slots of the
        batch indices are used; alpha goes whole into the round, for s
        over the whole capacity.  params are updated in place.  Returns
        (params, metrics) with the metrics still on the device, stacked
        over rounds: s (R, capacity), eta (R,) and delta_norm (R,), so the
        host does not wait for the span; the caller reads them back when
        it needs them, and charges the wire then (``account_uploads``).
        """
        if (plan is None) == (key is None):
            raise ValueError("pass exactly one of plan= or key=")
        dev = self.device
        if n_rounds <= 0:
            return params, {"s": torch.zeros((0, self.capacity), device=dev),
                            "eta": torch.zeros(0, device=dev),
                            "delta_norm": torch.zeros(0, device=dev)}
        if self._d_total is None:
            # the model's size in floats, for account_uploads
            self._d_total = sum(int(v.numel()) for v in params.values())
        tel = self.telemetry
        self._m_spans.inc()
        self._m_rounds.inc(n_rounds)
        with tel.span("engine.run_span", tau=tau_start, rounds=n_rounds), \
                self._profiled(tau_start, n_rounds):
            return self._run_span(params, tau_start, n_rounds, p=p,
                                  lr_shift_tau=lr_shift_tau,
                                  reboot_tau0=reboot_tau0,
                                  reboot_boost=reboot_boost, plan=plan,
                                  key=key, active=active)

    @contextlib.contextmanager
    def _profiled(self, tau_start: int, n_rounds: int):
        """With ``Telemetry(trace_dir=)``: the span under
        ``torch.profiler`` (CPU, and CUDA on the card), its Chrome trace
        written into trace_dir as ``run_span-<tau>-<rounds>-<seq>.json``.
        Otherwise nothing."""
        trace_dir = self.telemetry.trace_dir
        if not trace_dir:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"run_span-{tau_start:06d}-{n_rounds}-"
                       f"{self._traces_written:04d}.json"))
        self._traces_written += 1

    def account_uploads(self, s) -> None:
        """Charge fed_wire_bytes_total for a span's completed-epoch matrix
        (host numpy): one delta upload per client-round with any epochs,
        in the engine's wire format (``core.compression.wire_bytes``)."""
        uploads = int((np.asarray(s) > 0).sum())
        if uploads:
            self._m_wire.labels(self.compression.name).inc(
                wire_bytes(self._d_total, self.compression,
                           n_clients=uploads))

    def _run_span(self, params: Params, tau_start: int, n_rounds: int, *,
                  p, lr_shift_tau: int, reboot_tau0, reboot_boost, plan,
                  key, active):
        dev = self.device
        p = torch.as_tensor(p, dtype=torch.float32, device=dev)
        rb_tau0 = torch.as_tensor(reboot_tau0, dtype=torch.int32, device=dev)
        rb_boost = torch.as_tensor(reboot_boost, dtype=torch.float32,
                                   device=dev)
        if plan is not None:
            alphas = torch.as_tensor(plan[0], dtype=torch.float32, device=dev)
            idxs = np.asarray(plan[1])
            if self.sharding is not None:
                idxs = self.sharding.shard(idxs.swapaxes(0, 1)).swapaxes(0, 1)
            idxs = torch.as_tensor(idxs, dtype=torch.int64, device=dev)
        else:
            if active is None:
                raise ValueError("the device draw needs active=")
            alphas, idxs = self.sample_span(key, tau_start, n_rounds, active)
            if self.sharding is not None:
                idxs = self.sharding.shard(idxs.transpose(0, 1)).transpose(
                    0, 1)
        # round indices are made on the device: a host scalar per round
        # would be a blocking copy per round
        taus = tau_start + torch.arange(n_rounds, dtype=torch.int32,
                                        device=dev)
        ss, etas, norms = [], [], []
        for r in range(n_rounds):
            params, s, eta, dn = self._round_core(
                params, alphas[r], idxs[r], taus[r], p, rb_tau0, rb_boost,
                lr_shift_tau)
            ss.append(s)
            etas.append(eta)
            norms.append(dn)
        return params, {"s": torch.stack(ss), "eta": torch.stack(etas),
                        "delta_norm": (torch.stack(norms) if self.with_metrics
                                       else torch.zeros(n_rounds,
                                                        device=dev))}
