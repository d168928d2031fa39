"""Property-based event-stream fuzzer for the federation control plane.

Counterpart of ``repro/fed/fuzz.py``, with its names, signatures, defaults
and invariant names, so that a seed that fails in one package reads the
same in the other.  The streaming scheduler promises hard invariants under
*any* interleaving of participation events (arrivals, departures that
include or exclude, rejoins, trace shifts, inactivity bursts, duplicate
deliveries) with kills and resumes anywhere between spans.  This module
generates seeded random interleavings and checks the promises on every
one:

  exact-resume     killing the run at arbitrary span boundaries (in-memory
                   FedState.to_dict round-trip, the same serialization the
                   on-disk checkpoints use) and resuming yields a history
                   and final params **bit-identical** to the uninterrupted
                   run;
  zero-recompile   no fuzz case may make the engine rebuild anything after
                   warm-up: events cost slot writes in place
                   (``RoundEngine.admit_many``/``commit_burst``, ``evict``,
                   ``set_trace``), never a new buffer or a kernel build.
                   The port compiles no span, so where the reference pins
                   its jit cache this pins what an event may not cause
                   (``_fn_signature``): every device buffer of the engine
                   (its slot data, ``n``, the s-law table) at the same
                   address, shape and dtype, no kernel library loaded
                   since warm-up, and ``engine_traces_total`` unchanged;
  weight-sanity    every span's membership-derived arguments are lawful:
                   p >= 0 with total mass in (0, 1] (include-departures
                   keep their mass in the normalization while holding no
                   slot), active slots carry positive weight, 0 <= s <= E
                   with s > 0 only on active slots, the scheme A/B/C
                   coefficients computed from (p, s) are finite and
                   non-negative, and eta(t) = eta0 / max(t+1-lr_shift, 1)
                   for the forward-filled LR-shift round;
  plan-parity      mode="plan" (host-RNG sampling) walks the identical
                   control-plane trajectory as mode="device": same event
                   application log, same eta sequence, same per-span
                   (p, active, lr_shift), same final membership.  (Epoch
                   counts s are sample-path quantities drawn from
                   different RNG streams, so they are *not* compared.)

One warm engine is pooled across all cases: each case evicts every slot
and re-admits its own client set, which is exactly the
restore-into-warm-engine path the supervised service uses for recovery.

Beyond the single-engine invariants, two cross-cutting checks pool
*multiple* executions of one case:

  backend-parity   the same seeded op schedule runs on a pool of
                   execution backends (client_parallel, client_sequential,
                   the int8 wire on either, the banked engine with its
                   cohort prefetch, and the engine sharded over a
                   ``torch.distributed`` group), and every backend must
                   produce the identical control-plane trajectory
                   (tau/event/eta/n_active and the exact per-round epoch
                   counts s: device sampling folds the round index, so the
                   draw stream is backend-invariant) with final params
                   equal to numerical tolerance (aggregation order differs
                   across backends);
  chaos-bitexact   fuzz cases double as *supervised chaos* workloads: the
                   case's event schedule is submitted up-front to a real
                   ``FederationService(supervise=True)`` while a seeded
                   ``FaultPlan.generate`` schedule crashes the worker,
                   tears spans mid-run, breaks and corrupts snapshots and
                   floods the queue, and the recovered history and params
                   must be bit-identical to the fault-free service run.

A violation raises InvariantViolation carrying the case seed: re-running
``run_fuzz_case(harness, seed)`` (or ``run_chaos_case`` /
``run_cross_backend_case``) replays the exact interleaving.  Harnesses run
on the CUDA device unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import scheme_coefficients
from repro_torch.core.participation import TRACES
from repro_torch.device import resolve_device
from repro_torch.fed.engine import RoundEngine
from repro_torch.fed.events import (Arrival, Departure, InactivityBurst,
                                    TraceShift, event_from_dict,
                                    event_to_dict)
from repro_torch.fed.state import FedState
from repro_torch.fed.stream import StreamScheduler
from repro_torch.kernels import build


class InvariantViolation(AssertionError):
    """A fuzz case broke a control-plane invariant.  The message leads
    with the case seed so the interleaving can be replayed exactly."""

    def __init__(self, seed: int, invariant: str, detail: str):
        self.seed = seed
        self.invariant = invariant
        super().__init__(f"[fuzz seed={seed}] {invariant}: {detail}")


# -- case generation -----------------------------------------------------------

@dataclass
class FuzzCase:
    """A seeded op program: ("push", event_dict), ("run", n), ("kill",).
    Events are stored in codec (dict) form so every execution
    materializes fresh payload objects: two runs of one case must never
    share a Client."""
    seed: int
    ops: List[Tuple] = field(default_factory=list)
    total_rounds: int = 0

    @property
    def n_kills(self) -> int:
        return sum(1 for op in self.ops if op[0] == "kill")


def generate_case(seed: int, *, n_founding: int = 4, capacity: int = 8,
                  n_arrival_pool: int = 4, max_ops: int = 14,
                  max_kills: int = 2) -> FuzzCase:
    """A random-but-valid interleaving, draw for draw the reference's.  A
    conservative occupancy/membership simulation keeps programs inside the
    engine's contract: arrivals never exceed free slots (allocated at
    event *creation*, the pessimistic bound), exclude-departures never
    drive the objective below two members (data_weights normalizes by
    total mass), and rejoins pair 1:1 with prior include-departures (the
    freed slot is reserved for them).  Duplicate deliveries are injected
    for Departure/TraceShift (idempotent or deterministic on replay);
    payload-carrying Arrivals are never duplicated: registering the same
    payload twice is a *second* client by design."""
    rng = np.random.default_rng(seed)
    ops: List[Tuple] = []
    cursor = 0                       # rounds scheduled so far
    max_tau = 0                      # largest event tau pushed
    free = capacity - n_founding     # pessimistic free-slot budget
    members = set(range(n_founding))           # objective lower bound
    include_departed: List[int] = []           # rejoinable ids
    slotted = set(range(n_founding))           # ids that may trace-shift
    # a TraceShift dereferences clients[i], so it must not apply before
    # the arrival that registers i: clamp its tau to the arrival's
    min_tau = {i: 0 for i in range(n_founding)}
    next_arrival = 0                           # index into arrival pool
    next_id = n_founding                       # id a new payload will get
    # fresh-arrival taus never decrease: fresh payloads are registered in
    # *application* order, so a later pool entry landing at an earlier tau
    # would swap the ids this simulation hands to shifts and departures
    last_fresh_tau = 0
    kills = 0
    excludes = 0

    def push(e) -> None:
        nonlocal max_tau
        max_tau = max(max_tau, e.tau)
        ops.append(("push", event_to_dict(e)))

    n_ops = int(rng.integers(8, max_ops + 1))
    for _ in range(n_ops):
        kind = rng.choice(["run", "arrival", "departure", "rejoin",
                           "shift", "burst", "kill"],
                          p=[0.30, 0.13, 0.13, 0.10, 0.14, 0.10, 0.10])
        tau = cursor + int(rng.integers(0, 4))   # near-future (or stale
        if rng.random() < 0.2:                   # news for past rounds)
            tau = max(0, cursor - 1)
        if kind == "run":
            n = int(rng.integers(1, 6))
            ops.append(("run", n))
            cursor += n
        elif kind == "arrival" and free > 0 \
                and next_arrival < n_arrival_pool:
            tau = max(tau, last_fresh_tau)
            last_fresh_tau = tau
            # negative ids are pool references resolved at execution
            push(Arrival(tau, client_id=-(next_arrival + 1)))
            free -= 1
            members.add(next_id)
            slotted.add(next_id)
            min_tau[next_id] = tau
            next_arrival += 1
            next_id += 1
        elif kind == "departure" and members:
            i = int(rng.choice(sorted(members)))
            # the objective only ever shrinks via exclude (include keeps
            # the mass), so capping total excludes below n_founding - 1
            # keeps it nonempty under ANY application order
            if excludes < n_founding - 2 and rng.random() < 0.5:
                push(Departure(tau, client_id=i, policy="exclude"))
                members.discard(i)
                excludes += 1
            else:
                push(Departure(tau, client_id=i, policy="include"))
                members.discard(i)
                include_departed.append(i)
            slotted.discard(i)
            if rng.random() < 0.25:              # duplicate delivery:
                push(Departure(tau, client_id=i,  # second is a no-op
                               policy="include"))
        elif kind == "rejoin" and include_departed:
            i = include_departed.pop(int(rng.integers(
                0, len(include_departed))))
            # tau >= the departure's (same boundary is fine: the heap
            # pops the earlier-seq departure first, freeing the slot)
            push(Arrival(max(tau, cursor), client_id=i))
            members.add(i)
            slotted.add(i)
        elif kind == "shift" and slotted:
            i = int(rng.choice(sorted(slotted)))
            ev = TraceShift(max(tau, min_tau[i]), client_id=i,
                            trace=TRACES[int(rng.integers(0, len(TRACES)))])
            push(ev)
            if rng.random() < 0.25:              # duplicate delivery:
                push(ev)                         # deterministic replay
        elif kind == "burst" and members:
            ids = tuple(sorted(rng.choice(
                sorted(members),
                size=int(rng.integers(1, min(3, len(members)) + 1)),
                replace=False).tolist()))
            push(InactivityBurst(tau, duration=int(rng.integers(1, 4)),
                                 client_ids=ids))
        elif kind == "kill" and kills < max_kills and ops:
            ops.append(("kill",))
            kills += 1
    # tail run: pass every queued tau so all events actually apply
    tail = max(4, max_tau + 1 - cursor)
    ops.append(("run", int(tail)))
    cursor += tail
    return FuzzCase(seed=seed, ops=ops, total_rounds=cursor)


# -- harness -------------------------------------------------------------------

# the round's kernels (client-parallel f32, int8 wire, local steps); the
# sharded forms launch the same libraries
ROUND_KERNELS = ("weighted_agg", "weighted_agg_quant", "masked_sgd")


def _load_round_kernels() -> None:
    """Load every kernel library a round can launch.  The libraries are
    process-wide (``kernels.build._libs``), so a harness loads all of them
    before its baseline: then no backend's warm-up adds one under another
    harness's baseline, and a library loaded later was loaded by a case."""
    from repro_torch.kernels import masked_sgd, weighted_agg
    signatures = {"weighted_agg": weighted_agg._SIGNATURES,
                  "weighted_agg_quant": weighted_agg.QUANT_SIGNATURES,
                  "masked_sgd": masked_sgd._SIGNATURES}
    for name in ROUND_KERNELS:
        build.load(name, signatures[name])


def _buffer(name: str, t: torch.Tensor) -> tuple:
    return (name, t.data_ptr(), tuple(t.shape), str(t.dtype))


def _fn_signature(engine: RoundEngine) -> dict:
    """The rebuild fingerprint: every device buffer of the engine (slot
    data, n, the s-law table) by address, shape and dtype, the kernel
    libraries loaded in the process, and the engine's
    ``engine_traces_total``.  Any change after warm-up means an event
    reallocated a buffer or built a kernel instead of writing slots in
    place."""
    bufs = [_buffer(f"data.{k}", v) for k, v in sorted(engine.data.items())]
    bufs += [_buffer("n", engine.n), _buffer("s_cdf", engine.s_cdf)]
    return {"buffers": bufs, "kernels": sorted(build._libs),
            "traces": engine._m_traces.value}


def _numpy_params(params) -> dict:
    """A host copy of the port's params (numpy, the port's layout)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}


def _params_on(params, device) -> dict:
    """Fresh tensors on ``device`` from numpy arrays or tensors: the engine
    updates a scheduler's params in place, so no two schedulers may share
    them."""
    return {k: (v.detach().to(device).clone() if torch.is_tensor(v)
                else torch.tensor(np.asarray(v), device=device))
            for k, v in params.items()}


class FuzzHarness:
    """Shared fixtures for a fuzz corpus: data pools, one warm pooled
    engine (warmed by a 7-round span in both sampling modes), and the
    rebuild baseline every case is checked against.  The reference's
    arguments plus ``device`` (the CUDA device unless ``"cpu"``);
    ``chunk_size`` is accepted and has no effect (the port has no scan
    chunks).  Initial params are the reference's
    ``init_small(PRNGKey(0), SYNTHETIC_LR)`` (``scenarios.scenario_init``)."""

    def __init__(self, *, capacity: int = 8, n_founding: int = 4,
                 n_arrival_pool: int = 4, local_epochs: int = 3,
                 batch_size: int = 5, chunk_size: int = 4,
                 max_samples: int = 60, scheme: str = "C",
                 eta0: float = 1.0, data_seed: int = 0,
                 engine_mode: str = "client_parallel", sharding=None,
                 compression=None, bank: bool = False,
                 prefetch: bool = False, device=None):
        from repro_torch.configs.paper import SYNTHETIC_LR
        from repro_torch.data import synthetic_federation
        from repro_torch.fed.driver import Client
        from repro_torch.fed.scenarios import scenario_init
        from repro_torch.models.small import make_loss_fn

        self.device = resolve_device(device)
        self.capacity = capacity
        self.n_founding = n_founding
        self.n_arrival_pool = n_arrival_pool
        self.E = local_epochs
        self.scheme = scheme
        self.eta0 = eta0
        self.engine_mode = engine_mode
        self.bank = bank
        self.prefetch = prefetch
        cfg = SYNTHETIC_LR
        train, test = synthetic_federation(
            0.5, 0.5, n_founding + n_arrival_pool, seed=data_seed)
        clients = [Client(x=tr[0][:max_samples], y=tr[1][:max_samples],
                          trace=TRACES[j % len(TRACES)],
                          x_test=te[0], y_test=te[1])
                   for j, (tr, te) in enumerate(zip(train, test))]
        self.founding = clients[:n_founding]
        self.arrival_pool = clients[n_founding:]
        self.init_params = scenario_init(0, self.device)
        self.loss_fn = make_loss_fn(cfg)
        self.engine = RoundEngine(
            loss_fn=self.loss_fn, clients=list(self.founding),
            local_epochs=local_epochs, batch_size=batch_size,
            scheme=scheme, eta0=eta0, capacity=capacity,
            max_samples=max_samples, mode=engine_mode, sharding=sharding,
            compression=compression, device=self.device,
            model_kind=cfg.kind)
        if self.device.type == "cuda":
            _load_round_kernels()
        # warm-up: the reference's 7-round span in both modes (there it
        # compiles every chunk length; here it runs every path once)
        for mode in ("device", "plan"):
            sch = self.new_scheduler(mode)
            sch.run(7, eval_every=1 << 30)
            sch.close()
        self.fn_baseline = _fn_signature(self.engine)

    def _clone(self, client):
        from repro_torch.fed.events import client_from_dict, client_to_dict
        return client_from_dict(client_to_dict(client))

    def new_scheduler(self, mode: str, *, state: Optional[FedState] = None,
                      params=None, case_seed: int = 0,
                      injector=None) -> StreamScheduler:
        """A scheduler over the pooled warm engine: evict every slot,
        re-stage the case's (or restored state's) occupancy.  Clients are
        cloned per scheduler (runs of one case must stay independent), and
        params are copied onto the engine's device (the engine updates
        them in place)."""
        eng = self.engine
        for slot in range(eng.capacity):
            eng.evict(slot)
        if state is None:
            founders = [self._clone(c) for c in self.founding]
            eng.admit_many(list(enumerate(founders)))
            return StreamScheduler(
                clients=founders,
                init_params=_params_on(self.init_params, eng.device),
                engine=eng, mode=mode, seed=case_seed, log_spans=True,
                injector=injector, bank=self.bank, prefetch=self.prefetch)
        eng.admit_many(sorted(
            ((slot, state.clients[i])
             for i, slot in state.slot_of.items()),
            key=lambda sc: sc[0]))
        return StreamScheduler(
            init_params=_params_on(params, eng.device), engine=eng,
            state=state, mode=mode, log_spans=True, injector=injector,
            bank=self.bank, prefetch=self.prefetch)

    def materialize(self, case: FuzzCase) -> List[Tuple]:
        """Codec dicts -> fresh event objects; negative Arrival ids are
        resolved to cloned payloads from the arrival pool."""
        out = []
        for op in case.ops:
            if op[0] != "push":
                out.append(op)
                continue
            d = op[1]
            if d["kind"] == "arrival" and d.get("client_id") is not None \
                    and d["client_id"] < 0:
                payload = self._clone(
                    self.arrival_pool[-d["client_id"] - 1])
                out.append(("push", Arrival(int(d["tau"]),
                                            client=payload)))
            else:
                out.append(("push", event_from_dict(d)))
        return out


# -- execution -----------------------------------------------------------------

def _execute(harness: FuzzHarness, case: FuzzCase, *, mode: str,
             honor_kills: bool) -> dict:
    """Run one materialized op program.  ``honor_kills=True`` serializes
    the full control plane at every ("kill",) op (the in-memory twin of
    the on-disk checkpoint) and resumes into a freshly re-staged
    scheduler; ``False`` ignores kills (the uninterrupted reference)."""
    sch = harness.new_scheduler(mode, case_seed=case.seed)
    span_log = list(sch.span_log or [])
    n_resumes = 0
    try:
        for op in harness.materialize(case):
            if op[0] == "push":
                sch.push(op[1])
            elif op[0] == "run":
                sch.run(op[1], eval_every=1 << 30)
            elif op[0] == "kill" and honor_kills:
                span_log.extend(sch.span_log)
                blob = copy.deepcopy(sch.state.to_dict())
                params = _numpy_params(sch.params)
                history = list(sch.history)
                sch.close()
                sch = harness.new_scheduler(
                    mode, state=FedState.from_dict(blob), params=params)
                sch.history.extend(history)
                n_resumes += 1
    finally:
        sch.close()
    span_log.extend(sch.span_log)
    return {"history": sch.history,
            "params": _numpy_params(sch.params),
            "span_log": span_log,
            "state": sch.state,
            "n_resumes": n_resumes}


# -- invariants ----------------------------------------------------------------

def _same_record(r1, r2) -> bool:
    return (r1.tau == r2.tau and r1.event == r2.event and r1.eta == r2.eta
            and r1.n_active == r2.n_active
            and np.array_equal(np.asarray(r1.s), np.asarray(r2.s)))


def _check_exact_resume(seed: int, ref: dict, killed: dict, *,
                        invariant: str = "exact-resume") -> None:
    h1, h2 = ref["history"], killed["history"]
    if len(h1) != len(h2):
        raise InvariantViolation(seed, invariant,
                                 f"history length {len(h2)} != {len(h1)}")
    for r1, r2 in zip(h1, h2):
        if not _same_record(r1, r2):
            raise InvariantViolation(
                seed, invariant,
                f"round {r1.tau}: {r1} != {r2}")
    for k in sorted(ref["params"]):
        a, b = np.asarray(ref["params"][k]), np.asarray(killed["params"][k])
        if not np.array_equal(a, b):
            raise InvariantViolation(
                seed, invariant,
                f"final params differ (max |d|={np.max(np.abs(a - b))})")


def _check_zero_recompile(seed: int, harness: FuzzHarness) -> None:
    sig = _fn_signature(harness.engine)
    if sig != harness.fn_baseline:
        changed = [k for k in sig if sig[k] != harness.fn_baseline[k]]
        raise InvariantViolation(
            seed, "zero-recompile",
            f"the engine rebuilt {changed}: baseline {harness.fn_baseline} "
            f"-> {sig}")


def _check_weight_sanity(seed: int, harness: FuzzHarness,
                         result: dict) -> None:
    E, eta0, scheme = harness.E, harness.eta0, harness.scheme
    log = sorted(result["span_log"], key=lambda t: t[0])
    if not log:
        raise InvariantViolation(seed, "weight-sanity", "empty span log")
    j = 0
    for rec in result["history"]:
        while j + 1 < len(log) and log[j + 1][0] <= rec.tau:
            j += 1
        tau0, p, active, lr_shift = log[j]
        # sum(p) <= 1 with the deficit owned by include-departed members
        # (mass in the normalization, no slot); sum(p) == 0 is the
        # everyone-include-departed state, lawful only with nobody active
        # (covered by the active & p <= 0 check below)
        if np.any(p < 0) or p.sum() > 1.0 + 1e-5:
            raise InvariantViolation(
                seed, "weight-sanity",
                f"round {rec.tau}: p={p} (sum={p.sum()})")
        if np.any((active > 0) & (p <= 0)):
            raise InvariantViolation(
                seed, "weight-sanity",
                f"round {rec.tau}: active slot with zero weight "
                f"(p={p}, active={active})")
        s = np.asarray(rec.s)
        if np.any(s < 0) or np.any(s > E):
            raise InvariantViolation(
                seed, "weight-sanity",
                f"round {rec.tau}: s={s} outside [0, {E}]")
        if np.any((s > 0) & (active == 0)):
            raise InvariantViolation(
                seed, "weight-sanity",
                f"round {rec.tau}: inactive slot trained (s={s}, "
                f"active={active})")
        coeffs = scheme_coefficients(scheme, p, s, E).numpy()
        if np.any(~np.isfinite(coeffs)) or np.any(coeffs < 0):
            raise InvariantViolation(
                seed, "weight-sanity",
                f"round {rec.tau}: scheme-{scheme} coefficients "
                f"{coeffs} not finite/non-negative")
        want_eta = eta0 / max(rec.tau + 1 - lr_shift, 1)
        if abs(rec.eta - want_eta) > 1e-6 * max(1.0, want_eta):
            raise InvariantViolation(
                seed, "weight-sanity",
                f"round {rec.tau}: eta={rec.eta} != "
                f"eta0/max(t+1-{lr_shift},1)={want_eta}")


def _same_membership(s1: FedState, s2: FedState) -> bool:
    return (s1.objective == s2.objective and s1.departed == s2.departed
            and s1.slot_of == s2.slot_of)


def _check_plan_parity(seed: int, device: dict, plan: dict) -> None:
    h1, h2 = device["history"], plan["history"]
    if len(h1) != len(h2):
        raise InvariantViolation(seed, "plan-parity",
                                 f"history length {len(h2)} != {len(h1)}")
    for r1, r2 in zip(h1, h2):
        if r1.tau != r2.tau or r1.event != r2.event or r1.eta != r2.eta:
            raise InvariantViolation(
                seed, "plan-parity",
                f"round {r1.tau}: control plane diverged "
                f"({r1.event!r}/{r1.eta} vs {r2.event!r}/{r2.eta})")
    d1, d2 = device["span_log"], plan["span_log"]
    if len(d1) != len(d2):
        raise InvariantViolation(
            seed, "plan-parity",
            f"span-arg recompute count {len(d2)} != {len(d1)}")
    for (t1, p1, a1, l1), (t2, p2, a2, l2) in zip(d1, d2):
        if t1 != t2 or l1 != l2 or not np.array_equal(p1, p2) \
                or not np.array_equal(a1, a2):
            raise InvariantViolation(
                seed, "plan-parity",
                f"span args at tau {t1}/{t2} diverged")
    if not _same_membership(device["state"], plan["state"]):
        raise InvariantViolation(seed, "plan-parity",
                                 "final membership diverged")


# -- backend cross-checking ----------------------------------------------------

# The reference's measured parity tolerance for the quantized-vs-f32
# cross-check: the int8 round-off (~absmax/254 per element per round)
# enters the post-event amplification at the harness's eta0 = 1, so the
# final divergence is set by the dynamics, not the quantizer (the
# reference measured max 4.6e-1 over its 30-seed backend corpus, and set
# the gate at ~2x).  Two quantized backends share one quantization lattice
# and keep the ordinary tolerance.
QUANT_VS_F32_ATOL = 1.0
QUANT_VS_F32_RTOL = 1.0

# Engine kwargs per backend name; "sharded" is special-cased (needs a
# process group).  The quantized legs run the int8 wire format end to end.
_BACKEND_SPECS = {
    "client_parallel": {},
    "client_sequential": {"engine_mode": "client_sequential"},
    "quantized": {"compression": "int8"},
    "quantized_sequential": {"engine_mode": "client_sequential",
                             "compression": "int8"},
    "banked": {"bank": True, "prefetch": True},
}


def make_backend_pool(backends=("client_parallel", "client_sequential"),
                      *, sharding=None, **kw) -> dict:
    """One warm FuzzHarness per execution backend, identical geometry
    and data: "client_parallel" (all clients as one batch, one reduction),
    "client_sequential" (streaming accumulate), "quantized" /
    "quantized_sequential" (the int8 compressed-delta wire format on
    either layout), "banked" (the host-RAM client bank with cohort
    prefetch: must be bit-exact against "client_parallel"), "sharded"
    (the client-axis sharded engine: pass sharding=, a
    ``fed.sharding.FedSharding`` over a process group the caller
    initialised).  ``kw`` goes to every FuzzHarness (``device=`` among
    them)."""
    pool = {}
    for b in backends:
        if b == "sharded":
            if sharding is None:
                raise ValueError('backend "sharded" needs sharding=')
            pool[b] = FuzzHarness(sharding=sharding, **kw)
        elif b in _BACKEND_SPECS:
            pool[b] = FuzzHarness(**_BACKEND_SPECS[b], **kw)
        else:
            pool[b] = FuzzHarness(engine_mode=b, **kw)
    return pool


def _check_backend_parity(seed: int, backend: str, ref: dict,
                          other: dict, *, atol: float = 5e-4,
                          rtol: float = 5e-4) -> float:
    """The same op schedule on two execution backends must walk one
    trajectory: the control plane and the sampled epoch counts are
    *exact* (device sampling folds the round index, so the draw stream
    is invariant to how clients are executed or sharded); params agree
    to numerical tolerance (aggregation order differs)."""
    h1, h2 = ref["history"], other["history"]
    if len(h1) != len(h2):
        raise InvariantViolation(
            seed, "backend-parity",
            f"{backend}: history length {len(h2)} != {len(h1)}")
    for r1, r2 in zip(h1, h2):
        if not _same_record(r1, r2):
            raise InvariantViolation(
                seed, "backend-parity",
                f"{backend}: round {r1.tau}: {r1} != {r2}")
    if not _same_membership(ref["state"], other["state"]):
        raise InvariantViolation(
            seed, "backend-parity",
            f"{backend}: final membership diverged")
    max_err = 0.0
    for k in sorted(ref["params"]):
        a = np.asarray(ref["params"][k], np.float64)
        b = np.asarray(other["params"][k], np.float64)
        max_err = max(max_err, float(np.max(np.abs(a - b))))
        if not np.allclose(a, b, atol=atol, rtol=rtol):
            raise InvariantViolation(
                seed, "backend-parity",
                f"{backend}: final params diverged "
                f"(max |d|={np.max(np.abs(a - b)):.3g}, "
                f"atol={atol}, rtol={rtol})")
    return max_err


def run_cross_backend_case(pool: dict, seed: int, *,
                           reference: str = "client_parallel",
                           mode: str = "device",
                           case: Optional[FuzzCase] = None,
                           atol: float = 5e-4,
                           rtol: float = 5e-4) -> dict:
    """Execute one seeded op schedule on every backend in the pool and
    cross-check parity against the reference backend.  Kills are not
    honored here (resume is a per-backend invariant covered by
    run_fuzz_case); the schedule's event stream is."""
    ref_h = pool[reference]
    if case is None:
        case = generate_case(seed, n_founding=ref_h.n_founding,
                             capacity=ref_h.capacity,
                             n_arrival_pool=ref_h.n_arrival_pool)
    results = {}
    for name, h in pool.items():
        results[name] = _execute(h, case, mode=mode, honor_kills=False)
        _check_zero_recompile(seed, h)
    max_err = 0.0
    ref_wire = pool[reference].engine.compression.name
    for name in pool:
        if name == reference:
            continue
        # backends on the same wire format walk one quantization lattice
        # and keep the exact-law tolerance; a wire-format mismatch (int8
        # leg vs f32 reference) is held to the measured gate instead
        a, r = ((atol, rtol)
                if pool[name].engine.compression.name == ref_wire
                else (max(atol, QUANT_VS_F32_ATOL),
                      max(rtol, QUANT_VS_F32_RTOL)))
        max_err = max(max_err, _check_backend_parity(
            seed, name, results[reference], results[name],
            atol=a, rtol=r))
    return {"seed": seed, "rounds": case.total_rounds,
            "backends": sorted(pool), "max_param_err": max_err,
            "events_applied":
                results[reference]["state"].events_applied}


def run_backend_matrix(seeds, *, pool: Optional[dict] = None,
                       mode: str = "device", **pool_kw) -> dict:
    """Cross-backend parity over a seed corpus."""
    if pool is None:
        pool = make_backend_pool(**pool_kw)
    rows = [run_cross_backend_case(pool, int(s), mode=mode)
            for s in seeds]
    return {"cases": len(rows),
            "backends": sorted(pool),
            "rounds": int(sum(r["rounds"] for r in rows)),
            "max_param_err": max((r["max_param_err"] for r in rows),
                                 default=0.0),
            "per_case": rows}


# -- fuzzed supervised chaos ---------------------------------------------------

def run_chaos_case(harness: FuzzHarness, seed: int, *,
                   span_rounds: int = 4, hang: bool = False,
                   span_timeout: float = 2.0, snapshot_every: int = 1,
                   flood_size: int = 64, plan=None,
                   case: Optional[FuzzCase] = None,
                   timeout: float = 300.0) -> dict:
    """One fuzz case as a *supervised chaos* workload: the generator's
    event schedule is submitted to a real FederationService while a
    seeded FaultPlan (worker crashes, mid-span tears, snapshot
    write-failure and corruption, stale floods; optional hangs) fires
    against the supervision layer, and the recovered run must be
    bit-identical to the fault-free service run.

    Both runs submit every event *before* start() and use the
    merge-stale queue policy: ingest (and journal replay after a
    rollback) then sees each event at the same next_tau, so the policy's
    drop decisions, which annotate history, are identical by
    construction.  Kill ops in the case are ignored: the fault plan owns
    failure injection here."""
    import tempfile

    from repro_torch.fed.faults import Fault, FaultPlan
    from repro_torch.fed.service import FederationService

    if case is None:
        case = generate_case(seed, n_founding=harness.n_founding,
                             capacity=harness.capacity,
                             n_arrival_pool=harness.n_arrival_pool)
    events = [op[1] for op in harness.materialize(case)
              if op[0] == "push"]
    total = case.total_rounds
    spans = -(-total // span_rounds)
    if plan is None:
        plan = FaultPlan.generate(
            seed, spans=spans, saves=max(2, spans), hang=hang,
            flood_size=flood_size, hang_seconds=4 * span_timeout)
        # corrupting ckpt_written#0 poisons the generation-0 *base*
        # snapshot: a crash before the first periodic snapshot then has
        # no restorable candidate (unrecoverable by design: bitrot on the
        # only checkpoint), so retarget the bitrot to snapshot #1
        faults = []
        for f in plan.faults:
            if f.site == "ckpt_written" and f.at == 0:
                if any(g.site == "ckpt_written" and g.at == 1
                       for g in plan.faults):
                    continue
                f = Fault(f.site, 1, f.kind, size=f.size,
                          seconds=f.seconds)
            faults.append(f)
        plan = FaultPlan(faults=faults, seed=seed)

    def service(sch, **kw):
        return FederationService(
            sch, span_rounds=span_rounds, max_rounds=total,
            queue_policy="merge-stale", max_queue=256, **kw)

    # fault-free reference: same service machinery, no injector
    ref_sch = harness.new_scheduler("device", case_seed=seed)
    svc = service(ref_sch)
    svc.submit(*events)
    with svc:
        if not svc.wait_rounds(total, timeout=timeout):
            raise InvariantViolation(
                seed, "chaos-bitexact",
                f"fault-free reference stalled before {total} rounds")
    ref = {"history": ref_sch.history,
           "params": _numpy_params(ref_sch.params)}

    # chaotic run: supervised auto-recovery under the fault plan
    chaos_sch = harness.new_scheduler("device", case_seed=seed,
                                      injector=plan)
    with tempfile.TemporaryDirectory(prefix="fuzz-chaos-") as snapdir:
        live = service(
            chaos_sch, supervise=True, snapshot_dir=snapdir,
            snapshot_every=snapshot_every, keep_snapshots=4,
            backoff0=0.01, span_timeout=span_timeout,
            join_timeout=10.0, injector=plan,
            engine_factory=lambda: harness.engine,
            restore_kwargs=dict(loss_fn=harness.loss_fn))
        live.submit(*events)
        with live:
            if not live.wait_rounds(total, timeout=timeout):
                raise InvariantViolation(
                    seed, "chaos-bitexact",
                    f"supervised run stalled before {total} rounds "
                    f"(recoveries={len(live.recoveries)})")
        final = live.scheduler
        _check_exact_resume(
            seed, ref,
            {"history": final.history,
             "params": _numpy_params(final.params)},
            invariant="chaos-bitexact")
        _check_zero_recompile(seed, harness)
        return {"seed": seed, "rounds": total,
                "events": len(events),
                "recoveries": len(live.recoveries),
                "mttr_s": [r["mttr_s"] for r in live.recoveries],
                "fired": [list(t) for t in plan.fired],
                "events_merged": live.events_merged,
                "snapshot_failures": live.snapshot_failures}


def run_chaos_corpus(seeds, *, harness: Optional[FuzzHarness] = None,
                     device=None, **kw) -> dict:
    """Fuzzed-chaos verification over a seed corpus (a harness built on
    ``device`` when none is given)."""
    if harness is None:
        harness = FuzzHarness(device=device)
    rows = [run_chaos_case(harness, int(s), **kw) for s in seeds]
    mttrs = [m for r in rows for m in r["mttr_s"]]
    return {"cases": len(rows),
            "rounds": int(sum(r["rounds"] for r in rows)),
            "recoveries": int(sum(r["recoveries"] for r in rows)),
            "events": int(sum(r["events"] for r in rows)),
            "events_merged": int(sum(r["events_merged"]
                                     for r in rows)),
            "mttr_mean_s": float(np.mean(mttrs)) if mttrs else 0.0,
            "mttr_max_s": float(np.max(mttrs)) if mttrs else 0.0,
            "per_case": rows}


# -- corpus entry points -------------------------------------------------------

def run_fuzz_case(harness: FuzzHarness, seed: int, *,
                  check_plan_parity: bool = True,
                  case: Optional[FuzzCase] = None) -> dict:
    """Generate (or replay) one case and assert every invariant.  Returns
    case statistics for corpus reporting."""
    if case is None:
        case = generate_case(seed, n_founding=harness.n_founding,
                             capacity=harness.capacity,
                             n_arrival_pool=harness.n_arrival_pool)
    ref = _execute(harness, case, mode="device", honor_kills=False)
    _check_zero_recompile(seed, harness)
    _check_weight_sanity(seed, harness, ref)
    killed = _execute(harness, case, mode="device", honor_kills=True)
    _check_zero_recompile(seed, harness)
    _check_exact_resume(seed, ref, killed)
    stats = {"seed": seed, "ops": len(case.ops),
             "rounds": case.total_rounds, "kills": case.n_kills,
             "resumes": killed["n_resumes"],
             "events_applied": ref["state"].events_applied,
             "plan_parity": False}
    if check_plan_parity:
        plan = _execute(harness, case, mode="plan", honor_kills=True)
        _check_zero_recompile(seed, harness)
        _check_weight_sanity(seed, harness, plan)
        # compare against the *killed* device run: both resume at the
        # same boundaries, so their span-arg recompute logs line up
        _check_plan_parity(seed, killed, plan)
        stats["plan_parity"] = True
    return stats


def run_corpus(seeds, *, harness: Optional[FuzzHarness] = None,
               check_plan_parity: bool = True, device=None) -> dict:
    """Run a seed corpus (on a harness built on ``device`` when none is
    given); returns aggregate statistics and the per-case rows."""
    if harness is None:
        harness = FuzzHarness(device=device)
    rows = [run_fuzz_case(harness, int(s),
                          check_plan_parity=check_plan_parity)
            for s in seeds]
    return {"cases": len(rows),
            "rounds": int(sum(r["rounds"] for r in rows)),
            "kills": int(sum(r["kills"] for r in rows)),
            "resumes": int(sum(r["resumes"] for r in rows)),
            "events_applied": int(sum(r["events_applied"]
                                      for r in rows)),
            "seeds": [r["seed"] for r in rows],
            "per_case": rows}
