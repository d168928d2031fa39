"""Host-level federated round driver.

Counterpart of ``repro/fed/driver.py``: the paper's protocol around the
round step — per-round participation from device traces (alpha masks),
Scheme A/B/C coefficients, arrivals with objective shift and fast reboot
(coefficient boost + LR restart, §4.2), departures with the include /
exclude decision (§4.3).  Membership is handled by masking (alpha = 0,
coefficient 0).  Three modes:

  engine="plan"   (default) participation and batch indices are sampled
                  with the host numpy RNG in the seed order; every round
                  runs on the device-resident RoundEngine, driven by the
                  StreamScheduler; spans break at events and eval rounds.
  engine="device" the same engine and scheduler, with participation and
                  batch indices drawn on the device from the key
                  ``prng_key(seed)`` (the reference's fast path; the
                  draws are jax's threefry draws, bit for bit).
  engine="host"   the seed per-round host loop (the reference path of the
                  parity tests).

The reference's ``chunk_size`` has no counterpart: the port runs a span's
rounds one after another, with no scan to cut into chunks.
``mode="client_sequential"`` makes the engine train the clients one at a
time into a streaming accumulator (memory-bounded); the host loop stays
client-parallel, as the reference's does.  ``sharding=``
(``fed.sharding.FedSharding``) shards the engine's client axis over a
``torch.distributed`` group; the host loop stays unsharded, as the
reference's does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import scheme_coefficients
from repro_torch.core.arrivals import RebootState, staircase_lr
from repro_torch.core.compression import resolve_compression
from repro_torch.core.departures import BoundTerms, should_exclude
from repro_torch.core.fed_step import fed_round_parallel
from repro_torch.core.participation import Trace
from repro_torch.core.prng import prng_key
from repro_torch.device import resolve_device
from repro_torch.fed.engine import RoundEngine


@dataclass
class Client:
    """One federated device: per-sample arrays + availability trace."""
    x: np.ndarray
    y: Optional[np.ndarray] = None
    trace: Trace = None
    x_test: Optional[np.ndarray] = None
    y_test: Optional[np.ndarray] = None
    # membership
    active_from: int = 0          # round the device joins (0 = founding)
    departs_at: Optional[int] = None
    departure_policy: str = "exclude"   # exclude | include | auto
    gamma_l: float = 1.0          # non-IID estimate used by policy "auto"

    @property
    def n(self) -> int:
        return len(self.y) if self.y is not None else len(self.x)


@dataclass
class RoundRecord:
    tau: int
    loss: float     # NaN on rounds where no eval ran
    acc: float      # NaN on rounds where no eval ran
    eta: float
    n_active: int
    s: np.ndarray
    event: str = ""


class FederatedTrainer:
    """Runs the paper's federated rounds over ``clients``.

    loss_fn(params, batch) -> (C,) per-client losses with a leading client
    axis (``models.small.make_loss_fn``); eval_fn(params, x, y) -> (loss,
    acc) for one model.  ``init_params`` is copied to ``device`` (the CUDA
    device unless ``device="cpu"``); the trainer's own copy is updated in
    place round by round.  ``compression`` (None, a string such as
    ``"int8"``, or a ``CompressionSpec``) is the wire format of the client
    deltas (``core/compression.py``); ``model_kind`` (the model's
    ``PaperModelConfig.kind``) fixes a quantized wire's element order, the
    reference's for the CNN too (``core.aggregation.flatten_for_wire``).
    ``sharding`` (``fed.sharding.make_fed_sharding()``) gives the
    engine's client slots to the ranks of a process group; every rank
    runs the trainer and holds the same replicated params and history.
    ``mode`` (``"client_parallel"`` or ``"client_sequential"``) is the
    engine's round (``fed.engine.RoundEngine``); ``with_metrics`` makes it
    compute each round's delta norm, which ``delta_norms`` lists.

    The reference's quickstart on the CPU (on the card, drop ``device``)::

        FederatedTrainer(loss_fn=make_loss_fn(SYNTHETIC_LR), eval_fn=...,
                         init_params=init_small(SYNTHETIC_LR, device="cpu"),
                         clients=clients, local_epochs=5, batch_size=20,
                         eta0=1.0, engine="device", device="cpu").run(50)
    """

    def __init__(self, *, loss_fn: Callable,
                 eval_fn: Optional[Callable] = None,
                 init_params, clients: List[Client], local_epochs: int = 5,
                 batch_size: int = 10, scheme: str = "C", eta0: float = 0.01,
                 reboot_boost: float = 3.0, fast_reboot: bool = True,
                 horizon: Optional[int] = None,
                 bound_terms: Optional[BoundTerms] = None,
                 seed: int = 0, engine: str = "plan", agg: str = "auto",
                 compression=None, device=None,
                 model_kind: Optional[str] = None, sharding=None,
                 mode: str = "client_parallel", with_metrics: bool = False):
        if engine not in ("plan", "device", "host"):
            raise ValueError(f"engine must be plan|device|host, got "
                             f"{engine!r}")
        if engine == "host" and sharding is not None:
            raise ValueError("the host engine is not sharded: pass "
                             "sharding= with engine='plan' or 'device'")
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.params = {name: p.to(self.device, copy=True)
                       for name, p in init_params.items()}
        self.clients = clients
        self.E = local_epochs
        self.B = batch_size
        self.scheme = scheme
        self.eta0 = eta0
        self.reboot_boost = reboot_boost
        self.fast_reboot = fast_reboot
        self.horizon = horizon
        self.bound_terms = bound_terms or BoundTerms(
            D=5.0, V=20.0, gamma=10.0, E=local_epochs)
        self.rng = np.random.default_rng(seed)
        self._key = prng_key(seed)
        self.compression = resolve_compression(compression)
        self.model_kind = model_kind
        self.engine_mode = engine
        self.agg = agg
        self.sharding = sharding
        self.mode = mode
        self.with_metrics = with_metrics
        self._scheduler = None
        # membership bookkeeping
        self.objective: set = {i for i, c in enumerate(clients)
                               if c.active_from == 0}
        self.reboots: List[RebootState] = []
        self.lr_shift_tau = 0
        self.history: List[RoundRecord] = []
        self._next_tau = 0

    # -- weights over the current objective set -----------------------------
    def data_weights(self) -> np.ndarray:
        p = np.zeros(len(self.clients))
        total = sum(self.clients[i].n for i in self.objective)
        for i in self.objective:
            p[i] = self.clients[i].n / total
        return p

    def _participating(self, i: int, tau: int) -> bool:
        cl = self.clients[i]
        return (i in self.objective and tau >= cl.active_from
                and (cl.departs_at is None or tau < cl.departs_at))

    def _sample_round(self, tau: int):
        """One round of host-RNG sampling in the seed draw order: alpha
        (C, E) and the gathered batches {"x": (C, E, B, ...), "y"}."""
        C = len(self.clients)
        alpha = np.zeros((C, self.E), np.float32)
        bx = np.zeros((C, self.E, self.B, *self.clients[0].x.shape[1:]),
                      np.float32)
        by = np.zeros((C, self.E, self.B), np.int32)
        for i, cl in enumerate(self.clients):
            if not self._participating(i, tau):
                continue
            alpha[i] = (np.arange(self.E)
                        < cl.trace.sample_s(self.rng, self.E)
                        ).astype(np.float32)
            idx = self.rng.integers(0, cl.n, size=(self.E, self.B))
            bx[i] = cl.x[idx]
            by[i] = cl.y[idx]
        return alpha, {"x": bx, "y": by}

    # -- events --------------------------------------------------------------
    def _handle_events(self, tau: int) -> str:
        ev = ""
        for i, cl in enumerate(self.clients):
            if cl.active_from == tau and i not in self.objective:
                # arrival: mandatory objective shift (+ optional fast-reboot)
                self.objective.add(i)
                self.lr_shift_tau = tau
                if self.fast_reboot:
                    self.reboots.append(RebootState(tau, i,
                                                    self.reboot_boost))
                ev += f"arrival:{i};"
            if cl.departs_at == tau and i in self.objective:
                policy = cl.departure_policy
                if policy == "auto":
                    # Corollary 4.0.3: exclude iff enough training remains
                    T = self.horizon if self.horizon is not None \
                        else tau + 100
                    policy = "exclude" if should_exclude(
                        T, tau, self.bound_terms, cl.gamma_l) else "include"
                if policy == "exclude":
                    self.objective.discard(i)
                    self.lr_shift_tau = tau
                    ev += f"departure-exclude:{i};"
                else:
                    ev += f"departure-include:{i};"
        return ev

    # -- main loop ------------------------------------------------------------
    def run(self, n_rounds: int, eval_every: int = 1):
        if self.engine_mode == "host":
            return self._run_host(n_rounds, eval_every)
        return self._run_engine(n_rounds, eval_every)

    def _run_host(self, n_rounds: int, eval_every: int = 1):
        """The seed per-round host loop (reference path)."""
        dev = self.device
        start = self._next_tau
        for tau in range(start, start + n_rounds):
            ev = self._handle_events(tau)
            p = self.data_weights()
            alpha, batches = self._sample_round(tau)
            s = alpha.sum(axis=1)
            coeffs = scheme_coefficients(self.scheme, p, s, self.E).numpy()
            for rb in self.reboots:
                coeffs[rb.client_idx] *= rb.coeff_multiplier(tau)
            eta = staircase_lr(self.eta0, tau + 1, self.lr_shift_tau)
            self.params, _ = fed_round_parallel(
                self.loss_fn, self.params,
                {k: torch.from_numpy(v).to(dev) for k, v in batches.items()},
                torch.from_numpy(alpha).to(dev),
                torch.from_numpy(coeffs).to(dev),
                torch.tensor(eta, dtype=torch.float32, device=dev),
                compression=self.compression, model_kind=self.model_kind)
            loss = acc = float("nan")
            if tau % eval_every == 0 or ev:
                loss, acc = self.evaluate()
            self.history.append(RoundRecord(tau, float(loss), float(acc),
                                            eta, int((s > 0).sum()), s, ev))
        self._next_tau = start + n_rounds
        return self.history

    @property
    def delta_norms(self) -> List[float]:
        """Each engine round's delta norm, with ``with_metrics``."""
        return [] if self._scheduler is None else \
            self._scheduler.delta_norms

    def _stream_scheduler(self):
        """The plan and device engines run through the StreamScheduler:
        the clients' active_from/departs_at schedule becomes an event
        stream once, and the scheduler owns span splitting,
        weights/reboot/LR recomputation and history.  It shares this
        trainer's clients, RNG, key, history, objective and reboots."""
        if self._scheduler is None:
            from repro_torch.fed.events import Arrival, Departure
            from repro_torch.fed.stream import StreamScheduler
            events = []
            for i, cl in enumerate(self.clients):
                if cl.active_from > 0:
                    events.append(Arrival(cl.active_from, client_id=i))
                if cl.departs_at is not None:
                    events.append(Departure(cl.departs_at, client_id=i))

            def eval_cb(params):
                self.params = params
                return self.evaluate()

            engine = RoundEngine(
                loss_fn=self.loss_fn, clients=self.clients,
                local_epochs=self.E, batch_size=self.B, scheme=self.scheme,
                eta0=self.eta0, agg=self.agg, device=self.device,
                compression=self.compression, model_kind=self.model_kind,
                sharding=self.sharding, mode=self.mode,
                with_metrics=self.with_metrics)
            self._scheduler = StreamScheduler(
                clients=self.clients, init_params=self.params, engine=engine,
                mode=self.engine_mode, key=self._key,
                reboot_boost=self.reboot_boost, fast_reboot=self.fast_reboot,
                horizon=self.horizon, bound_terms=self.bound_terms,
                rng=self.rng, evaluate=eval_cb, history=self.history,
                reboots=self.reboots, objective=self.objective,
                events=events)
        return self._scheduler

    def _run_engine(self, n_rounds: int, eval_every: int = 1):
        sch = self._stream_scheduler()
        sch.params = self.params
        sch.run(n_rounds, eval_every)
        self.params = sch.params
        self.lr_shift_tau = sch.lr_shift_tau
        self._next_tau = sch.state.next_tau
        return self.history

    def evaluate(self):
        """eval_fn over the held-out arrays of the objective's clients;
        NaN when there is no eval_fn or no held-out data."""
        xs = [self.clients[i].x_test for i in self.objective
              if self.clients[i].x_test is not None]
        ys = [self.clients[i].y_test for i in self.objective
              if self.clients[i].y_test is not None]
        if self.eval_fn is None or not xs:
            return float("nan"), float("nan")
        return self.eval_fn(
            self.params, torch.from_numpy(np.concatenate(xs)).to(self.device),
            torch.from_numpy(np.concatenate(ys)).to(self.device))
