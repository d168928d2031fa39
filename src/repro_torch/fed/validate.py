"""Theory-scored validation: run fuzzed schedules, score against Thm 3.1.

Counterpart of ``repro/fed/validate.py``, with its names, defaults and
invariant names.  The fuzzer (fed/fuzz.py) checks *control-plane*
invariants (resume, rebuilds, weight sanity) but never the paper's actual
claim: that the iterate gap ||w_tau - w*||^2 stays under the Theorem 3.1
envelope, and that the scheme-C debiasing beats schemes A/B under
heterogeneous device participation.  This module is the validate half of
a run/validate split:

  run       QuadraticRunner executes real engine rounds (device-mode
            sampling, the engine's scheme coefficients, the production
            path) on a synthetic quadratic federation where every paper
            constant is *closed form*: each client k holds identical
            one-hot samples, so the batch loss is exactly
            F_k(w) = 0.5 (w - c_k)^T A_k (w - c_k) with sigma_k = 0,
            and w*, L, mu, Gamma_k come from
            core.theory.quadratic_problem_constants.

  validate  TheoryValidator replays the run's dump (the observed
            per-round participation matrix (p, s), not a forecast)
            through core.theory.observed_participation_stats +
            theorem31_terms + convergence_bound, and asserts
            (1) the measured gap stays under slack * bound at every
            evaluated round (the bound is loose by construction, gamma
            ~ 1e3 for these configs, so this is a divergence tripwire,
            catching sign/scale breakage in the aggregation weights), and
            (2) the paper's Table-1 ordering: scheme C's tail error is
            decisively below A's and B's, which *does* discriminate:
            mis-weighting C (e.g. dropping the E/s debias) collapses it
            onto B's bias plateau and trips the check.

Fuzzed schedules come from generate_participation_schedule:
objective-preserving event streams (TraceShift within the slow-trace
pool, InactivityBurst) so w* is pinned while the participation law
churns mid-run.  Runners execute on the CUDA device unless
``device="cpu"`` is passed.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.aggregation import theta_bound
from repro_torch.core.participation import TRACES
from repro_torch.core.theory import (ProblemConstants, convergence_bound,
                                     observed_participation_stats,
                                     quadratic_problem_constants,
                                     theorem31_terms)
from repro_torch.device import resolve_device
from repro_torch.fed.engine import RoundEngine
from repro_torch.fed.events import InactivityBurst, TraceShift
from repro_torch.fed.fuzz import InvariantViolation
from repro_torch.fed.stream import StreamScheduler
from repro_torch.fed.task import ArrayTask

__all__ = ["QuadraticProblem", "make_quadratic_problem", "RunDump",
           "QuadraticRunner", "TheoryValidator",
           "generate_participation_schedule", "validate_corpus"]


# -- the closed-form problem ---------------------------------------------------

# heterogeneous availability: one always-on device, two CPU-contended
# ones, one with 30% inactivity: strong enough scheme-A/B bias that the
# Table-1 ordering is decisive, yet every trace keeps training moving
DEFAULT_TRACE_NAMES = ("cpu_0", "cpu_70", "cpu_90", "bw_low")
_TRACE_BY_NAME = {t.name: t for t in TRACES}

# TraceShift pool for fuzzed schedules: slow/flaky traces only, so the
# participation *law* churns while the A/B-vs-C bias gap (and with it the
# ordering check's discrimination) survives every shift
SHIFT_POOL = ("cpu_50", "cpu_70", "cpu_90", "bw_low", "bw_med")


@dataclass(frozen=True)
class QuadraticProblem:
    """A federation of diagonal quadratics with every Assumption 3.1-3.4
    constant exact (G2 is a trajectory estimate, see
    make_quadratic_problem)."""
    a_diag: np.ndarray      # (N, D) diagonal of A_k
    c: np.ndarray           # (N, D) per-client optimum c_k
    n_k: np.ndarray         # (N,) samples per client -> data weights
    p: np.ndarray           # (N,) normalized data weights
    pc: ProblemConstants
    w_star: np.ndarray      # (D,) global optimum of sum_k p_k F_k
    G2: float               # plug-in stochastic-gradient bound
    traces: tuple = ()      # per-client Trace assignment

    @property
    def n_clients(self) -> int:
        return len(self.n_k)

    @property
    def dim(self) -> int:
        return self.a_diag.shape[1]


def make_quadratic_problem(n_clients: int = 4, dim: int = 6, *,
                           seed: int = 0,
                           trace_names: Sequence[str] = DEFAULT_TRACE_NAMES
                           ) -> QuadraticProblem:
    """Sample a well-conditioned heterogeneous quadratic federation, array
    for array the reference's.

    Client k's dataset is n_k copies of the one-hot row e_k, so a batch
    loss of 0.5 mean_b sum_d (x_b @ A)(w - x_b @ c)^2 is *exactly*
    F_k(w): zero gradient variance (sigma_k = 0) and closed-form
    constants."""
    rng = np.random.default_rng(seed)
    a_diag = rng.uniform(0.5, 2.0, size=(n_clients, dim))
    c = rng.uniform(-1.0, 1.0, size=(n_clients, dim))
    n_k = rng.integers(6, 13, size=n_clients)
    p = n_k / n_k.sum()
    pc, w_star = quadratic_problem_constants(
        [np.diag(a) for a in a_diag], list(c), p)
    # G2: sup ||grad F_k|| over the trajectory's hull: iterates live
    # between w0 = 0 and w*, so bound at both endpoints with headroom
    g_at = lambda w: float(np.max(np.sum(                      # noqa: E731
        (a_diag * (w[None, :] - c)) ** 2, axis=1)))
    G2 = 4.0 * max(g_at(np.zeros(dim)), g_at(w_star)) + 1.0
    traces = tuple(_TRACE_BY_NAME[trace_names[k % len(trace_names)]]
                   for k in range(n_clients))
    return QuadraticProblem(a_diag=a_diag, c=c, n_k=n_k, p=p, pc=pc,
                            w_star=w_star, G2=G2, traces=traces)


# -- fuzzed participation schedules -------------------------------------------

def generate_participation_schedule(seed: int, *, n_clients: int,
                                    rounds: int,
                                    max_events: int = 6) -> List:
    """A seeded objective-preserving event stream: TraceShifts (drawn
    from SHIFT_POOL, never touching the always-on client 0) and short
    InactivityBursts.  No arrivals/departures: membership and hence w*
    stay fixed, so the same Theorem 3.1 envelope scores the whole run
    while the participation law churns mid-stream."""
    rng = np.random.default_rng(seed)
    events = []
    for _ in range(int(rng.integers(2, max_events + 1))):
        tau = int(rng.integers(1, max(2, rounds - 4)))
        if rng.random() < 0.6:
            i = int(rng.integers(1, n_clients))
            name = SHIFT_POOL[int(rng.integers(0, len(SHIFT_POOL)))]
            events.append(TraceShift(tau, client_id=i,
                                     trace=_TRACE_BY_NAME[name]))
        else:
            size = int(rng.integers(1, max(2, n_clients - 1)))
            ids = tuple(sorted(rng.choice(
                np.arange(1, n_clients), size=size,
                replace=False).tolist()))
            events.append(InactivityBurst(
                tau, duration=int(rng.integers(1, 4)), client_ids=ids))
    return events


# -- runner --------------------------------------------------------------------

@dataclass
class RunDump:
    """Everything the validator needs from one executed run: the error
    trajectory and the *observed* participation matrix."""
    scheme: str
    E: int
    seed: int
    taus: np.ndarray        # (R,) round indices
    errs: np.ndarray        # (R,) ||w_tau+1 - w*||^2 after each round
    s: np.ndarray           # (R, N) realized completed epochs
    p: np.ndarray           # (R, N) forward-filled span data weights
    n_events: int = 0


class QuadraticRunner:
    """Executes quadratic federations through the real engine and stream
    scheduler (device-mode sampling, the engine's scheme coefficients),
    one pooled warm engine per scheme: the run half of the validator.
    The reference's arguments plus ``device`` (the CUDA device unless
    ``"cpu"``); ``chunk_size`` is accepted and has no effect (the port has
    no scan chunks)."""

    def __init__(self, problem: Optional[QuadraticProblem] = None, *,
                 local_epochs: int = 4, batch_size: int = 4,
                 eta0: float = 0.4, chunk_size: int = 8,
                 compression=None, device=None):
        self.problem = problem if problem is not None \
            else make_quadratic_problem()
        self.E = local_epochs
        self.B = batch_size
        self.eta0 = eta0
        self.chunk_size = chunk_size
        self.device = resolve_device(device)
        # delta wire format for every run this runner executes: quantized
        # runs are scored against the same Thm 3.1 envelope (a sane
        # quantizer perturbs the trajectory below the bound's slack, while
        # an over-coarse one such as "int8:levels=1,chunk=4096" destroys
        # the debiased update and trips the validator)
        from repro_torch.core.compression import resolve_compression
        self.compression = resolve_compression(compression)
        pr = self.problem
        a_mat = torch.tensor(pr.a_diag, dtype=torch.float32,
                             device=self.device)
        c_mat = torch.tensor(pr.c, dtype=torch.float32, device=self.device)

        def loss_fn(params, batch):
            # (C,) per-client losses, a leading client axis on params and
            # batch: x (C, B, N) one-hot, w (C, D)
            x = batch["x"].to(torch.float32)
            a = x @ a_mat               # (C, B, D): this batch's A_k
            cc = x @ c_mat              # (C, B, D): this batch's c_k
            w = params["w"][:, None, :]
            return 0.5 * (a * (w - cc) ** 2).sum(-1).mean(-1)

        self.task = ArrayTask(loss_fn, (pr.n_clients,))
        self.init_params = {"w": torch.zeros(pr.dim, dtype=torch.float32,
                                             device=self.device)}
        self._w_star = torch.tensor(pr.w_star, dtype=torch.float32,
                                    device=self.device)
        self._engines: Dict[str, RoundEngine] = {}

    def _clients(self):
        from repro_torch.fed.driver import Client
        pr = self.problem
        out = []
        for k in range(pr.n_clients):
            x = np.zeros((int(pr.n_k[k]), pr.n_clients), np.float32)
            x[:, k] = 1.0
            out.append(Client(x=x, y=np.zeros(int(pr.n_k[k]), np.int32),
                              trace=pr.traces[k]))
        return out

    def _engine(self, scheme: str) -> RoundEngine:
        # one engine per scheme, as the reference's (the scheme is a
        # property of the engine); every run of one scheme reuses it
        if scheme not in self._engines:
            pr = self.problem
            self._engines[scheme] = RoundEngine(
                task=self.task, clients=self._clients(),
                local_epochs=self.E, batch_size=self.B, scheme=scheme,
                eta0=self.eta0, capacity=pr.n_clients,
                compression=self.compression,
                max_samples=int(pr.n_k.max()), device=self.device)
        return self._engines[scheme]

    def run(self, scheme: str, *, rounds: int = 64, seed: int = 0,
            events: Sequence = ()) -> RunDump:
        """One executed federation: returns the dump the validator
        scores.  Clients are rebuilt per run (TraceShift swaps a client's
        law) and re-staged into the pooled engine."""
        pr = self.problem
        eng = self._engine(scheme)
        for slot in range(eng.capacity):
            eng.evict(slot)
        clients = self._clients()
        eng.admit_many(list(enumerate(clients)))
        w_star = self._w_star

        def gap(params):
            return (float(((params["w"] - w_star) ** 2).sum()),
                    float("nan"))

        sch = StreamScheduler(
            clients=clients,
            init_params={k: v.clone() for k, v in self.init_params.items()},
            engine=eng, mode="device", seed=seed, log_spans=True,
            evaluate=gap)
        events = list(events)
        sch.push(*events)
        sch.run(rounds, eval_every=1)
        hist = sch.history
        taus = np.array([r.tau for r in hist])
        errs = np.array([r.loss for r in hist])
        s = np.stack([np.asarray(r.s, np.float64) for r in hist])
        # forward-fill the span-arg log into a per-round weight matrix
        log = sorted(sch.span_log, key=lambda t: t[0])
        p = np.empty((len(hist), eng.capacity))
        j = 0
        for i, rec in enumerate(hist):
            while j + 1 < len(log) and log[j + 1][0] <= rec.tau:
                j += 1
            p[i] = log[j][1]
        return RunDump(scheme=scheme, E=self.E, seed=seed, taus=taus,
                       errs=errs, s=s, p=p, n_events=len(events))


# -- validator -----------------------------------------------------------------

class TheoryValidator:
    """Scores RunDumps against Theorem 3.1 computed from the *observed*
    participation matrix.

    slack calibrates the bound check: the Thm 3.1 envelope is loose
    (gamma ~ 1e3, V >= gamma^2 on these configs, vs measured gaps of
    order 1), so the default slack 1.0 makes check_bound a divergence
    tripwire: any mis-signed or mis-scaled aggregation that sends the
    iterate away from w* crosses the envelope within a few rounds.
    Discrimination against *subtle* mis-weighting comes from
    check_scheme_ordering (Table 1): scheme C's tail error must beat
    A's and B's bias plateaus by `factor`."""

    def __init__(self, problem: QuadraticProblem, *, slack: float = 1.0):
        self.problem = problem
        self.slack = slack

    def score(self, dump: RunDump) -> dict:
        pr = self.problem
        stats = observed_participation_stats(
            dump.scheme, dump.p, dump.s, dump.E)
        theta = theta_bound(dump.scheme, pr.n_clients, dump.E)
        terms = theorem31_terms(
            replace(pr.pc, G2=pr.G2), pr.p, dump.E, theta,
            np.maximum(stats["E_ps"], 1e-9))
        M = stats["M"]
        bounds = np.array([
            convergence_bound(int(t) + 1, terms, float(M[i]))
            for i, t in enumerate(dump.taus)])
        ok = np.isfinite(dump.errs)
        ratios = dump.errs[ok] / np.maximum(bounds[ok], 1e-12)
        margin = float(ratios.max()) if ratios.size else 0.0
        return {"terms": terms, "bounds": bounds, "margin": margin,
                "S": stats["S"], "biased_frac":
                    float(stats["z"].mean()) if len(stats["z"]) else 0.0}

    @staticmethod
    def _tail_err(dump: RunDump, tail: float) -> float:
        errs = dump.errs[np.isfinite(dump.errs)]
        n = max(1, int(round(len(errs) * tail)))
        return float(np.mean(errs[-n:]))

    def check_bound(self, dump: RunDump) -> dict:
        sc = self.score(dump)
        evaluated = ~np.isnan(dump.errs)     # NaN = no eval that round
        if not np.all(np.isfinite(dump.errs[evaluated])):
            raise InvariantViolation(
                dump.seed, "theory-bound",
                f"scheme {dump.scheme}: iterate gap diverged to "
                f"non-finite")
        if sc["margin"] > self.slack:
            i = int(np.nanargmax(
                dump.errs / np.maximum(sc["bounds"], 1e-12)))
            raise InvariantViolation(
                dump.seed, "theory-bound",
                f"scheme {dump.scheme}: gap {dump.errs[i]:.4g} > "
                f"{self.slack:g} x bound {sc['bounds'][i]:.4g} at "
                f"tau={int(dump.taus[i])} (margin={sc['margin']:.3g})")
        return sc

    def check_scheme_ordering(self, dumps: Dict[str, RunDump], *,
                              factor: float = 0.6,
                              tail: float = 0.25) -> dict:
        """Table 1: scheme C (debiased) must converge decisively below
        the A/B bias plateaus: tail-mean gap_C <= factor * gap_A and
        <= factor * gap_B."""
        tails = {s: self._tail_err(d, tail) for s, d in dumps.items()}
        seed = dumps["C"].seed
        for other in ("A", "B"):
            if other not in dumps:
                continue
            if not tails["C"] <= factor * tails[other]:
                raise InvariantViolation(
                    seed, "scheme-ordering",
                    f"tail gap C={tails['C']:.4g} not <= {factor:g} x "
                    f"{other}={tails[other]:.4g} (paper Table 1 "
                    f"predicts the debiased scheme wins)")
        return tails


def validate_corpus(seeds, *, runner: Optional[QuadraticRunner] = None,
                    rounds: int = 64, slack: float = 1.0,
                    factor: float = 0.6, compression=None,
                    device=None) -> dict:
    """Run + validate a seed corpus: each seed fuzzes a participation
    schedule, executes it under all three schemes, and scores every run
    against the bound plus the cross-scheme ordering.  ``compression``
    selects the delta wire format of the default runner (built on
    ``device``): quantized corpora are held to the same envelope and
    Table-1 ordering as f32."""
    if runner is None:
        runner = QuadraticRunner(compression=compression, device=device)
    validator = TheoryValidator(runner.problem, slack=slack)
    rows = []
    for seed in seeds:
        seed = int(seed)
        events = generate_participation_schedule(
            seed, n_clients=runner.problem.n_clients, rounds=rounds)
        dumps = {s: runner.run(s, rounds=rounds, seed=seed,
                               events=events)
                 for s in ("A", "B", "C")}
        scores = {s: validator.check_bound(d) for s, d in dumps.items()}
        tails = validator.check_scheme_ordering(dumps, factor=factor)
        rows.append({"seed": seed, "n_events": dumps["C"].n_events,
                     "rounds": rounds,
                     "margin_C": scores["C"]["margin"],
                     "biased_frac_C": scores["C"]["biased_frac"],
                     "tails": tails})
    return {"cases": len(rows), "rounds": int(rounds * 3 * len(rows)),
            "max_margin": max((r["margin_C"] for r in rows),
                              default=0.0),
            "per_case": rows}
