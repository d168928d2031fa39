"""Paper-level federation signals derived from FedState + span metrics.

Counterpart of ``repro/obs/fedmetrics.py``, line for line in behaviour.

The paper's argument is about *participation dynamics*: how many devices
are inactive each round, how much aggregate weight mass the scheme
assigns (and how it drifts as devices depart/arrive), each device's
effective participation rate, and how those statistics enter the
Theorem 3.1 convergence bound.  ``FedObserver`` turns the raw per-span
outputs the scheduler already produces — the completed-epoch matrix
``s`` (R, capacity), the learning rates, the event log — into live
gauges/histograms on the shared telemetry registry:

  ``fed_active_clients`` / ``fed_inactive_clients``
      devices with s>0 vs objective members that contributed nothing
      this round (the paper's "inactive" x_k = 0 case).
  ``fed_scheme_weight_mass`` / ``fed_scheme_weight_drift``
      sum of the round's aggregation coefficients p_tau^k under the
      configured scheme (A/B/C re-derived in numpy from p and s — host
      arithmetic, no device round-trip), and its change vs the previous
      round.  Scheme B's mass deficit under inactivity is exactly the
      bias the paper's §3.2 discussion attributes it.
  ``fed_participation_rate{stat=min|mean|max}``
      per-client effective participation (fraction of member rounds
      with s>0), the quantity MIFA-style analyses bound regret by.
  ``fed_event_staleness_rounds``
      histogram of (apply_tau - event.tau) — how late news lands.
  ``fed_bound_D`` / ``fed_bound_V`` / ``fed_bound_gamma`` / ``fed_bound_value``
      live Theorem 3.1 terms, when a tractable problem is attached via
      :meth:`FedObserver.set_problem` — E[p s] is estimated online from
      the observed rounds, so the gauge tracks the *measured*
      participation process rather than an a-priori trace model.

With a null telemetry object every method is a cheap no-op (one
``enabled`` check), so schedulers can construct a FedObserver
unconditionally.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .telemetry import resolve

# staleness is measured in rounds, not seconds
STALENESS_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                     256.0)


def scheme_mass(scheme: str, p: np.ndarray, s: np.ndarray,
                E: int) -> float:
    """Sum of aggregation coefficients p_tau^k for one round — the numpy
    twin of core.aggregation.scheme_coefficients (which runs on the
    engine's device and would cost a round-trip per observed round)."""
    p = np.asarray(p, np.float64)
    s = np.asarray(s, np.float64)
    if scheme == "A":
        complete = (s >= E).astype(np.float64)
        K = complete.sum()
        N = float((p > 0).sum())
        return float((N * p * complete / max(K, 1.0)).sum()) if K > 0 \
            else 0.0
    if scheme == "B":
        return float((p * (s > 0)).sum())
    if scheme == "C":
        return float(np.where(s > 0, E * p / np.maximum(s, 1.0),
                              0.0).sum())
    raise ValueError(f"unknown scheme {scheme}")


def _coeffs(scheme: str, p: np.ndarray, s: np.ndarray,
            E: int) -> np.ndarray:
    """Per-slot aggregation coefficients (numpy)."""
    p = np.asarray(p, np.float64)
    s = np.asarray(s, np.float64)
    if scheme == "A":
        complete = (s >= E).astype(np.float64)
        K = complete.sum()
        N = float((p > 0).sum())
        return (N * p * complete / max(K, 1.0)) if K > 0 \
            else np.zeros_like(p)
    if scheme == "B":
        return p * (s > 0)
    if scheme == "C":
        return np.where(s > 0, E * p / np.maximum(s, 1.0), 0.0)
    raise ValueError(f"unknown scheme {scheme}")


class FedObserver:
    """Per-round paper-signal instrumentation over a shared telemetry."""

    def __init__(self, telemetry=None):
        tel = resolve(telemetry)
        self.tel = tel
        self.enabled = tel.enabled
        self._g_active = tel.gauge(
            "fed_active_clients", "devices with s>0 in the last round")
        self._g_inactive = tel.gauge(
            "fed_inactive_clients",
            "objective members that contributed no epochs last round")
        self._g_objective = tel.gauge(
            "fed_objective_clients", "devices in the current objective")
        self._g_pending = tel.gauge(
            "fed_pending_events", "participation events queued, not yet "
            "applied")
        self._g_mass = tel.gauge(
            "fed_scheme_weight_mass",
            "sum of aggregation coefficients p_tau^k last round")
        self._g_drift = tel.gauge(
            "fed_scheme_weight_drift",
            "change in scheme weight mass vs the previous round")
        self._g_eta = tel.gauge("fed_eta", "learning rate of the last "
                                "round")
        self._g_rate = tel.gauge(
            "fed_participation_rate",
            "per-client effective participation rate (rounds with s>0 / "
            "member rounds)", labelnames=("stat",))
        self._c_rounds = tel.counter(
            "fed_rounds_total", "federated rounds completed")
        self._c_events = tel.counter(
            "sched_events_applied_total",
            "participation events applied, by kind", labelnames=("kind",))
        self._h_stale = tel.histogram(
            "fed_event_staleness_rounds",
            "rounds between an event's tau and the boundary it applied at",
            buckets=STALENESS_BUCKETS)
        self._g_bound = tel.gauge(
            "fed_bound", "live Theorem 3.1 bound terms (tractable configs "
            "only)", labelnames=("term",))
        # running state
        self._prev_mass: Optional[float] = None
        self._part = {}          # client id -> rounds with s>0
        self._member = {}        # client id -> member rounds observed
        # optional tractable problem for live bound evaluation
        self._pc = None
        self._theta = None
        self._m_tau = 1.0
        self._ps_sum = None      # per-client running sum of p_tau^k s^k
        self._ps_rounds = 0

    # -- tractable-config bound evaluation ------------------------------------
    def set_problem(self, pc, theta: float, m_tau: float = 1.0) -> None:
        """Attach Assumption 3.1-3.4 constants (core.theory
        ProblemConstants, e.g. from quadratic_problem_constants) so each
        span also refreshes the fed_bound{term=...} gauges."""
        self._pc = pc
        self._theta = float(theta)
        self._m_tau = float(m_tau)
        self._ps_sum = np.zeros(len(pc.gamma_k))
        self._ps_rounds = 0

    # -- per-event ------------------------------------------------------------
    def observe_event(self, e, tau: int) -> None:
        """Record one applied participation event (at boundary tau)."""
        if not self.enabled:
            return
        self._c_events.labels(type(e).__name__).inc()
        self._h_stale.observe(float(max(0, tau - e.tau)))

    # -- per-span -------------------------------------------------------------
    def observe_span(self, state, tau0: int, m: dict, scheme: str,
                     E: int) -> None:
        """Fold one span's metrics (m["s"]: (R, capacity), m["eta"]: (R,))
        into the gauges.  ``state`` is the scheduler's FedState *after*
        the span's events applied — membership is the span's membership."""
        if not self.enabled:
            return
        s_mat = np.asarray(m["s"], np.float64)
        etas = np.asarray(m["eta"], np.float64)
        R = s_mat.shape[0]
        if R == 0:
            return
        p = state.data_weights()
        n_obj = len(state.objective)
        slot_of = state.slot_of

        mass = None
        for j in range(R):
            s_row = s_mat[j]
            active = int((s_row > 0).sum())
            prev = mass if mass is not None else self._prev_mass
            mass = scheme_mass(scheme, p, s_row, E)
            if prev is not None:
                self._g_drift.set(mass - prev)
            self._g_active.set(active)
            self._g_inactive.set(max(0, n_obj - active))
            # per-client effective participation over observed rounds
            for i in state.objective:
                slot = slot_of.get(i)
                if slot is None:
                    continue
                self._member[i] = self._member.get(i, 0) + 1
                if s_row[slot] > 0:
                    self._part[i] = self._part.get(i, 0) + 1
            if self._pc is not None:
                self._accumulate_bound_round(state, p, s_row, scheme, E)
        self._prev_mass = mass
        self._g_mass.set(mass)
        self._g_eta.set(float(etas[-1]))
        self._g_objective.set(n_obj)
        self._g_pending.set(state.pending)
        self._c_rounds.inc(R)

        rates = [self._part.get(i, 0) / n for i, n in self._member.items()
                 if n > 0]
        if rates:
            self._g_rate.labels("min").set(min(rates))
            self._g_rate.labels("mean").set(sum(rates) / len(rates))
            self._g_rate.labels("max").set(max(rates))
        if self._pc is not None:
            self._refresh_bound(state, tau0 + R)

    def _accumulate_bound_round(self, state, p, s_row, scheme: str,
                                E: int) -> None:
        """Update the online E[p_tau^k s^k] estimate (client-indexed)."""
        c = _coeffs(scheme, p, s_row, E)
        for i, slot in state.slot_of.items():
            if i < len(self._ps_sum):
                self._ps_sum[i] += c[slot] * s_row[slot]
        self._ps_rounds += 1

    def _refresh_bound(self, state, tau: int) -> None:
        """Evaluate Theorem 3.1 terms against the measured participation
        process and publish them as gauges."""
        from repro_torch.core.theory import convergence_bound, theorem31_terms
        if self._ps_rounds == 0:
            return
        E_ps = self._ps_sum / self._ps_rounds
        if E_ps.sum() <= 0:
            return                      # all-inactive so far: bound moot
        C = len(E_ps)
        p_slot = state.data_weights()
        p_client = np.zeros(C)
        for i in state.objective:
            slot = state.slot_of.get(i)
            if slot is not None and i < C:
                p_client[i] = p_slot[slot]
        terms = theorem31_terms(self._pc, p_client,
                                state.bound_terms.E, self._theta, E_ps)
        self._g_bound.labels("D").set(terms.D)
        self._g_bound.labels("V").set(terms.V)
        self._g_bound.labels("gamma").set(terms.gamma)
        self._g_bound.labels("value").set(
            convergence_bound(tau, terms, self._m_tau))

    # -- participation snapshot (fed_top reads this) --------------------------
    def participation(self) -> dict:
        """{client id: (participated, member_rounds)} observed so far."""
        return {i: (self._part.get(i, 0), n)
                for i, n in sorted(self._member.items())}
