"""Convergence-bound calculators (Theorem 3.1, Theorem 3.2, Table 1).

Copy of the reference's ``core/theory.py``, in numpy: the paper's bounds
evaluated numerically, so that experiments can hold measured loss against
the predicted envelope, and so the departure rule (core.departures) has
concrete D / V / gamma values.  The participation statistics recompute the
round coefficients with the port's ``scheme_coefficients`` on CPU tensors,
in f32 as the reference's device arrays are.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.aggregation import scheme_coefficients
from repro_torch.core.departures import BoundTerms


@dataclass(frozen=True)
class ProblemConstants:
    """Assumption 3.1-3.4 constants for the learning problem."""

    L: float           # smoothness
    mu: float          # strong convexity
    G2: float          # E||g||^2 bound
    sigma2: np.ndarray  # per-client gradient variance (C,)
    gamma_k: np.ndarray  # per-client non-IID metric Gamma_k (C,)


def theorem31_terms(pc: ProblemConstants, p: np.ndarray, E: int,
                    theta: float, E_ps: np.ndarray) -> BoundTerms:
    """Assemble the Theorem 3.1 bound terms.

    E_ps[k] ~= E[p_tau^k s_tau^k] (estimated, see
    aggregation.expected_coeff_stats); theta from Assumption 3.5.
    """
    S = float(np.sum(E_ps))
    gamma = max(32 * E * (1 + theta) * pc.L / (pc.mu * S),
                4 * E * E * theta / S)
    D = 64 * E * float(np.sum(E_ps * pc.gamma_k)) / (pc.mu * S)
    # B term (expectation, leading order)
    B = (2 * (2 + theta) * pc.L * float(np.sum(E_ps * pc.gamma_k))
         + (2 + pc.mu / (2 * (1 + theta) * pc.L)) * E * (E - 1) * pc.G2 * S
         + 2 * E * pc.G2 * float(np.sum(E_ps))
         + float(np.sum((p ** 2) * pc.sigma2)) * E)
    V = max(gamma ** 2, (16 * E / (pc.mu * S)) ** 2 * B / E)
    return BoundTerms(D=D, V=V, gamma=gamma, E=E)


def convergence_bound(tau: int, terms: BoundTerms, M_tau: float) -> float:
    """Eq. (3): E||w - w*||^2 <= (M_tau D + V) / (tau E + gamma)."""
    return (M_tau * terms.D + terms.V) / (tau * terms.E + terms.gamma)


def observed_participation_stats(scheme: str, p_rounds, s_rounds, E: int,
                                 *, tol: float = 1e-6) -> dict:
    """Plug-in estimates of Theorem 3.1's participation quantities from an
    *executed* run's observed participation matrix, instead of the
    Monte-Carlo forecast (aggregation.expected_coeff_stats).

    p_rounds: (R, C) per-round data weights p^k; s_rounds: (R, C) realized
    completed-epoch counts.  The realized coefficients p_tau^k are
    recomputed per round with ``scheme_coefficients``, giving

      E_ps[k] — empirical mean of p_tau^k s_tau^k over the run;
      z[t]    — Assumption 3.5's per-round bias indicator: 1 where the
                realized coefficient mass sum_k p_tau^k s_tau^k deviates
                from the unbiased E * sum_k p^k;
      M[t]    — the cumulative biased-round count (Eq. (3) at round tau
                takes M[tau - 1]);
      S       — sum_k E_ps[k] (the bound's S).
    """
    p = np.asarray(p_rounds, np.float64)
    s = np.asarray(s_rounds, np.float64)
    if p.shape != s.shape:
        raise ValueError(f"p_rounds {p.shape} vs s_rounds {s.shape}")
    ps = np.empty_like(p)
    for t in range(len(p)):
        c = scheme_coefficients(scheme, p[t], s[t], E).numpy()
        ps[t] = c.astype(np.float64) * s[t]
    E_ps = ps.mean(axis=0) if len(ps) else np.zeros(p.shape[-1])
    z = (np.abs(ps.sum(axis=1) - E * p.sum(axis=1))
         > tol * max(float(E), 1.0)).astype(np.float64)
    return {"E_ps": E_ps, "z": z, "M": np.cumsum(z),
            "S": float(E_ps.sum())}


def objective_shift_offset(L: float, mu: float, n_l: float, n: float,
                           gamma_l: float, arrival: bool) -> float:
    """Theorem 3.2 bound on ||w* - w~*||."""
    frac = n_l / (n + n_l) if arrival else n_l / n
    return (2.0 * np.sqrt(2.0 * L) / mu) * frac * np.sqrt(max(gamma_l, 0.0))


def quadratic_problem_constants(A_list, c_list, p):
    """Closed-form constants for F_k(w) = 0.5 (w-c_k)^T A_k (w-c_k).
    Returns (ProblemConstants, w_star).

    With quadratics every paper quantity (w*, Gamma_k, L, mu) is exact, so
    Theorem 3.1 / Table 1 are directly checkable.
    """
    A_list = [np.asarray(A) for A in A_list]
    c_list = [np.asarray(c) for c in c_list]
    p = np.asarray(p, np.float64)
    A_bar = sum(pk * A for pk, A in zip(p, A_list))
    b_bar = sum(pk * A @ c for pk, A, c in zip(p, A_list, c_list))
    w_star = np.linalg.solve(A_bar, b_bar)
    gamma_k = np.array([0.5 * (w_star - c) @ A @ (w_star - c)
                        for A, c in zip(A_list, c_list)])
    eigs = [np.linalg.eigvalsh(A) for A in A_list]
    L = float(max(e.max() for e in eigs))
    mu = float(min(e.min() for e in eigs))
    return ProblemConstants(L=L, mu=mu, G2=0.0,
                            sigma2=np.zeros(len(p)), gamma_k=gamma_k), w_star
