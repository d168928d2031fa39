"""Model applicability on departures (paper §4.3, Corollary 4.0.3).

Copy of the reference's ``repro/core/departures.py``: ``BoundTerms``,
``f0_include``, ``f1_exclude``, ``should_exclude``, ``crossing_round`` and
``shift_weights_departure``.  Exclude wins iff
``min_{tau>=tau0} f0(tau) >= f1(T)`` with
``f0(tau) = ((tau - tau0) D + V) / (tau E + gamma)`` (include) and
``f1(tau) = V~ / ((tau - tau0) E + gamma)``, ``V~ = V / (tau0 E + gamma) +
Gamma_l`` (exclude).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BoundTerms:
    D: float        # heterogeneity/non-IID drift term (Thm 3.1)
    V: float        # variance/initialization term
    gamma: float    # learning-rate offset
    E: int          # local epochs per round


def f0_include(tau, tau0, t: BoundTerms):
    return ((tau - tau0) * t.D + t.V) / (tau * t.E + t.gamma)


def f1_exclude(tau, tau0, t: BoundTerms, gamma_l: float):
    V_tilde = t.V / (tau0 * t.E + t.gamma) + gamma_l
    return V_tilde / ((tau - tau0) * t.E + t.gamma)


def should_exclude(T: int, tau0: int, terms: BoundTerms,
                   gamma_l: float) -> bool:
    """Corollary 4.0.3 decision at departure time tau0 with deadline T."""
    taus = np.arange(tau0, T + 1)
    min_f0 = float(np.min(f0_include(taus, tau0, terms)))
    return min_f0 >= float(f1_exclude(T, tau0, terms, gamma_l))


def crossing_round(T: int, tau0: int, terms: BoundTerms,
                   gamma_l: float):
    """First tau where excluding beats including (None if never by T),
    the quantity tabulated in paper Table 5."""
    taus = np.arange(tau0 + 1, T + 1)
    f0 = f0_include(taus, tau0, terms)
    f1 = f1_exclude(taus, tau0, terms, gamma_l)
    hit = np.nonzero(f1 <= f0)[0]
    return int(taus[hit[0]]) if hit.size else None


def shift_weights_departure(n: np.ndarray, idx: int) -> np.ndarray:
    """Weights over remaining clients after excluding client idx."""
    m = np.delete(n, idx)
    return m / float(np.sum(m))
