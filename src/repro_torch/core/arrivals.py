"""Fast-reboot on device arrival (paper §4.2, Corollary 4.0.2).

Copy of the reference's ``repro/core/arrivals.py``: ``RebootState``,
``staircase_lr``, ``shift_weights_arrival`` and ``reboot_radius``.  When device l arrives at round tau0 the
objective shifts, the staircase learning rate restarts, and l's
aggregation coefficient is boosted to beta * p^l, decaying back to p^l as
O((tau - tau0)^-2).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RebootState:
    tau0: int
    client_idx: int
    boost: float = 3.0

    def coeff_multiplier(self, tau: int) -> float:
        """Multiplier on p^l at round tau >= tau0; ->1 as O((tau-tau0)^-2)."""
        dt = max(tau - self.tau0, 0)
        return 1.0 + (self.boost - 1.0) / float((1 + dt) ** 2)


def staircase_lr(eta0: float, tau: int, tau0: int = 0) -> float:
    """eta_tau = eta0 / (tau - tau0), restarted at the last objective
    shift (Cor. 3.2.1)."""
    return eta0 / max(tau - tau0, 1)


def shift_weights_arrival(n: np.ndarray, n_l: float) -> np.ndarray:
    """Data weights after admitting a device with n_l samples.
    n: (C,) sample counts of existing clients. Returns (C+1,) weights."""
    total = float(np.sum(n) + n_l)
    return np.concatenate([n, [n_l]]) / total


def reboot_radius(F_tilde_gap: float, p_l: float, gamma_l: float,
                  L: float, mu: float, W: float) -> float:
    """Corollary 4.0.2: the extra update helps iff
    ||w - w*|| < (F~(w*) - F~(w~*)) / ((2 sqrt(2L)/mu) p~l sqrt(Gamma_l) + 1) p~l W."""
    denom = ((2.0 * np.sqrt(2.0 * L) / mu) * p_l * np.sqrt(max(gamma_l, 0.0))
             + 1.0) * p_l * W
    return F_tilde_gap / max(denom, 1e-12)
