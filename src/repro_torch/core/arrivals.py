"""Fast-reboot on device arrival (paper §4.2, Corollary 4.0.2).

Copy of the reference's ``RebootState`` and ``staircase_lr``
(``repro/core/arrivals.py``).  When device l arrives at round tau0 the
objective shifts, the staircase learning rate restarts, and l's
aggregation coefficient is boosted to beta * p^l, decaying back to p^l as
O((tau - tau0)^-2).
"""
from __future__ import annotations

from dataclasses import dataclass


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
