"""Device-participation models (paper §5.1, Table 2).

Copy of the reference's ``repro/core/participation.py``: ``Trace``/``TRACES``,
``sample_alpha``, ``assign_traces`` and ``BernoulliParticipation``.
Each trace is a distribution over the fraction of the E required local
epochs a device completes in a round; the means are a reconstruction (the
paper's column did not survive extraction), the stdevs are the paper's.
Every sampler consumes the numpy RNG in exactly the reference's order, so
a seed gives both packages the same participation stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class Trace:
    """Fraction-of-epochs-completed distribution for one device class."""

    name: str
    mean: float          # mean completed fraction, conditional on active
    stdev: float         # stdev of the completed fraction
    p_inactive: float    # probability of s == 0 in a round

    def _beta_params(self):
        m, s = self.mean, max(self.stdev, 1e-3)
        # method of moments for Beta(a,b); clamp to a valid variance
        var = min(s * s, m * (1 - m) * 0.95) if 0 < m < 1 else None
        if var is None or var <= 0:
            return None
        k = m * (1 - m) / var - 1
        return max(m * k, 1e-2), max((1 - m) * k, 1e-2)

    def sample_fraction(self, rng: np.random.Generator, size=()):
        frac = np.full(size, self.mean, dtype=np.float64)
        ab = self._beta_params()
        if ab is not None:
            frac = rng.beta(ab[0], ab[1], size=size)
        if self.p_inactive > 0:
            frac = np.where(rng.random(size) < self.p_inactive, 0.0, frac)
        return frac

    def sample_s(self, rng: np.random.Generator, E: int, size=()):
        """Number of completed local epochs s in {0..E}."""
        frac = self.sample_fraction(rng, size)
        s = np.round(frac * E).astype(np.int64)
        if self.p_inactive == 0:
            # CPU-contention traces never produce zero epochs (paper §5.1)
            s = np.maximum(s, 1)
        return np.clip(s, 0, E)


# Table-2 reconstruction (stdevs from the paper; means reconstructed).
TRACES: Sequence[Trace] = (
    Trace("cpu_0", 1.00, 0.000, 0.0),
    Trace("cpu_30", 0.90, 0.148, 0.0),
    Trace("cpu_50", 0.75, 0.113, 0.0),
    Trace("cpu_70", 0.55, 0.117, 0.0),
    Trace("cpu_90", 0.30, 0.148, 0.0),
    Trace("bw_low", 0.50, 0.233, 0.30),
    Trace("bw_med", 0.65, 0.223, 0.20),
    Trace("bw_high", 0.80, 0.183, 0.10),
)


def sample_alpha(rng: np.random.Generator, traces: Sequence[Trace],
                 E: int) -> np.ndarray:
    """One round of participation masks in the equivalent view (paper
    App. A.1.1): (C, E) float32 with alpha[c, :s_c] = 1."""
    s = np.array([t.sample_s(rng, E) for t in traces])
    return (np.arange(E)[None, :] < s[:, None]).astype(np.float32)


def assign_traces(rng: np.random.Generator, n_clients: int,
                  n_traces: int) -> list:
    """Paper §5.2: |T| = j uses the first j traces, randomly assigned."""
    idx = rng.integers(0, n_traces, size=n_clients)
    return [TRACES[i] for i in idx]


class BernoulliParticipation:
    """alpha_t ~ iid Bernoulli(q), so s ~ Bin(E, q) (paper App. A.1.1)."""

    def __init__(self, q: float):
        self.q = q

    def sample_alpha(self, rng: np.random.Generator, C: int, E: int):
        return (rng.random((C, E)) < self.q).astype(np.float32)
