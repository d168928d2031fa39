"""SYNTHETIC(alpha, beta) dataset (Li et al. 2018, as used in paper §5.1).

Copy of the reference's ``data/synthetic.py``: the same numpy draws in the
same order, so a seed gives the reference's arrays bit for bit.  alpha
controls how much local models differ; beta controls how much local data
distributions differ.  (0,0) ~ IID; (1,1) ~ strongly non-IID.
"""
from __future__ import annotations

import numpy as np

N_FEATURES = 60
N_CLASSES = 10


def synthetic_client(rng: np.random.Generator, alpha: float, beta: float,
                     n_samples: int):
    """One client's (x, y)."""
    u = rng.normal(0.0, alpha)
    Bk = rng.normal(0.0, beta)
    W = rng.normal(u, 1.0, size=(N_FEATURES, N_CLASSES))
    b = rng.normal(u, 1.0, size=(N_CLASSES,))
    v = rng.normal(Bk, 1.0, size=(N_FEATURES,))
    sigma = np.diag(np.arange(1, N_FEATURES + 1, dtype=np.float64) ** -1.2)
    x = rng.multivariate_normal(v, sigma, size=n_samples)
    logits = x @ W + b
    y = np.argmax(logits, axis=1)
    return x.astype(np.float32), y.astype(np.int32)


def synthetic_federation(alpha: float, beta: float, n_clients: int,
                         seed: int = 0, pareto_index: float = 0.5,
                         min_samples: int = 40, max_samples: int = 500):
    """Per-client datasets with Type-I-Pareto sample counts (paper §5.1);
    the last 20 samples of each client are its holdout."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(pareto_index, size=n_clients) + 1.0
    counts = np.clip((raw * min_samples).astype(int), min_samples,
                     max_samples)
    clients = [synthetic_client(rng, alpha, beta, int(c) + 20)
               for c in counts]
    train = [(x[:-20], y[:-20]) for x, y in clients]
    test = [(x[-20:], y[-20:]) for x, y in clients]
    return train, test
