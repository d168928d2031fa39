"""Pseudo-MNIST / pseudo-EMNIST, seeded and synthetic.

Copy of the reference's ``data/images.py`` generators: seeded
class-prototype images (28x28, one prototype per class, Gaussian pixel
noise, prototype mixing), split over clients with the paper's label-sorted
non-IID partition or an IID one, with Type-I Pareto sample counts.
Nothing is downloaded; the same seed gives the same arrays as the
reference.
"""
from __future__ import annotations

import numpy as np


def make_class_dataset(n_classes: int, n_per_class: int, shape=(28, 28),
                       noise: float = 0.35, seed: int = 0):
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, size=(n_classes, *shape)).astype(np.float32)
    # low-pass the prototypes a little so classes are learnable but not trivial
    for _ in range(2):
        protos = (protos + np.roll(protos, 1, axis=1)
                  + np.roll(protos, 1, axis=2)) / 3.0
    xs, ys = [], []
    for c in range(n_classes):
        base = protos[c]
        mix = protos[(c + 1) % n_classes]
        lam = rng.uniform(0.0, 0.25, size=(n_per_class, 1, 1)).astype(np.float32)
        x = (1 - lam) * base + lam * mix
        x = x + rng.normal(0.0, noise, size=(n_per_class, *shape)).astype(np.float32)
        xs.append(x)
        ys.append(np.full(n_per_class, c, np.int32))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    idx = rng.permutation(len(x))
    return x[idx], y[idx]


def label_sorted_partition(x, y, n_clients: int, labels_per_client: int = 1,
                           seed: int = 0, pareto_index: float = 0.5,
                           min_samples: int = 50, holdout: int = 20):
    """Paper §5.1: sort by label; each device gets data from
    `labels_per_client` labels chosen uniformly at random; sample counts
    follow Type-I Pareto(0.5)."""
    rng = np.random.default_rng(seed)
    by_label = {c: np.nonzero(y == c)[0].tolist() for c in np.unique(y)}
    raw = rng.pareto(pareto_index, size=n_clients) + 1.0
    counts = np.clip((raw * min_samples).astype(int), min_samples, 400)
    train, test = [], []
    classes = list(by_label.keys())
    for k in range(n_clients):
        labs = rng.choice(classes, size=labels_per_client, replace=False)
        idxs = []
        need = counts[k] + holdout
        per = -(-need // labels_per_client)
        for lab in labs:
            pool = by_label[int(lab)]
            take = [pool[i % len(pool)] for i in
                    rng.integers(0, len(pool), size=per)]
            idxs.extend(take)
        idxs = np.array(idxs[:need])
        train.append((x[idxs[:-holdout]], y[idxs[:-holdout]]))
        test.append((x[idxs[-holdout:]], y[idxs[-holdout:]]))
    return train, test


def iid_partition(x, y, n_clients: int, seed: int = 0,
                  pareto_index: float = 0.5, min_samples: int = 50,
                  holdout: int = 20):
    """IID split: each client draws its samples uniformly from the whole
    pool, with Type-I Pareto counts (clipped to [min_samples, 400])."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(pareto_index, size=n_clients) + 1.0
    counts = np.clip((raw * min_samples).astype(int), min_samples, 400)
    train, test = [], []
    for k in range(n_clients):
        idxs = rng.integers(0, len(x), size=counts[k] + holdout)
        train.append((x[idxs[:-holdout]], y[idxs[:-holdout]]))
        test.append((x[idxs[-holdout:]], y[idxs[-holdout:]]))
    return train, test
