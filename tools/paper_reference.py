#!/usr/bin/env python3
"""Write the reference's initial parameters and table rows for the port.

    PYTHONPATH=src python tools/paper_reference.py

Run it from the root of a checkout, on the CPU (JAX_PLATFORMS=cpu).  It
calls the JAX package's unmodified experiment functions in ``benchmarks/``
at their default arguments and writes, under
``src/repro_torch/benchmarks/``:

- ``reference_init.npz``: ``init_small(PRNGKey(0), cfg)`` for SYNTHETIC_LR
  and MNIST_MLP, the tables' starting point, in the reference's layout
  (keys ``<config name>/<leaf>``);
- ``reference_rows.json``: the rows of Table 3 (synthetic and images),
  Table 4, Table 5 and ``bound_check.run()``, each at its defaults, with
  the command that produced them, the jax and numpy versions, each
  table's seconds and a SHA-256 of every federation the tables draw (its
  clients' train and test arrays in order), by which a port on another
  machine shows that its data are the reference's.

The port runs with no JAX, so these files are how it starts from the
reference's parameters and how its tables on the card are held to the
reference's rows.  This script is the only
producer of both files; ``tests/test_torch_paper_tables.py`` recomputes
the initial parameters and two cheap rows and compares them with the
committed files.
"""
from __future__ import annotations

import hashlib
import json
import platform
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import bound_check, paper_tables  # noqa: E402
from repro.configs.paper import MNIST_MLP, SYNTHETIC_LR  # noqa: E402
from repro.data import (iid_partition, label_sorted_partition,  # noqa: E402
                        make_class_dataset, synthetic_federation)
from repro.models.small import init_small  # noqa: E402

OUT = ROOT / "src" / "repro_torch" / "benchmarks"
COMMAND = "JAX_PLATFORMS=cpu PYTHONPATH=src python tools/paper_reference.py"


def _plain(rows):
    """Rows of tuples with numpy scalars -> lists of JSON values."""
    return [[v.item() if isinstance(v, np.generic) else v for v in row]
            for row in rows]


# the federations the tables draw, as repro_torch.benchmarks.reference
# names them: synthetic (alpha, beta, clients, seed), images (partition,
# clients, seed)
SYNTHETIC = [(0.0, 0.0, 24, 0), (1.0, 1.0, 24, 0), (1.0, 1.0, 9, 4),
             (1.0, 1.0, 1, 99), (0.1, 0.1, 10, 7), (1.0, 1.0, 10, 7)]
IMAGES = [("iid", 24, 0), ("niid", 24, 0)]


def fingerprint(train, test) -> str:
    h = hashlib.sha256()
    for x, y in list(train) + list(test):
        h.update(np.ascontiguousarray(x).tobytes())
        h.update(np.ascontiguousarray(y).tobytes())
    return h.hexdigest()


def data_fingerprints() -> dict:
    out = {}
    for a, b, n, seed in SYNTHETIC:
        out[f"synthetic {a} {b} {n} {seed}"] = fingerprint(
            *synthetic_federation(a, b, n, seed=seed))
    for part, n, seed in IMAGES:
        x, y = make_class_dataset(10, 400, seed=seed)
        split = iid_partition if part == "iid" else label_sorted_partition
        out[f"images {part} {n} {seed}"] = fingerprint(
            *split(x, y, n, seed=seed))
    return out


def main() -> None:
    init = {}
    for cfg in (SYNTHETIC_LR, MNIST_MLP):
        for name, leaf in init_small(jax.random.PRNGKey(0), cfg).items():
            init[f"{cfg.name}/{name}"] = np.asarray(leaf)
    np.savez(OUT / "reference_init.npz", **init)

    tables = {
        "table3_synthetic": lambda: paper_tables.table3_scheme_comparison(
            dataset="synthetic"),
        "table3_images": lambda: paper_tables.table3_scheme_comparison(
            dataset="images"),
        "table4": paper_tables.table4_fast_reboot,
        "table5": paper_tables.table5_departure_crossing,
        "bound_check": bound_check.run,
    }
    rows, seconds = {}, {}
    for name, fn in tables.items():
        t0 = time.perf_counter()
        rows[name] = _plain(fn())
        seconds[name] = round(time.perf_counter() - t0, 3)
        print(f"{name}: {seconds[name]} s", flush=True)
    out = {
        "command": COMMAND,
        "jax": jax.__version__,
        "numpy": np.__version__,
        "python": platform.python_version(),
        "backend": jax.default_backend(),
        "columns": {
            "table3_synthetic": ["dataset", "iid", "n_traces", "acc_A",
                                 "acc_B", "acc_C", "B-A", "C-B"],
            "table3_images": ["dataset", "iid", "n_traces", "acc_A",
                              "acc_B", "acc_C", "B-A", "C-B"],
            "table4": ["tau0", "recover_fast", "recover_vanilla"],
            "table5": ["alpha", "beta", "tau0", "crossing"],
            "bound_check": ["tau", "err", "bound"],
        },
        "seconds": seconds,
        "data": data_fingerprints(),
        "rows": rows,
    }
    (OUT / "reference_rows.json").write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
