#!/usr/bin/env python3
"""The port's s-law table against the reference's, entry by entry.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/s_law_table_drift.py

Run it from the root of a checkout, on the CPU.  It evaluates both
packages' ``trace_cdf_row`` over the 8 Table-2 traces at E in (1, 2, 3, 5,
10, 20) and prints, as one JSON line, how many entries there are, how many
differ and the largest difference.  The reference evaluates the
incomplete beta with jax in f32 (jax runs with x64 off), the port with
scipy in f64; both cast the row to f32.  The device draw reads this table,
so a uniform that lands between the two values of an entry draws another
s; everything else in the draw is bit for bit the same.
"""
from __future__ import annotations

import json

import numpy as np

from repro.core.participation import TRACES
from repro.fed.engine import trace_cdf_row as reference_row
from repro_torch.core.participation import TRACES as PORT_TRACES
from repro_torch.fed.engine import trace_cdf_row as port_row

EPOCHS = (1, 2, 3, 5, 10, 20)


def main() -> None:
    entries = differ = 0
    worst = 0.0
    for E in EPOCHS:
        for ref, port in zip(TRACES, PORT_TRACES, strict=True):
            a, b = reference_row(ref, E), port_row(port, E)
            entries += a.size
            differ += int((a != b).sum())
            worst = max(worst, float(np.abs(a - b).max()))
    print(json.dumps({"epochs": EPOCHS, "traces": len(TRACES),
                      "entries": entries, "differ": differ,
                      "max_abs_diff": worst}))


if __name__ == "__main__":
    main()
