"""The reference's experiment results, committed, and the rules that hold
the port's to them.

The port runs with no JAX, so two files in this directory carry what the
reference computed (``tools/paper_reference.py`` writes both, on the CPU,
from the unmodified ``benchmarks/`` functions at their defaults):

- ``reference_init.npz``: ``init_small(PRNGKey(0), cfg)`` for SYNTHETIC_LR
  and MNIST_MLP in the reference's layout, the tables' starting point;
- ``reference_rows.json``: the rows of Table 3 (synthetic and images),
  Table 4, Table 5 and ``bound_check.run()``, and a fingerprint of every
  federation the tables draw (``data_fingerprints``): numpy draws the
  data, and a port on another machine's numpy shows with these that its
  data are the reference's.

At eta0 1.0 over 60+ rounds, f32 summation order could move accuracies by
held-out samples and threshold crossings by epochs, so a port's table is
held to the reference's claims, not to its raw numbers.  The thresholds
below come from the drift of the port's own tables on the CPU against
these rows (``tools/paper_drift.py``; ``PERF.md`` §2): none on either
aggregation layout or from initial params moved by 1 or 1,024 ulps (every
row equal to the reference's); 2 samples in Table 3 and no epoch in
Tables 4 and 5 from initial params moved by 65,536 ulps.

- Table 3: where the reference's B-A or C-B is exactly 0 (the schemes
  coincide), the port's must be exactly 0.  Where the reference's
  |difference| exceeds ``TABLE3_NOISE_SAMPLES`` held-out samples (1 / n_test
  each), the signs must agree.  Every other difference is "within noise":
  listed, not counted as agreeing.
- Table 4: each recovery epoch within ``EPOCH_TOL`` of the reference's;
  where the reference's fast and vanilla epochs differ by more than
  2 * ``EPOCH_TOL``, their order must match.
- Table 5: each crossing within ``EPOCH_TOL``; a run with no crossing (-1)
  must match a reference with no crossing, and only such a reference.
- bound_check: every error within its Theorem 3.1 bound, the last error
  meeting the convergence criterion of ``tests/test_theory_bound.py``, each
  error within ``BOUND_RTOL`` (relative) of the reference's and each bound
  within ``BOUND_RTOL`` of the reference's.
"""
from __future__ import annotations

import functools
import hashlib
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROWS_FILE = HERE / "reference_rows.json"
INIT_FILE = HERE / "reference_init.npz"

# held-out samples per Table 3 federation: 24 clients x 20 each, on both
# datasets
TABLE3_N_TEST = 24 * 20
TABLE3_NOISE_SAMPLES = 2
EPOCH_TOL = 2
BOUND_RTOL = 1e-3


# the federations the tables draw (Table 3 synthetic iid and non-iid, Table
# 4's nine clients and its arrival, Table 5's two (alpha, beta); Table 3
# on images, iid and non-iid), keyed as reference_rows.json's "data"
SYNTHETIC = [(0.0, 0.0, 24, 0), (1.0, 1.0, 24, 0), (1.0, 1.0, 9, 4),
             (1.0, 1.0, 1, 99), (0.1, 0.1, 10, 7), (1.0, 1.0, 10, 7)]
IMAGES = [("iid", 24, 0), ("niid", 24, 0)]


def fingerprint(train, test) -> str:
    """SHA-256 of a federation's clients' train and test arrays, in
    order."""
    h = hashlib.sha256()
    for x, y in list(train) + list(test):
        h.update(np.ascontiguousarray(x).tobytes())
        h.update(np.ascontiguousarray(y).tobytes())
    return h.hexdigest()


def data_fingerprints() -> dict:
    """The fingerprint of every federation the tables draw, from the
    port's data generators on this machine."""
    from repro_torch.data import (iid_partition, label_sorted_partition,
                                  make_class_dataset, synthetic_federation)
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


@functools.lru_cache(maxsize=1)
def reference_rows() -> dict:
    """The committed ``reference_rows.json``: ``rows`` by table, and how
    they were produced (``command``, ``jax``, ``seconds``, ...)."""
    return json.loads(ROWS_FILE.read_text())


def reference_init(cfg, device=None):
    """The reference's ``init_small(PRNGKey(0), cfg)`` as the port's
    parameters on ``device`` (``params.from_jax`` owns the layout)."""
    from repro_torch.params import from_jax
    with np.load(INIT_FILE) as f:
        prefix = f"{cfg.name}/"
        arrays = {k[len(prefix):]: f[k] for k in f.files
                  if k.startswith(prefix)}
    if not arrays:
        raise KeyError(f"no reference init for {cfg.name} in {INIT_FILE}")
    return from_jax(arrays, cfg, device)


def _sign(x: float) -> int:
    return (x > 0) - (x < 0)


def compare_table3(rows, want, *, noise=TABLE3_NOISE_SAMPLES,
                   n_test=TABLE3_N_TEST):
    """Table 3 rows (dataset, iid, |T|, acc_A, acc_B, acc_C, B-A, C-B)
    against the reference's.  Returns (lines, failures): one verdict line
    per difference, and the lines of those that break a rule."""
    lines, failures = [], []
    threshold = noise / n_test
    for got, ref in zip(rows, want, strict=True):
        if tuple(got[:3]) != tuple(ref[:3]):
            raise ValueError(f"row {got[:3]} against reference row {ref[:3]}")
        for label, g, r in (("B-A", got[6], ref[6]), ("C-B", got[7], ref[7])):
            head = f"{got[0]} {got[1]} |T|={got[2]} {label}: " \
                   f"{g:+.4f} (reference {r:+.4f})"
            if r == 0:
                ok = g == 0
                verdict = "coincide" if ok else "reference exactly 0, " \
                    "this is not"
            elif abs(r) > threshold:
                ok = _sign(g) == _sign(r)
                verdict = "signs agree" if ok else "signs DIFFER"
            else:
                ok = True
                verdict = f"within noise (|reference| <= {noise} samples " \
                          f"of {n_test})"
            lines.append(f"{head}: {verdict}")
            if not ok:
                failures.append(lines[-1])
    return lines, failures


def compare_table4(rows, want, *, k=EPOCH_TOL):
    """Table 4 rows (tau0, recover_fast, recover_vanilla)."""
    lines, failures = [], []
    for got, ref in zip(rows, want, strict=True):
        if got[0] != ref[0]:
            raise ValueError(f"tau0 {got[0]} against reference {ref[0]}")
        ok = all(abs(g - r) <= k for g, r in zip(got[1:], ref[1:]))
        verdict = f"within +-{k}" if ok else f"NOT within +-{k}"
        if abs(ref[1] - ref[2]) > 2 * k:
            same = _sign(got[1] - got[2]) == _sign(ref[1] - ref[2])
            verdict += ", order matches" if same else ", order DIFFERS"
            ok = ok and same
        lines.append(f"tau0={got[0]}: fast {got[1]} vanilla {got[2]} "
                     f"(reference {ref[1]} {ref[2]}): {verdict}")
        if not ok:
            failures.append(lines[-1])
    return lines, failures


def compare_table5(rows, want, *, k=EPOCH_TOL):
    """Table 5 rows (alpha, beta, tau0, crossing)."""
    lines, failures = [], []
    for got, ref in zip(rows, want, strict=True):
        if tuple(got[:3]) != tuple(ref[:3]):
            raise ValueError(f"row {got[:3]} against reference row {ref[:3]}")
        g, r = got[3], ref[3]
        if r == -1 or g == -1:
            ok = g == r
        else:
            ok = abs(g - r) <= k
        lines.append(f"({got[0]}, {got[1]}) tau0={got[2]}: crossing {g} "
                     f"(reference {r}): "
                     + ("agrees" if ok else "DISAGREES") + f" (+-{k})")
        if not ok:
            failures.append(lines[-1])
    return lines, failures


def converged(rows) -> bool:
    """The convergence criterion of tests/test_theory_bound.py."""
    return rows[-1][1] < 0.1 * max(rows[0][1], 1e-6) or rows[-1][1] < 0.05


def compare_bound_check(rows, want, *, rtol=BOUND_RTOL):
    """bound_check rows (tau, err, bound)."""
    lines, failures = [], []
    for got, ref in zip(rows, want, strict=True):
        tau, err, bound = got
        if tau != ref[0]:
            raise ValueError(f"tau {tau} against reference {ref[0]}")
        rel = abs(err - ref[1]) / abs(ref[1])
        ok = (err <= bound and rel <= rtol
              and abs(bound - ref[2]) <= rtol * abs(ref[2]))
        lines.append(f"tau={tau}: err {err:.6g} (reference {ref[1]:.6g}, "
                     f"relative {rel:.2e}) bound {bound:.6g} (reference "
                     f"{ref[2]:.6g}): " + ("ok" if ok else "FAILS"))
        if not ok:
            failures.append(lines[-1])
    if not converged(rows):
        failures.append(f"last error {rows[-1][1]:.6g} does not meet the "
                        f"convergence criterion (first {rows[0][1]:.6g})")
    return lines, failures
