#!/usr/bin/env python3
"""Drift of the port's paper tables on the CPU against the reference's rows.

    PYTHONPATH=src python tools/paper_drift.py [--agg tree flat]
        [--ulp-seeds 1 2 3] [--ulps 1]

Runs the port's Table 3 (synthetic and images), Table 4, Table 5 and
bound_check (both modes) free-running at their defaults on the CPU, once
per aggregation layout asked for (``tree`` is the CPU's default, ``flat``
the card's: two f32 summation orders) and, with ``--ulp-seeds``, once more
per seed from the reference's initial params moved by ``--ulps`` ulps
each, up or down at random (f32 noise that another summation order would
add, or more; on the tree layout).  It prints each table's rows beside the
reference's committed rows (``repro_torch/benchmarks/reference_rows.json``)
with the largest differences: Table 3's accuracies and differences in
held-out samples (1/480), Table 4's and Table 5's epochs, bound_check's
relative error.  These are the drift from which the
comparison thresholds of ``repro_torch.benchmarks.reference`` were set;
the rules' verdicts at those thresholds are printed too.  The last line is
one JSON object with every row and drift.  Imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.benchmarks import bound_check, paper_tables  # noqa: E402
from repro_torch.benchmarks import reference as R  # noqa: E402
from repro_torch.configs.paper import MNIST_MLP, SYNTHETIC_LR  # noqa: E402


def ulp_moved(cfg, seed: int, ulps: int = 1):
    """The reference's initial params of cfg, every element moved ``ulps``
    units in its last place (the spacing above it) up or down, a fair coin
    per element, from seed."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in R.reference_init(cfg, "cpu").items():
        sign = torch.from_numpy(np.where(rng.random(p.shape) < 0.5, 1.0,
                                         -1.0)).float()
        spacing = torch.nextafter(p, torch.full_like(p, np.inf)) - p
        out[name] = p + sign * ulps * spacing
    return out


def table3_drift(rows, want) -> dict:
    """Largest |port - reference| of the accuracies and of the
    differences, in held-out samples."""
    acc = max(abs(g[i] - r[i]) for g, r in zip(rows, want)
              for i in (3, 4, 5))
    diff = max(abs(g[i] - r[i]) for g, r in zip(rows, want) for i in (6, 7))
    return {"acc_samples": acc * R.TABLE3_N_TEST,
            "diff_samples": diff * R.TABLE3_N_TEST}


def epoch_drift(rows, want, cols) -> int:
    return max(abs(g[i] - r[i]) for g, r in zip(rows, want) for i in cols)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agg", nargs="*", default=["tree", "flat"])
    ap.add_argument("--ulp-seeds", nargs="*", type=int, default=[])
    ap.add_argument("--ulps", type=int, default=1)
    args = ap.parse_args()
    want = R.reference_rows()["rows"]
    out = {}
    variants = [(agg, None) for agg in args.agg] + [
        ("tree", seed) for seed in args.ulp_seeds]
    for agg, seed in variants:
        res, secs = {}, {}
        kw = dict(device="cpu", agg=agg)

        def init(cfg):
            return None if seed is None else ulp_moved(cfg, seed, args.ulps)
        for name, fn in (
                ("table3_synthetic", lambda: paper_tables
                 .table3_scheme_comparison(dataset="synthetic",
                                           init_params=init(SYNTHETIC_LR),
                                           **kw)),
                ("table3_images", lambda: paper_tables
                 .table3_scheme_comparison(dataset="images",
                                           init_params=init(MNIST_MLP),
                                           **kw)),
                ("table4", lambda: paper_tables.table4_fast_reboot(
                    init_params=init(SYNTHETIC_LR), **kw)),
                ("table5", lambda: paper_tables.table5_departure_crossing(
                    init_params=init(SYNTHETIC_LR), **kw))):
            t0 = time.perf_counter()
            res[name] = [list(r) for r in fn()]
            secs[name] = time.perf_counter() - t0
        drift = {name: table3_drift(res[name], want[name])
                 for name in ("table3_synthetic", "table3_images")}
        drift["table4"] = epoch_drift(res["table4"], want["table4"], (1, 2))
        drift["table5"] = epoch_drift(res["table5"], want["table5"], (3,))
        verdicts = {
            "table3_synthetic": R.compare_table3(res["table3_synthetic"],
                                                 want["table3_synthetic"]),
            "table3_images": R.compare_table3(res["table3_images"],
                                              want["table3_images"]),
            "table4": R.compare_table4(res["table4"], want["table4"]),
            "table5": R.compare_table5(res["table5"], want["table5"])}
        for mode in ("client_parallel", "client_sequential"):
            rows = bound_check.run(mode=mode, device="cpu")
            res[f"bound_check {mode}"] = rows
            drift[f"bound_check {mode}"] = max(
                abs(g[1] - r[1]) / abs(r[1])
                for g, r in zip(rows, want["bound_check"]))
            verdicts[f"bound_check {mode}"] = R.compare_bound_check(
                rows, want["bound_check"])
        label = agg if seed is None else f"{agg}, init moved by " \
            f"{args.ulps} ulp (seed {seed})"
        print(f"== agg={label!r} on the CPU", flush=True)
        for name, rows in res.items():
            print(f"{name} ({secs.get(name, 0):.1f} s):")
            ref = want[name.split()[0]]
            for g, r in zip(rows, ref):
                print(f"  port {g}\n  ref  {r}")
        print("drift:", json.dumps(drift))
        for name, (lines, failures) in verdicts.items():
            print(f"{name}: {len(failures)} rule failures")
            for line in lines:
                print("  " + line)
        out[label] = {"rows": res, "seconds": secs, "drift": drift,
                    "failures": {n: f for n, (_, f) in verdicts.items()}}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
