#!/usr/bin/env python3
"""How far does one round of the port's scenario run lie from the
reference's, from the same params, and how far does the reference lie
from itself when only its f32 summation order changes?

    PYTHONPATH=src python tools/scenario_drift.py [--scenarios flash-crowd]
        [--modes device plan] [--eta0 1.0] [--perms 0 1 2]

Run it from the root of a checkout, on the CPU; it imports JAX and the JAX
package (the reference) beside the port, as the port's tests do.  The
scenarios are ``tests/test_torch_scenarios.py``'s short cuts (SHORT), at
the scenarios' own eta0 unless ``--eta0`` is given.  For each scenario and
sampling mode, every round starts the port and the reordered references
from the reference's params (teacher-forced, as that test does), and the
distance of each from the reference's round is printed in units of
PARAM_TOL (``tools/resume_drift.distance``: 1 is ``assert_allclose(rtol=1e-5,
atol=1e-6)``'s edge).  ``ref-reordered`` is the reference with the logreg's
input features permuted (``x[:, p]``, ``w[p]``), one run per permutation
seed: the same problem, its sums over features in another order.  In device
mode the port draws from the reference's s-law table (ROADMAP Limits
item 3).  The last line is one JSON object with every distance.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "tools"))

from resume_drift import distance, permutations, reorder  # noqa: E402

EVAL_EVERY = 3                     # tests/test_torch_scenarios.py's


def reordered_scenario(R, name, seed, knobs, perm):
    """The reference's scenario with every client's features (founding and
    arriving) permuted by perm["features"]."""
    sc = R.make_scenario(name, seed=seed, **knobs)
    f = perm["features"]
    payloads = [e.client for e in sc.events
                if getattr(e, "client", None) is not None]
    for c in sc.clients + payloads:
        c.x, c.x_test = c.x[:, f], c.x_test[:, f]
    return sc


def measure(name: str, mode: str, eta0, perm_seeds) -> dict:
    import jax.numpy as jnp
    import repro_torch.fed.engine as port_engine
    from repro.fed import scenarios as R
    from repro.fed.engine import trace_cdf_row
    from repro_torch.configs.paper import SYNTHETIC_LR
    from repro_torch.fed import scenarios as P
    from repro_torch.params import from_jax, to_numpy
    from test_torch_scenarios import SHORT

    port_engine.trace_cdf_row = trace_cdf_row    # the reference's table
    seed, knobs = SHORT[name]

    def scenario(pkg, sc):
        if eta0 is not None:
            sc.eta0 = eta0
        return sc

    ref = R.build_scheduler(scenario(R, R.make_scenario(name, seed=seed,
                                                        **knobs)), mode=mode)
    port = P.build_scheduler(scenario(P, P.make_scenario(name, seed=seed,
                                                         **knobs)),
                             mode=mode, device="cpu")
    perms = [permutations("logreg", s) for s in perm_seeds]
    alts = [R.build_scheduler(scenario(R, reordered_scenario(
        R, name, seed, knobs, p)), mode=mode) for p in perms]
    numpy = lambda p: {k: np.asarray(v) for k, v in p.items()}  # noqa: E731
    rounds = []
    for _ in range(knobs["n_rounds"]):
        p0 = numpy(ref.params)
        port.params = from_jax(p0, SYNTHETIC_LR, "cpu")
        for alt, p in zip(alts, perms):
            alt.params = {k: jnp.asarray(v)
                          for k, v in reorder(p0, p).items()}
        for s in [ref, port] + alts:
            s.run(1, eval_every=EVAL_EVERY)
        r = ref.history[-1]
        want = numpy(ref.params)
        rounds.append(dict(
            tau=r.tau, eta=float(r.eta), event=r.event,
            n_active=int(r.n_active),
            port=distance(to_numpy(port.params, SYNTHETIC_LR), want),
            reordered=[distance(reorder(numpy(a.params), p, back=True),
                                want) for a, p in zip(alts, perms)]))
    return dict(scenario=name, mode=mode, eta0=float(ref.eta0),
                rounds=rounds)


def main(argv=None) -> int:
    from test_torch_scenarios import SHORT
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenarios", nargs="+", default=list(SHORT))
    ap.add_argument("--modes", nargs="+", default=["device", "plan"])
    ap.add_argument("--eta0", type=float, default=None,
                    help="default: each scenario's own (1.0)")
    ap.add_argument("--perms", nargs="+", type=int, default=[0, 1, 2],
                    help="seeds of the reorderings' permutations")
    args = ap.parse_args(argv)
    out = []
    for name in args.scenarios:
        for mode in args.modes:
            m = measure(name, mode, args.eta0, args.perms)
            out.append(m)
            print(f"{name} {mode} eta0 {m['eta0']}: one round from the "
                  f"reference's params, distance in PARAM_TOLs")
            print("  tau    eta  n_act      port  reordered         event")
            for r in m["rounds"]:
                alt = " ".join(f"{d:7.3f}" for d in r["reordered"])
                print(f"  {r['tau']:3d} {r['eta']:6.3f} {r['n_active']:5d} "
                      f"{r['port']:9.3f}  {alt}  {r['event']}")
            worst = max(r["port"] for r in m["rounds"])
            alt_worst = max(max(r["reordered"]) for r in m["rounds"])
            print(f"  worst: port {worst:.3f}, reordered {alt_worst:.3f}",
                  flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
