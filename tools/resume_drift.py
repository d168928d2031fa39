#!/usr/bin/env python3
"""How far do the two packages' streamed runs lie apart, and how far does the
reference lie from itself when only its f32 summation order changes?

    PYTHONPATH=src python tools/resume_drift.py [--models logreg cnn]
        [--modes plan device] [--seed 0]

Run it from the root of a checkout, on the CPU; it imports JAX and the JAX
package (the reference) beside the port, as the port's tests do.  The
scenario is the resume tests' (``tests/test_torch_checkpoint.py``:
every event kind, an Arrival with a brand-new client at tau 8 whose round
restarts the learning rate, an including Departure at tau 10; the logreg
of the reference's ``tests/test_checkpoint_resume.py`` and a small CNN).

Three runs of each (model, eta0, mode):

- ``ref``: the reference's scheduler;
- ``port``: the port's scheduler on the CPU (in device mode from the
  reference's s-law table, ROADMAP Limits item 3);
- ``ref-reordered``: the reference on the same problem with its summation
  order changed and nothing else: the logreg's input features permuted
  (``x[:, p]``, ``w[p]``: the forward's sum over features runs in another
  order), the CNN's first conv channels and dense hidden units permuted
  (``c1``/``cb1``/``c2``'s input channels, ``w1``'s columns/``b1``/``w2``'s
  rows: conv2's and the logits' sums run in another order).  Its params
  are permuted back before they are compared.

Each is measured twice, as a distance from ``ref``'s params in units of
PARAM_TOL (max over elements of |a - ref| / (1e-6 + 1e-5 |ref|); 1 is
``assert_allclose(rtol=1e-5, atol=1e-6)``'s edge):

- one round from the same params: before every round the other two runs
  take ``ref``'s params, so each round's distance is one round's own;
- free-running: the three run 12 rounds on their own from the same initial
  params.

The rows print as they come; the last line is one JSON object with every
distance.
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

ROUNDS = 12
EVAL_EVERY = 4                     # the resume tests' (evaluation moves no param)
ATOL, RTOL = 1e-6, 1e-5            # tests/test_torch_trainer.py's PARAM_TOL


def distance(a: dict, ref: dict) -> float:
    """max |a - ref| / (ATOL + RTOL |ref|) over every element, in the
    reference's layout."""
    return max(float(np.max(np.abs(np.asarray(a[k], np.float64) - r)
                             / (ATOL + RTOL * np.abs(r))))
               for k, r in ((k, np.asarray(v, np.float64))
                            for k, v in ref.items()))


def permutations(model: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    if model == "logreg":
        return {"features": rng.permutation(60)}
    return {"c1": rng.permutation(32), "hidden": rng.permutation(128)}


def reorder(params: dict, perm: dict, back: bool = False) -> dict:
    """The params of the reordered problem (or, ``back``, the original
    problem's from the reordered one's), numpy in the reference's layout."""
    p = {k: np.asarray(v) for k, v in params.items()}
    inv = {k: np.argsort(v) for k, v in perm.items()}
    q = inv if back else perm
    if "features" in q:
        p["w"] = p["w"][q["features"]]
        return p
    c, h = q["c1"], q["hidden"]
    p["c1"], p["cb1"] = p["c1"][..., c], p["cb1"][c]
    p["c2"] = p["c2"][:, :, c, :]
    p["w1"], p["b1"], p["w2"] = p["w1"][:, h], p["b1"][h], p["w2"][h]
    return p


def schedulers(model: str, mode: str, eta0: float, perm: dict):
    """(ref, port, ref-reordered) schedulers of the resume scenario, from
    the reference's init_small(PRNGKey(0))."""
    import jax
    import jax.numpy as jnp
    import repro.fed as ref_fed
    import repro_torch.fed as port_fed
    from repro.configs.paper import PAPER_CONFIGS
    from repro.core.participation import TRACES as RTRACES
    from repro.models.small import init_small, make_loss_fn as rloss
    from repro_torch.core.participation import TRACES
    from repro_torch.fed.engine import RoundEngine
    from repro_torch.models.small import make_loss_fn
    from repro_torch.params import from_jax
    from test_torch_checkpoint import SCENARIOS, events, port_client
    from test_torch_trainer import port_eval, ref_eval

    cfg, clients, newcomer, capacity, nmax, B, _ = SCENARIOS[model]
    rcfg = PAPER_CONFIGS[cfg.name]
    init = {k: np.asarray(v)
            for k, v in init_small(jax.random.PRNGKey(0), rcfg).items()}

    def ref(reordered: bool):
        features = perm.get("features") if reordered else None

        def client(a):
            x, xt = a["x"], a["x_test"]
            if features is not None:
                x, xt = x[:, features], xt[:, features]
            return ref_fed.Client(x=x, y=a["y"], trace=RTRACES[a["trace"]],
                                  x_test=xt, y_test=a["y_test"])
        p0 = reorder(init, perm) if reordered else init
        return ref_fed.StreamScheduler(
            clients=[client(a) for a in clients()],
            init_params={k: jnp.asarray(v) for k, v in p0.items()},
            loss_fn=rloss(rcfg), eval_fn=ref_eval(rcfg), capacity=capacity,
            max_samples=nmax, local_epochs=5, batch_size=B, scheme="C",
            eta0=eta0, seed=0, mode=mode, chunk_size=4,
            events=events(ref_fed, RTRACES, client(newcomer())))

    pclients = [port_client(a) for a in clients()]
    engine = RoundEngine(
        loss_fn=make_loss_fn(cfg), clients=pclients, local_epochs=5,
        batch_size=B, scheme="C", eta0=eta0, capacity=capacity,
        max_samples=nmax, device="cpu", model_kind=cfg.kind)
    port = port_fed.StreamScheduler(
        clients=pclients, init_params=from_jax(init, cfg, "cpu"),
        engine=engine, mode=mode, eval_fn=port_eval(cfg), seed=0,
        events=events(port_fed, TRACES, port_client(newcomer())))
    return cfg, ref(False), port, ref(True)


def measure(model: str, mode: str, eta0: float, seed: int) -> dict:
    import jax.numpy as jnp
    import repro_torch.fed.engine as port_engine
    from repro.fed.engine import trace_cdf_row
    from repro_torch.params import from_jax, to_numpy

    port_engine.trace_cdf_row = trace_cdf_row    # the reference's table
    perm = permutations(model, seed)
    numpy = lambda p: {k: np.asarray(v) for k, v in p.items()}  # noqa: E731

    cfg, ref, port, alt = schedulers(model, mode, eta0, perm)
    rounds = []
    for _ in range(ROUNDS):                      # one round from the same
        p0 = numpy(ref.params)                   # params, every round
        port.params = from_jax(p0, cfg, "cpu")
        alt.params = {k: jnp.asarray(v)
                      for k, v in reorder(p0, perm).items()}
        for s in (ref, port, alt):
            s.run(1, eval_every=EVAL_EVERY)
        r = ref.history[-1]
        want = numpy(ref.params)
        rounds.append(dict(
            tau=r.tau, eta=float(r.eta), event=r.event,
            n_active=int(r.n_active),
            update=max(float(np.max(np.abs(want[k] - p0[k])))
                       for k in want),
            port=distance(to_numpy(port.params, cfg), want),
            reordered=distance(reorder(numpy(alt.params), perm, back=True),
                               want)))

    cfg, ref, port, alt = schedulers(model, mode, eta0, perm)
    for s in (ref, port, alt):
        s.run(ROUNDS, eval_every=EVAL_EVERY)
    want = numpy(ref.params)
    free = dict(port=distance(to_numpy(port.params, cfg), want),
                reordered=distance(reorder(numpy(alt.params), perm,
                                           back=True), want))
    return dict(model=model, mode=mode, eta0=eta0, one_round=rounds,
                free_running=free)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", nargs="+", default=["logreg", "cnn"])
    ap.add_argument("--modes", nargs="+", default=["plan", "device"])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the reordering's permutations")
    args = ap.parse_args(argv)
    eta0s = {"logreg": (1.0, 0.5), "cnn": (0.05,)}
    out = []
    for model in args.models:
        for eta0 in eta0s[model]:
            for mode in args.modes:
                m = measure(model, mode, eta0, args.seed)
                out.append(m)
                print(f"{model} eta0 {eta0} {mode}: one round from the "
                      f"same params, distance from ref in PARAM_TOLs")
                print("  tau    eta  n_act     |update|      port   "
                      "reordered  event")
                for r in m["one_round"]:
                    print(f"  {r['tau']:3d} {r['eta']:6.3f} {r['n_active']:6d}"
                          f" {r['update']:12.6g} {r['port']:9.4g} "
                          f"{r['reordered']:11.4g}  {r['event']}")
                f = m["free_running"]
                print(f"  free-running {ROUNDS} rounds: port "
                      f"{f['port']:.6g}, reordered {f['reordered']:.6g}",
                      flush=True)
    print(json.dumps({"runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
