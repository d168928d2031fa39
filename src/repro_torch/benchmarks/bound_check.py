"""Theorem 3.1 envelope vs measured convergence on quadratics.

Counterpart of the reference's ``benchmarks/bound_check.py``: (tau,
measured ||w - w*||^2, bound) rows, where the measured trajectory of a
Scheme-C federated run with heterogeneous Bernoulli participation must stay
under the Theorem 3.1 bound built from the same problem's constants.  The
same numpy draws in the same order as the reference's; the round runs
through the port's ``make_fed_round`` in ``mode`` (client_parallel, as the
reference runs it, or client_sequential) on ``device`` (the CUDA device
unless ``"cpu"`` is asked for).

    PYTHONPATH=src python -m repro_torch.benchmarks.bound_check --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.aggregation import (expected_coeff_stats,
                                          scheme_coefficients, theta_bound)
from repro_torch.core.fed_step import make_fed_round
from repro_torch.core.theory import (convergence_bound,
                                     quadratic_problem_constants,
                                     theorem31_terms)
from repro_torch.device import resolve_device

E = 4
N = 4
DIM = 6


def quadratic_loss(A: torch.Tensor, c: torch.Tensor):
    """F_k(w) = 0.5 (w - c_k)^T A_k (w - c_k) in the port's batched loss
    contract: params {"w": (C, DIM)}, batch {"client": (C, 1)} naming each
    row's client -> (C,) losses."""
    def loss_fn(params, batch):
        k = batch["client"][:, 0]
        d = params["w"] - c[k]
        return 0.5 * (torch.bmm(d[:, None], A[k]) @ d[:, :, None])[:, 0, 0]
    return loss_fn


def run(rounds=200, seed=0, *, mode="client_parallel", device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    A_list = [np.diag(rng.uniform(0.5, 2.0, DIM)) for _ in range(N)]
    c_list = [rng.normal(0, 1.5, DIM) for _ in range(N)]
    n_k = rng.integers(50, 200, N).astype(float)
    p = n_k / n_k.sum()
    pc, w_star = quadratic_problem_constants(A_list, c_list, p)

    # heterogeneous participation: client k completes Bin(E, q_k), >=1
    qs = rng.uniform(0.3, 1.0, N)

    def sampler(r):
        return np.maximum(r.binomial(E, qs), 1)

    stats = expected_coeff_stats("C", p, sampler, E, n_rounds=1000,
                                 seed=seed)
    # G^2 estimate: max_k sup ||grad|| over the trajectory region
    G2 = max(float(np.linalg.norm(A @ (w_star - c)) ** 2) * 4
             for A, c in zip(A_list, c_list)) + 1.0
    pc = type(pc)(L=pc.L, mu=pc.mu, G2=G2, sigma2=np.zeros(N),
                  gamma_k=pc.gamma_k)
    terms = theorem31_terms(pc, p, E, theta_bound("C", N, E),
                            np.asarray(stats["E_ps"]))

    A = torch.tensor(np.stack(A_list), dtype=torch.float32, device=dev)
    c = torch.tensor(np.stack(c_list), dtype=torch.float32, device=dev)
    round_fn = make_fed_round(quadratic_loss(A, c), mode)
    params = {"w": torch.zeros(DIM, device=dev)}
    batches = {"client": torch.tensor(
        np.tile(np.arange(N)[:, None, None], (1, E, 1)), device=dev)}
    p_dev = torch.tensor(p, dtype=torch.float32, device=dev)
    eta_scale = 16 * E / (pc.mu * stats["E_sum_ps"])
    rows = []
    for tau in range(rounds):
        s = sampler(rng).astype(np.float32)
        alpha = (np.arange(E)[None, :] < s[:, None]).astype(np.float32)
        s_dev = torch.from_numpy(s).to(dev)
        coeffs = scheme_coefficients("C", p_dev, s_dev, E)
        eta = min(eta_scale / (tau * E + terms.gamma), 0.5)
        params, _ = round_fn(
            params, batches, torch.from_numpy(alpha).to(dev), coeffs,
            torch.tensor(eta, dtype=torch.float32, device=dev))
        if tau % 10 == 0:
            w = params["w"].cpu().numpy()
            err = float(np.sum((w - w_star) ** 2))
            bound = convergence_bound(max(tau, 1), terms, M_tau=0.0)
            rows.append((tau, err, bound))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", default="client_parallel",
                    choices=("client_parallel", "client_sequential"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print("tau,measured_err2,thm31_bound,within")
    for tau, err, bound in run(args.rounds, args.seed, mode=args.mode,
                               device=args.device):
        print(f"{tau},{err:.6f},{bound:.6f},{err <= bound}")


if __name__ == "__main__":
    main()
