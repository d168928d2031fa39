"""The port's data generators, theory module and Theorem 3.1 check against
the reference's.

- ``synthetic_federation`` and ``iid_partition`` (numpy, the same draws in
  the same order): the arrays bit for bit;
- ``theta_bound``, ``expected_coeff_stats`` and every function of
  ``core/theory.py``: bit for bit (numpy arithmetic on the same f32
  coefficients);
- Table 1 on the quadratics of tests/test_convergence.py through the
  port's ``make_fed_round`` in both modes: scheme C converges, A and B
  stay biased, and each distance to w* matches the reference's within
  ``DIST_RTOL`` (f32 in another summation order);
- ``benchmarks.bound_check.run`` in both modes: the bounds bit for bit, the
  errors within ``BOUND_RTOL`` of the reference's, every row inside the
  envelope.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bound_check as ref_bound_check
from repro.core import aggregation as ref_agg
from repro.core import theory as ref_theory
from repro.data import images as ref_images
from repro.data import synthetic as ref_synthetic
from repro_torch.benchmarks import bound_check as port_bound_check
from repro_torch.benchmarks.reference import BOUND_RTOL, converged
from repro_torch.core import aggregation as port_agg
from repro_torch.core import theory as port_theory
from repro_torch.core.fed_step import make_fed_round
from repro_torch.data import images as port_images
from repro_torch.data import synthetic as port_synthetic

from test_convergence import E, N, make_problem, run_scheme


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODES = ("client_parallel", "client_sequential")
# Table 1's distances: 300 f32 rounds of a contraction, the reference's
# order of operations against the port's
DIST_RTOL = 1e-4


def _same_federation(got, want):
    for (gx, gy), (wx, wy) in zip(got, want, strict=True):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("args", [(0.0, 0.0, 24, 0), (1.0, 1.0, 10, 7),
                                  (0.5, 0.5, 4, 0), (1.0, 1.0, 1, 99)])
def test_synthetic_federation_is_the_references(args):
    a, b, n, seed = args
    got = port_synthetic.synthetic_federation(a, b, n, seed=seed)
    want = ref_synthetic.synthetic_federation(a, b, n, seed=seed)
    for g, w in zip(got, want, strict=True):
        _same_federation(g, w)


def test_iid_partition_is_the_references():
    x, y = port_images.make_class_dataset(10, 40, seed=3)
    got = port_images.iid_partition(x, y, 7, seed=3)
    want = ref_images.iid_partition(x, y, 7, seed=3)
    for g, w in zip(got, want, strict=True):
        _same_federation(g, w)


@pytest.mark.parametrize("scheme", "ABC")
def test_theta_bound_and_expected_coeff_stats(scheme):
    assert port_agg.theta_bound(scheme, 7, 5) == \
        ref_agg.theta_bound(scheme, 7, 5)
    p = np.array([0.1, 0.25, 0.4, 0.25])
    qs = np.array([0.3, 0.9, 0.6, 1.0])

    def sampler(r):
        return r.binomial(4, qs)
    got = port_agg.expected_coeff_stats(scheme, p, sampler, 4, n_rounds=300,
                                        seed=2)
    want = ref_agg.expected_coeff_stats(scheme, p, sampler, 4, n_rounds=300,
                                        seed=2)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _constants():
    A_list, c_list, p, _ = make_problem(0)
    return A_list, c_list, p


def test_quadratic_constants_and_theorem31_terms():
    A_list, c_list, p = _constants()
    pc, w = port_theory.quadratic_problem_constants(A_list, c_list, p)
    rpc, rw = ref_theory.quadratic_problem_constants(A_list, c_list, p)
    np.testing.assert_array_equal(w, rw)
    for f in ("L", "mu", "G2", "sigma2", "gamma_k"):
        np.testing.assert_array_equal(getattr(pc, f), getattr(rpc, f),
                                      err_msg=f)
    pc = port_theory.ProblemConstants(L=pc.L, mu=pc.mu, G2=3.5,
                                      sigma2=np.full(N, 0.2),
                                      gamma_k=pc.gamma_k)
    rpc = ref_theory.ProblemConstants(L=rpc.L, mu=rpc.mu, G2=3.5,
                                      sigma2=np.full(N, 0.2),
                                      gamma_k=rpc.gamma_k)
    E_ps = np.array([0.3, 0.5, 0.9, 1.4])
    for theta in (1.0, 4.0, float(N)):
        got = port_theory.theorem31_terms(pc, p, E, theta, E_ps)
        want = ref_theory.theorem31_terms(rpc, p, E, theta, E_ps)
        assert (got.D, got.V, got.gamma, got.E) == \
            (want.D, want.V, want.gamma, want.E)
        for tau, M in ((1, 0.0), (50, 3.0), (400, 17.0)):
            assert port_theory.convergence_bound(tau, got, M) == \
                ref_theory.convergence_bound(tau, want, M)


@pytest.mark.parametrize("arrival", [True, False])
def test_objective_shift_offset(arrival):
    for args in ((2.0, 0.5, 30.0, 400.0, 1.7), (1.0, 1.0, 5.0, 5.0, -1.0)):
        assert port_theory.objective_shift_offset(*args, arrival) == \
            ref_theory.objective_shift_offset(*args, arrival)


@pytest.mark.parametrize("scheme", "ABC")
def test_observed_participation_stats(scheme):
    rng = np.random.default_rng(5)
    R, C = 12, 5
    p = rng.dirichlet(np.ones(C), size=R)
    p[:, 4] = 0.0                                  # an empty slot
    s = rng.integers(0, 4, size=(R, C)).astype(float)
    got = port_theory.observed_participation_stats(scheme, p, s, 3)
    want = ref_theory.observed_participation_stats(scheme, p, s, 3)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError):
        port_theory.observed_participation_stats(scheme, p, s[:-1], 3)


def _port_distance(scheme, A_list, c_list, w_star, s_pattern, mode,
                   rounds=300, eta0=0.5):
    """tests/test_convergence.py's run_scheme through the port's
    make_fed_round."""
    A = torch.tensor(np.stack(A_list), dtype=torch.float32)
    c = torch.tensor(np.stack(c_list), dtype=torch.float32)
    round_fn = make_fed_round(port_bound_check.quadratic_loss(A, c), mode)
    params = {"w": torch.zeros(A.shape[-1])}
    alpha = torch.tensor(np.arange(E)[None, :]
                         < np.asarray(s_pattern)[:, None], dtype=torch.float32)
    batches = {"client": torch.tensor(
        np.tile(np.arange(N)[:, None, None], (1, E, 1)))}
    p = make_problem(0)[2]
    coeffs = port_agg.scheme_coefficients(scheme, p, s_pattern, E)
    for tau in range(rounds):
        params, _ = round_fn(params, batches, alpha, coeffs,
                             torch.tensor(eta0 / (tau + 1),
                                          dtype=torch.float32))
    return float(np.linalg.norm(params["w"].numpy() - w_star))


@pytest.mark.parametrize("mode", MODES)
def test_table1_on_quadratics_through_make_fed_round(mode):
    """Table 1: under heterogeneous participation only scheme C reaches the
    global optimum; A (complete devices only) and B (partial work at fixed
    weights) stay biased.  Each distance is the reference's."""
    A_list, c_list, p, w_star = make_problem(0)
    s_pattern = [E, 2, 1, 3]
    got = {s: _port_distance(s, A_list, c_list, w_star, s_pattern, mode)
           for s in "ABC"}
    want = {s: run_scheme(s, A_list, c_list, p, w_star, s_pattern=s_pattern)
            for s in "ABC"}
    for s in "ABC":
        np.testing.assert_allclose(got[s], want[s], rtol=DIST_RTOL,
                                   err_msg=s)
    assert got["C"] < 0.05, got
    for s in "AB":
        assert got[s] > 5 * got["C"] and got[s] > 0.05, got


def test_make_fed_round_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="client_sequential"):
        make_fed_round(lambda p, b: None, "client_serial")


@pytest.mark.parametrize("mode", MODES)
def test_bound_check_matches_the_reference(mode):
    want = ref_bound_check.run(rounds=80, seed=1)
    got = port_bound_check.run(rounds=80, seed=1, mode=mode, device="cpu")
    assert [g[0] for g in got] == [w[0] for w in want]
    for (tau, err, bound), (_, rerr, rbound) in zip(got, want):
        assert bound == rbound, tau
        assert abs(err - rerr) <= BOUND_RTOL * abs(rerr), (tau, err, rerr)
        assert err <= bound, tau
    assert converged(got)


def test_bound_check_cli(capsys):
    port_bound_check.main(["--rounds", "21", "--device", "cpu", "--mode",
                           "client_sequential"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "tau,measured_err2,thm31_bound,within"
    assert [line.split(",")[0] for line in lines[1:]] == ["0", "10", "20"]
    assert all(line.endswith("True") for line in lines[1:])


def test_scheme_coefficients_match_on_the_bound_check_draws():
    """The f32 coefficients behind expected_coeff_stats: the port's on CPU
    tensors equal the reference's jnp arrays."""
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(6))
    for _ in range(20):
        s = np.maximum(rng.binomial(4, 0.6, size=6), 0)
        for scheme in "ABC":
            np.testing.assert_array_equal(
                port_agg.scheme_coefficients(scheme, p, s, 4).numpy(),
                np.asarray(ref_agg.scheme_coefficients(
                    scheme, jnp.asarray(p), jnp.asarray(s), 4)))
