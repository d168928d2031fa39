"""The port's theory-scored validator (``repro_torch.fed.validate``) on the
CPU, and its jax-vs-torch leg.

- The six legs of ``tests/test_theory_validator.py`` on the port, and the
  two validator legs of ``tests/test_compression.py`` (int8 and bf16
  corpora held to the same envelope; an over-coarse int8 lattice trips
  the Table-1 ordering).  The mutations patch the coefficient function
  the port's engine calls: ``repro_torch.fed.engine.scheme_coefficients``
  (``RoundEngine._round_core`` reads the module global at every round).
- The jax-vs-torch leg: ``make_quadratic_problem`` and
  ``generate_participation_schedule`` build the reference's arrays and
  events; ``QuadraticRunner.run`` of each scheme on seeds 0 and 1 (the
  port on the CPU with the reference's s-law table, ROADMAP Limits item
  3) dumps the reference's taus, s and p exactly, and errs within
  ERRS_TOL; ``TheoryValidator.score`` of one dump gives the reference's
  bounds and margin within rtol 1e-12 (numpy on both sides).  ERRS_TOL
  is measured: over those 6 runs of 64 rounds the two packages' errs lay
  at most 1.19e-7 apart (one f32 ulp at the largest gap, ~0.87) and at
  most 7.6e-6 apart relative to the smallest, which the bound covers
  with 7x or more to spare; the quadratic contracts, so no amplification
  is expected.

Every runner runs on the CPU with one intra-op thread.
"""
import numpy as np
import pytest
import torch

import repro_torch.fed.engine as port_engine
from repro_torch.core.aggregation import scheme_coefficients
from repro_torch.fed import InvariantViolation
from repro_torch.fed.validate import (QuadraticRunner, TheoryValidator,
                                      generate_participation_schedule,
                                      make_quadratic_problem,
                                      validate_corpus)

ERRS_TOL = dict(rtol=1e-6, atol=1e-7)
CROSS_SEEDS = (0, 1)
ROUNDS = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (tests/test_torch_bank.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runner():
    """One pooled per-scheme engine set for the module."""
    return QuadraticRunner(device="cpu")


def test_validator_corpus_bound_and_ordering(runner):
    agg = validate_corpus(range(2), runner=runner)
    assert agg["cases"] == 2
    # the envelope is loose by construction; a clean run sits far below
    assert agg["max_margin"] < 0.05
    for row in agg["per_case"]:
        assert row["n_events"] >= 2            # schedules actually churn
        # Table-1 ordering with real headroom, not a squeaker
        assert row["tails"]["C"] < 0.6 * row["tails"]["A"]
        assert row["tails"]["C"] < 0.6 * row["tails"]["B"]


def test_quadratic_constants_are_closed_form():
    pr = make_quadratic_problem(seed=3)
    # w* solves sum_k p_k A_k (w - c_k) = 0 for diagonal A_k
    num = (pr.p[:, None] * pr.a_diag * pr.c).sum(0)
    den = (pr.p[:, None] * pr.a_diag).sum(0)
    np.testing.assert_allclose(pr.w_star, num / den, rtol=1e-10)
    assert pr.pc.mu > 0 and pr.pc.L >= pr.pc.mu
    assert pr.G2 > 0 and np.all(np.asarray(pr.pc.sigma2) == 0)


def test_schedule_generator_reproducible():
    a = generate_participation_schedule(5, n_clients=4, rounds=64)
    b = generate_participation_schedule(5, n_clients=4, rounds=64)
    assert repr(a) == repr(b)
    assert 2 <= len(a) <= 6
    assert repr(a) != repr(
        generate_participation_schedule(6, n_clients=4, rounds=64))


def test_observed_stats_feed_the_bound(runner):
    """score() consumes the run's own (p, s) matrix: a positive effective
    rate, and a finite bound trajectory decreasing in tau."""
    dump = runner.run("C", rounds=16, seed=0)
    sc = TheoryValidator(runner.problem).score(dump)
    assert sc["S"] > 0
    assert np.all(np.isfinite(sc["bounds"]))
    assert sc["bounds"][-1] < sc["bounds"][0]
    assert 0.0 <= sc["biased_frac"] <= 1.0


@pytest.mark.parametrize("compression", ["int8", "bf16"])
def test_validator_quantized_corpus_passes(compression):
    """Quantized runs are held to the same envelope and Table-1 ordering
    as f32 (tests/test_compression.py's leg)."""
    agg = validate_corpus(range(1), rounds=48, compression=compression,
                          device="cpu")
    assert agg["cases"] == 1
    assert agg["max_margin"] <= 1.0


# -- mutation smoke: a validator that can't fail validates nothing -------------

def test_mutation_collapsed_scheme_c_is_caught(monkeypatch):
    """Scheme C served B's coefficients (no E/s debias): C lands on B's
    bias plateau and the Table-1 ordering check fires."""
    def collapsed(scheme, p, s, E):
        return scheme_coefficients("B" if scheme == "C" else scheme,
                                   p, s, E)
    monkeypatch.setattr(port_engine, "scheme_coefficients", collapsed)
    with pytest.raises(InvariantViolation) as ei:
        validate_corpus(range(1), runner=QuadraticRunner(device="cpu"))
    assert ei.value.invariant == "scheme-ordering"


def test_mutation_sign_flipped_weights_are_caught(monkeypatch):
    """Mis-signed aggregation drives the iterate away from w*; the gap
    crosses the Theorem 3.1 envelope and the bound check fires."""
    monkeypatch.setattr(
        port_engine, "scheme_coefficients",
        lambda scheme, p, s, E: -scheme_coefficients(scheme, p, s, E))
    runner = QuadraticRunner(device="cpu")
    dump = runner.run("C", rounds=64, seed=0)
    with pytest.raises(InvariantViolation) as ei:
        TheoryValidator(runner.problem).check_bound(dump)
    assert ei.value.invariant == "theory-bound"


def test_mutation_over_coarse_quantization_is_caught():
    """One level per chunk destroys the debiased update's edge: the
    validator trips the Table-1 ordering (tests/test_compression.py's
    leg)."""
    with pytest.raises(InvariantViolation) as ei:
        validate_corpus(range(1), rounds=48, compression="int8:levels=1",
                        device="cpu")
    assert ei.value.invariant == "scheme-ordering"


# -- the jax-vs-torch leg ------------------------------------------------------

def test_problem_and_schedule_equal_the_reference():
    from repro.fed import validate as R
    for seed in (0, 3):
        got, want = make_quadratic_problem(seed=seed), \
            R.make_quadratic_problem(seed=seed)
        for attr in ("a_diag", "c", "n_k", "p", "w_star"):
            np.testing.assert_array_equal(getattr(got, attr),
                                          getattr(want, attr))
        assert got.G2 == want.G2
        assert [t.name for t in got.traces] == [t.name for t in want.traces]
        for attr in ("L", "mu", "G2"):
            assert getattr(got.pc, attr) == getattr(want.pc, attr)
        for attr in ("sigma2", "gamma_k"):
            np.testing.assert_array_equal(getattr(got.pc, attr),
                                          getattr(want.pc, attr))
    for seed in range(8):
        got = generate_participation_schedule(seed, n_clients=4,
                                              rounds=ROUNDS)
        want = R.generate_participation_schedule(seed, n_clients=4,
                                                 rounds=ROUNDS)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert type(g).__name__ == type(w).__name__
            assert g.tau == w.tau
            if hasattr(w, "trace"):
                assert (g.client_id, g.trace.name) == \
                    (w.client_id, w.trace.name)
            else:
                assert (tuple(g.client_ids), g.duration) == \
                    (tuple(w.client_ids), w.duration)


@pytest.fixture(scope="module")
def cross_dumps(runner):
    """Each scheme on CROSS_SEEDS through both packages' runners, the port
    drawing from the reference's s-law table."""
    from repro.fed import validate as R
    from repro.fed.engine import trace_cdf_row
    ref_runner = R.QuadraticRunner()
    out = {}
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(port_engine, "trace_cdf_row", trace_cdf_row)
        for seed in CROSS_SEEDS:
            for scheme in "ABC":
                kw = dict(rounds=ROUNDS, seed=seed)
                want = ref_runner.run(
                    scheme, events=R.generate_participation_schedule(
                        seed, n_clients=4, rounds=ROUNDS), **kw)
                got = runner.run(
                    scheme, events=generate_participation_schedule(
                        seed, n_clients=4, rounds=ROUNDS), **kw)
                out[seed, scheme] = (got, want)
    return out


@pytest.mark.parametrize("seed", CROSS_SEEDS)
def test_jax_vs_torch_dumps(cross_dumps, seed):
    """taus, s and p exactly the reference's; errs within ERRS_TOL."""
    for scheme in "ABC":
        got, want = cross_dumps[seed, scheme]
        assert (got.scheme, got.E, got.seed, got.n_events) == \
            (want.scheme, want.E, want.seed, want.n_events)
        np.testing.assert_array_equal(got.taus, want.taus)
        np.testing.assert_array_equal(got.s, want.s)
        np.testing.assert_array_equal(got.p, want.p)
        np.testing.assert_allclose(got.errs, want.errs, **ERRS_TOL,
                                   err_msg=scheme)


def test_jax_vs_torch_score(cross_dumps, runner):
    """score() of one dump, in each package, gives the same bounds and
    margin (numpy on both sides: rtol 1e-12)."""
    from repro.fed import validate as R
    _, dump = cross_dumps[0, "C"]
    got = TheoryValidator(runner.problem).score(dump)
    want = R.TheoryValidator(R.make_quadratic_problem()).score(dump)
    np.testing.assert_allclose(got["bounds"], want["bounds"], rtol=1e-12)
    np.testing.assert_allclose(got["margin"], want["margin"], rtol=1e-12)
    np.testing.assert_allclose(got["S"], want["S"], rtol=1e-12)
    assert got["biased_frac"] == want["biased_frac"]
    for attr in ("D", "V", "gamma", "E"):
        np.testing.assert_allclose(getattr(got["terms"], attr),
                                   getattr(want["terms"], attr), rtol=1e-12)
