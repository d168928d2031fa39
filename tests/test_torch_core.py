"""The port's own copies of the reference's numpy-only modules give the
reference's results: the participation traces draw the same stream from
one seed, the data generators build the same arrays, and the arrival and
departure rules decide alike."""
import numpy as np
import pytest
import torch

from repro.core import arrivals, departures, participation
from repro.data import images
from repro_torch.core import arrivals as port_arrivals
from repro_torch.core import departures as port_departures
from repro_torch.core import participation as port_participation
from repro_torch.data import images as port_images


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def test_traces_are_the_reference_table():
    assert [(t.name, t.mean, t.stdev, t.p_inactive)
            for t in port_participation.TRACES] == \
        [(t.name, t.mean, t.stdev, t.p_inactive)
         for t in participation.TRACES]


@pytest.mark.parametrize("E", [1, 5])
def test_sample_s_consumes_the_rng_like_the_reference(E):
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(20):
        for pt, rt in zip(port_participation.TRACES, participation.TRACES):
            assert pt.sample_s(a, E) == rt.sample_s(b, E)
            np.testing.assert_array_equal(pt.sample_s(a, E, size=(3,)),
                                          rt.sample_s(b, E, size=(3,)))
    assert a.random() == b.random()        # the streams stay in step


def test_data_generators_match_reference():
    x, y = port_images.make_class_dataset(12, 15, seed=3)
    rx, ry = images.make_class_dataset(12, 15, seed=3)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    got = port_images.label_sorted_partition(x, y, 5, seed=4)
    want = images.label_sorted_partition(x, y, 5, seed=4)
    for part, rpart in zip(got, want):
        for (gx, gy), (wx, wy) in zip(part, rpart):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_arrival_and_departure_rules_match_reference():
    for tau in range(0, 12):
        for tau0 in range(0, tau + 1):
            assert port_arrivals.staircase_lr(0.3, tau, tau0) == \
                arrivals.staircase_lr(0.3, tau, tau0)
            assert port_arrivals.RebootState(tau0, 1, 3.0).coeff_multiplier(
                tau) == arrivals.RebootState(tau0, 1, 3.0).coeff_multiplier(
                    tau)
    terms = dict(D=5.0, V=20.0, gamma=10.0, E=5)
    for T, tau0, gamma_l in [(120, 60, 1.0), (65, 60, 5.0), (300, 10, 0.1),
                             (61, 60, 50.0)]:
        assert port_departures.should_exclude(
            T, tau0, port_departures.BoundTerms(**terms), gamma_l) == \
            departures.should_exclude(T, tau0, departures.BoundTerms(**terms),
                                      gamma_l)
