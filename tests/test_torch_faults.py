"""The port's fault injection (``repro_torch.fed.faults``) against the
reference's (``repro.fed.faults``).

- ``FaultPlan.generate(seed, ...)`` is the reference's plan, fault for
  fault, for seeds 0-31 with and without the hang, and at other spans,
  saves and flood sizes: a seed names the same chaos in both packages.
- ``Fault``'s and ``FaultPlan``'s validation errors.
- ``fire`` for each kind: crash and io-error raise (``InjectedWriteError``
  is an ``OSError``), a hang stalls until its seconds pass or returns as
  soon as its abort event is set, corrupt flips bytes of the path it is
  given, flood, dup and delay are returned to the caller; counts are per
  site, and the log, ``summary()`` and ``faults_fired_total{site,kind}``
  equal the reference's after the same firings.
- ``corrupt_file`` flips the reference's bytes on copies of one file, and
  a plan's corrupt fault takes the same draws as the reference's plan.
- ``make_flood`` picks the reference's targets from a ``FedState`` of the
  same clients, and leaves the plan's generator where the reference's
  leaves it.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.fed import faults as P
from repro_torch.fed import Fault, FaultPlan, InjectedFault, InjectedWriteError


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = range(32)


def ref_faults():
    from repro.fed import faults
    return faults


def as_tuples(plan):
    return [(f.site, f.at, f.kind, f.size, f.seconds) for f in plan.faults]


@pytest.mark.parametrize("hang", [True, False], ids=["hang", "no-hang"])
def test_generate_equals_the_reference_for_seeds_0_to_31(hang):
    R = ref_faults()
    for seed in SEEDS:
        got = FaultPlan.generate(seed, hang=hang)
        want = R.FaultPlan.generate(seed, hang=hang)
        assert as_tuples(got) == as_tuples(want), seed
        assert got.seed == want.seed == seed
        assert len(got.faults) == (6 if hang else 5)


@pytest.mark.parametrize("kw", [dict(spans=3, saves=1), dict(spans=40,
                                                              saves=20),
                                dict(spans=8, saves=0, flood_size=17,
                                     hang_seconds=2.5)],
                         ids=["short", "long", "knobs"])
def test_generate_equals_the_reference_at_other_knobs(kw):
    R = ref_faults()
    for seed in (0, 7, 31):
        for hang in (True, False):
            assert as_tuples(FaultPlan.generate(seed, hang=hang, **kw)) == \
                as_tuples(R.FaultPlan.generate(seed, hang=hang, **kw))


def test_hang_false_drops_only_the_hang():
    for seed in SEEDS:
        full = as_tuples(FaultPlan.generate(seed))
        assert as_tuples(FaultPlan.generate(seed, hang=False)) == \
            [f for f in full if f[2] != "hang"]


def test_fault_validation_errors():
    with pytest.raises(ValueError, match="unknown fault site"):
        Fault("disk", 0, "crash")
    with pytest.raises(ValueError, match="invalid at site"):
        Fault("ckpt_save", 0, "crash")
    with pytest.raises(ValueError, match="invalid at site"):
        Fault("worker", 0, "flood")
    with pytest.raises(ValueError, match="duplicate fault"):
        FaultPlan([Fault("worker", 1, "crash"), Fault("worker", 1, "hang")])
    assert set(P._KINDS_BY_SITE) == set(ref_faults()._KINDS_BY_SITE)
    assert P._KINDS_BY_SITE == ref_faults()._KINDS_BY_SITE


def test_fire_raises_for_crash_and_io_error():
    plan = FaultPlan([Fault("worker", 1, "crash"),
                      Fault("sched_span", 0, "crash"),
                      Fault("ckpt_save", 2, "io-error")])
    assert plan.fire("worker") is None
    with pytest.raises(InjectedFault, match="worker#1"):
        plan.fire("worker")
    assert plan.fire("worker") is None        # fires once, at its call
    with pytest.raises(InjectedFault, match="sched_span#0"):
        plan.fire("sched_span", tau=0)
    plan.fire("ckpt_save", path="x")
    plan.fire("ckpt_save", path="x")
    with pytest.raises(InjectedWriteError) as err:
        plan.fire("ckpt_save", path="x")
    assert isinstance(err.value, OSError)
    assert plan.fired == [("worker", 1, "crash"), ("sched_span", 0, "crash"),
                          ("ckpt_save", 2, "io-error")]


def test_hang_stalls_until_its_seconds_or_its_abort():
    plan = FaultPlan([Fault("worker", 0, "hang", seconds=0.2),
                      Fault("worker", 1, "hang", seconds=60.0)])
    t0 = time.monotonic()
    f = plan.fire("worker")
    assert f.kind == "hang" and time.monotonic() - t0 >= 0.19
    abort = threading.Event()
    threading.Timer(0.1, abort.set).start()
    t0 = time.monotonic()
    assert plan.fire("worker", abort=abort).kind == "hang"
    assert time.monotonic() - t0 < 10.0       # released, not the 60 s


def test_caller_kinds_are_returned_and_corrupt_flips_the_path(tmp_path):
    path = tmp_path / "blob"
    path.write_bytes(bytes(range(256)) * 4)
    plan = FaultPlan([Fault("flood", 0, "flood", size=9),
                      Fault("ingest", 0, "dup"), Fault("ingest", 1, "delay"),
                      Fault("ckpt_written", 0, "corrupt", size=4),
                      Fault("ckpt_written", 1, "corrupt")], seed=3)
    assert plan.fire("flood").size == 9
    assert plan.fire("ingest").kind == "dup"
    assert plan.fire("ingest").kind == "delay"
    assert plan.fire("ingest") is None
    before = path.read_bytes()
    assert plan.fire("ckpt_written", path=str(path)).kind == "corrupt"
    after = path.read_bytes()
    assert 1 <= sum(a != b for a, b in zip(before, after)) <= 4
    # no path: nothing to corrupt, the fault still fires
    assert plan.fire("ckpt_written").kind == "corrupt"


def fire_script(plan, abort, path):
    """The same firings, in the same order, on a plan of either package."""
    for site, n in (("worker", 3), ("flood", 2), ("ingest", 4),
                    ("ckpt_save", 2), ("sched_span", 2)):
        for _ in range(n):
            try:
                plan.fire(site, abort=abort, path=path, tau=0)
            except (RuntimeError, OSError):
                pass
    plan.fire("ckpt_written", path=path)


def test_log_summary_and_telemetry_equal_the_reference(tmp_path):
    from repro.obs import Telemetry as RTelemetry
    from repro_torch.obs import Telemetry
    R = ref_faults()
    abort = threading.Event()
    abort.set()                               # hangs return at once
    plans = []
    for pkg, tel in ((P, Telemetry()), (R, RTelemetry())):
        path = tmp_path / f"{pkg.__name__}.bin"
        path.write_bytes(b"\x00" * 64)
        plan = pkg.FaultPlan.generate(5, spans=4, saves=2)
        plan.attach_telemetry(tel)
        fire_script(plan, abort, str(path))
        plans.append((plan, tel, path.read_bytes()))
    (got, tel, got_bytes), (want, rtel, want_bytes) = plans
    assert got.summary() == want.summary()
    assert got.fired == want.fired and len(got.fired) >= 4
    assert got_bytes == want_bytes
    prom = [ln for ln in tel.render_prom().splitlines()
            if ln.startswith("faults_fired_total")]
    assert prom and prom == [ln for ln in rtel.render_prom().splitlines()
                             if ln.startswith("faults_fired_total")]


@pytest.mark.parametrize("seed,nbytes", [(0, 16), (7, 1), (11, 64)])
def test_corrupt_file_flips_the_references_bytes(tmp_path, seed, nbytes):
    R = ref_faults()
    raw = np.random.default_rng(99).bytes(4096)
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    a.write_bytes(raw)
    b.write_bytes(raw)
    P.corrupt_file(str(a), np.random.default_rng(seed), nbytes=nbytes)
    R.corrupt_file(str(b), np.random.default_rng(seed), nbytes=nbytes)
    assert a.read_bytes() == b.read_bytes() != raw
    empty = tmp_path / "empty"
    empty.write_bytes(b"")
    P.corrupt_file(str(empty), np.random.default_rng(seed))
    assert empty.read_bytes() == b""


def fed_states():
    """A port and a reference FedState of the same six clients, four of
    them in the objective, on eight slots."""
    import repro.fed as rfed
    from repro.core.participation import TRACES as RTRACES
    from repro.fed.state import FedState as RFedState
    from repro_torch.core.participation import TRACES
    from repro_torch.data import synthetic_federation
    from repro_torch.fed import Client, FedState
    train, _ = synthetic_federation(0.5, 0.5, 6, seed=4)
    objective = {0, 2, 3, 5}
    port = FedState(clients=[Client(x=x, y=y, trace=TRACES[j % 8])
                             for j, (x, y) in enumerate(train)],
                    capacity=8, objective=set(objective))
    ref = RFedState(clients=[rfed.Client(x=x, y=y, trace=RTRACES[j % 8])
                             for j, (x, y) in enumerate(train)],
                    capacity=8, objective=set(objective))
    return port, ref


@pytest.mark.parametrize("size", [1, 5, 256])
def test_make_flood_picks_the_references_targets(size):
    R = ref_faults()
    port, ref = fed_states()
    assert sorted(port.slot_of) == sorted(ref.slot_of)
    got_rng, want_rng = np.random.default_rng(7), np.random.default_rng(7)
    got = P.make_flood(port, size, got_rng)
    want = R.make_flood(ref, size, want_rng)
    assert len(got) == len(want) == size
    assert [(e.tau, e.client_id, e.trace.name) for e in got] == \
        [(e.tau, e.client_id, e.trace.name) for e in want]
    assert all(e.client_id in port.objective for e in got)
    assert all(e.trace == port.clients[e.client_id].trace for e in got)
    # the generators were drawn alike: their next draws agree
    assert got_rng.integers(0, 1 << 30) == want_rng.integers(0, 1 << 30)


def test_make_flood_without_targets_is_empty():
    port, _ = fed_states()
    port.objective.clear()
    assert P.make_flood(port, 8, np.random.default_rng(0)) == []
