"""The port's FederationService (``repro_torch.fed.service``) on the CPU.

- The twelve cases of ``tests/test_service.py`` on the port: concurrent
  ingestion while spans run, backpressure of the bounded inbox,
  pause/resume/drain, the live stream against the same events preloaded
  (records and params bit for bit), a worker error surfacing on the
  control threads, ``stats()``, and the lifecycle's error paths.
- One cross-package leg: the reference's live schedule
  (``tests/test_service.py``'s live-against-preloaded events) submitted to
  the reference's service and to the port's, at eta0 0.5 with the
  reference's s-law table handed to the port (as
  ``tests/test_torch_scenarios.py`` does): every record's (tau, event,
  eta, s) equal, and the params after the first span within PARAM_TOL.
  Free-running params are not compared past it (ROADMAP Limits item 6).
"""
import time

import numpy as np
import pytest
import torch

import repro_torch.fed.engine as port_engine
from repro_torch.benchmarks.reference import reference_init
from repro_torch.configs.paper import SYNTHETIC_LR as CFG
from repro_torch.core.participation import TRACES
from repro_torch.data import synthetic_federation
from repro_torch.fed import (Arrival, Client, Fault, FaultPlan,
                             FederationService, StreamScheduler, TraceShift)
from repro_torch.models.small import make_loss_fn

PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
NO_EVAL = 1 << 30
# the cross-package leg's eta0: at the reference's 1.0 either package's own
# f32 summation order moves its params past PARAM_TOL within a few rounds
CROSS_ETA0 = 0.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (tests/test_torch_bank.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_clients(n=4, seed=0, trace_idx=0):
    train, test = synthetic_federation(0.5, 0.5, n, seed=seed)
    return [Client(x=tr[0], y=tr[1], trace=TRACES[trace_idx],
                   x_test=te[0], y_test=te[1])
            for tr, te in zip(train, test)]


def make_scheduler(seed=0, capacity=6, eta0=1.0):
    return StreamScheduler(
        clients=make_clients(4, seed=seed),
        init_params=reference_init(CFG, "cpu"),
        loss_fn=make_loss_fn(CFG), capacity=capacity, max_samples=600,
        local_epochs=5, batch_size=6, scheme="C", eta0=eta0, seed=seed,
        mode="device", chunk_size=4, device="cpu", model_kind=CFG.kind)


def test_concurrent_ingestion_applies_events():
    """Events submitted while the worker trains land on the scheduler and
    take effect: the main thread is the traffic source, the worker never
    stops spanning."""
    sch = make_scheduler()
    svc = FederationService(sch, span_rounds=2, eval_every=NO_EVAL,
                            max_rounds=None)
    newcomer = make_clients(1, seed=99)[0]
    with svc:
        assert svc.wait_rounds(4, timeout=120)
        # late news (tau=0 already passed): applies at the next boundary
        assert svc.submit(Arrival(0, client=newcomer))
        assert svc.submit(TraceShift(0, client_id=0, trace=TRACES[4]))
        assert svc.drain(timeout=120)
        assert svc.wait_rounds(sch._next_tau + 6, timeout=240)
    assert svc.events_ingested == 2
    assert sch.events_applied == 2
    assert 4 in sch.objective                # newcomer admitted + joined
    slot = sch.slot_of[4]
    assert any(h.s[slot] > 0 for h in sch.history)  # and it trained
    assert sch._next_tau >= 10


def test_backpressure_bounded_inbox():
    sch = make_scheduler()
    svc = FederationService(sch, span_rounds=2, max_pending=2)
    # not started: nothing drains the inbox
    assert svc.submit(TraceShift(1, 0, TRACES[1]), block=False)
    assert svc.submit(TraceShift(2, 0, TRACES[2]), block=False)
    assert not svc.submit(TraceShift(3, 0, TRACES[3]), block=False)
    assert svc.events_submitted == 2
    assert not svc.submit(TraceShift(3, 0, TRACES[3]), timeout=0.05)


def test_pause_resume_and_drain():
    sch = make_scheduler()
    svc = FederationService(sch, span_rounds=2, max_rounds=None)
    with svc:
        assert svc.wait_rounds(2, timeout=120)
        svc.pause()
        frozen = sch._next_tau
        svc.submit(TraceShift(0, client_id=1, trace=TRACES[2]))
        assert svc.drain(timeout=60)         # ingested while paused
        assert svc.events_ingested == 1
        time.sleep(0.05)
        assert sch._next_tau == frozen       # no spans while paused
        svc.resume()
        assert svc.wait_rounds(frozen + 2, timeout=120)
    assert sch.clients[1].trace == TRACES[2]


def live_events(pkg, traces, clients):
    """tests/test_service.py's live schedule, in either package."""
    return [pkg.TraceShift(3, client_id=0, trace=traces[2]),
            pkg.Arrival(5, client=clients(1, seed=7)[0]),
            pkg.Departure(8, client_id=1, policy="exclude")]


def test_live_stream_matches_preloaded_run():
    """Feeding a schedule through the service (submitted ahead of their
    taus) reproduces the trajectory of the same events preloaded into a
    blocking scheduler: the service is pure transport."""
    import repro_torch.fed as port_fed
    pre = make_scheduler()
    pre.push(*live_events(port_fed, TRACES, make_clients))
    pre.run(12, eval_every=NO_EVAL)

    live = make_scheduler()
    svc = FederationService(live, span_rounds=12, eval_every=NO_EVAL,
                            max_rounds=12)
    svc.submit(*live_events(port_fed, TRACES, make_clients))
    with svc:
        assert svc.wait_rounds(12, timeout=240)
    assert len(live.history) == len(pre.history) == 12
    for r1, r2 in zip(pre.history, live.history):
        np.testing.assert_array_equal(r1.s, r2.s)
        assert r1.event == r2.event
    for k, v in pre.params.items():
        assert torch.equal(v, live.params[k]), k


def test_worker_error_surfaces():
    """A raising span must not hang callers: wait_rounds and stop re-raise
    from the worker."""
    sch = make_scheduler(capacity=4)         # no free slots
    svc = FederationService(sch, span_rounds=2, max_rounds=20)
    svc.submit(Arrival(0, client=make_clients(1, seed=3)[0]))
    svc.start()
    with pytest.raises(RuntimeError, match="worker died"):
        svc.wait_rounds(20, timeout=120)
    with pytest.raises(RuntimeError, match="worker died"):
        svc.stop()


def test_stats_shape():
    sch = make_scheduler()
    svc = FederationService(sch, span_rounds=4, max_rounds=4)
    with svc:
        svc.wait_rounds(4, timeout=120)
    st = svc.stats()
    assert st["rounds"] == 4
    assert st["spans_run"] >= 1
    assert st["inbox_depth"] == 0
    assert st["running"] is False
    assert st["prefetch"] == {}              # no bank


# -- lifecycle error paths -----------------------------------------------------

def test_submit_after_stop_raises():
    sch = make_scheduler()
    svc = FederationService(sch, span_rounds=2, max_rounds=2)
    with svc:
        svc.wait_rounds(2, timeout=120)
    with pytest.raises(RuntimeError, match="stopped"):
        svc.submit(TraceShift(0, client_id=0, trace=TRACES[1]))


def test_double_start_is_idempotent_restart_is_not():
    sch = make_scheduler()
    svc = FederationService(sch, span_rounds=2, max_rounds=None)
    svc.start()
    assert svc.start() is svc                # already running: no-op
    assert svc.wait_rounds(2, timeout=120)
    svc.stop()
    with pytest.raises(RuntimeError, match="restarted"):
        svc.start()                          # dead services stay dead


def test_snapshot_while_paused_stays_paused(tmp_path):
    sch = make_scheduler()
    svc = FederationService(sch, span_rounds=2, max_rounds=None)
    with svc:
        assert svc.wait_rounds(2, timeout=120)
        svc.pause()
        frozen = sch._next_tau
        state = svc.snapshot(str(tmp_path / "snap"))  # consistent, paused
        assert state["next_tau"] == frozen
        time.sleep(0.05)
        assert svc.stats()["paused"]         # snapshot didn't resume us
        assert sch._next_tau == frozen
        svc.resume()
        assert svc.wait_rounds(frozen + 2, timeout=120)
    res = StreamScheduler.restore(str(tmp_path / "snap"), device="cpu",
                                  loss_fn=make_loss_fn(CFG))
    assert res._next_tau == frozen


def test_drain_racing_a_dead_worker_raises():
    """drain() must not hang forever when the worker died with the inbox
    non-empty: it re-raises the worker's error instead of spinning."""
    plan = FaultPlan([Fault("worker", k, "crash") for k in range(4)],
                     seed=0)
    sch = make_scheduler()
    sch.injector = plan
    svc = FederationService(sch, span_rounds=2, max_rounds=20)
    svc.start()
    time.sleep(0.2)                          # let the crash land
    svc.submit(TraceShift(0, client_id=0, trace=TRACES[1]))
    with pytest.raises(RuntimeError, match="worker died"):
        svc.drain(timeout=30)                # nobody is draining
    with pytest.raises(RuntimeError, match="worker died"):
        svc.stop()


def test_stop_with_timeout_joins_cleanly():
    sch = make_scheduler()
    svc = FederationService(sch, span_rounds=2, max_rounds=None)
    svc.start()
    assert svc.wait_rounds(2, timeout=120)
    svc.stop(wait=True, timeout=30)          # bounded join, no error
    assert not svc.running


def test_supervise_requires_snapshot_dir():
    with pytest.raises(ValueError, match="snapshot_dir"):
        FederationService(make_scheduler(), supervise=True)
    with pytest.raises(ValueError, match="queue_policy"):
        FederationService(make_scheduler(), queue_policy="bogus")


# -- the live schedule through both packages' services -------------------------

def record_spans(sch, to_numpy):
    """Wrap the scheduler's run() so that each worker span leaves a copy
    of the params after it."""
    spans = []
    run = sch.run

    def recorded(n_rounds, eval_every=1):
        out = run(n_rounds, eval_every=eval_every)
        spans.append(to_numpy(sch.params))
        return out
    sch.run = recorded
    return spans


def test_live_schedule_through_both_services_is_the_references():
    import jax
    import repro.fed as ref_fed
    from repro.core.participation import TRACES as RTRACES
    from repro.data import synthetic_federation as rsynth
    from repro.fed.engine import trace_cdf_row
    from repro.models.small import init_small as rinit
    from repro.models.small import make_loss_fn as rloss
    import repro_torch.fed as port_fed
    from repro_torch.params import to_numpy

    def ref_clients(n=4, seed=0):
        train, test = rsynth(0.5, 0.5, n, seed=seed)
        return [ref_fed.Client(x=tr[0], y=tr[1], trace=RTRACES[0],
                               x_test=te[0], y_test=te[1])
                for tr, te in zip(train, test)]

    ref = ref_fed.StreamScheduler(
        clients=ref_clients(), init_params=rinit(jax.random.PRNGKey(0), CFG),
        loss_fn=rloss(CFG), capacity=6, max_samples=600, local_epochs=5,
        batch_size=6, scheme="C", eta0=CROSS_ETA0, seed=0, mode="device",
        chunk_size=4)
    ref_spans = record_spans(
        ref, lambda p: {k: np.array(v, copy=True) for k, v in p.items()})
    rsvc = ref_fed.FederationService(ref, span_rounds=4, eval_every=NO_EVAL,
                                     max_rounds=12)
    rsvc.submit(*live_events(ref_fed, RTRACES, ref_clients))
    with rsvc:
        assert rsvc.wait_rounds(12, timeout=240)

    with pytest.MonkeyPatch.context() as mp:
        # device mode: the port draws from the reference's s-law table
        mp.setattr(port_engine, "trace_cdf_row", trace_cdf_row)
        port = make_scheduler(eta0=CROSS_ETA0)
        port_spans = record_spans(port, lambda p: {
            k: np.array(v, copy=True) for k, v in to_numpy(p, CFG).items()})
        svc = FederationService(port, span_rounds=4, eval_every=NO_EVAL,
                                max_rounds=12)
        svc.submit(*live_events(port_fed, TRACES, make_clients))
        with svc:
            assert svc.wait_rounds(12, timeout=240)

    assert svc.events_ingested == rsvc.events_ingested == 3
    assert port.events_applied == ref.events_applied == 3
    assert len(port.history) == len(ref.history) == 12
    for a, b in zip(port.history, ref.history):
        assert (a.tau, a.event, a.eta) == (b.tau, b.event, b.eta)
        np.testing.assert_array_equal(np.asarray(a.s), np.asarray(b.s))
    assert "arrival" in "".join(h.event for h in port.history)
    assert len(port_spans) == len(ref_spans) == 3
    for k, want in ref_spans[0].items():
        np.testing.assert_allclose(port_spans[0][k], want, **PARAM_TOL,
                                   err_msg=k)
