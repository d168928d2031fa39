"""The names the port's core and scheduler took from the reference beside
the scenario library: ``core/participation.{sample_alpha, assign_traces,
BernoulliParticipation}``, ``core/arrivals.{shift_weights_arrival,
reboot_radius}``, ``core/departures.{crossing_round,
shift_weights_departure}``, ``ClientTask.init_params``/``param_specs``,
and ``StreamScheduler``'s engine-building constructor, its views, the
reference's arguments it now takes (``telemetry``, ``bank``,
``prefetch``, ``injector``) and its refusals of what is not ported yet."""
import numpy as np
import pytest
import torch

from repro.core import arrivals, departures, participation
from repro.fed.task import ArrayTask as RefArrayTask
from repro_torch.configs.paper import SYNTHETIC_LR
from repro_torch.core import arrivals as port_arrivals
from repro_torch.core import departures as port_departures
from repro_torch.core import participation as port_participation
from repro_torch.fed import (ArrayTask, ClientTask, RoundEngine,
                             StreamScheduler)
from repro_torch.fed.scenarios import (_paper_eval_fn, make_scenario,
                                       scenario_init)
from repro_torch.models.small import make_loss_fn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = [0, 1, 7, 12345]
E = 4     # tests/test_arrivals_departures.py's E


@pytest.mark.parametrize("seed", SEEDS)
def test_samplers_draw_the_reference_stream(seed):
    """sample_alpha, assign_traces and BernoulliParticipation: equal bit for
    bit to the reference's from equal generator states, and the generators
    left in equal states."""
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for E_ in (1, 5, 8):
        traces = [port_participation.TRACES[i % 8] for i in range(20)]
        rtraces = [participation.TRACES[i % 8] for i in range(20)]
        got = port_participation.sample_alpha(a, traces, E_)
        want = participation.sample_alpha(b, rtraces, E_)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert [t.name for t in port_participation.assign_traces(a, 50, 3)] \
            == [t.name for t in participation.assign_traces(b, 50, 3)]
        for q in (0.1, 0.5, 0.9):
            np.testing.assert_array_equal(
                port_participation.BernoulliParticipation(q).sample_alpha(
                    a, 30, E_),
                participation.BernoulliParticipation(q).sample_alpha(
                    b, 30, E_))
    assert a.random() == b.random()


def test_the_reference_participation_assertions_hold_for_the_port():
    """tests/test_participation.py's assertions on these names, run on the
    port's copies."""
    rng = np.random.default_rng(1)
    alpha = port_participation.sample_alpha(
        rng, [port_participation.TRACES[i % 8] for i in range(20)], E=5)
    assert alpha.shape == (20, 5)
    assert (np.diff(alpha, axis=1) <= 0).all()
    rng = np.random.default_rng(0)
    names = {t.name for t in port_participation.assign_traces(rng, 50, 3)}
    assert names <= {t.name for t in port_participation.TRACES[:3]}
    s = port_participation.BernoulliParticipation(0.3).sample_alpha(
        np.random.default_rng(5), 3000, 8).sum(axis=1)
    assert abs(s.mean() - 8 * 0.3) < 0.3
    assert abs(s.var() - 8 * 0.3 * 0.7) < 0.5


def test_weight_shifts_and_radius_match_reference():
    for n in (np.array([100.0, 200.0, 100.0]), np.arange(1.0, 9.0),
              np.array([40.0])):
        for n_l in (1.0, 100.0, 517.0):
            got = port_arrivals.shift_weights_arrival(n, n_l)
            np.testing.assert_array_equal(
                got, arrivals.shift_weights_arrival(n, n_l))
        for idx in range(len(n) if len(n) > 1 else 0):
            np.testing.assert_array_equal(
                port_departures.shift_weights_departure(n, idx),
                departures.shift_weights_departure(n, idx))
    for args in [(1.0, 0.2, 1.0, 2.0, 0.5, 3.0), (0.3, 0.05, 0.0, 1.0, 1.0,
                                                  1.0),
                 (5.0, 1.0, 9.0, 10.0, 0.1, 0.01), (0.0, 0.0, 0.0, 1.0, 1.0,
                                                    0.0)]:
        assert port_arrivals.reboot_radius(*args) == \
            arrivals.reboot_radius(*args)


def test_crossing_round_matches_reference():
    """On tests/test_arrivals_departures.py's terms (E 4), and that file's
    trend assertions on the port's copy."""
    terms = dict(D=5.0, V=20.0, gamma=10.0, E=E)
    pt, rt = port_departures.BoundTerms(**terms), departures.BoundTerms(
        **terms)
    for T, tau0, gamma_l in [(2000, 50, 0.5), (2000, 50, 5.0),
                             (2000, 20, 1.0), (2000, 200, 1.0),
                             (500, 10, 1.0), (500, 499, 1.0), (60, 59, 50.0)]:
        assert port_departures.crossing_round(T, tau0, pt, gamma_l) == \
            departures.crossing_round(T, tau0, rt, gamma_l)
    small = port_departures.crossing_round(2000, 50, pt, gamma_l=0.5)
    large = port_departures.crossing_round(2000, 50, pt, gamma_l=5.0)
    assert small is not None and large is not None and large >= small
    early = port_departures.crossing_round(2000, 20, pt, gamma_l=1.0)
    late = port_departures.crossing_round(2000, 200, pt, gamma_l=1.0)
    assert (late - 200) >= (early - 20)
    n = np.array([100.0, 200.0, 100.0])
    w = port_arrivals.shift_weights_arrival(n, 100.0)
    np.testing.assert_allclose(w.sum(), 1.0)
    np.testing.assert_allclose(w[-1], 0.2)
    np.testing.assert_allclose(port_departures.shift_weights_departure(n, 1),
                               [0.5, 0.5])


def test_task_init_params_and_specs():
    """ClientTask.init_params raises, param_specs replicates (None);
    ArrayTask(init_fn=) draws through it and, without one, raises the
    reference's error."""
    with pytest.raises(NotImplementedError):
        ClientTask().init_params(0)
    assert ClientTask().param_specs({"w": 1}) is None
    loss = make_loss_fn(SYNTHETIC_LR)
    bare = ArrayTask(loss, (60,))
    ref_bare = RefArrayTask(None, (60,))
    for task in (bare, ref_bare):
        with pytest.raises(NotImplementedError,
                           match="ArrayTask built without init_fn"):
            task.init_params(0)
    assert bare.param_specs({}) is None
    task = ArrayTask(loss, (60,), init_fn=lambda s: scenario_init(s, "cpu"))
    got = task.init_params(1)
    want = scenario_init(1, "cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k])


def _scheduler(sc, **kw):
    return StreamScheduler(
        clients=sc.clients, init_params=scenario_init(sc.seed, "cpu"),
        eval_fn=_paper_eval_fn(), seed=sc.seed, events=sc.events, **kw)


@pytest.mark.parametrize("mode", ["device", "plan"])
def test_built_engine_equals_a_given_one(mode):
    """StreamScheduler(engine=None, loss_fn=..., ...) builds the engine the
    caller would have built: equal geometry, and a few rounds of churn
    (bursts, an auto departure, an arrival) on the int8 wire give equal
    records, delta norms and params."""
    sc = make_scenario("churn", n_clients=4, n_rounds=8, burst_every=2,
                       seed=2)
    geometry = dict(capacity=sc.capacity, max_samples=sc.max_samples,
                    local_epochs=sc.local_epochs, batch_size=sc.batch_size,
                    scheme=sc.scheme, eta0=sc.eta0, agg="tree",
                    compression="int8", with_metrics=True)
    engine = RoundEngine(loss_fn=make_loss_fn(SYNTHETIC_LR),
                         clients=sc.clients, device="cpu",
                         model_kind="logreg", **geometry)
    given = _scheduler(sc, engine=engine, mode=mode)
    built = _scheduler(sc, loss_fn=make_loss_fn(SYNTHETIC_LR), mode=mode,
                       chunk_size=4, device="cpu", model_kind="logreg",
                       **geometry)
    assert built.engine is not engine
    assert built.engine_config() == given.engine_config()
    assert built.eta0 == given.eta0 == sc.eta0
    a, b = given.run(8, eval_every=3), built.run(8, eval_every=3)
    assert "".join(h.event for h in a) == "".join(h.event for h in b)
    for x, y in zip(a, b, strict=True):
        assert (x.tau, x.eta, x.n_active, x.event) == \
            (y.tau, y.eta, y.n_active, y.event)
        np.testing.assert_array_equal(x.s, y.s)
        np.testing.assert_array_equal([x.loss, x.acc], [y.loss, y.acc])
    assert given.delta_norms == built.delta_norms
    for k in given.params:
        assert torch.equal(given.params[k], built.params[k])


def test_views_read_the_state():
    sc = make_scenario("flash-crowd", n_rounds=6, arrive_at=2, stay=2,
                       seed=0)
    sch = _scheduler(sc, loss_fn=make_loss_fn(SYNTHETIC_LR), device="cpu",
                     capacity=sc.capacity, max_samples=sc.max_samples,
                     eta0=sc.eta0, mode="plan")
    sch.run(4, eval_every=2)
    st = sch.state
    assert sch.client_at is st.client_at and sch.free_slots is st.free_slots
    assert sch.reboots is st.reboots and sch.rng is st.rng
    assert sch._queue is st.queue and sch._next_tau == st.next_tau == 4
    np.testing.assert_array_equal(sch.data_weights(), st.data_weights())
    assert len(sch._queue) == sch.pending > 0
    # six founding clients and the four crowd members of taus 2 and 3
    assert sorted(sch.client_at) == list(range(10))
    assert sorted(sch.free_slots) == [10, 11]


REFUSED = [("interpret", True, "jax-only"), ("donate", True, "jax-only")]


@pytest.mark.parametrize("name,value,item", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_unported_arguments_are_refused(name, value, item):
    """Each of the reference's arguments the port has not ported is
    refused by name unless null, by the scheduler and by build_scheduler
    (where the reference's takes it)."""
    from repro_torch.fed.scenarios import build_scheduler
    sc = make_scenario("staggered", n_rounds=4, seed=0)
    with pytest.raises(ValueError, match=f"{name}=.*{item}"):
        _scheduler(sc, loss_fn=make_loss_fn(SYNTHETIC_LR), device="cpu",
                   **{name: value})
    if name == "interpret":
        with pytest.raises(ValueError, match=f"{name}=.*{item}"):
            build_scheduler(sc, device="cpu", **{name: value})
    # the null defaults pass
    _scheduler(sc, loss_fn=make_loss_fn(SYNTHETIC_LR), device="cpu",
               capacity=sc.capacity, max_samples=sc.max_samples,
               **{name: None if value is not True else False})


ACCEPTED = ["telemetry", "bank", "prefetch", "log_spans"]


@pytest.mark.parametrize("name", ACCEPTED)
def test_ported_arguments_are_accepted(name):
    """The reference's telemetry, bank, prefetch and log_spans arguments
    are taken by the scheduler and by build_scheduler (where the
    reference's takes them: not log_spans), and do what they name: the
    scheduler and the engine it builds share the telemetry (which counts
    the spans), a bank holds every client, prefetch adds a stager that
    serves the arrivals, log_spans logs one entry per recomputation of the
    span arguments; the records are those of a run without them."""
    from repro_torch.fed.scenarios import build_scheduler
    from repro_torch.obs import Telemetry
    sc = make_scenario("staggered", n_rounds=4, spacing=2, seed=0)
    plain = build_scheduler(sc, device="cpu")
    plain.run(4, eval_every=2)
    value = Telemetry() if name == "telemetry" else True
    schedulers = [_scheduler(sc, loss_fn=make_loss_fn(SYNTHETIC_LR),
                             device="cpu", capacity=sc.capacity,
                             max_samples=sc.max_samples, eta0=sc.eta0,
                             **{name: value})]
    if name != "log_spans":
        schedulers.append(build_scheduler(sc, device="cpu", **{name: value}))
    for sch in schedulers:
        sch.run(4, eval_every=2)
        sch.close()
        assert [(h.tau, h.event, h.n_active) for h in sch.history] == \
            [(h.tau, h.event, h.n_active) for h in plain.history]
        if name == "telemetry":
            assert sch.engine.telemetry is sch.telemetry
            assert sch.telemetry.registry.get("sched_spans_total") \
                .labels().value > 0
            assert sch.prefetch_stats() == {}
        elif name == "log_spans":
            assert plain.span_log is None
            # one entry at tau 0, one per boundary that applied events
            taus = [t for t, _, _, _ in sch.span_log]
            assert taus[0] == 0 and taus == sorted(set(taus))
            assert taus[1:] == [h.tau for h in sch.history if h.event]
            for tau, p, active, lr_shift in sch.span_log:
                assert p.shape == active.shape == (sc.capacity,)
                assert lr_shift <= tau
        else:
            assert len(sch.bank) == len(sch.clients)
            assert (sch._stager is not None) is (name == "prefetch")
            assert sch.engine_config()[name] is True
        if name == "prefetch":
            assert sch.prefetch_stats()["hits"] > 0


@pytest.mark.parametrize("mode", ["device", "plan"])
def test_injector_tears_the_scheduler_where_the_references_tears(mode):
    """StreamScheduler(injector=) consults the plan at "sched_span" at the
    top of every span iteration of run(): a crash at the third leaves the
    port's scheduler torn as the reference's is (the spans already run
    flushed into the history, next_tau stale, the crash's own boundary's
    events not applied), and a later run() resumes from the torn state
    with the reference's records."""
    import repro.fed as ref_fed
    from repro.fed import scenarios as ref_scenarios
    from repro_torch.fed import Fault, FaultPlan, InjectedFault
    from repro_torch.fed.scenarios import build_scheduler

    def torn(sch, pkg_fault):
        with pytest.raises(pkg_fault):
            sch.run(8, eval_every=4)
        torn_at = (len(sch.history), sch._next_tau, sch.events_applied)
        sch.run(8, eval_every=4)
        return torn_at, [(h.tau, h.event, h.n_active) for h in sch.history]

    sc = make_scenario("staggered", n_rounds=8, spacing=2, seed=0)
    port = build_scheduler(sc, device="cpu", mode=mode)
    port.injector = FaultPlan([Fault("sched_span", 2, "crash")])
    ref = ref_scenarios.build_scheduler(
        ref_scenarios.make_scenario("staggered", n_rounds=8, spacing=2,
                                    seed=0), mode=mode)
    ref.injector = ref_fed.FaultPlan([ref_fed.Fault("sched_span", 2,
                                                    "crash")])
    got, want = torn(port, InjectedFault), torn(ref, ref_fed.InjectedFault)
    assert got == want
    assert got[0][0] > 0 and got[0][1] == 0   # flushed, clock stale
    assert port.injector.fired == [("sched_span", 2, "crash")]
