"""The port's telemetry plane (``repro_torch.obs``) against the
reference's (``repro.obs``).

- The unit cases of ``tests/test_telemetry.py``: counters and gauges,
  histogram bucket maths, ``observe_many``, the registry's idempotence
  and kind mismatch, the Prometheus text and the snapshot, spans and the
  JSONL export, the tracer ring, span-to-histogram, null inertness.
- ``render_prom`` and ``snapshot`` after the same operations equal the
  reference's byte for byte (label escaping and float formatting
  included).
- ``scheme_mass`` equals the port's own ``scheme_coefficients`` summed,
  and the reference's; a ``FedObserver`` fed the same events and span
  metrics under schemes A, B and C (with and without a tractable
  problem's bound terms) exposes the reference's gauges byte for byte.
- A null-telemetry scheduler run is bit-identical to an uninstrumented
  one and to one with telemetry on.
- After the same short flash-crowd run, the port's families and label
  sets are the reference's, and every counter, gauge and histogram that
  does not time anything is equal (``engine_traces_total`` excepted: the
  reference counts its compiles there, the port compiles nothing); each
  span name is recorded as many times.
- The service and ``fed_top`` cases of ``tests/test_telemetry.py``: a
  service's counters work with the null telemetry (a private registry
  backs ``drain()`` and ``stats()``), and ``FedTop.frame()`` renders
  headlessly against a live service, with and without telemetry.
"""
import json
import math

import numpy as np
import pytest
import torch

from repro_torch.obs import (DEFAULT_BUCKETS, MetricsRegistry, NullTelemetry,
                             Telemetry, Tracer, resolve, scheme_mass)
from repro_torch.obs.telemetry import NULL

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (tests/test_torch_bank.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the metrics registry -------------------------------------------------------

def test_counter_and_gauge_basics():
    reg = MetricsRegistry()
    c = reg.counter("c_total", "a counter")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("g", "a gauge")
    g.set(4)
    g.inc()
    g.dec(2)
    assert g.value == 3.0


def test_histogram_le_inclusive_bucket_math():
    reg = MetricsRegistry()
    h = reg.histogram("h_seconds", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 2.0, 8.0):
        h.observe(v)
    # cumulative, le-inclusive: 1.0 lands in le="1"
    assert h.buckets() == [(1.0, 2), (2.0, 4), (4.0, 4), (math.inf, 5)]
    assert h.count == 5
    assert h.sum == pytest.approx(13.0)
    with pytest.raises(ValueError, match="strictly"):
        reg.histogram("bad_seconds", buckets=(2.0, 1.0))


def test_observe_many_matches_scalar_observe():
    reg = MetricsRegistry()
    a = reg.histogram("a_seconds")
    b = reg.histogram("b_seconds")
    vals = np.abs(np.random.default_rng(0).normal(0.01, 0.05, 500))
    for v in vals:
        a.observe(float(v))
    b.observe_many(vals)
    b.observe_many([])
    assert a.buckets() == b.buckets()
    assert a.sum == pytest.approx(b.sum)
    assert tuple(a.bounds) == DEFAULT_BUCKETS


def test_registry_idempotent_and_kind_mismatch():
    reg = MetricsRegistry()
    c1 = reg.counter("x_total")
    c2 = reg.counter("x_total")
    assert c1 is c2
    with pytest.raises(ValueError):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        reg.counter("x_total", labelnames=("site",))
    fam = reg.counter("y_total", labelnames=("site",))
    assert fam.labels("a") is fam.labels("a")
    assert fam.labels("a") is not fam.labels("b")
    assert fam.labels(site="a") is fam.labels("a")
    with pytest.raises(ValueError, match="expected labels"):
        fam.labels("a", "b")
    assert reg.get("y_total") is fam and reg.get("nope") is None


def test_prom_rendering_roundtrip():
    reg = MetricsRegistry()
    reg.counter("ev_total", "events").inc(3)
    h = reg.histogram("lat_seconds", "latency", labelnames=("name",),
                      buckets=(0.1, 1.0))
    h.labels("run").observe(0.05)
    h.labels("run").observe(0.5)
    h.labels("run").observe(5.0)
    lines = reg.render_prom().splitlines()
    assert "# TYPE ev_total counter" in lines
    assert "ev_total 3" in lines
    assert 'lat_seconds_bucket{name="run",le="0.1"} 1' in lines
    assert 'lat_seconds_bucket{name="run",le="1"} 2' in lines
    assert 'lat_seconds_bucket{name="run",le="+Inf"} 3' in lines
    assert 'lat_seconds_count{name="run"} 3' in lines
    # the snapshot holds the same numbers as plain data (the JSONL sink's)
    snap = reg.snapshot()
    assert snap["ev_total"]["samples"][0]["value"] == 3
    s = snap["lat_seconds"]["samples"][0]
    assert s["labels"] == {"name": "run"} and s["count"] == 3
    json.dumps(snap)
    assert MetricsRegistry().render_prom() == ""


# -- tracing -------------------------------------------------------------------

def test_span_nesting_and_jsonl_export(tmp_path):
    tr = Tracer(capacity=16)
    with tr.span("outer", k=1):
        with tr.span("inner"):
            assert tr.current().name == "inner"
    assert tr.current() is None
    spans = tr.peek(10)
    by_name = {s["name"]: s for s in spans}
    assert by_name["inner"]["parent"] == by_name["outer"]["id"]
    assert by_name["outer"]["parent"] is None
    assert by_name["outer"]["attrs"] == {"k": 1}
    assert all(s["dur_s"] >= 0 for s in spans)
    path = tmp_path / "spans.jsonl"
    assert tr.export_jsonl(str(path)) == 2
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert {x["name"] for x in lines} == {"outer", "inner"}
    assert tr.peek(10) == []              # the export drained the ring
    with pytest.raises(ValueError):
        Tracer(capacity=0)


def test_tracer_ring_drops_oldest():
    tr = Tracer(capacity=2)
    for j in range(5):
        with tr.span(f"s{j}"):
            pass
    assert tr.recorded == 5
    assert tr.dropped == 3
    assert [s["name"] for s in tr.peek(10)] == ["s3", "s4"]
    assert [s["name"] for s in tr.drain()] == ["s3", "s4"]


def test_telemetry_span_feeds_latency_histogram(tmp_path):
    tel = Telemetry()
    with tel.span("work"):
        pass
    h = tel.registry.histogram("span_seconds",
                               labelnames=("name",)).labels("work")
    assert h.count == 1
    path = tmp_path / "dump.jsonl"
    n = tel.dump_jsonl(str(path))
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert n == len(recs) == 2
    assert recs[0]["kind"] == "span" and recs[0]["name"] == "work"
    assert recs[1]["name"] == "span_seconds"
    tel.write_prom(str(tmp_path / "m.prom"))
    assert (tmp_path / "m.prom").read_text() == tel.render_prom()


# -- null telemetry --------------------------------------------------------------

def test_null_telemetry_is_inert(tmp_path):
    tel = resolve(None)
    assert tel is NULL and not tel.enabled
    assert isinstance(tel, NullTelemetry)
    assert tel.registry is None and tel.trace_dir is None
    c = tel.counter("whatever")
    c.inc()
    assert c.value == 0.0
    assert tel.gauge("g").labels("a") is c
    tel.histogram("h").observe_many([1.0, 2.0])
    with tel.span("x", a=1) as span:
        assert span.name == ""
    assert tel.render_prom() == ""
    assert tel.dump_jsonl(str(tmp_path / "x")) == 0
    assert not (tmp_path / "x").exists()
    live = Telemetry()
    assert resolve(live) is live


# -- byte for byte against the reference ------------------------------------------

def exercise(obs):
    """The same operations on a registry of either package: counters,
    labelled families with characters the exposition escapes, gauges of
    awkward floats, histograms of default and custom buckets."""
    reg = obs.MetricsRegistry()
    reg.counter("ev_total", "events ingested").inc(3)
    fam = reg.counter("site_total", "by site", labelnames=("site", "kind"))
    fam.labels("a", "x").inc(2.5)
    fam.labels('quote"back\\slash\nline', "y").inc()
    reg.gauge("g_plain", "a gauge").set(0.1)
    reg.gauge("g_int").set(1e6)
    reg.gauge("g_tiny", "tiny").set(1e-7)
    reg.gauge("g_neg").set(-2.0)
    reg.gauge("rate", "stat", labelnames=("stat",)).labels("min").set(1 / 3)
    h = reg.histogram("lat_seconds", "latency", labelnames=("name",))
    vals = np.abs(np.random.default_rng(1).normal(0.01, 0.2, 300))
    for v in vals[:50]:
        h.labels("run").observe(float(v))
    h.labels("admit").observe_many(vals[50:])
    small = reg.histogram("rounds", buckets=(0.0, 1.0, 2.0, 4.0))
    small.observe_many([0, 0, 1, 3, 9])
    reg.histogram("empty_seconds", "never observed")
    return reg


def test_render_prom_equals_the_reference_byte_for_byte():
    import repro.obs as ref_obs
    import repro_torch.obs as port_obs
    got, want = exercise(port_obs), exercise(ref_obs)
    assert got.render_prom() == want.render_prom()
    assert json.dumps(got.snapshot()) == json.dumps(want.snapshot())


def test_scheme_mass_matches_the_coefficients_and_the_reference():
    from repro.obs import scheme_mass as ref_scheme_mass
    from repro_torch.core.aggregation import scheme_coefficients
    rng = np.random.default_rng(0)
    for _ in range(5):
        p = rng.random(8)
        p /= p.sum()
        s = rng.integers(0, 6, 8).astype(float)
        for scheme in ("A", "B", "C"):
            want = float(scheme_coefficients(
                scheme, torch.tensor(p, dtype=torch.float32),
                torch.tensor(s, dtype=torch.float32), 5).sum())
            got = scheme_mass(scheme, p, s, 5)
            assert got == pytest.approx(want, rel=1e-5)
            assert got == ref_scheme_mass(scheme, p, s, 5)
    assert scheme_mass("A", p, np.zeros(8), 5) == 0.0
    with pytest.raises(ValueError):
        scheme_mass("D", p, s, 5)


def observer_run(pkg, with_problem):
    """A FedObserver of one package fed the same FedState, events and span
    metrics: 6 clients in 8 slots, two spans of random s and eta around a
    departure; its Telemetry's exposition."""
    from test_torch_bank import make_clients
    if pkg is None:
        import repro_torch.fed as fed
        import repro_torch.obs as obs
        from repro_torch.core import theory
    else:
        fed = pkg
        import repro.obs as obs
        from repro.core import theory
    clients = make_clients(6, seed=3, pkg=pkg)
    st = fed.FedState(clients=clients, capacity=8, seed=0)
    tel = obs.Telemetry()
    observer = obs.FedObserver(tel)
    if with_problem:
        rng = np.random.default_rng(3)
        A = [np.diag(rng.uniform(0.5, 2.0, 2)) for _ in range(6)]
        c = [rng.normal(size=2) for _ in range(6)]
        pc, _ = theory.quadratic_problem_constants(A, c, np.full(6, 1 / 6))
        observer.set_problem(pc, theta=0.5)
    rng = np.random.default_rng(7)
    tau = 0
    for span, event in enumerate(
            (fed.TraceShift(0, client_id=1, trace=clients[0].trace),
             fed.Departure(1, client_id=2, policy="exclude"))):
        st.push(event)
        e = st.pop_event()
        st.apply(e, tau + 2)
        observer.observe_event(e, tau + 2)
        R = 3 + span
        m = {"s": rng.integers(0, 6, (R, 8)).astype(np.float32),
             "eta": rng.random(R).astype(np.float32)}
        m["s"][:, 6:] = 0
        for scheme in ("A", "B", "C"):
            observer.observe_span(st, tau, m, scheme, 5)
        tau += R
    return tel.render_prom(), observer.participation()


@pytest.mark.parametrize("with_problem", [False, True],
                         ids=["gauges", "bound"])
def test_fed_observer_equals_the_reference(with_problem):
    import repro.fed as ref_fed
    got, got_part = observer_run(None, with_problem)
    want, want_part = observer_run(ref_fed, with_problem)
    assert got == want
    assert got_part == want_part
    assert "fed_scheme_weight_mass" in got
    assert ('fed_bound{term="value"}' in got) is with_problem


# -- the scheduler -----------------------------------------------------------------

def test_null_telemetry_scheduler_bit_identical():
    """Instrumentation is off the compute path: no telemetry, the null
    object and live telemetry give the same records and params, bit for
    bit."""
    from repro_torch.core.participation import TRACES
    from repro_torch.fed import Arrival, TraceShift
    from test_torch_bank import make_clients, make_scheduler

    def run_one(telemetry):
        clients = make_clients(6, seed=2)
        late = make_clients(8, seed=2)[7]
        sch = make_scheduler(clients, capacity=8, seed=2, telemetry=telemetry,
                             events=[TraceShift(3, client_id=1,
                                                trace=TRACES[0]),
                                     Arrival(5, client=late)])
        sch.run(10, eval_every=4)
        return sch

    plain = run_one(None)
    for tel in (NULL, Telemetry()):
        other = run_one(tel)
        assert len(other.history) == len(plain.history)
        for a, b in zip(plain.history, other.history):
            assert (a.tau, a.event, a.n_active, a.eta) == \
                (b.tau, b.event, b.n_active, b.eta)
            np.testing.assert_array_equal(a.s, b.s)
            np.testing.assert_array_equal([a.loss, a.acc], [b.loss, b.acc])
        for k, v in plain.params.items():
            assert torch.equal(v, other.params[k]), k
    assert other.telemetry.registry.get("fed_rounds_total") \
        .labels().value == 10


def live_flash_crowd(pkg):
    """flash-crowd cut short (tests/test_torch_scenarios.py's SHORT, plan
    mode) with live telemetry and prefetch, through one package's
    build_scheduler; its telemetry's snapshot after the run."""
    from test_torch_scenarios import SHORT
    seed, knobs = SHORT["flash-crowd"]
    if pkg is None:
        from repro_torch.fed import scenarios
        from repro_torch.obs import Telemetry as Tel
        kw = dict(device="cpu")
    else:
        from repro.fed import scenarios
        from repro.obs import Telemetry as Tel
        kw = {}
    tel = Tel()
    sch = scenarios.build_scheduler(
        scenarios.make_scenario("flash-crowd", seed=seed, **knobs),
        mode="plan", telemetry=tel, prefetch=True, **kw)
    sch.run(knobs["n_rounds"], eval_every=3)
    sch.close()
    return tel.registry.snapshot()


def test_families_after_a_flash_crowd_are_the_references():
    import repro.fed as ref_fed
    got, want = live_flash_crowd(None), live_flash_crowd(ref_fed)
    assert got.keys() == want.keys()
    for name, fam in want.items():
        mine = got[name]
        assert (mine["kind"], mine["help"]) == (fam["kind"], fam["help"]), \
            name
        assert [s["labels"] for s in mine["samples"]] == \
            [s["labels"] for s in fam["samples"]], name
        if name == "engine_traces_total":
            assert mine["samples"][0]["value"] == 0
        elif name == "span_seconds":      # times differ; counts do not
            assert [s["count"] for s in mine["samples"]] == \
                [s["count"] for s in fam["samples"]]
        else:
            assert mine["samples"] == fam["samples"], name
    spans = {s["labels"]["name"] for s in got["span_seconds"]["samples"]}
    # every arrival is a prefetch hit (commit_burst): no engine.admit_many
    assert spans == {"sched.apply_events", "sched.run_span",
                     "engine.run_span", "engine.evict"}
    hits = got["sched_prefetch_hits_total"]["samples"][0]["value"]
    assert hits == 6
    wire = got["fed_wire_bytes_total"]["samples"][0]
    assert wire["labels"] == {"wire": "none"} and wire["value"] > 0


def test_trace_dir_writes_a_chrome_trace_of_each_span(tmp_path):
    """Telemetry(trace_dir=) runs each RoundEngine.run_span under
    torch.profiler and writes its Chrome trace into the directory (the
    reference's jax_trace_dir=); spans are still timed and counted."""
    from test_torch_bank import make_clients, make_scheduler
    tel = Telemetry(trace_dir=str(tmp_path / "traces"))
    sch = make_scheduler(make_clients(4, seed=4), capacity=4, mode="plan",
                         telemetry=tel)
    sch.run(3, eval_every=2)
    traces = sorted((tmp_path / "traces").glob("run_span-*.json"))
    assert [p.name for p in traces] == ["run_span-000000-1-0000.json",
                                        "run_span-000001-2-0001.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert tel.registry.get("engine_spans_total").labels().value == 2


# -- the service and fed_top ---------------------------------------------------

NO_EVAL = 1 << 30


def test_service_counters_work_without_telemetry():
    """drain()/stats() rely on functional counters even when the shared
    telemetry is the null object: the service keeps a private
    registry."""
    from repro_torch.core.participation import TRACES
    from repro_torch.fed import TraceShift
    from repro_torch.fed.service import FederationService
    from test_torch_bank import make_clients, make_scheduler
    sch = make_scheduler(make_clients(4, seed=0), seed=0)
    svc = FederationService(sch, span_rounds=2, eval_every=NO_EVAL,
                            max_rounds=8)
    assert not svc.telemetry.enabled
    with svc:
        assert svc.submit(TraceShift(0, client_id=0, trace=TRACES[2]))
        assert svc.drain(timeout=30)
        assert svc.wait_rounds(8, timeout=60)
    st = svc.stats()
    assert st["events_submitted"] == st["events_ingested"] == 1
    rep = svc.chaos_report()
    assert rep["detect_latency_mean_s"] == 0.0
    assert rep["n_recoveries"] == 0
    assert svc._registry.get("svc_spans_total").labels().value \
        == st["spans_run"] >= 4


def test_fed_top_renders_headlessly_against_live_service():
    from repro_torch.fed.service import FederationService
    from repro_torch.launch.fed_top import FedTop
    from test_torch_bank import make_clients, make_scheduler
    tel = Telemetry()
    sch = make_scheduler(make_clients(4, seed=0), seed=0, telemetry=tel)
    svc = FederationService(sch, span_rounds=2, eval_every=NO_EVAL,
                            max_rounds=8)
    with svc:
        svc.wait_rounds(8, timeout=60)
        top = FedTop(svc)
        frame1 = top.frame()
        frame2 = top.frame()              # second frame: rate available
    for needle in ("fed_top", "rounds", "events", "service", "paper",
                   "tau=8"):
        assert needle in frame2, frame2
    assert "r/s" in frame2                # rate needs two frames
    assert frame1.count("\n") >= 6

    # null-telemetry service still renders (registry-backed counters)
    sch2 = make_scheduler(make_clients(4, seed=0), seed=0)
    svc2 = FederationService(sch2, span_rounds=2, eval_every=NO_EVAL,
                             max_rounds=4)
    with svc2:
        svc2.wait_rounds(4, timeout=60)
        frame = FedTop(svc2).frame()
    assert "fed_top" in frame and "paper" not in frame
