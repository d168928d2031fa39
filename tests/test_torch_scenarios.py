"""The port's scenario library and its CLI against the reference's
(``repro_torch.fed.scenarios``, ``repro_torch.launch.fed_stream``).

- Every generator at seeds 0, 1, 3 and 4, and at the non-default knobs of
  the reference's own tests, builds the reference's scenario: the same
  signature, every client's arrays bit for bit (founding and arriving),
  the same traces, capacity, rounds, sample bound and notes.
- ``scenario_init.npz`` holds the reference's ``init_small(PRNGKey(s))``
  for every committed seed, and ``build_scheduler`` refuses any other.
- The legs of ``tests/test_stream.py``'s scenario tests, on the port.
- Each scenario cut short (SHORT: at most 12 rounds, every event kind of
  the scenario still firing), in device mode with the reference's s-law
  table (ROADMAP Limits item 3) and in plan mode, teacher-forced: before
  every round the reference's params are copied into the port.  Round
  records (s bit for bit), ``events_applied`` and ``clients_end`` equal,
  each round's params within PARAM_TOL, eval losses within LOSS_RTOL,
  and the scheduler's views equal after the run.  Each runs at the
  scenario's eta0 (1.0) except flash-crowd (SHORT_ETA0): there, at eta0
  1.0, one round of the reference from its own params moves 3.29 (device)
  and 1.16 (plan) PARAM_TOLs when only its f32 summation order changes,
  and the port's 3.79 (tools/scenario_drift.py; ROADMAP Limits item 6),
  so no package could be held to PARAM_TOL there; at 0.5 the port lies
  within 0.10 and the reordered reference within 0.22.  Free-running
  params are not held to each other: at eta0 1.0 both packages drift from
  any reordering of their f32 sums.
- A ``fed_stream --save-state`` of each package, ``--restore``d by the
  other, continues with the records of an uncut run.
- ``fed_stream``'s ``--bank``, ``--prefetch``, ``--metrics-out`` and
  ``--prom-out`` each run and write what they name, the records those of
  the run without them.

Each reference run is computed once per module (module-scoped fixtures).
"""
import json

import numpy as np
import pytest
import torch

import repro_torch.fed.engine as port_engine
from repro_torch.configs.paper import SYNTHETIC_LR
from repro_torch.fed import scenarios as P
from repro_torch.params import from_jax, to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
EVAL_EVERY = 3

# the reference's own tests' knobs (tests/test_stream.py:253,
# tests/test_bank.py:155,188; tests/test_torch_bank.py runs the latter two
# through the port's bank) beside each generator's defaults
GENERATOR_CASES = (
    [(name, seed, {}) for name in P.SCENARIOS for seed in (0, 1, 3, 4)]
    + [("churn", 1, dict(n_clients=6, n_rounds=15)),
       ("rotation", 0, dict(fleet=16, hot=6, n_rounds=24)),
       ("rotation", 1, dict(fleet=10, hot=4))])

# each scenario cut to <= 12 rounds with every event kind it has still
# firing: trace-shift waves, a crowd arriving and departing (excluding),
# two cohorts arriving, bursts plus the auto departure and the
# replacement arrival, and the rotation's including departures, new
# arrivals and client_id rejoins through slots it frees
SHORT = {
    "diurnal": (1, dict(n_clients=6, n_rounds=10, period=4)),
    "flash-crowd": (0, dict(arrive_at=2, stay=4, n_rounds=10)),
    "staggered": (3, dict(spacing=3, n_rounds=10)),
    "churn": (1, dict(n_clients=6, n_rounds=12, burst_every=3,
                      burst_len=2)),
    "rotation": (4, dict(fleet=8, hot=4, dwell=1, n_rounds=12)),
}
# tools/scenario_drift.py: the scenarios whose one-round teacher-forced
# distance, for the reference reordered, passes PARAM_TOL at eta0 1.0 run at
# it; flash-crowd's (its arrival's LR restart at tau 2 in device mode, the
# round after tau 0 in plan mode) does not, and runs at 0.5
SHORT_ETA0 = {"flash-crowd": 0.5}
SHORT_EVENTS = {
    "diurnal": ("trace-shift:",),
    "flash-crowd": ("arrival:", "departure-exclude:"),
    "staggered": ("arrival:",),
    "churn": ("burst:", "departure-", "arrival:"),
    "rotation": ("departure-include:", "arrival:", "rejoin:"),
}
PARITY_CASES = [(name, mode) for name in SHORT for mode in ("device",
                                                             "plan")]


def ref_scenarios():
    from repro.fed import scenarios as R
    return R


def assert_clients_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for attr in ("x", "y", "x_test", "y_test"):
            a, b = getattr(g, attr), getattr(w, attr)
            assert a.dtype == b.dtype, attr
            np.testing.assert_array_equal(a, b, err_msg=attr)
        assert g.trace.name == w.trace.name
        assert (g.trace.mean, g.trace.stdev, g.trace.p_inactive) == \
            (w.trace.mean, w.trace.stdev, w.trace.p_inactive)


@pytest.mark.parametrize(
    "name,seed,knobs", GENERATOR_CASES,
    ids=[f"{n}-{s}" + ("-knobs" if k else "") for n, s, k in GENERATOR_CASES])
def test_generators_build_the_reference_scenarios(name, seed, knobs):
    got = P.make_scenario(name, seed=seed, **knobs)
    want = ref_scenarios().make_scenario(name, seed=seed, **knobs)
    assert got.signature() == want.signature()
    assert_clients_equal(got.clients, want.clients)
    for attr in ("name", "capacity", "n_rounds", "eval_every",
                 "local_epochs", "batch_size", "scheme", "eta0", "seed",
                 "max_samples", "notes"):
        assert getattr(got, attr) == getattr(want, attr), attr
    # the arrivals' payloads and the trace shifts' laws
    for g, w in zip(got.events, want.events, strict=True):
        assert type(g).__name__ == type(w).__name__
        if getattr(w, "client", None) is not None:
            assert_clients_equal([g.client], [w.client])
        if hasattr(w, "trace"):
            assert g.trace.name == w.trace.name


def test_committed_initial_params_are_the_reference_draws():
    import jax
    from repro.configs.paper import SYNTHETIC_LR as RLR
    from repro.models.small import init_small

    seeds = P.committed_seeds()
    assert seeds == list(range(16))
    for seed in seeds:
        want = init_small(jax.random.PRNGKey(seed), RLR)
        got = to_numpy(P.scenario_init(seed, "cpu"), SYNTHETIC_LR)
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    with np.load(P.INIT_FILE) as f:
        about = json.loads(str(f["about"]))
    assert about["command"].endswith("tools/scenario_reference.py")
    assert about["seeds"] == seeds and about["jax"]
    sc = P.make_scenario("diurnal", n_rounds=2, seed=16)
    with pytest.raises(ValueError, match="scenario_reference"):
        P.build_scheduler(sc, device="cpu")


def test_churn_scenario_honest_nan_records():
    """tests/test_stream.py's leg on the port: with eval_every=5 only eval
    rounds and event rounds carry finite loss/acc, and summarize_history
    filters the rest."""
    sc = P.make_scenario("churn", n_clients=6, n_rounds=15, seed=1)
    sch, summary = P.run_scenario(sc, eval_every=5, device="cpu")
    assert len(sch.history) == 15
    for h in sch.history:
        should_eval = h.tau % 5 == 0 or bool(h.event)
        assert np.isfinite(h.loss) == should_eval
        assert np.isfinite(h.acc) == should_eval
    finite = [h for h in sch.history if np.isfinite(h.loss)]
    assert 0 < len(finite) < len(sch.history)
    assert summary["evals"] == len(finite)
    assert np.isfinite(summary["final_loss"])
    accs = [h.acc for h in sch.history if np.isfinite(h.acc)]
    assert np.isfinite(np.mean(accs[-3:]))


def test_scenarios_reproducible_from_seed():
    for name in P.SCENARIOS:
        a = P.make_scenario(name, seed=3)
        b = P.make_scenario(name, seed=3)
        assert a.signature() == b.signature()
        assert len(a.clients) == len(b.clients)
        for ca, cb in zip(a.clients, b.clients):
            np.testing.assert_array_equal(ca.x, cb.x)
            assert ca.trace == cb.trace
        c = P.make_scenario(name, seed=4)
        assert a.signature() != c.signature() or any(
            not np.array_equal(ca.x, cc.x)
            for ca, cc in zip(a.clients, c.clients))


def test_fed_stream_cli(tmp_path, capsys):
    from repro_torch.launch.fed_stream import main as cli_main
    out = tmp_path / "stream.json"
    summary = cli_main(["--scenario", "diurnal", "--rounds", "6",
                        "--eval-every", "3", "--quiet", "--json", str(out),
                        "--device", "cpu"])
    assert json.loads(out.read_text())["rounds"] == summary["rounds"] == 6
    assert summary["rounds_per_sec"] > 0
    assert capsys.readouterr().out == ""
    cli_main(["--scenario", "staggered", "--rounds", "4", "--mode", "plan",
              "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# device cpu"
    assert "tau,loss,acc,eta,n_active,event" in lines
    assert [ln.split(",")[0] for ln in lines[-10:]] == [
        "rounds", "evals", "events_applied", "final_loss", "final_acc",
        "mean_active", "clients_end", "capacity", "wall_s",
        "rounds_per_sec"]


@pytest.mark.parametrize("flag", ["--bank", "--prefetch", "--metrics-out",
                                  "--prom-out"])
def test_fed_stream_runs_the_service_flags(flag, tmp_path, capsys):
    """Each of the reference's service flags runs on the port and writes
    what it names: --bank and --prefetch a "bank" entry in the summary and
    a "# bank:" line (prefetch: every arrival a hit), --metrics-out the
    telemetry JSONL (spans, then one line per metric family), --prom-out
    the Prometheus exposition; the records are the plain run's."""
    from repro_torch.launch.fed_stream import main as cli_main
    common = ["--scenario", "flash-crowd", "--rounds", "10", "--eval-every",
              "4", "--device", "cpu"]
    plain = cli_main(common + ["--quiet"])
    capsys.readouterr()
    out = tmp_path / "out"
    args = [flag] if flag in ("--bank", "--prefetch") else [flag, str(out)]
    summary = cli_main(common + args)
    lines = capsys.readouterr().out.splitlines()
    assert summary["events"] == plain["events"]
    assert summary["final_loss"] == plain["final_loss"]
    if flag in ("--bank", "--prefetch"):
        bank = summary["bank"]["bank"]
        assert bank["clients"] == summary["clients_end"] == 12
        assert any(ln.startswith("# bank: 12 resident") for ln in lines)
        stager = summary["bank"].get("stager")
        assert (stager is not None) is (flag == "--prefetch")
        if stager is not None:
            assert summary["bank"]["hits"] == 6
            assert summary["bank"]["misses"] == 0
            assert stager["stage_errors"] == 0
        assert "bank" not in plain
    elif flag == "--metrics-out":
        recs = [json.loads(ln) for ln in out.read_text().splitlines()]
        spans = {r["name"] for r in recs if r["kind"] == "span"}
        assert {"sched.run_span", "engine.run_span",
                "sched.apply_events", "engine.admit_many"} <= spans
        # a metric line's "kind" is its family's (the reference's dump
        # spreads the family over the line's own "metric")
        metrics = {r["name"]: r for r in recs if r["kind"] != "span"}
        assert metrics["engine_rounds_total"]["kind"] == "counter"
        assert metrics["engine_rounds_total"]["samples"][0]["value"] == 10
        assert f"# telemetry JSONL written to {out}" in lines
    else:
        text = out.read_text()
        assert "engine_rounds_total 10" in text.splitlines()
        assert 'fed_wire_bytes_total{wire="none"}' in text
        assert "# TYPE span_seconds histogram" in text
        assert f"# prom exposition written to {out}" in lines


# -- the scenarios cut short, teacher-forced ----------------------------------

def _numpy(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module", params=PARITY_CASES,
                ids=[f"{n}-{m}" for n, m in PARITY_CASES])
def parity(request):
    """The reference's scheduler and the port's on one short scenario, run
    one round at a time, the port starting each round from the reference's
    params: both schedulers, and each round's params after it."""
    from repro.fed.engine import trace_cdf_row
    R = ref_scenarios()
    name, mode = request.param
    seed, knobs = SHORT[name]
    rsc = R.make_scenario(name, seed=seed, **knobs)
    psc = P.make_scenario(name, seed=seed, **knobs)
    rsc.eta0 = psc.eta0 = SHORT_ETA0.get(name, psc.eta0)
    with pytest.MonkeyPatch.context() as mp:
        # device mode: the port draws from the reference's s-law table
        mp.setattr(port_engine, "trace_cdf_row", trace_cdf_row)
        ref = R.build_scheduler(rsc, mode=mode)
        port = P.build_scheduler(psc, mode=mode, device="cpu")
        ref_after, port_after = [], []
        for _ in range(knobs["n_rounds"]):
            port.params = from_jax(_numpy(ref.params), SYNTHETIC_LR, "cpu")
            ref.run(1, eval_every=EVAL_EVERY)
            port.run(1, eval_every=EVAL_EVERY)
            ref_after.append(_numpy(ref.params))
            port_after.append(to_numpy(port.params, SYNTHETIC_LR))
    return dict(name=name, ref=ref, port=port, ref_after=ref_after,
                port_after=port_after)


def assert_records_equal(got, want, *, losses=True):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.tau, a.eta, a.n_active, a.event) == \
            (b.tau, b.eta, b.n_active, b.event)
        np.testing.assert_array_equal(np.asarray(a.s), np.asarray(b.s))
        assert np.isnan(a.loss) == np.isnan(b.loss)
        assert np.isnan(a.acc) == np.isnan(b.acc)
        if losses and not np.isnan(b.loss):
            np.testing.assert_allclose(a.loss, b.loss, rtol=LOSS_RTOL)
            assert a.acc == b.acc


def test_short_scenario_records_equal_the_reference(parity):
    port, ref = parity["port"], parity["ref"]
    assert_records_equal(port.history, ref.history)
    events = "".join(h.event for h in ref.history)
    for tag in SHORT_EVENTS[parity["name"]]:
        assert tag in events, (tag, events)
    assert port.events_applied == ref.events_applied > 0
    assert len(port.clients) == len(ref.clients)
    summary = P.summarize_history(port.history)
    want = ref_scenarios().summarize_history(ref.history)
    assert summary["events"] == want["events"]
    assert (summary["rounds"], summary["evals"], summary["mean_active"]) == \
        (want["rounds"], want["evals"], want["mean_active"])


def test_short_scenario_teacher_forced_params(parity):
    """Each round of the port from the reference's params lands within
    PARAM_TOL of the reference's round."""
    for tau, (got, want) in enumerate(zip(parity["port_after"],
                                          parity["ref_after"],
                                          strict=True)):
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, err_msg=f"{k} tau={tau}",
                                       **PARAM_TOL)


def test_short_scenario_views_equal_the_reference(parity):
    """The scheduler's control-plane views after the run: slots, free list,
    reboots, RNG state, round clock, pending queue, data weights."""
    port, ref = parity["port"], parity["ref"]
    assert port.client_at == ref.client_at
    assert port.slot_of == ref.slot_of
    assert list(port.free_slots) == list(ref.free_slots)
    assert port.objective == ref.objective
    assert port.departed == ref.departed
    assert port.lr_shift_tau == ref.lr_shift_tau
    assert [(r.tau0, r.client_idx, r.boost) for r in port.reboots] == \
        [(r.tau0, r.client_idx, r.boost) for r in ref.reboots]
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state
    assert port._next_tau == ref._next_tau
    assert [(t, s, type(e).__name__) for t, s, e in port._queue] == \
        [(t, s, type(e).__name__) for t, s, e in ref._queue]
    np.testing.assert_array_equal(port.data_weights(), ref.data_weights())
    assert port.eta0 == ref.eta0


# -- checkpoints across the packages, through the CLIs ------------------------

CUT, AFTER = 7, 5       # flash-crowd: arrivals at 6 applied, 7-8 pending


@pytest.fixture(scope="module")
def crossover(tmp_path_factory):
    """flash-crowd through both CLIs (device mode, the port on the CPU with
    the reference's s-law table): each package's run cut at CUT and saved,
    resumed by the other for AFTER rounds; the port's uncut run.  Every
    run saves its end state, whose history the tests read."""
    from repro.fed.engine import trace_cdf_row
    from repro.launch.fed_stream import main as ref_main
    from repro_torch.launch.fed_stream import main as port_main
    tmp = tmp_path_factory.mktemp("fed-stream")
    common = ["--scenario", "flash-crowd", "--eval-every", "3", "--quiet"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_engine, "trace_cdf_row", trace_cdf_row)
        out["ref_cut"] = ref_main(common + ["--rounds", str(CUT),
                                            "--save-state",
                                            str(tmp / "ref-cut")])
        out["in_port"] = port_main(common + [
            "--restore", str(tmp / "ref-cut"), "--rounds", str(AFTER),
            "--device", "cpu", "--save-state", str(tmp / "in-port")])
        out["port_cut"] = port_main(common + [
            "--rounds", str(CUT), "--device", "cpu", "--save-state",
            str(tmp / "port-cut")])
        out["in_ref"] = ref_main(common + [
            "--restore", str(tmp / "port-cut"), "--rounds", str(AFTER),
            "--save-state", str(tmp / "in-ref")])
        out["port_uncut"] = port_main(common + [
            "--rounds", str(CUT + AFTER), "--device", "cpu",
            "--save-state", str(tmp / "port-uncut")])
    return tmp, out


def _history(path):
    from repro_torch.checkpoint.io import load_fed_checkpoint
    from repro_torch.fed.stream import history_from_dict
    _, _, history, _, _ = load_fed_checkpoint(str(path))
    return history_from_dict(history)


@pytest.mark.parametrize("resumed,cut", [("in-port", "ref-cut"),
                                         ("in-ref", "port-cut")])
def test_checkpoints_resume_across_the_packages(crossover, resumed, cut):
    """The resumed run carries the saver's rounds unchanged and continues
    with the uncut run's records (s bit for bit, events, eval rounds); its
    resumed rounds' losses are finite (free-running after the cut, they are
    not held to a tolerance: ROADMAP Limits item 6)."""
    tmp, out = crossover
    got, saved = _history(tmp / resumed), _history(tmp / cut)
    uncut = _history(tmp / "port-uncut")
    assert len(saved) == CUT and len(got) == len(uncut) == CUT + AFTER
    for a, b in zip(got[:CUT], saved):
        assert (a.tau, a.eta, a.n_active, a.event) == \
            (b.tau, b.eta, b.n_active, b.event)
        np.testing.assert_array_equal([a.loss, a.acc], [b.loss, b.acc])
        np.testing.assert_array_equal(a.s, b.s)
    assert_records_equal(got, uncut, losses=False)
    assert all(np.isfinite(h.loss) for h in got[CUT:]
               if h.event or h.tau % 3 == 0)
    events = "".join(h.event for h in got[CUT:])
    assert events == "arrival:8;arrival:9;arrival:10;arrival:11;"
    name = "in_port" if resumed == "in-port" else "in_ref"
    assert out[name]["resumed_from"] == CUT
    assert out[name]["events_applied"] == out["port_uncut"][
        "events_applied"]
    assert out[name]["clients_end"] == out["port_uncut"]["clients_end"]


def test_cli_summaries_have_the_reference_keys(crossover):
    _, out = crossover
    for ref_key, port_key in (("ref_cut", "port_cut"),
                              ("in_ref", "in_port")):
        assert out[port_key].keys() == out[ref_key].keys()
