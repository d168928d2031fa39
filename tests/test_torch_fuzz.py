"""The port's event-stream fuzzer (``repro_torch.fed.fuzz``) on the CPU,
and the standing jax-vs-torch fuzz leg.

- The legs of ``tests/test_fuzz_invariants.py`` on the port: a seeded
  corpus with every invariant (exact resume, zero rebuilds, weight sanity,
  plan parity), the generator's reproducibility and fresh-arrival order,
  copy-on-shift, the backend matrix (parallel against sequential; the
  int8 wire on either layout and the banked engine; the sharded engine
  over 2 gloo ranks), fuzzed supervised chaos, and the mutation smokes,
  each caught under the reference's invariant name.  The corpus
  thresholds are the reference's (``rounds > 100``, ``events_applied >
  30`` over 30 seeds) scaled to this corpus's seed count.
- New for the port: ``generate_case`` draws the reference's ops for seeds
  0-63; an engine write that reallocates a slot buffer trips
  ``zero-recompile``; ``restore(log_spans=True)`` logs what the uncut
  run logs, and the service keeps logging across a recovery.
- The jax-vs-torch leg: for each seed of CROSS_SEEDS both packages run the
  same case at eta0 0.5 in device mode, the port with the reference's
  s-law table (ROADMAP Limits item 3).  The uninterrupted runs' records
  (s bit for bit), span logs, final membership and ``events_applied`` are
  equal.  Params are teacher-forced: at the start of every ``("run", n)``
  op the port resumes from the reference's ``FedState.to_dict()`` and
  params (``new_scheduler(state=, params=)``, the path ``_execute`` takes
  at a kill) and runs the op, whose params must end within PARAM_TOL of
  the reference's.  Free-running params are not compared (ROADMAP Limits
  item 6).  Over seeds 0-15 the teacher-forced ops lay at most 0.082
  PARAM_TOLs from the reference's, so no wider bound is needed.

Every harness runs on the CPU with one intra-op thread.
"""
import copy
import datetime
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro_torch.fed.engine as port_engine
from repro_torch.configs.paper import SYNTHETIC_LR
from repro_torch.fed import (Fault, FaultPlan, FedState, FederationService,
                             FuzzHarness, InvariantViolation, RoundEngine,
                             StreamScheduler, generate_case,
                             make_backend_pool, run_backend_matrix,
                             run_chaos_corpus, run_corpus, run_fuzz_case)
from repro_torch.fed import fuzz as port_fuzz
from repro_torch.params import from_jax

PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
# seed counts cut to keep this file and test_torch_validate.py within 150 s
# of summed test time on the CPU, never the invariants
CORPUS_SEEDS = range(10)
CROSS_SEEDS = range(4)
SHARDED_SEEDS = range(1)
N_RANKS = 2
NO_EVAL = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (tests/test_torch_bank.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def harness():
    """One warm engine for the module, as the reference's test has."""
    return FuzzHarness(device="cpu")


def test_corpus_passes_all_invariants(harness):
    agg = run_corpus(CORPUS_SEEDS, harness=harness)
    assert agg["cases"] == len(CORPUS_SEEDS)
    # the reference's thresholds over its 30 seeds, scaled to this corpus
    scale = len(CORPUS_SEEDS) / 30
    assert agg["rounds"] > 100 * scale
    assert agg["kills"] > 0                 # some cases kill + restore
    assert agg["resumes"] == agg["kills"]   # every kill resumed
    assert agg["events_applied"] > 30 * scale
    assert all(r["plan_parity"] for r in agg["per_case"])


def test_generator_is_reproducible():
    for seed in (0, 7, 123):
        a = generate_case(seed)
        b = generate_case(seed)
        assert a.seed == b.seed == seed
        assert a.ops == b.ops
        assert a.total_rounds == b.total_rounds
        assert a.n_kills == b.n_kills
    assert generate_case(0).ops != generate_case(1).ops


def test_generator_draws_the_reference_ops():
    """Every seed's op program is the reference's, event dict for event
    dict, so a seed names one interleaving in both packages."""
    from repro.fed.fuzz import generate_case as ref_generate_case
    for seed in range(64):
        got, want = generate_case(seed), ref_generate_case(seed)
        assert got.ops == want.ops, seed
        assert got.total_rounds == want.total_rounds, seed


def test_case_replay_matches_fresh_generation(harness):
    case = generate_case(3)
    fresh = run_fuzz_case(harness, 3)
    replay = run_fuzz_case(harness, 3, case=case)
    assert fresh == replay


def test_generator_fresh_arrival_taus_nondecreasing():
    """Fresh payload arrivals register in application order, so the
    generator's pool-order id model holds only if their taus never
    decrease (the reference's seed 41 once inverted two)."""
    for seed in range(64):
        taus = [op[1]["tau"] for op in generate_case(seed).ops
                if op[0] == "push" and op[1]["kind"] == "arrival"
                and op[1].get("client_id", 0) < 0]
        assert taus == sorted(taus), f"seed {seed}: {taus}"


def test_trace_shift_does_not_mutate_aliased_payload():
    """Copy-on-shift: apply(TraceShift) swaps the registered Client, never
    writes through the payload an Arrival (or a service journal replaying
    it) still holds."""
    from repro_torch.core.participation import TRACES
    from repro_torch.fed import Arrival, TraceShift
    from repro_torch.fed.scenarios import _make_clients

    st = FedState(clients=[], capacity=4)
    payload = _make_clients(1, seed=3)[0]
    original_trace = payload.trace
    st.push(Arrival(0, client=payload))
    assert st.due(0)
    for _, _, e in sorted(st.queue):
        st.apply(e, 0)
    st.queue.clear()
    cid = len(st.clients) - 1
    st.apply(TraceShift(1, client_id=cid, trace=TRACES[0]), 1)
    assert payload.trace is original_trace          # alias untouched
    assert st.clients[cid].trace is TRACES[0]       # state shifted
    # unknown device: no-op, never an IndexError
    assert st.apply(TraceShift(1, client_id=99, trace=TRACES[0]),
                    1) == ("", [])


# -- cross-backend parity ------------------------------------------------------

def test_backend_parity_parallel_vs_sequential(harness):
    """The reference's leg over 3 of its 4 seeds (its rounds threshold
    scaled to them); the module's harness is the client_parallel
    backend."""
    pool = {"client_parallel": harness,
            **make_backend_pool(("client_sequential",), device="cpu")}
    agg = run_backend_matrix(range(3), pool=pool)
    assert agg["cases"] == 3
    assert agg["backends"] == ["client_parallel", "client_sequential"]
    assert agg["rounds"] > 30 * 3 / 4
    assert agg["max_param_err"] < 5e-4


def test_backend_parity_quantized_and_banked_legs(harness):
    """The int8 wire on both layouts and the banked engine with prefetch
    against client_parallel (the module's harness): the records exact,
    int8 within the reference's QUANT_VS_F32 gate; banked bit-exact
    against client_parallel and the two int8 layouts bit-exact against
    each other (one quantization lattice), as the reference asserts."""
    pool = {"client_parallel": harness,
            **make_backend_pool(("quantized", "quantized_sequential",
                                 "banked"), device="cpu")}
    worst = 0.0
    for seed in range(2):
        case = generate_case(seed)
        got = {}
        for name, h in pool.items():
            got[name] = port_fuzz._execute(h, case, mode="device",
                                           honor_kills=False)
            port_fuzz._check_zero_recompile(seed, h)
        for name in ("quantized", "quantized_sequential"):
            worst = max(worst, port_fuzz._check_backend_parity(
                seed, name, got["client_parallel"], got[name],
                atol=port_fuzz.QUANT_VS_F32_ATOL,
                rtol=port_fuzz.QUANT_VS_F32_RTOL))
        for a, b in (("banked", "client_parallel"),
                     ("quantized_sequential", "quantized")):
            assert port_fuzz._check_backend_parity(seed, a, got[b],
                                                   got[a]) == 0.0, (a, b)
    assert 0 < worst < port_fuzz.QUANT_VS_F32_ATOL
    assert pool["banked"].engine is not harness.engine


def test_backend_pool_sharded_requires_sharding():
    with pytest.raises(ValueError, match="sharded"):
        make_backend_pool(("client_parallel", "sharded"), device="cpu")


def _sharded_rank(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.fed import make_fed_sharding
        from repro_torch.fed.fuzz import run_cross_backend_case
        pool = make_backend_pool(("client_parallel", "sharded"),
                                 sharding=make_fed_sharding(), device="cpu")
        stats = run_backend_matrix(SHARDED_SEEDS, pool=pool)
        out = {k: stats[k] for k in ("cases", "rounds", "backends",
                                     "max_param_err")}
        out["events_applied"] = sum(r["events_applied"]
                                    for r in stats["per_case"])
        out["local_slots"] = pool["sharded"].engine.local_slots
        # the reference's planted fault: the sharded engine's slot-0
        # aggregation weight silently scaled by 1.5 (every rank computes
        # the coefficients of the whole capacity, so all ranks agree)
        eng = pool["sharded"].engine
        orig = eng.run_span

        def biased(params, tau_start, n_rounds, *, p, **kw):
            p = torch.as_tensor(p).clone()
            p[0] *= 1.5
            return orig(params, tau_start, n_rounds, p=p, **kw)

        eng.run_span = biased
        try:
            run_cross_backend_case(pool, 0)
            out["caught"] = None
        except InvariantViolation as e:
            out["caught"] = e.invariant
        finally:
            del eng.run_span
        run_cross_backend_case(pool, 0)        # clean engine passes again
        out["clean_after"] = True
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded_ranks(tmp_path_factory):
    """The backend matrix over N_RANKS gloo ranks, once per module."""
    tmp = tmp_path_factory.mktemp("fuzz-ranks")
    mp.spawn(_sharded_rank, nprocs=N_RANKS, join=True,
             args=(N_RANKS, str(tmp / "pg"), str(tmp)))
    out = []
    for r in range(N_RANKS):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def test_sharded_backend_matrix_gloo(sharded_ranks):
    """client_parallel against the engine sharded over 2 gloo ranks: every
    rank walks the unsharded trajectory (records exact, params within the
    backend tolerance), each holding its own half of the slots."""
    assert [r["local_slots"] for r in sharded_ranks] == [range(0, 4),
                                                         range(4, 8)]
    for r in sharded_ranks:
        assert r["cases"] == len(SHARDED_SEEDS)
        assert r["backends"] == ["client_parallel", "sharded"]
        # the reference's thresholds over its 6 seeds, scaled
        scale = len(SHARDED_SEEDS) / 6
        assert r["rounds"] > 40 * scale
        assert r["events_applied"] > 20 * scale
        assert r["max_param_err"] < 5e-4
    assert len({r["max_param_err"] for r in sharded_ranks}) == 1


def test_mutation_sharded_parity_break_is_caught(sharded_ranks):
    """A sharded slot-0 weight x 1.5 trips "backend-parity" on every rank,
    and the same case passes again once the mutation is lifted."""
    for r in sharded_ranks:
        assert r["caught"] == "backend-parity"
        assert r["clean_after"] is True


# -- fuzzed supervised chaos ---------------------------------------------------

def test_chaos_corpus_bitexact(harness):
    """Generated fault plans (crashes, mid-span tears, snapshot bitrot and
    write failures, stale floods) against a supervised FederationService:
    every recovered run is the fault-free service run bit for bit."""
    agg = run_chaos_corpus(range(2), harness=harness)
    assert agg["cases"] == 2
    assert agg["recoveries"] > 0            # the plans actually bite
    assert agg["events_merged"] > 0         # floods actually flood
    assert agg["rounds"] > 15               # the reference's 30 at 4 seeds
    assert agg["mttr_max_s"] < 60.0


def test_mutation_broken_journal_replay_is_caught(harness, monkeypatch):
    """Drop journaling in the service's accept path: replay after a
    recovery misses events, and the cross-check flags "chaos-bitexact"."""
    from repro_torch.fed.fuzz import run_chaos_case

    plan = [Fault("worker", 0, "crash")]

    def mutated(seed):
        return FaultPlan(faults=list(plan), seed=seed)

    seed = 1
    stats = run_chaos_case(harness, seed, plan=mutated(seed))
    assert stats["recoveries"] >= 1

    orig = FederationService._accept

    def no_journal(self, sch, e, count=True):
        journal, self._journal = self._journal, None
        try:
            orig(self, sch, e, count)
        finally:
            self._journal = journal
    monkeypatch.setattr(FederationService, "_accept", no_journal)
    with pytest.raises(InvariantViolation) as ei:
        run_chaos_case(harness, seed, plan=mutated(seed))
    assert ei.value.invariant == "chaos-bitexact"


# -- mutation smoke: a fuzzer that can't fail is not a fuzzer ------------------

def test_mutation_broken_weights_is_caught(harness, monkeypatch):
    """Inflated data weights: weight-sanity (sum p <= 1) fires."""
    orig = FedState.data_weights

    def inflated(self, *a, **kw):
        return np.asarray(orig(self, *a, **kw)) * 1.5
    monkeypatch.setattr(FedState, "data_weights", inflated)
    with pytest.raises(InvariantViolation) as ei:
        run_fuzz_case(harness, 0, check_plan_parity=False)
    assert ei.value.invariant == "weight-sanity"


def test_mutation_broken_resume_is_caught(harness, monkeypatch):
    """The LR-decay anchor skewed on rehydration: exact-resume fires on
    the first seed whose case kills."""
    seed = next(s for s in range(64) if generate_case(s).n_kills > 0)
    orig = FedState.from_dict.__func__

    def skewed(cls, d, *a, **kw):
        st = orig(cls, d, *a, **kw)
        st.lr_shift_tau += 1
        return st
    monkeypatch.setattr(FedState, "from_dict", classmethod(skewed))
    with pytest.raises(InvariantViolation) as ei:
        run_fuzz_case(harness, seed, check_plan_parity=False)
    assert ei.value.invariant == "exact-resume"


@pytest.mark.parametrize("site", ["evict", "commit_burst"])
def test_mutation_reallocating_slot_write_is_caught(site, monkeypatch):
    """A slot write that reallocates a buffer instead of writing in place
    (the s-law table on evict; a data buffer on an admit's commit) trips
    zero-recompile.  A harness of its own: the mutation moves its
    engine's buffers for good."""
    h = FuzzHarness(device="cpu")
    run_fuzz_case(h, 1, check_plan_parity=False)      # clean: passes
    orig = getattr(RoundEngine, site)

    def reallocating(self, *a, **kw):
        if site == "evict":
            self.s_cdf = self.s_cdf.clone()
        else:
            self.data = {k: v.clone() for k, v in self.data.items()}
        return orig(self, *a, **kw)
    monkeypatch.setattr(RoundEngine, site, reallocating)
    with pytest.raises(InvariantViolation) as ei:
        run_fuzz_case(h, 1, check_plan_parity=False)
    assert ei.value.invariant == "zero-recompile"
    assert ("s_cdf" if site == "evict" else "data.x") in str(ei.value)


# -- the span log --------------------------------------------------------------

def test_restore_with_log_spans_logs_as_the_uncut_run(harness, tmp_path):
    """A scheduler saved mid-case and restored with log_spans=True logs
    one entry per recomputation of the span arguments from its first span
    on (one at the cut, where a fresh scheduler recomputes them), and
    after it the uncut run's entries; without log_spans the log stays
    None.  (The uncut logs of the two packages are held equal by the
    jax-vs-torch leg below.)"""
    from repro_torch.models.small import make_loss_fn

    case = generate_case(3)

    def replay(sch, ops):
        for op in ops:
            if op[0] == "push":
                sch.push(op[1])
            elif op[0] == "run":
                sch.run(op[1], eval_every=NO_EVAL)

    sch = harness.new_scheduler("plan", case_seed=3)
    replay(sch, harness.materialize(case)[:5])
    cut = sch.next_tau
    sch.save(str(tmp_path / "c"))
    loss_fn = make_loss_fn(SYNTHETIC_LR)
    plain = StreamScheduler.restore(str(tmp_path / "c"), loss_fn=loss_fn,
                                    device="cpu")
    assert plain.span_log is None
    res = StreamScheduler.restore(str(tmp_path / "c"), loss_fn=loss_fn,
                                  device="cpu", log_spans=True)
    assert res.span_log == []
    replay(res, harness.materialize(case)[5:])
    uncut = harness.new_scheduler("plan", case_seed=3)
    replay(uncut, harness.materialize(case))
    assert res.next_tau == uncut.next_tau == case.total_rounds
    got = res.span_log
    # the uncut run's arguments in force at the cut, then its later entries
    want = [max((e for e in uncut.span_log if e[0] <= cut),
                key=lambda e: e[0])]
    want += [e for e in uncut.span_log if e[0] > cut]
    assert got[0][0] == cut and len(got) == len(want) > 1
    for (t1, p1, a1, l1), (t2, p2, a2, l2) in zip(got[1:], want[1:]):
        assert (t1, l1) == (t2, l2)
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(a1, a2)
    for got_arr, want_arr in zip(got[0][1:3], want[0][1:3]):
        np.testing.assert_array_equal(got_arr, want_arr)
    assert got[0][3] == want[0][3]


def test_service_keeps_logging_after_recovery(harness, tmp_path):
    """A supervised service restores a logging scheduler as a logging one
    (the supervisor passes log_spans on): the recovered scheduler's log
    starts at the snapshot's tau it resumed from."""
    plan = FaultPlan([Fault("worker", 1, "crash")], seed=0)
    sch = harness.new_scheduler("device", case_seed=0, injector=plan)
    svc = FederationService(
        sch, span_rounds=4, max_rounds=12, supervise=True,
        snapshot_dir=str(tmp_path), snapshot_every=1, backoff0=0.01,
        join_timeout=10.0, injector=plan,
        engine_factory=lambda: harness.engine,
        restore_kwargs=dict(loss_fn=harness.loss_fn))
    with svc:
        assert svc.wait_rounds(12, timeout=120), svc.stats()
    rep = svc.chaos_report()
    assert rep["n_recoveries"] == 1
    final = svc.scheduler
    assert final is not sch and final.span_log is not None
    resumed = rep["recoveries"][0]["tau_resumed"]
    assert [t for t, _, _, _ in final.span_log][0] == resumed
    assert len(final.history) == 12


# -- the jax-vs-torch leg ------------------------------------------------------

def _distance(got: dict, want: dict) -> float:
    """max |got - want| / (atol + rtol |want|) over every element, in
    PARAM_TOLs (1 is assert_allclose's edge)."""
    return max(float(np.max(
        np.abs(np.asarray(got[k], np.float64) - np.asarray(v, np.float64))
        / (PARAM_TOL["atol"] + PARAM_TOL["rtol"]
           * np.abs(np.asarray(v, np.float64)))))
        for k, v in want.items())


@pytest.fixture(scope="module")
def cross():
    """Each CROSS_SEEDS case through both packages' harnesses at eta0 0.5
    in device mode, the port drawing from the reference's s-law table:
    the uninterrupted runs, and every run op teacher-forced."""
    from repro.fed import fuzz as ref_fuzz
    from repro.fed.engine import trace_cdf_row

    out = {}
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(port_engine, "trace_cdf_row", trace_cdf_row)
        ref_h = ref_fuzz.FuzzHarness(eta0=0.5)
        port_h = FuzzHarness(eta0=0.5, device="cpu")
        for seed in CROSS_SEEDS:
            case = generate_case(seed)
            port = port_fuzz._execute(port_h, case, mode="device",
                                      honor_kills=False)
            # the reference's uninterrupted run (_execute without kills),
            # with the port resumed from its state at every run op
            forced = []
            sch = ref_h.new_scheduler("device", case_seed=seed)
            for op in ref_h.materialize(case):
                if op[0] == "push":
                    sch.push(op[1])
                elif op[0] == "run":
                    blob = copy.deepcopy(sch.state.to_dict())
                    start = {k: np.asarray(v) for k, v in sch.params.items()}
                    mine = port_h.new_scheduler(
                        "device", state=FedState.from_dict(blob),
                        params=from_jax(start, SYNTHETIC_LR, "cpu"))
                    sch.run(op[1], eval_every=NO_EVAL)
                    mine.run(op[1], eval_every=NO_EVAL)
                    forced.append((
                        port_fuzz._numpy_params(mine.params),
                        {k: np.asarray(v) for k, v in sch.params.items()}))
            ref = {"history": sch.history, "span_log": sch.span_log,
                   "state": sch.state}
            out[seed] = dict(case=case, ref=ref, port=port, forced=forced)
        port_fuzz._check_zero_recompile(-1, port_h)
    return out


@pytest.mark.parametrize("seed", CROSS_SEEDS)
def test_jax_vs_torch_records_equal(cross, seed):
    """The uninterrupted runs of both packages: records (s bit for bit),
    span logs, final membership and events applied are equal."""
    ref, port = cross[seed]["ref"], cross[seed]["port"]
    assert len(port["history"]) == len(ref["history"]) \
        == cross[seed]["case"].total_rounds
    for a, b in zip(port["history"], ref["history"]):
        assert (a.tau, a.event, a.eta, a.n_active) == \
            (b.tau, b.event, b.eta, b.n_active)
        np.testing.assert_array_equal(np.asarray(a.s), np.asarray(b.s))
    assert len(port["span_log"]) == len(ref["span_log"])
    for (t1, p1, a1, l1), (t2, p2, a2, l2) in zip(port["span_log"],
                                                  ref["span_log"]):
        assert (t1, l1) == (t2, l2)
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(a1, a2)
    for attr in ("objective", "departed", "slot_of", "events_applied"):
        assert getattr(port["state"], attr) == getattr(ref["state"], attr)
    assert ref["state"].events_applied > 0


@pytest.mark.parametrize("seed", CROSS_SEEDS)
def test_jax_vs_torch_teacher_forced_params(cross, seed):
    """Each run op of the port, resumed from the reference's state and
    params, ends within PARAM_TOL of the reference's op."""
    forced = cross[seed]["forced"]
    assert len(forced) == sum(op[0] == "run"
                              for op in cross[seed]["case"].ops)
    for i, (got, want) in enumerate(forced):
        assert got.keys() == want.keys()
        assert _distance(got, want) <= 1.0, (seed, i, _distance(got, want))
