"""Resume across the two packages: a run saved by the reference resumes in
the port, and a run saved by the port resumes in the reference.

For the logreg and the CNN, in plan and device mode, on the reference's
resume scenario (every event kind; an Arrival with a brand-new client and
an including Departure pending at the cut, ``tests/test_checkpoint_resume.py``):

- the reference runs 6 rounds and saves; the port restores that
  checkpoint (the CNN with ``model_kind="cnn"``: the reference's files
  carry no kind) and runs 6 more;
- the port runs 6 rounds and saves; the reference restores and runs on.

Each resumed run's round records (tau, s bit for bit, eta, n_active,
event, the eval rounds) equal the other package's uninterrupted 12-round
run, its eval losses are within 1e-5 of it and its params within
PARAM_TOL (the resumed half: see test_the_uncut_runs_draw_the_same_rounds
for why the uncut runs are held to each other's records only).  In device mode the port draws from the reference's s-law
table (ROADMAP Limits item 3).  Tolerances, not equality: the two
packages sum their f32 products in other orders.  The logreg runs at
eta0 0.5, as tests/test_torch_trainer.py's: at the reference test's eta0
1.0 the arrival round's LR restart (eta 1.0) moves one round of the port
6.66 PARAM_TOLs from the reference's from the same params, and moves the
reference with only its summation order changed (features permuted)
10.7-15.5 from itself (tools/resume_drift.py; ROADMAP Limits item 6), so
no resume, of either package, could be held to PARAM_TOL there.

A bank-backed checkpoint crosses too: a prefetching scheduler of either
package writes fed-checkpoint-v2 (one chunk per client) with ``bank`` and
``prefetch`` in its config, and the other package restores it with both
rebuilt; the resumed records equal the saver's uncut run's.
"""
import numpy as np
import pytest
import torch

import repro_torch.fed.engine as port_engine
from repro_torch.configs.paper import EMNIST_CNN as PORT_CNN
from repro_torch.configs.paper import SYNTHETIC_LR as PORT_LR
from repro_torch.fed import StreamScheduler
from repro_torch.models.small import make_loss_fn
from repro_torch.params import from_jax, to_numpy
from test_torch_checkpoint import (CUT, EVAL_EVERY, ROUNDS, SCENARIOS,
                                   events, port_client, port_scheduler,
                                   ref_scheduler)
from test_torch_trainer import PARAM_TOL, port_eval, ref_eval


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside the other test workers, a pool of
    threads per process oversubscribes the cores, and its idle threads
    spin, slowing every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOSS_RTOL = 1e-5
# (model, sampling mode); the logreg at eta0 0.5 (see the docstring)
CASES = [(model, mode) for model in ("logreg", "cnn")
         for mode in ("plan", "device")]
ETA0 = {"logreg": 0.5, "cnn": 0.05}
PORT_CFG = {"logreg": PORT_LR, "cnn": PORT_CNN}


def reference(model, mode):
    """The reference's scheduler on the scenario's arrays, from the
    reference's init_small(PRNGKey(0)), and those initial params."""
    import jax
    import repro.fed as ref_fed
    from repro.configs.paper import PAPER_CONFIGS
    from repro.core.participation import TRACES as RTRACES
    from repro.models.small import init_small, make_loss_fn as rloss

    cfg = PAPER_CONFIGS[PORT_CFG[model].name]
    _, clients, newcomer, capacity, nmax, B, _ = SCENARIOS[model]

    def client(a):
        return ref_fed.Client(x=a["x"], y=a["y"], trace=RTRACES[a["trace"]],
                              x_test=a["x_test"], y_test=a["y_test"])
    init = init_small(jax.random.PRNGKey(0), cfg)
    return ref_fed.StreamScheduler(
        clients=[client(a) for a in clients()], init_params=init,
        loss_fn=rloss(cfg), eval_fn=ref_eval(cfg), capacity=capacity,
        max_samples=nmax, local_epochs=5, batch_size=B, scheme="C",
        eta0=ETA0[model], seed=0, mode=mode, chunk_size=4,
        events=events(ref_fed, RTRACES, client(newcomer()))), \
        {k: np.asarray(v) for k, v in init.items()}


def port(model, mode, init):
    from repro_torch.core.participation import TRACES
    import repro_torch.fed as port_fed
    cfg = PORT_CFG[model]
    _, clients, newcomer, capacity, nmax, B, _ = SCENARIOS[model]
    clients = [port_client(a) for a in clients()]
    engine = port_engine.RoundEngine(
        loss_fn=make_loss_fn(cfg), clients=clients, local_epochs=5,
        batch_size=B, scheme="C", eta0=ETA0[model], capacity=capacity,
        max_samples=nmax, device="cpu", model_kind=cfg.kind)
    return StreamScheduler(
        clients=clients, init_params=from_jax(init, cfg, "cpu"),
        engine=engine, mode=mode, eval_fn=port_eval(cfg), seed=0,
        events=events(port_fed, TRACES, port_client(newcomer())))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{m}-{s}" for m, s in CASES])
def runs(request, tmp_path_factory):
    """Both packages' uncut runs and both resumed runs of one case."""
    from repro.fed import StreamScheduler as RefScheduler
    from repro.fed.engine import trace_cdf_row
    from repro.models.small import make_loss_fn as rloss
    from repro.configs.paper import PAPER_CONFIGS

    model, mode = request.param
    cfg = PORT_CFG[model]
    tmp = tmp_path_factory.mktemp(f"{model}-{mode}")
    with pytest.MonkeyPatch.context() as mp:
        # device mode: the port draws from the reference's s-law table
        mp.setattr(port_engine, "trace_cdf_row", trace_cdf_row)
        ref_uncut, init = reference(model, mode)
        ref_uncut.run(ROUNDS, eval_every=EVAL_EVERY)
        port_uncut = port(model, mode, init)
        port_uncut.run(ROUNDS, eval_every=EVAL_EVERY)

        ref_cut, _ = reference(model, mode)
        ref_cut.run(CUT, eval_every=EVAL_EVERY)
        assert ref_cut.pending == 2
        ref_cut.save(str(tmp / "by-reference"))
        in_port = StreamScheduler.restore(
            str(tmp / "by-reference"), loss_fn=make_loss_fn(cfg),
            model_kind=cfg.kind, eval_fn=port_eval(cfg), device="cpu")
        in_port.run(ROUNDS - CUT, eval_every=EVAL_EVERY)

        port_cut = port(model, mode, init)
        port_cut.run(CUT, eval_every=EVAL_EVERY)
        assert port_cut.pending == 2
        port_cut.save(str(tmp / "by-port"))
        rcfg = PAPER_CONFIGS[cfg.name]
        in_reference = RefScheduler.restore(
            str(tmp / "by-port"), loss_fn=rloss(rcfg),
            eval_fn=ref_eval(rcfg))
        in_reference.run(ROUNDS - CUT, eval_every=EVAL_EVERY)
    return dict(cfg=cfg, ref_uncut=ref_uncut, port_uncut=port_uncut,
                in_port=in_port, in_reference=in_reference)


def assert_records_equal(got, want):
    assert len(got) == len(want) == ROUNDS
    for a, b in zip(got, want):
        assert (a.tau, a.eta, a.n_active, a.event) == \
            (b.tau, b.eta, b.n_active, b.event)
        np.testing.assert_array_equal(np.asarray(a.s), np.asarray(b.s))
        assert np.isnan(a.loss) == np.isnan(b.loss)
        if not np.isnan(a.loss):
            np.testing.assert_allclose(a.loss, b.loss, rtol=LOSS_RTOL)
    # the newcomer takes the next client id, the founding clients' count
    founding = len(got[0].s) - 2
    assert "".join(h.event for h in got) == (
        "trace-shift:0;burst:1,2@2;departure-exclude:3;"
        f"arrival:{founding};departure-include:1;")


def test_the_reference_resumes_in_the_port(runs):
    """Saved by the reference at tau 6, run to tau 12 by the port: the
    reference's uncut records, params within PARAM_TOL (in the port's
    layout, compared in the reference's)."""
    res, want = runs["in_port"], runs["ref_uncut"]
    assert_records_equal(res.history, want.history)
    got = to_numpy(res.params, runs["cfg"])
    for k, v in want.params.items():
        np.testing.assert_allclose(got[k], np.asarray(v), err_msg=k,
                                   **PARAM_TOL)
    assert res.objective == want.objective
    assert res.slot_of == want.slot_of
    assert res.departed == want.departed
    assert res.lr_shift_tau == want.lr_shift_tau
    assert res.events_applied == want.events_applied


def test_the_port_resumes_in_the_reference(runs):
    """Saved by the port at tau 6 (the CNN HWIO on disk), run to tau 12 by
    the reference: the port's uncut records, params within PARAM_TOL."""
    res, want = runs["in_reference"], runs["port_uncut"]
    assert_records_equal(res.history, want.history)
    want_params = to_numpy(want.params, runs["cfg"])
    for k, v in want_params.items():
        np.testing.assert_allclose(np.asarray(res.params[k]), v, err_msg=k,
                                   **PARAM_TOL)
    assert res.objective == want.objective
    assert res.slot_of == want.slot_of
    assert res.events_applied == want.events_applied


def test_the_uncut_runs_draw_the_same_rounds(runs):
    """The two packages' uncut runs, what the resumes are held against:
    equal round records (s, eta, n_active, events, eval rounds).  Their
    params are not held to each other: free-running, every round's update
    differs by ~1e-6 of itself (f32 order) and the rounds amplify it; by
    tau 12 in device mode to 15.8 PARAM_TOLs (logreg) and 6,710 (the CNN,
    where a ReLU or max-pool switches), in plan mode 0.13 and 0.037, and
    the reference with only its summation order changed drifts as far
    from itself (5.3-35.5 and 18,977 in device mode; tools/resume_drift.py,
    ROADMAP Limits item 6).  Each resume above starts from the other
    package's state at the cut, so it meets PARAM_TOL."""
    for a, b in zip(runs["port_uncut"].history, runs["ref_uncut"].history,
                    strict=True):
        assert (a.tau, a.eta, a.n_active, a.event) == \
            (b.tau, b.eta, b.n_active, b.event)
        np.testing.assert_array_equal(np.asarray(a.s), np.asarray(b.s))
        assert np.isnan(a.loss) == np.isnan(b.loss)


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_bank_checkpoints_cross_the_packages(tmp_path, saver):
    """The reference's resume scenario (logreg, plan mode) with prefetch on,
    cut at tau 6 and saved by one package (v2 by default), restored by the
    other with its bank and stager rebuilt, run to tau 12: the records of
    the saver's uncut run, the pending newcomer a prefetch hit."""
    import json
    from repro.fed import StreamScheduler as RefScheduler
    from repro.configs.paper import SYNTHETIC_LR as RCFG
    from repro.models.small import make_loss_fn as rloss

    build = ref_scheduler if saver == "reference" else port_scheduler
    uncut = build("plan")
    uncut.run(ROUNDS, eval_every=EVAL_EVERY)
    cut = build("plan", prefetch=True)
    cut.run(CUT, eval_every=EVAL_EVERY)
    cut.save(str(tmp_path / "c"))
    cut.close()
    manifest = json.loads((tmp_path / "c" / "fed_manifest.json").read_text())
    assert manifest["format"] == "fed-checkpoint-v2"
    assert manifest["config"]["bank"] is True
    assert manifest["config"]["prefetch"] is True
    assert len(manifest["client_chunks"]) == len(cut.clients)
    if saver == "reference":      # its scheduler evaluates nothing
        res = StreamScheduler.restore(
            str(tmp_path / "c"), loss_fn=make_loss_fn(PORT_LR),
            device="cpu")
    else:
        res = RefScheduler.restore(str(tmp_path / "c"), loss_fn=rloss(RCFG),
                                   eval_fn=ref_eval(RCFG))
    assert res.bank is not None and res._stager is not None
    assert len(res.bank) == len(cut.clients)
    res.run(ROUNDS - CUT, eval_every=EVAL_EVERY)
    res.close()
    for a, b in zip(res.history, uncut.history, strict=True):
        assert (a.tau, a.eta, a.n_active, a.event) == \
            (b.tau, b.eta, b.n_active, b.event)
        np.testing.assert_array_equal(np.asarray(a.s), np.asarray(b.s))
        assert np.isnan(a.loss) == np.isnan(b.loss)
    stats = res.prefetch_stats()
    assert (stats["hits"], stats["misses"]) == (1, 0)
