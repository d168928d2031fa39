"""Supervised recovery of the port's FederationService under injected
faults (``repro_torch.fed.service`` with ``repro_torch.fed.faults``), on
the CPU: the eight cases of ``tests/test_chaos.py``, each held bit for bit
against the port's own run without faults.

Per-round randomness folds tau into a never-split key, so a rollback and
replay is indistinguishable from never crashing: records (tau, event,
eta, s) and final params must be the fault-free run's exactly.  The soak
(worker crash, worker hang found by the watchdog, mid-span scheduler
crash, snapshot write failure, snapshot corruption, a 256-event stale
flood, in one 32-round run) reuses the engine in every recovery, as
``fed_serve --chaos`` does.  Timeouts are the reference's or shorter
(``span_timeout`` at most 2 s, ``backoff0`` 0.01 s).
"""
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.benchmarks.reference import reference_init
from repro_torch.checkpoint import CorruptCheckpointError
from repro_torch.configs.paper import SYNTHETIC_LR as CFG
from repro_torch.core.participation import TRACES
from repro_torch.data import synthetic_federation
from repro_torch.fed import (Client, Fault, FaultPlan, FederationService,
                             InjectedFault, StreamScheduler, TraceShift)
from repro_torch.fed.faults import corrupt_file
from repro_torch.models.small import make_loss_fn

NO_EVAL = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (tests/test_torch_bank.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_clients(n=4, seed=0):
    train, test = synthetic_federation(0.5, 0.5, n, seed=seed)
    return [Client(x=tr[0], y=tr[1], trace=TRACES[0],
                   x_test=te[0], y_test=te[1])
            for tr, te in zip(train, test)]


def make_scheduler(**kw):
    return StreamScheduler(
        clients=make_clients(), init_params=reference_init(CFG, "cpu"),
        loss_fn=make_loss_fn(CFG), capacity=6, max_samples=600,
        local_epochs=5, batch_size=6, scheme="C", eta0=1.0, seed=0,
        mode="device", chunk_size=4, device="cpu", model_kind=CFG.kind,
        **kw)


def supervised(sch, tmpdir, **kw):
    eng = sch.engine
    defaults = dict(span_rounds=4, supervise=True,
                    snapshot_dir=str(tmpdir), snapshot_every=1,
                    keep_snapshots=4, backoff0=0.01, join_timeout=10.0,
                    engine_factory=lambda: eng,
                    restore_kwargs=dict(loss_fn=make_loss_fn(CFG)))
    defaults.update(kw)
    return FederationService(sch, **defaults)


def assert_bitexact(ref, live):
    assert len(ref.history) == len(live.history)
    for r1, r2 in zip(ref.history, live.history):
        assert (r1.tau, r1.event, r1.eta) == (r2.tau, r2.event, r2.eta)
        np.testing.assert_array_equal(r1.s, r2.s)
    assert ref.params.keys() == live.params.keys()
    for k, v in ref.params.items():
        assert torch.equal(v, live.params[k]), k


def test_acceptance_soak_every_fault_site_one_run(tmp_path):
    """Worker crash, worker hang (watchdog), mid-span scheduler crash,
    snapshot write failure, snapshot corruption and a 256-event stale
    flood in one 32-round run, and the service still produces the
    fault-free trajectory bit for bit."""
    ref = make_scheduler()
    ref.run(32, eval_every=NO_EVAL)

    plan = FaultPlan([
        Fault("worker", 1, "crash"),
        Fault("worker", 4, "hang", seconds=30.0),
        Fault("sched_span", 6, "crash"),
        Fault("ckpt_save", 3, "io-error"),
        Fault("ckpt_written", 5, "corrupt", size=16),
        Fault("flood", 2, "flood", size=256),
    ], seed=7)
    sch = make_scheduler(injector=plan)
    svc = supervised(sch, tmp_path, max_rounds=32, span_timeout=2.0,
                     queue_policy="merge-stale", max_queue=64)
    with svc:
        assert svc.wait_rounds(32, timeout=300), svc.stats()
    rep = svc.chaos_report()

    fired_sites = {site for site, _, _ in rep["faults"]["fired"]}
    assert fired_sites == {"worker", "sched_span", "ckpt_save",
                           "ckpt_written", "flood"}
    assert rep["n_recoveries"] >= 3          # crash, watchdog, mid-span
    assert rep["snapshot_failures"] >= 1     # the io-error was absorbed
    assert rep["events_merged"] == 256       # the flood never hit history
    assert rep["mttr_max_s"] < 60
    causes = " ".join(r["cause"] for r in rep["recoveries"])
    assert "Timeout" in causes               # the hang died by watchdog
    assert all(r["engine_reused"] for r in rep["recoveries"])
    assert all("InjectedFault" in r["cause"] or "TimeoutError" in r["cause"]
               for r in rep["recoveries"])
    assert svc.scheduler.engine is sch.engine
    assert_bitexact(ref, svc.scheduler)


def test_corrupt_newest_snapshot_falls_back(tmp_path):
    """Corrupt the snapshot written right before a crash: recovery must
    detect it (checksum), skip to the older epoch, recompute the lost
    span, and still land bit-exact."""
    ref = make_scheduler()
    ref.run(16, eval_every=NO_EVAL)

    # save #0 is the gen-0 base; span k writes save #k+1: corrupting
    # ckpt_written #2 poisons the newest snapshot (tau=8) exactly when
    # worker #2 crashes before span 2 runs
    plan = FaultPlan([
        Fault("ckpt_written", 2, "corrupt", size=16),
        Fault("worker", 2, "crash"),
    ], seed=11)
    sch = make_scheduler(injector=plan)
    svc = supervised(sch, tmp_path, max_rounds=16)
    with svc:
        assert svc.wait_rounds(16, timeout=180), svc.stats()
    rep = svc.chaos_report()

    assert rep["n_recoveries"] == 1
    rec = rep["recoveries"][0]
    assert len(rec["corrupt_skipped"]) == 1  # newest snapshot rejected
    assert rec["tau_at_failure"] == 8
    assert rec["tau_resumed"] == 4           # older epoch, one span back
    assert rep["recovered_rounds"] == 4
    assert_bitexact(ref, svc.scheduler)


def test_journal_replays_events_lost_with_the_snapshot(tmp_path):
    """Events ingested after the last snapshot survive a crash: they are
    journaled at ingest and replayed onto the restored state."""
    ref = make_scheduler()
    ref.push(TraceShift(5, client_id=0, trace=TRACES[3]))
    ref.run(12, eval_every=NO_EVAL)

    plan = FaultPlan([Fault("worker", 2, "crash")], seed=0)
    sch = make_scheduler(injector=plan)
    # snapshot_every huge: the gen-0 base snapshot (tau=0) is the only one
    # on disk, so recovery must re-derive everything from the journal
    svc = supervised(sch, tmp_path, max_rounds=12, snapshot_every=10 ** 6)
    svc.submit(TraceShift(5, client_id=0, trace=TRACES[3]))
    with svc:
        assert svc.wait_rounds(12, timeout=180), svc.stats()
    rep = svc.chaos_report()

    assert rep["n_recoveries"] == 1
    rec = rep["recoveries"][0]
    assert rec["tau_resumed"] == 0           # rolled back to the base
    assert rec["events_replayed"] == 1       # ...but kept the news
    assert_bitexact(ref, svc.scheduler)
    assert any("shift" in h.event for h in svc.scheduler.history)


def test_watchdog_frees_a_hung_worker(tmp_path):
    """A worker stuck mid-span trips the span watchdog; the supervisor
    abandons the wedged generation (its span lock is never coming back)
    and a fresh worker finishes the job."""
    ref = make_scheduler()
    ref.run(12, eval_every=NO_EVAL)
    plan = FaultPlan([Fault("worker", 1, "hang", seconds=120.0)], seed=0)
    sch = make_scheduler(injector=plan)
    svc = supervised(sch, tmp_path, max_rounds=12, span_timeout=1.5)
    t0 = time.monotonic()
    with svc:
        assert svc.wait_rounds(12, timeout=120), svc.stats()
    assert time.monotonic() - t0 < 100       # did not sit out the hang
    rep = svc.chaos_report()
    assert rep["n_recoveries"] == 1
    assert "Timeout" in rep["recoveries"][0]["cause"]
    assert rep["recoveries"][0]["detect_latency_s"] >= 0.0
    assert svc.generation == 1
    assert_bitexact(ref, svc.scheduler)


def test_gives_up_after_max_restarts(tmp_path):
    """A fault that returns on every restart must not retry forever: after
    max_restarts consecutive failures the supervisor surfaces the error."""
    plan = FaultPlan([Fault("worker", k, "crash") for k in range(16)],
                     seed=0)
    sch = make_scheduler(injector=plan)
    svc = supervised(sch, tmp_path, max_rounds=32, max_restarts=3)
    svc.start()
    with pytest.raises(RuntimeError, match="worker died") as err:
        svc.wait_rounds(32, timeout=60)
    assert isinstance(err.value.__cause__, InjectedFault)
    with pytest.raises(RuntimeError, match="worker died"):
        svc.stop(wait=True, timeout=30)
    assert len(svc.recoveries) == 3              # tried, tried, tried
    assert svc.scheduler._next_tau == 0          # every span crashed


def test_recovery_without_engine_factory_rebuilds(tmp_path):
    """No pooled engine offered: recovery rebuilds one on the old engine's
    device (slower, still bit-exact)."""
    ref = make_scheduler()
    ref.run(8, eval_every=NO_EVAL)

    plan = FaultPlan([Fault("worker", 1, "crash")], seed=0)
    sch = make_scheduler(injector=plan)
    svc = supervised(sch, tmp_path, max_rounds=8, engine_factory=None)
    with svc:
        assert svc.wait_rounds(8, timeout=180), svc.stats()
    rep = svc.chaos_report()
    assert rep["n_recoveries"] == 1
    assert not rep["recoveries"][0]["engine_reused"]
    assert svc.scheduler.engine is not sch.engine
    assert svc.scheduler.engine.device.type == "cpu"
    assert_bitexact(ref, svc.scheduler)


def test_snapshot_retention_prunes_disk(tmp_path):
    """keep_snapshots bounds disk: old epochs (and their journal prefix)
    are dropped as new snapshots land."""
    sch = make_scheduler()
    svc = supervised(sch, tmp_path, max_rounds=24, keep_snapshots=2)
    with svc:
        assert svc.wait_rounds(24, timeout=180)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("snap-"))
    assert len(kept) <= 2
    assert svc.stats()["snapshots_kept"] == len(kept)


def test_manual_corruption_detected_at_load(tmp_path):
    """Byte-flip a persisted fed checkpoint: the manifest checksum gate
    refuses it with CorruptCheckpointError instead of resuming garbage."""
    sch = make_scheduler()
    sch.run(4, eval_every=NO_EVAL)
    path = str(tmp_path / "ckpt")
    sch.save(path)
    StreamScheduler.restore(path, loss_fn=make_loss_fn(CFG),
                            device="cpu")                 # loads fine
    rng = np.random.default_rng(0)
    corrupt_file(os.path.join(path, "fed_checkpoint.npz"), rng)
    with pytest.raises(CorruptCheckpointError):
        StreamScheduler.restore(path, loss_fn=make_loss_fn(CFG),
                                device="cpu")
