"""The port's ``fed_serve`` and ``fed_top`` CLIs on the CPU
(``repro_torch.launch.fed_serve``, ``repro_torch.launch.fed_top``).

- A churn trace written by the reference's ``--dump-trace`` is byte for
  byte the port's, each package's ``load_trace`` reads the other's file
  into the same events, and the reference's file replays in the port:
  ``--trace`` gives the records and params of the scenario's own paced
  run.
- ``--chaos 7`` over a short churn run (a worker crash, a hang found by
  the watchdog, a mid-span scheduler crash, a write failure, a corrupt
  snapshot, a flood) recovers to the records and params of the same run
  without ``--chaos``, bit for bit, and prints its ``chaos`` block.
- ``--resume`` of a ``--snapshot`` continues where the snapshot stopped,
  ``--metrics-out`` and ``--prom-out`` write the service's families, and
  ``fed_top.main`` serves with the live view attached.

Every run submits its events at 10^6 a second, so that each lands before
its tau whatever the CPU's speed (at the CLI's default 50 a second a fast
worker runs past the first taus before their events are submitted, and
the records depend on the race).  Records are read back from the
``--snapshot`` checkpoint, which holds the whole history.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_fed_checkpoint
from repro_torch.launch import fed_serve, fed_top

FAST = ["--events-per-sec", "1000000"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (tests/test_torch_bank.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def serve(args, path):
    """fed_serve on the CPU with a final --snapshot at ``path``: (summary,
    history dict, params)."""
    summary = fed_serve.main(args + FAST + ["--device", "cpu", "--quiet",
                                            "--snapshot", str(path)])
    params, _, history, _, _ = load_fed_checkpoint(str(path))
    return summary, history, params


def assert_same_run(got, want):
    _, h1, p1 = got
    _, h2, p2 = want
    for key in ("tau", "eta", "n_active", "s", "event"):
        assert np.array_equal(np.asarray(h1[key]), np.asarray(h2[key])), key
    np.testing.assert_array_equal(np.isnan(h1["loss"]), np.isnan(h2["loss"]))
    assert p1.keys() == p2.keys()
    for k in p1:
        np.testing.assert_array_equal(p1[k], p2[k], err_msg=k)


def test_churn_trace_is_byte_identical_and_replays_in_the_port(tmp_path):
    from repro.launch import fed_serve as ref_serve
    from repro.fed.events import event_to_dict as ref_to_dict
    from repro_torch.fed.events import event_to_dict
    ref_path, port_path = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    for main, path in ((ref_serve.main, ref_path),
                       (fed_serve.main, port_path)):
        out = main(["--scenario", "churn", "--dump-trace", str(path),
                    "--quiet"] + FAST)
        assert out == {"trace": str(path), "events": 6}
    raw = port_path.read_bytes()
    assert raw == ref_path.read_bytes() and raw.count(b"\n") == 6
    # each package reads the other's file into the same events
    from_ref = fed_serve.load_trace(str(ref_path))
    from_port = ref_serve.load_trace(str(port_path))
    assert [at for at, _ in from_ref] == [at for at, _ in from_port]
    for (_, a), (_, b) in zip(from_ref, from_port):
        assert json.dumps(fed_serve._to_jsonable(event_to_dict(a))) == \
            json.dumps(ref_serve._to_jsonable(ref_to_dict(b)))
    # the reference's file replays in the port as the paced scenario
    rounds = ["--scenario", "churn", "--rounds", "20"]
    replayed = serve(rounds + ["--trace", str(ref_path)], tmp_path / "a")
    paced = serve(rounds, tmp_path / "b")
    assert replayed[0]["events_ingested"] == paced[0]["events_ingested"] == 6
    # bursts at 7 and 14, the departure at 15, the arrival at 17 (the
    # bursts at 21 and 28 stay queued)
    assert replayed[0]["events_applied"] == paced[0]["events_applied"] == 4
    assert_same_run(replayed, paced)


def test_chaos_recovers_to_the_run_without_chaos(tmp_path, capsys):
    """--chaos 7 at 32 rounds (8 spans, 4 saves): every site fires, the
    worker crash and the mid-span crash are recovered from snapshots and
    the hang by the watchdog, and the records and params are the run
    without --chaos's."""
    args = ["--scenario", "churn", "--rounds", "32", "--span-timeout", "2"]
    plain = serve(args, tmp_path / "plain")
    chaos = serve(args + ["--chaos", "7", "--chaos-dir",
                          str(tmp_path / "snaps")], tmp_path / "chaos")
    assert_same_run(chaos, plain)
    ch = chaos[0]["chaos"]
    sites = {site for site, _, _ in ch["faults"]["fired"]}
    assert sites == {"worker", "sched_span", "ckpt_save", "ckpt_written",
                     "flood"}
    assert ch["n_recoveries"] >= 3 and ch["snapshot_failures"] >= 1
    causes = [r["cause"] for r in ch["recoveries"]]
    assert all("InjectedFault" in c or "TimeoutError" in c for c in causes)
    assert any("TimeoutError" in c for c in causes)
    assert all(r["engine_reused"] for r in ch["recoveries"])
    assert ch["final_rounds"] == 32 and "chaos" not in plain[0]
    fed_serve.main(args + FAST + ["--device", "cpu", "--chaos", "7",
                                  "--chaos-dir", str(tmp_path / "again")])
    out = capsys.readouterr().out
    assert "# device cpu" in out
    assert f"# chaos: {ch['n_recoveries']} recoveries" in out


def test_resume_metrics_and_fed_top(tmp_path, capsys):
    args = ["--scenario", "flash-crowd", "--rounds", "12"]
    first, _, _ = serve(args, tmp_path / "cut")
    resumed = fed_serve.main(["--resume", str(tmp_path / "cut"), "--rounds",
                              "8", "--device", "cpu", "--quiet"] + FAST)
    assert resumed["rounds_served"] == 8 and resumed["rounds"] == 20
    jsonl, prom = tmp_path / "m.jsonl", tmp_path / "m.prom"
    summary = fed_serve.main(args + FAST + [
        "--device", "cpu", "--quiet", "--metrics-out", str(jsonl),
        "--prom-out", str(prom), "--json", str(tmp_path / "s.json")])
    text = prom.read_text()
    for family in ("svc_spans_total", "svc_events_ingested_total 12",
                   "svc_busy_seconds_total", "svc_ingest_lag_seconds_count",
                   "sched_spans_total"):
        assert family in text, family
    names = {json.loads(line).get("name") for line in
             jsonl.read_text().splitlines()}
    assert {"svc.span", "svc.ingest", "svc_spans_total"} <= names
    assert summary["telemetry"]["spans_recorded"] > 0
    assert json.loads((tmp_path / "s.json").read_text())["rounds"] == 12
    assert summary["events"] == first["events"]
    top = fed_top.main(args + FAST + ["--device", "cpu", "--top-interval",
                                      "0.05"])
    assert top["rounds"] == 12
    assert "fed_top" in capsys.readouterr().out
