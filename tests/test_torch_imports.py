"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``
or the port's tools: ``tools/weighted_agg_quant_turns.py``,
``tools/paper_drift.py``, ``tools/batch_invariance.py``,
``tools/tp_cards.py``) imports jax, the
reference package or ``ml_dtypes`` (the card's machine has no ml_dtypes:
the checkpoints carry bf16 leaves through torch), and its entry points
refuse to run without a CUDA device unless the CPU is asked for."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in ("repro_torch.fed.sharding", "repro_torch.core.theory",
             "repro_torch.core.prng",
             "repro_torch.checkpoint", "repro_torch.checkpoint.io",
             "repro_torch.data.synthetic",
             "repro_torch.benchmarks.paper_tables",
             "repro_torch.benchmarks.bound_check",
             "repro_torch.benchmarks.reference",
             "repro_torch.fed.scenarios", "repro_torch.launch.fed_stream",
             "repro_torch.fed.bank", "repro_torch.obs",
             "repro_torch.obs.metrics", "repro_torch.obs.tracing",
             "repro_torch.obs.telemetry", "repro_torch.obs.fedmetrics",
             "repro_torch.fed.faults", "repro_torch.fed.service",
             "repro_torch.launch.fed_serve", "repro_torch.launch.fed_top",
             "repro_torch.fed.fuzz", "repro_torch.fed.validate",
             "repro_torch.data.tokens", "repro_torch.optim",
             "repro_torch.optim.sgd", "repro_torch.launch.train",
             "repro_torch.configs.llava_next_34b",
             "repro_torch.configs.musicgen_medium",
             "repro_torch.launch.steps", "repro_torch.launch.fed_train",
             "repro_torch.launch.mesh", "repro_torch.launch.cluster",
             "repro_torch.models.sharding"):
    assert name in names, name
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro.")
             or m == "ml_dtypes" or m.startswith("ml_dtypes."))
assert not bad, bad
print(len(names))
"""


def test_every_port_module_imports_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL],
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 25     # every module was reached


FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\.|\s|$)", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "tools" / "weighted_agg_quant_turns.py",
                            ROOT / "tools" / "paper_drift.py",
                            ROOT / "tools" / "batch_invariance.py",
                            ROOT / "tools" / "tp_cards.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_reference(path):
    assert not FORBIDDEN.findall(path.read_text()), path


def test_entry_points_refuse_to_run_without_cuda(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.configs.paper import SYNTHETIC_LR
    from repro_torch.core.participation import TRACES
    from repro_torch.fed import Client, FederatedTrainer, RoundEngine
    from repro_torch.models.small import init_small, make_loss_fn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_small(SYNTHETIC_LR)
    params = init_small(SYNTHETIC_LR, device="cpu")
    clients = [Client(x=np.zeros((4, 60), np.float32),
                      y=np.zeros(4, np.int32), trace=TRACES[0])]
    with pytest.raises(RuntimeError, match="CUDA"):
        FederatedTrainer(loss_fn=make_loss_fn(SYNTHETIC_LR),
                         init_params=params, clients=clients)
    with pytest.raises(RuntimeError, match="CUDA"):
        RoundEngine(loss_fn=make_loss_fn(SYNTHETIC_LR), clients=clients,
                    local_epochs=2, batch_size=2)
    from repro_torch.benchmarks import bound_check, paper_tables
    with pytest.raises(RuntimeError, match="CUDA"):
        bound_check.run(rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        paper_tables.table4_fast_reboot(rounds_after=1, taus=(1,))
    with pytest.raises(RuntimeError, match="CUDA"):
        paper_tables.table3_trainer("synthetic", True, 1, "C")
    from repro_torch.launch import fed_train
    with pytest.raises(RuntimeError, match="CUDA"):
        fed_train.main(["--rounds", "1", "--quiet"])
    # asked for, the CPU runs
    FederatedTrainer(loss_fn=make_loss_fn(SYNTHETIC_LR), init_params=params,
                     clients=clients, device="cpu")
    bound_check.run(rounds=1, device="cpu")


def test_serving_entry_points_refuse_to_run_without_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params

    cfg = get_config("nemotron-4-15b").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--gen", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve(cfg, gen=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_cache(cfg, 1, 8)
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--rounds", "1"])


def test_streaming_entry_points_refuse_to_run_without_cuda(monkeypatch):
    from repro_torch.fed.scenarios import build_scheduler, make_scenario
    from repro_torch.launch import fed_stream

    sc = make_scenario("flash-crowd", n_rounds=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fed_stream.main(["--scenario", "flash-crowd", "--rounds", "1",
                         "--quiet"])
    with pytest.raises(RuntimeError, match="CUDA"):
        fed_stream.main(["--scenario", "flash-crowd", "--rounds", "1",
                         "--quiet", "--prefetch"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_scheduler(sc)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_scheduler(sc, prefetch=True)
    # asked for, the CPU runs
    assert fed_stream.main(["--scenario", "flash-crowd", "--rounds", "1",
                            "--quiet", "--device", "cpu"])["rounds"] == 1
    sch = build_scheduler(sc, prefetch=True, device="cpu")
    assert sch._stager._stream is None      # the CPU: no staging stream
    sch.close()


def test_service_entry_points_refuse_to_run_without_cuda(monkeypatch,
                                                        tmp_path):
    from repro_torch.launch import fed_serve, fed_top

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (fed_serve.main, fed_top.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--scenario", "churn", "--rounds", "1", "--quiet"])
    with pytest.raises(RuntimeError, match="CUDA"):
        fed_serve.main(["--scenario", "churn", "--rounds", "1", "--quiet",
                        "--chaos", "7", "--chaos-dir", str(tmp_path)])
    # the trace dump runs nothing on a device; asked for, the CPU serves
    assert fed_serve.main(["--scenario", "churn", "--quiet", "--dump-trace",
                           str(tmp_path / "t.jsonl")])["events"] == 6
    assert fed_serve.main(["--scenario", "churn", "--rounds", "1",
                           "--quiet", "--device", "cpu"])["rounds"] == 1
    assert fed_serve.build_round_kernels(torch.device("cpu")) == {}
