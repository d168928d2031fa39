"""The port's checkpoint and resume (``repro_torch.checkpoint``, the event
codec, ``FedState.to_dict``/``from_dict``, ``StreamScheduler.save``/
``restore``) against the reference's.

- The codec: for every event kind (an Arrival carrying a brand-new client
  with ``None`` test arrays, one with a ``client_id``, a custom and an
  interned trace) the port's ``event_to_dict`` equals the reference's,
  array for array, and each package's dict decodes in the other.
- ``FedState.to_dict`` after the same plan-mode run through every event
  kind equals the reference's key for key (the key as uint32 words, the
  RNG state, the queue with a pending brand-new client,
  ``objective_version``); ``from_dict`` round-trips;
  ``compact_stale_traceshifts`` drops what the reference's drops.
- ``checkpoint.io``'s durability, as ``tests/test_checkpoint_robustness.py``
  holds the reference's, with a stub injector: a failed save leaves the
  previous checkpoint and no ``*.tmp``; a flipped byte, a truncated npz
  and a mangled manifest raise ``CorruptCheckpointError``; native dtypes
  and bf16 leaves round-trip bit for bit, with no ``ml_dtypes`` loaded;
  v2 chunks are checksummed and stale ones pruned.
- Files cross over both ways, v1 and v2, f32 and bf16.
- Resume parity of the port against itself, bit for bit, in the
  reference's own scenario (``tests/test_checkpoint_resume.py``: logreg,
  6 clients, every event kind, two events pending at the cut): device and
  plan mode, the f32 and int8 wires, ``client_sequential``, the CNN in its
  reference layout on disk, and cut into run() calls of other lengths.
- ``restore`` runs on the card unless the CPU is asked for, rebuilds the
  tiered bank and its prefetch from a checkpoint saved with them (v2 by
  default), reuses an engine, and refuses to write or read a CNN's params
  with no model kind.
- A checkpoint of the unsharded port restored with ``sharding=`` on 4 gloo
  ranks gives the unsharded run's records.

Cross-package resume (the reference saves and the port resumes, and the
reverse) is ``tests/test_torch_checkpoint_cross.py``.
"""
import datetime
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro_torch.fed as port_fed
from repro_torch.benchmarks.reference import reference_init
from repro_torch.checkpoint import (CorruptCheckpointError, load_checkpoint,
                                    load_fed_checkpoint, save_checkpoint,
                                    save_fed_checkpoint)
from repro_torch.checkpoint.io import dejsonify_tree, jsonify_tree
from repro_torch.configs.paper import EMNIST_CNN, SYNTHETIC_LR
from repro_torch.core.participation import TRACES, Trace
from repro_torch.data import synthetic_federation
from repro_torch.fed import (Arrival, Client, Departure, FedState,
                             InactivityBurst, RoundEngine, StreamScheduler,
                             TraceShift, make_fed_sharding)
from repro_torch.fed import events as port_events
from repro_torch.fed.stream import history_from_dict, history_to_dict
from repro_torch.models.small import init_small, make_loss_fn
from repro_torch.params import to_numpy
from test_torch_trainer import PARAM_TOL, port_eval

ROOT = Path(__file__).resolve().parents[1]
CUT = 6                         # the reference's kill round
ROUNDS = 12
EVAL_EVERY = 4
N_RANKS = 4


# -- the reference's resume scenario on the port -------------------------------

def client_arrays(n, seed):
    """tests/test_checkpoint_resume.py's make_clients, as arrays and
    trace indices (the port's synthetic_federation is the reference's bit
    for bit)."""
    train, test = synthetic_federation(0.5, 0.5, n, seed=seed)
    rng = np.random.default_rng(seed)
    return [dict(x=tr[0], y=tr[1], trace=int(rng.integers(0, 8)),
                 x_test=te[0], y_test=te[1]) for tr, te in zip(train, test)]


def cnn_arrays(n, seed):
    """n clients of 8-15 random 28x28x1 images with 62-class labels, and
    4 held-out images each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(8, 16))
        out.append(dict(
            x=rng.normal(size=(m, 28, 28, 1)).astype(np.float32),
            y=rng.integers(0, 62, m).astype(np.int32),
            trace=int(rng.integers(0, 8)),
            x_test=rng.normal(size=(4, 28, 28, 1)).astype(np.float32),
            y_test=rng.integers(0, 62, 4).astype(np.int32)))
    return out


def events(pkg, traces, newcomer):
    """Every event kind: an early trace shift and burst, a departure
    freeing a slot, and two events still pending at the cut (an Arrival
    with a brand-new client at tau 8, an including departure at 10)."""
    return [pkg.TraceShift(2, client_id=0, trace=traces[1]),
            pkg.InactivityBurst(3, 2, (1, 2)),
            pkg.Departure(5, client_id=3, policy="exclude"),
            pkg.Arrival(8, client=newcomer),
            pkg.Departure(10, client_id=1, policy="include")]


# (model, clients, capacity, max_samples, batch, eta0): the reference's
# scenario (eta0 1.0, as tests/test_checkpoint_resume.py), and a CNN of 4
# small clients
SCENARIOS = {
    "logreg": (SYNTHETIC_LR, lambda: client_arrays(6, 0),
               lambda: client_arrays(1, 500)[0], 8, 600, 6, 1.0),
    "cnn": (EMNIST_CNN, lambda: cnn_arrays(4, 0),
            lambda: cnn_arrays(1, 500)[0], 6, 16, 4, 0.05),
}


def port_client(a):
    return Client(x=a["x"], y=a["y"], trace=TRACES[a["trace"]],
                  x_test=a["x_test"], y_test=a["y_test"])


def init_params(cfg):
    if cfg.kind == "cnn":
        return init_small(cfg, seed=0, device="cpu")
    return reference_init(cfg, "cpu")


def port_scheduler(mode, model="logreg", compression=None,
                   round_mode="client_parallel", sharding=None, eta0=None,
                   **kw):
    cfg, clients, newcomer, capacity, nmax, B, scenario_eta0 = \
        SCENARIOS[model]
    eta0 = scenario_eta0 if eta0 is None else eta0
    clients = [port_client(a) for a in clients()]
    engine = RoundEngine(
        loss_fn=make_loss_fn(cfg), clients=clients, local_epochs=5,
        batch_size=B, scheme="C", eta0=eta0, capacity=capacity,
        max_samples=nmax, device="cpu", compression=compression,
        model_kind=cfg.kind, mode=round_mode, sharding=sharding)
    return StreamScheduler(
        clients=clients, init_params=init_params(cfg), engine=engine,
        mode=mode, eval_fn=port_eval(cfg), seed=0,
        events=events(port_fed, TRACES, port_client(newcomer())), **kw)


def ref_scheduler(mode, **kw):
    """The reference's tests/test_checkpoint_resume.py scheduler, on the
    same arrays."""
    import jax
    import repro.fed as ref_fed
    from repro.configs.paper import SYNTHETIC_LR as RCFG
    from repro.core.participation import TRACES as RTRACES
    from repro.models.small import init_small as rinit
    from repro.models.small import make_loss_fn as rloss

    def client(a):
        return ref_fed.Client(x=a["x"], y=a["y"], trace=RTRACES[a["trace"]],
                              x_test=a["x_test"], y_test=a["y_test"])
    _, clients, newcomer, capacity, nmax, B, eta0 = SCENARIOS["logreg"]
    return ref_fed.StreamScheduler(
        clients=[client(a) for a in clients()],
        init_params=rinit(jax.random.PRNGKey(0), RCFG),
        loss_fn=rloss(RCFG), capacity=capacity, max_samples=nmax,
        local_epochs=5, batch_size=B, scheme="C", eta0=eta0, seed=0,
        mode=mode, chunk_size=4,
        events=events(ref_fed, RTRACES, client(newcomer())), **kw)


def assert_records_identical(h1, h2):
    """tests/test_checkpoint_resume.py's assert_history_identical."""
    assert len(h1) == len(h2)
    for r1, r2 in zip(h1, h2):
        assert (r1.tau, r1.eta, r1.event, r1.n_active) == \
            (r2.tau, r2.eta, r2.event, r2.n_active)
        np.testing.assert_array_equal(r1.s, r2.s)
        assert np.isnan(r1.loss) == np.isnan(r2.loss)
        if np.isfinite(r1.loss):
            assert r1.loss == r2.loss and r1.acc == r2.acc


def assert_params_equal(p1, p2):
    assert p1.keys() == p2.keys()
    for k in p1:
        assert torch.equal(p1[k].cpu(), p2[k].cpu()), k


def assert_same(a, b, path="d"):
    """Deep equality of plain data: dict keys, list lengths, arrays by
    dtype and value, scalars by value (and type class)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), \
            (path, sorted(a), sorted(b) if isinstance(b, dict) else b)
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b and (a is None) == (b is None), (path, a, b)
        assert isinstance(a, bool) == isinstance(b, bool), (path, a, b)


# -- (a) the event codec --------------------------------------------------------

CUSTOM = ("battery_cell", 0.42, 0.21, 0.3)


def codec_events(pkg, traces, trace_cls):
    a = client_arrays(1, 7)[0]
    fresh = pkg.Client(x=a["x"], y=a["y"], trace=trace_cls(*CUSTOM),
                       active_from=4, departs_at=11,
                       departure_policy="auto", gamma_l=2.5)
    unlabelled = pkg.Client(x=a["x"][:5], trace=traces[3])
    return [pkg.Arrival(3, client=fresh),
            pkg.Arrival(4, client=unlabelled, fast_reboot=False),
            pkg.Arrival(5, client_id=2, fast_reboot=True),
            pkg.Departure(6, client_id=1),
            pkg.Departure(7, client_id=0, policy="include"),
            pkg.TraceShift(8, client_id=0, trace=traces[6]),
            pkg.TraceShift(9, client_id=1, trace=trace_cls(*CUSTOM)),
            pkg.InactivityBurst(10, 3, (0, 4, 5))]


def reference_codec():
    import repro.fed as ref_fed
    from repro.core.participation import TRACES as RTRACES
    from repro.core.participation import Trace as RTrace
    from repro.fed import events as ref_events
    return ref_events, codec_events(ref_fed, RTRACES, RTrace), RTRACES


def test_event_codec_equals_the_reference_array_for_array():
    """Every kind's dict equals the reference's key for key; the
    unlabelled newcomer's y, x_test and y_test are None on both sides."""
    ref_events, ref_evs, _ = reference_codec()
    port_evs = codec_events(port_fed, TRACES, Trace)
    for p, r in zip(port_evs, ref_evs, strict=True):
        assert_same(port_events.event_to_dict(p), ref_events.event_to_dict(r))
    d = port_events.event_to_dict(port_evs[1])["client"]
    assert d["y"] is None and d["x_test"] is None and d["y_test"] is None


def test_event_dicts_decode_in_either_package():
    """The reference's dicts decode in the port (interned traces as the
    canonical TRACES objects, custom laws rebuilt from their moments) and
    the port's in the reference, each back to the same dict."""
    ref_events, ref_evs, rtraces = reference_codec()
    for r in ref_evs:
        d = ref_events.event_to_dict(r)
        p = port_events.event_from_dict(d)
        assert type(p).__name__ == type(r).__name__
        assert_same(port_events.event_to_dict(p), d)
        back = ref_events.event_from_dict(port_events.event_to_dict(p))
        assert_same(ref_events.event_to_dict(back), d)
    shift = port_events.event_from_dict(
        ref_events.event_to_dict(ref_evs[5]))
    assert shift.trace is TRACES[6]
    custom = port_events.event_from_dict(
        ref_events.event_to_dict(ref_evs[6]))
    assert custom.trace == Trace(*CUSTOM)
    assert ref_events.trace_from_dict(
        port_events.trace_to_dict(TRACES[2])) is rtraces[2]
    # a Table-2 name with other moments is a custom law, not the interned
    odd = dict(port_events.trace_to_dict(TRACES[2]), mean=0.5)
    assert port_events.trace_from_dict(odd) is not TRACES[2]
    with pytest.raises(ValueError, match="unknown event kind"):
        port_events.event_from_dict({"kind": "teleport", "tau": 1})


# -- (b) FedState.to_dict against the reference's -------------------------------

@pytest.fixture(scope="module")
def cut_states():
    """The port's and the reference's plan-mode schedulers after CUT
    rounds of the same run (every event kind applied or pending)."""
    port, ref = port_scheduler("plan"), ref_scheduler("plan")
    port.run(CUT, eval_every=EVAL_EVERY)
    ref.run(CUT, eval_every=EVAL_EVERY)
    return port, ref


def test_fedstate_to_dict_equals_the_reference_key_for_key(cut_states):
    port, ref = cut_states
    d, want = port.state.to_dict(), ref.state.to_dict()
    assert_same(d, want)
    assert d["key"].dtype == np.uint32 and d["key"].shape == (2,)
    assert d["rng_state"]["bit_generator"] == "PCG64"
    assert d["objective_version"] == 1          # the excluding departure
    assert [q[2]["kind"] for q in d["queue"]] == ["arrival", "departure"]
    newcomer = d["queue"][0][2]["client"]
    assert newcomer["x"].shape == (len(newcomer["y"]), 60)


def test_fedstate_from_dict_round_trips_either_packages_dict(cut_states):
    """from_dict(to_dict) is exact, for the port's dict and the
    reference's, and the reference's from_dict reads the port's: the same
    membership, queue, reboots, key words and future RNG stream."""
    from repro.fed import FedState as RefFedState
    port, ref = cut_states
    d = port.state.to_dict()
    for src in (d, ref.state.to_dict()):
        st = FedState.from_dict(src)
        assert_same(st.to_dict(), src)
        assert st.key.dtype == torch.int64
        assert torch.equal(st.key, port.state.key)
        assert st.client_at == port.state.client_at
    st = FedState.from_dict(d)
    np.testing.assert_array_equal(st.rng.integers(0, 1 << 30, 16),
                                  FedState.from_dict(d).rng.integers(
                                      0, 1 << 30, 16))
    arrival = st.queue[0][2] if isinstance(st.queue[0][2], Arrival) else \
        st.queue[1][2]
    np.testing.assert_array_equal(arrival.client.x,
                                  port.state.queue[0][2].client.x)
    assert st.clients[0].trace is TRACES[1]     # shifted at tau 2
    assert_same(RefFedState.from_dict(d).to_dict(), d)
    with pytest.raises(ValueError, match="version"):
        FedState.from_dict(dict(d, version=2))


def test_objective_version_bumps_where_the_reference_does():
    clients = [port_client(a) for a in client_arrays(3, 0)]
    st = FedState(clients=clients, capacity=5)
    assert st.objective_version == 0
    st.apply(InactivityBurst(0, 2, (0,)), 0)
    st.apply(TraceShift(0, client_id=1, trace=TRACES[2]), 0)
    st.apply(Departure(1, client_id=2, policy="include"), 1)
    assert st.objective_version == 0            # membership unchanged
    st.apply(Arrival(2, client_id=2), 2)        # a rejoin: still unchanged
    assert st.objective_version == 0
    st.apply(Departure(3, client_id=0, policy="exclude"), 3)
    assert st.objective_version == 1
    st.apply(Arrival(4, client=port_client(client_arrays(1, 9)[0])), 4)
    assert st.objective_version == 2


def test_compact_stale_traceshifts_drops_what_the_reference_drops():
    """A flood of stale TraceShifts: newest per client kept, a restatement
    of the current law dropped, future and other events untouched."""
    import repro.fed as ref_fed
    from repro.core.participation import TRACES as RTRACES
    from repro.fed import FedState as RefFedState
    from repro.fed.events import event_to_dict as ref_event_to_dict

    def flood(pkg, state_cls, traces):
        arrays = client_arrays(4, 0)
        clients = [pkg.Client(x=a["x"], y=a["y"], trace=traces[a["trace"]])
                   for a in arrays]
        st = state_cls(clients=clients, capacity=6)
        st.next_tau = 5
        st.push(pkg.TraceShift(1, client_id=0, trace=traces[2]),
                pkg.TraceShift(2, client_id=0, trace=traces[4]),
                pkg.TraceShift(3, client_id=1, trace=traces[5]),
                pkg.TraceShift(4, client_id=1, trace=traces[6]),
                pkg.TraceShift(2, client_id=2,
                               trace=traces[arrays[2]["trace"]]),
                pkg.TraceShift(5, client_id=9, trace=traces[1]),
                pkg.TraceShift(9, client_id=0, trace=traces[7]),
                pkg.Departure(3, client_id=3),
                pkg.InactivityBurst(4, 2, (1,)))
        return st

    port = flood(port_fed, FedState, TRACES)
    ref = flood(ref_fed, RefFedState, RTRACES)
    dropped = port.compact_stale_traceshifts()
    assert dropped == ref.compact_stale_traceshifts() == 3
    assert_same([[t, s, port_events.event_to_dict(e)]
                 for t, s, e in sorted(port.queue)],
                [[t, s, ref_event_to_dict(e)] for t, s, e in sorted(ref.queue)])
    assert port.compact_stale_traceshifts() == 0


def test_history_dict_round_trips(cut_states):
    port, ref = cut_states
    from repro.fed.stream import history_to_dict as ref_history_to_dict
    d = history_to_dict(port.history)
    assert_same({k: v for k, v in d.items() if k not in ("loss", "acc")},
                {k: v for k, v in ref_history_to_dict(ref.history).items()
                 if k not in ("loss", "acc")})
    assert_records_identical(history_from_dict(d), port.history)
    assert history_from_dict(history_to_dict([])) == []


# -- (c) checkpoint.io's durability ----------------------------------------------

class StubInjector:
    """A fault hook of the reference's shape (``fire(site, **kw)``): an
    injected write failure at ``fail_at``, and a log of every firing."""

    def __init__(self, fail_at=None):
        self.fail_at = fail_at
        self.fired = []

    def fire(self, site, **kw):
        self.fired.append((site, os.path.basename(kw["path"])))
        if site == self.fail_at:
            raise OSError(f"injected write failure at {site}")


def small_params(scale=1.0):
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4) * scale,
            "b": np.ones(4, np.float32) * scale}


def small_state(tau=3):
    return {"next_tau": tau, "seq": 0, "events_applied": 0,
            "rb_tau0": np.zeros(4, np.int32)}


def flip_byte(path, at=None):
    with open(path, "r+b") as f:
        size = os.path.getsize(path)
        f.seek(size // 2 if at is None else at)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


def test_failed_save_leaves_previous_checkpoint_intact(tmp_path):
    path = str(tmp_path / "ckpt")
    save_fed_checkpoint(path, small_params(1.0), small_state(tau=3))
    with pytest.raises(OSError, match="injected"):
        save_fed_checkpoint(path, small_params(2.0), small_state(tau=9),
                            injector=StubInjector("ckpt_save"))
    params, state, _, _, _ = load_fed_checkpoint(path)
    np.testing.assert_array_equal(params["w"], small_params(1.0)["w"])
    assert state["next_tau"] == 3
    assert not [f for f in os.listdir(path) if f.endswith(".tmp")]


def test_injector_fires_at_save_and_at_commit(tmp_path):
    inj = StubInjector()
    save_fed_checkpoint(str(tmp_path / "c"), small_params(), small_state(),
                        injector=inj)
    assert inj.fired == [("ckpt_save", "fed_checkpoint.npz"),
                         ("ckpt_written", "fed_checkpoint.npz")]


def test_flipped_byte_fails_the_checksum(tmp_path):
    path = str(tmp_path / "ckpt")
    save_fed_checkpoint(path, small_params(), small_state())
    flip_byte(os.path.join(path, "fed_checkpoint.npz"))
    with pytest.raises(CorruptCheckpointError, match="checksum"):
        load_fed_checkpoint(path)
    # unverified, the container's own damage still surfaces as corrupt
    with pytest.raises(CorruptCheckpointError):
        load_fed_checkpoint(path, verify=False)


def test_truncated_npz_is_corrupt_not_a_zip_error(tmp_path):
    path = str(tmp_path / "ckpt")
    save_fed_checkpoint(path, small_params(), small_state())
    npz = os.path.join(path, "fed_checkpoint.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    for verify in (True, False):
        with pytest.raises(CorruptCheckpointError):
            load_fed_checkpoint(path, verify=verify)


@pytest.mark.parametrize("torn", ['{"step": 5, "keys": {', "[1, 2]",
                                  "\xff\xfe garbage"])
def test_mangled_manifest_is_corrupt_not_a_json_error(tmp_path, torn):
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, small_params(), step=5)
    with open(os.path.join(path, "manifest.json"), "w",
              encoding="latin-1") as f:
        f.write(torn)
    with pytest.raises(CorruptCheckpointError, match="manifest"):
        load_checkpoint(path)
    fed = str(tmp_path / "fed")
    save_fed_checkpoint(fed, small_params(), small_state())
    with open(os.path.join(fed, "fed_manifest.json"), "w",
              encoding="latin-1") as f:
        f.write(torn)
    with pytest.raises(CorruptCheckpointError):
        load_fed_checkpoint(fed)


def test_manifest_missing_its_sections_is_corrupt(tmp_path):
    import json
    path = str(tmp_path / "fed")
    save_fed_checkpoint(path, small_params(), small_state())
    mpath = os.path.join(path, "fed_manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    del manifest["state"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CorruptCheckpointError, match="manifest"):
        load_fed_checkpoint(path)


def bits(t):
    """The stored bits of a leaf, numpy or torch, as unsigned ints."""
    if isinstance(t, torch.Tensor):
        size = t.element_size()
        t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[size])
        return t.numpy().view({2: np.uint16, 4: np.uint32, 8: np.uint64}[size])
    a = np.asarray(t)
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_plain_checkpoint_dtype_round_trip(tmp_path, dtype):
    """bf16 is stored as a uint16 view with its name in the manifest and
    comes back a torch.bfloat16 tensor bit for bit; native dtypes come
    back as numpy arrays of their dtype."""
    path = str(tmp_path / "ckpt")
    w = torch.linspace(-3, 3, 24).reshape(4, 6).to(getattr(torch, dtype))
    save_checkpoint(path, {"w": w, "n": np.arange(3)}, step=1)
    loaded, manifest = load_checkpoint(path)
    assert manifest["keys"]["w"] == {"shape": [4, 6], "dtype": dtype}
    if dtype == "bfloat16":
        assert loaded["w"].dtype == torch.bfloat16
        assert manifest["array_dtypes"] == {"w": "bfloat16"}
    else:
        assert str(loaded["w"].dtype) == dtype
    np.testing.assert_array_equal(bits(loaded["w"]), bits(w))
    np.testing.assert_array_equal(loaded["n"], np.arange(3))


def test_fed_checkpoint_bf16_round_trip(tmp_path):
    path = str(tmp_path / "ckpt")
    params = {"w": torch.tensor([[1.5, -2.25], [0.125, 3e-3]],
                                dtype=torch.bfloat16),
              "b": np.zeros(2, np.float32)}
    state = dict(small_state(),
                 blob=torch.tensor([0.1, 0.7], dtype=torch.bfloat16))
    save_fed_checkpoint(path, params, state)
    loaded, lstate, _, _, _ = load_fed_checkpoint(path)
    assert loaded["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(loaded["w"]), bits(params["w"]))
    assert lstate["blob"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(lstate["blob"]), bits(state["blob"]))
    np.testing.assert_array_equal(loaded["b"], params["b"])


NO_ML_DTYPES = """
import sys, tempfile, torch
from repro_torch.checkpoint import load_fed_checkpoint, save_fed_checkpoint
w = torch.randn(64, generator=torch.Generator().manual_seed(0)).bfloat16()
d = tempfile.mkdtemp()
save_fed_checkpoint(d, {"w": w}, {"blob": w[:5]})
p, s, _, _, _ = load_fed_checkpoint(d)
assert p["w"].dtype == torch.bfloat16 and torch.equal(p["w"], w)
assert torch.equal(s["blob"], w[:5])
assert "ml_dtypes" not in sys.modules, "ml_dtypes was imported"
print("ok")
"""


def test_bf16_round_trips_without_ml_dtypes():
    out = subprocess.run([sys.executable, "-c", NO_ML_DTYPES],
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


def chunk_state(n):
    return {"next_tau": 4, "clients": [
        port_events.client_to_dict(port_client(a))
        for a in client_arrays(n, 3)]}


def test_v2_chunks_are_checksummed_and_stale_ones_pruned(tmp_path):
    path = str(tmp_path / "ckpt")
    save_fed_checkpoint(path, small_params(), chunk_state(4),
                        client_chunks=True)
    names = sorted(os.listdir(os.path.join(path, "clients")))
    assert names == [f"client-{i:08d}.npz" for i in range(4)]
    _, state, _, _, _ = load_fed_checkpoint(path)
    assert_same(state["clients"], chunk_state(4)["clients"])
    # an overwrite with fewer clients prunes the chunks beyond its count
    save_fed_checkpoint(path, small_params(), chunk_state(2),
                        client_chunks=True)
    assert sorted(os.listdir(os.path.join(path, "clients"))) == names[:2]
    _, state, _, _, _ = load_fed_checkpoint(path)
    assert len(state["clients"]) == 2
    flip_byte(os.path.join(path, "clients", names[1]))
    with pytest.raises(CorruptCheckpointError, match="client chunk"):
        load_fed_checkpoint(path)


def test_jsonify_tree_rejects_int_keys_and_keeps_tuples():
    arrays = {}
    tree = {"a": (1, np.arange(3), [np.float32(2.5), None]),
            "b": torch.ones(2), "c": np.int64(7), "d": np.bool_(True)}
    skel = jsonify_tree(tree, arrays)
    back = dejsonify_tree(skel, arrays)
    assert isinstance(back["a"], tuple) and back["c"] == 7
    assert back["d"] is True and back["a"][2] == [2.5, None]
    np.testing.assert_array_equal(back["a"][1], np.arange(3))
    with pytest.raises(TypeError, match="keys must be str"):
        jsonify_tree({1: 2}, {})


# -- (d) files cross over both ways ----------------------------------------------

def crossover_payload(dtype):
    """Params and a state dict of the given float dtype: torch tensors for
    the port's writer, and the same bits as numpy (ml_dtypes for bf16) for
    the reference's."""
    import jax.numpy as jnp
    gen = torch.Generator().manual_seed(3)
    w = torch.randn(5, 7, generator=gen).to(getattr(torch, dtype))
    b = torch.randn(7, generator=gen).to(getattr(torch, dtype))
    ref = {name: np.asarray(jnp.asarray(t.float().numpy(), dtype=dtype))
           for name, t in (("w", w), ("b", b))}
    state = dict(chunk_state(2), next_tau=6,
                 rb_tau0=np.arange(4, dtype=np.int32))
    return {"layer": {"w": w}, "b": b}, \
        {"layer": {"w": ref["w"]}, "b": ref["b"]}, state


def assert_leaves_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            assert_leaves_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(bits(got[k]), bits(want[k]))


@pytest.mark.parametrize("chunks", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_over_both_ways(tmp_path, dtype, chunks):
    from repro.checkpoint.io import load_checkpoint as ref_load
    from repro.checkpoint.io import load_fed_checkpoint as ref_load_fed
    from repro.checkpoint.io import save_checkpoint as ref_save
    from repro.checkpoint.io import save_fed_checkpoint as ref_save_fed
    port_params, ref_params, state = crossover_payload(dtype)
    history = history_to_dict([])
    config = {"capacity": 8, "mode": "plan"}

    save_fed_checkpoint(str(tmp_path / "p"), port_params, state,
                        history=history, config=config, extra={"by": 1},
                        client_chunks=chunks)
    p, s, h, c, e = ref_load_fed(str(tmp_path / "p"))
    assert str(p["b"].dtype) == dtype
    assert_leaves_equal(p, ref_params)
    assert_same(s, state)
    assert_same(h, history)
    assert (c, e) == (config, {"by": 1})

    ref_save_fed(str(tmp_path / "r"), ref_params, state, history=history,
                 config=config, client_chunks=chunks)
    p, s, h, c, _ = load_fed_checkpoint(str(tmp_path / "r"))
    if dtype == "bfloat16":
        assert p["layer"]["w"].dtype == torch.bfloat16
    assert_leaves_equal(p, port_params)
    assert_same(s, state)
    assert_same(h, history)
    assert c == config

    if not chunks:                                  # the params-only layer
        save_checkpoint(str(tmp_path / "pp"), port_params, step=3)
        p, m = ref_load(str(tmp_path / "pp"))
        assert_leaves_equal(p, ref_params)
        assert m["step"] == 3
        ref_save(str(tmp_path / "rp"), ref_params, step=4)
        p, m = load_checkpoint(str(tmp_path / "rp"))
        assert_leaves_equal(p, port_params)
        assert m["step"] == 4


def test_port_corruption_is_caught_by_the_reference(tmp_path):
    from repro.checkpoint import CorruptCheckpointError as RefCorrupt
    from repro.checkpoint.io import load_fed_checkpoint as ref_load_fed
    path = str(tmp_path / "ckpt")
    save_fed_checkpoint(path, small_params(), small_state())
    flip_byte(os.path.join(path, "fed_checkpoint.npz"))
    with pytest.raises(RefCorrupt, match="checksum"):
        ref_load_fed(path)


# -- (e) resume parity of the port against itself ----------------------------------

# (sampling mode, model, wire, round mode)
RESUME_CASES = {
    "device": ("device", "logreg", None, "client_parallel"),
    "plan": ("plan", "logreg", None, "client_parallel"),
    "device-int8": ("device", "logreg", "int8", "client_parallel"),
    "plan-int8": ("plan", "logreg", "int8", "client_parallel"),
    "plan-sequential": ("plan", "logreg", None, "client_sequential"),
    "plan-cnn": ("plan", "cnn", None, "client_parallel"),
}


@pytest.mark.parametrize("case", RESUME_CASES)
def test_resume_parity_mid_stream(case, tmp_path):
    """Cut at tau 6 with an Arrival (tau 8) and a Departure (tau 10)
    pending, save, restore from disk into a fresh engine, run the other 6
    rounds: round records and params bit-identical to one uncut 12-round
    run, the control plane converged, and no thread pinning needed (the
    same code runs both)."""
    mode, model, wire, round_mode = RESUME_CASES[case]
    cfg = SCENARIOS[model][0]
    baseline = port_scheduler(mode, model, wire, round_mode)
    baseline.run(ROUNDS, eval_every=EVAL_EVERY)

    sch = port_scheduler(mode, model, wire, round_mode)
    sch.run(CUT, eval_every=EVAL_EVERY)
    assert sch.pending == 2
    ckpt = str(tmp_path / "ckpt")
    sch.save(ckpt)
    del sch

    res = StreamScheduler.restore(ckpt, loss_fn=make_loss_fn(cfg),
                                  eval_fn=port_eval(cfg), device="cpu")
    assert res.mode == mode and res.next_tau == CUT and res.pending == 2
    assert res.engine.compression.name == (wire or "none")
    assert res.engine.mode == round_mode
    assert res.engine.model_kind == cfg.kind
    res.run(ROUNDS - CUT, eval_every=EVAL_EVERY)

    assert_records_identical(baseline.history, res.history)
    assert "".join(h.event for h in res.history) == (
        "trace-shift:0;burst:1,2@2;departure-exclude:3;arrival:"
        f"{len(SCENARIOS[model][1]())};departure-include:1;")
    assert_params_equal(baseline.params, res.params)
    for attr in ("objective", "slot_of", "departed", "lr_shift_tau",
                 "events_applied", "next_tau"):
        assert getattr(res, attr) == getattr(baseline, attr), attr


def test_cnn_params_lie_on_disk_in_the_reference_layout(tmp_path):
    """The CNN's conv weights are written HWIO and w1's rows in HWC order
    (``params.to_numpy``), whatever the leaves are called."""
    sch = port_scheduler("plan", "cnn")
    sch.save(str(tmp_path / "c"))
    params, _, _, config, _ = load_fed_checkpoint(str(tmp_path / "c"))
    assert config["model_kind"] == "cnn"
    assert params["c1"].shape == (5, 5, 1, 32)
    assert params["c2"].shape == (5, 5, 32, 64)
    for k, v in to_numpy(sch.params, EMNIST_CNN).items():
        np.testing.assert_array_equal(params[k], v, err_msg=k)


@pytest.mark.parametrize("model", ["logreg", "cnn"])
def test_scheduler_checkpoints_carry_bf16_params(tmp_path, model):
    """A scheduler whose params are bf16 saves them as bits under
    "bfloat16" in the reference's layout (the CNN HWIO, w1's rows HWC:
    the bits of the f32 layout's conversion), the reference's loader reads
    them as ml_dtypes' bf16, and ``restore`` gives them back as
    torch.bfloat16 tensors in the port's layout, bit for bit."""
    from repro.checkpoint.io import load_fed_checkpoint as ref_load_fed
    cfg = SCENARIOS[model][0]
    sch = port_scheduler("plan", model)
    sch.params = {k: v.to(torch.bfloat16) for k, v in sch.params.items()}
    sch.save(str(tmp_path / "c"))
    want = to_numpy({k: v.float() for k, v in sch.params.items()}, cfg)
    params, _, _, _, _ = load_fed_checkpoint(str(tmp_path / "c"))
    ref, _, _, _, _ = ref_load_fed(str(tmp_path / "c"))
    for k, v in want.items():
        assert params[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(params[k].float().numpy(), v,
                                      err_msg=k)
        assert str(ref[k].dtype) == "bfloat16", k
        np.testing.assert_array_equal(ref[k].astype(np.float32), v,
                                      err_msg=k)
    res = StreamScheduler.restore(str(tmp_path / "c"),
                                  loss_fn=make_loss_fn(cfg), device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in res.params.values())
    assert_params_equal(res.params, sch.params)


def test_cnn_without_a_model_kind_raises(tmp_path):
    """A 4-D leaf with no model kind is refused on save (the port's OIHW
    layout would go out under the reference's format) and on restore (a
    reference checkpoint carries no kind)."""
    sch = port_scheduler("plan", "cnn")
    sch.engine.model_kind = None
    with pytest.raises(ValueError, match="model_kind"):
        sch.save(str(tmp_path / "c"))
    sch.engine.model_kind = "cnn"
    sch.save(str(tmp_path / "c"))
    params, state, history, config, _ = load_fed_checkpoint(
        str(tmp_path / "c"))
    del config["model_kind"]                    # as the reference writes it
    save_fed_checkpoint(str(tmp_path / "r"), params, state, history=history,
                        config=config)
    with pytest.raises(ValueError, match="model_kind"):
        StreamScheduler.restore(str(tmp_path / "r"),
                                loss_fn=make_loss_fn(EMNIST_CNN),
                                device="cpu")
    res = StreamScheduler.restore(str(tmp_path / "r"),
                                  loss_fn=make_loss_fn(EMNIST_CNN),
                                  model_kind="cnn", device="cpu")
    assert_params_equal(res.params, sch.params)


@pytest.mark.parametrize("mode", ["device", "plan"])
def test_run_call_structure_invariance(mode):
    """The same rounds cut into other run() calls: the same records and
    params, bit for bit."""
    a = port_scheduler(mode)
    a.run(ROUNDS, eval_every=EVAL_EVERY)
    b = port_scheduler(mode)
    for n in (1, 4, 2, 5):
        b.run(n, eval_every=EVAL_EVERY)
    assert_records_identical(a.history, b.history)
    assert_params_equal(a.params, b.params)


def test_restore_reuses_an_engine_and_v2_checkpoints(tmp_path):
    """engine= reuses an engine of the checkpoint's capacity and wire (every
    slot evicted first, the checkpoint's occupancy re-admitted); a v2
    checkpoint restores the same run; a mismatched engine is refused."""
    baseline = port_scheduler("device")
    baseline.run(ROUNDS, eval_every=EVAL_EVERY)
    sch = port_scheduler("device")
    sch.run(CUT, eval_every=EVAL_EVERY)
    sch.save(str(tmp_path / "c"), client_chunks=True)
    donor = port_scheduler("device")
    donor.run(3, eval_every=EVAL_EVERY)             # dirty slots
    res = StreamScheduler.restore(str(tmp_path / "c"),
                                  eval_fn=port_eval(SYNTHETIC_LR),
                                  engine=donor.engine)
    assert res.engine is donor.engine
    res.run(ROUNDS - CUT, eval_every=EVAL_EVERY)
    assert_records_identical(baseline.history, res.history)
    assert_params_equal(baseline.params, res.params)
    int8 = port_scheduler("device", compression="int8")
    with pytest.raises(ValueError, match="compression"):
        StreamScheduler.restore(str(tmp_path / "c"), engine=int8.engine)


def test_restore_runs_on_the_card_unless_asked_for_the_cpu(tmp_path,
                                                           monkeypatch):
    sch = port_scheduler("plan")
    sch.save(str(tmp_path / "c"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamScheduler.restore(str(tmp_path / "c"),
                                loss_fn=make_loss_fn(SYNTHETIC_LR))
    res = StreamScheduler.restore(str(tmp_path / "c"),
                                  loss_fn=make_loss_fn(SYNTHETIC_LR),
                                  device="cpu")
    assert res.engine.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in res.params.values())


@pytest.mark.parametrize("flag", ["bank", "prefetch"])
def test_restore_rebuilds_the_bank_and_prefetch(tmp_path, flag):
    """A scheduler saved with the tiered bank (or prefetch, which implies
    it) writes fed-checkpoint-v2 by default, one chunk per client, records
    the flag in its config, and restores with the bank (and the stager)
    rebuilt from the restored clients; the resumed run is the uncut one
    bit for bit."""
    baseline = port_scheduler("plan")
    baseline.run(ROUNDS, eval_every=EVAL_EVERY)
    sch = port_scheduler("plan", **{flag: True})
    sch.run(CUT, eval_every=EVAL_EVERY)
    sch.save(str(tmp_path / "c"))
    sch.close()
    n_clients = len(sch.clients)
    params, state, history, config, _ = load_fed_checkpoint(
        str(tmp_path / "c"))
    assert config["bank"] is True
    assert config["prefetch"] is (flag == "prefetch")
    assert len(list((tmp_path / "c" / "clients").glob("client-*.npz"))) \
        == n_clients
    res = StreamScheduler.restore(str(tmp_path / "c"),
                                  loss_fn=make_loss_fn(SYNTHETIC_LR),
                                  eval_fn=port_eval(SYNTHETIC_LR),
                                  device="cpu")
    assert res.bank is not None and len(res.bank) == n_clients
    assert (res._stager is not None) is (flag == "prefetch")
    assert res.engine_config()["bank"] is True
    res.run(ROUNDS - CUT, eval_every=EVAL_EVERY)
    res.close()
    assert_records_identical(baseline.history, res.history)
    assert_params_equal(baseline.params, res.params)
    if flag == "prefetch":       # the pending newcomer came from the stack
        assert res.prefetch_stats()["hits"] == 1
        assert res.prefetch_stats()["misses"] == 0


def test_restore_of_a_flipped_byte_raises_corrupt(tmp_path):
    sch = port_scheduler("plan")
    sch.run(2, eval_every=EVAL_EVERY)
    sch.save(str(tmp_path / "c"))
    flip_byte(str(tmp_path / "c" / "fed_checkpoint.npz"))
    with pytest.raises(CorruptCheckpointError):
        StreamScheduler.restore(str(tmp_path / "c"),
                                loss_fn=make_loss_fn(SYNTHETIC_LR),
                                device="cpu")


def test_restore_hands_the_injector_to_the_scheduler(tmp_path):
    """restore(injector=) gives the restored scheduler that injector (it is
    not swallowed into the geometry's overrides), and restore(log_spans=True)
    a scheduler that logs its span arguments."""
    sch = port_scheduler("plan")
    sch.run(2, eval_every=EVAL_EVERY)
    sch.save(str(tmp_path / "c"))
    plan = port_fed.FaultPlan([port_fed.Fault("sched_span", 0, "crash")])
    res = StreamScheduler.restore(str(tmp_path / "c"), device="cpu",
                                  loss_fn=make_loss_fn(SYNTHETIC_LR),
                                  injector=plan)
    assert res.injector is plan and res.span_log is None
    assert "injector" not in res.engine_config()
    with pytest.raises(port_fed.InjectedFault):
        res.run(2, eval_every=EVAL_EVERY)    # the plan fires in run()
    assert plan.fired == [("sched_span", 0, "crash")]
    logged = StreamScheduler.restore(str(tmp_path / "c"), device="cpu",
                                     loss_fn=make_loss_fn(SYNTHETIC_LR),
                                     log_spans=True)
    assert logged.span_log == [] and "log_spans" not in \
        logged.engine_config()
    logged.run(2, eval_every=EVAL_EVERY)
    assert [t for t, _, _, _ in logged.span_log][0] == 2


def test_scheduler_save_fires_the_injectors_sites(tmp_path):
    """A scheduler's save() hands its injector to the checkpoint writer: an
    injected io-error at ckpt_save raises InjectedWriteError and leaves the
    previous checkpoint loadable (tests/test_checkpoint_robustness.py's
    case, through the scheduler), and a corrupt fault at ckpt_written
    leaves a checkpoint that fails its checksum."""
    path = str(tmp_path / "c")
    plain = port_scheduler("plan")
    plain.run(2, eval_every=EVAL_EVERY)
    plain.save(path)
    faulty = port_scheduler("plan", injector=port_fed.FaultPlan(
        [port_fed.Fault("ckpt_save", 0, "io-error")]))
    faulty.run(4, eval_every=EVAL_EVERY)
    with pytest.raises(port_fed.InjectedWriteError):
        faulty.save(path)
    assert faulty.injector.fired == [("ckpt_save", 0, "io-error")]
    assert not [f for f in os.listdir(path) if f.endswith(".tmp")]
    res = StreamScheduler.restore(path, device="cpu",
                                  loss_fn=make_loss_fn(SYNTHETIC_LR))
    assert res._next_tau == 2                # the old run, not the torn one
    assert_params_equal(res.params, plain.params)
    faulty.save(path)                        # the plan's only fault is spent
    assert StreamScheduler.restore(path, device="cpu",
                                   loss_fn=make_loss_fn(SYNTHETIC_LR)) \
        ._next_tau == 4
    rotten = port_scheduler("plan", injector=port_fed.FaultPlan(
        [port_fed.Fault("ckpt_written", 0, "corrupt", size=16)], seed=3))
    rotten.save(path)
    assert rotten.injector.fired == [("ckpt_written", 0, "corrupt")]
    with pytest.raises(CorruptCheckpointError, match="checksum"):
        StreamScheduler.restore(path, device="cpu",
                                loss_fn=make_loss_fn(SYNTHETIC_LR))


def test_engine_config_carries_every_key_the_reference_reads():
    sch = port_scheduler("plan")
    cfg = sch.engine_config()
    for key in ("local_epochs", "batch_size", "scheme", "eta0",
                "chunk_size", "agg", "compression", "with_metrics",
                "engine_mode", "capacity", "max_samples", "mode", "bank",
                "prefetch"):
        assert key in cfg, key
    assert cfg["chunk_size"] == 16 and cfg["capacity"] == 8
    assert (cfg["compression"], cfg["engine_mode"]) == ("none",
                                                        "client_parallel")


# -- (g) a restore sharded over 4 gloo ranks ---------------------------------------

# At the reference scenario's eta0 1.0 the arrival's LR restart (eta 1.0,
# boost 3) amplifies the all-reduce's other f32 summation order past 1e-5
# within a few rounds (an eval loss of 8.78939 sharded against 8.78985):
# the sharded leg runs at tests/test_torch_sharding.py's eta0 0.5
SHARDED_ETA0 = 0.5

def _sharded_rank(rank, world, init_file, ckpt_dir, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = {}
        for mode in ("plan", "device"):
            res = StreamScheduler.restore(
                str(Path(ckpt_dir) / mode),
                loss_fn=make_loss_fn(SYNTHETIC_LR),
                eval_fn=port_eval(SYNTHETIC_LR), device="cpu",
                sharding=make_fed_sharding())
            res.run(ROUNDS - CUT, eval_every=EVAL_EVERY)
            out[mode] = dict(
                slots=res.engine.local_slots,
                history=[(h.tau, h.eta, h.n_active, h.event, h.s, h.loss)
                         for h in res.history],
                params={k: v.numpy().copy() for k, v in res.params.items()})
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_unsharded_checkpoint_restores_sharded_over_four_ranks(tmp_path):
    """Saved by the unsharded port at tau 6 (capacity 8: 2 slots a rank),
    restored with sharding=make_fed_sharding() on 4 gloo ranks: every
    rank's round records equal the unsharded uncut run's (s, eta,
    n_active, events, the eval rounds), its params and eval losses within
    PARAM_TOL of it (the all-reduce sums in another order)."""
    baselines = {}
    for mode in ("plan", "device"):
        baselines[mode] = port_scheduler(mode, eta0=SHARDED_ETA0)
        baselines[mode].run(ROUNDS, eval_every=EVAL_EVERY)
        sch = port_scheduler(mode, eta0=SHARDED_ETA0)
        sch.run(CUT, eval_every=EVAL_EVERY)
        sch.save(str(tmp_path / mode))
    mp.spawn(_sharded_rank, nprocs=N_RANKS, join=True,
             args=(N_RANKS, str(tmp_path / "pg"), str(tmp_path),
                   str(tmp_path)))
    for r in range(N_RANKS):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got = pickle.load(f)
        for mode, base in baselines.items():
            assert got[mode]["slots"] == range(2 * r, 2 * r + 2)
            for (tau, eta, n_active, event, s, loss), h in zip(
                    got[mode]["history"], base.history, strict=True):
                assert (tau, eta, n_active, event) == \
                    (h.tau, h.eta, h.n_active, h.event)
                np.testing.assert_array_equal(s, h.s)
                assert np.isnan(loss) == np.isnan(h.loss)
                if not np.isnan(loss):
                    np.testing.assert_allclose(loss, h.loss, rtol=1e-5)
            for k, v in base.params.items():
                np.testing.assert_allclose(got[mode]["params"][k], v.numpy(),
                                           err_msg=f"{mode} {k}", **PARAM_TOL)
