"""Pytree and control-plane checkpoints: a flattened-key npz plus a JSON
manifest, in the reference's format (``repro/checkpoint/io.py``), so a
checkpoint written by either package loads in the other.

Two layers:

  * ``save_checkpoint``/``load_checkpoint``: params only (a flattened
    dict tree in ``params.npz`` and ``manifest.json``);
  * ``save_fed_checkpoint``/``load_fed_checkpoint``: a federation run's
    whole restart state, params plus the ``FedState`` dict
    (``fed/state.py``), the round history and the engine geometry, so a
    killed streamed run resumes round for round
    (``StreamScheduler.save``/``restore``).  ``jsonify_tree`` splits the
    plain-data structures into a JSON skeleton (in the manifest) and the
    numpy arrays it referenced (in the npz under ``blob/...`` keys);
    ``dejsonify_tree`` puts them back.  ``fed-checkpoint-v2``
    (``client_chunks=True``) writes each client's payload as its own
    checksummed ``clients/client-<id>.npz``.

The durability contract:

  * every file is written atomically: into a ``*.tmp`` sibling, fsynced,
    ``os.replace``d over its name, then the directory fsynced, so a kill
    mid-write leaves the previous checkpoint or the new one, never a torn
    file;
  * the npz (and any client chunks) first, the manifest last: the
    manifest is the commit record and carries the SHA-256 of every file,
    checked on load;
  * a torn, truncated or mangled checkpoint raises
    ``CorruptCheckpointError``, never a numpy, zip or JSON error;
  * a leaf of a dtype numpy has no native form of (bfloat16 and the float8
    types) is stored as an unsigned-int view of its bits with its dtype's
    name in the manifest's ``array_dtypes``, as the reference stores its
    ml_dtypes leaves.  Leaves may be numpy arrays or torch tensors; on
    load such a leaf comes back as a torch tensor of that dtype, bit for
    bit, and every other leaf as a numpy array.

``injector`` is a fault-injection hook: any object with ``fire(site,
**kw)``; it fires at ``ckpt_save`` (a file staged, before its rename) and
``ckpt_written`` (the checkpoint committed), as the reference's does.

``telemetry`` (``repro_torch.obs``; None is the null default) times the
spans ``ckpt.save`` and ``ckpt.load`` and counts the reference's
``ckpt_saves_total``, ``ckpt_save_bytes_total`` (the npz and every client
chunk), ``ckpt_loads_total``, ``ckpt_load_bytes_total`` (the npz) and
``ckpt_checksum_failures_total`` (loads refused as corrupt).
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from repro_torch.obs.telemetry import resolve as resolve_telemetry

_ARRAY_KEY = "__npz__"
_TUPLE_KEY = "__tuple__"


class CorruptCheckpointError(RuntimeError):
    """The on-disk checkpoint is unreadable or fails its manifest
    checksum (torn write, bitrot, truncation)."""


# -- durability helpers --------------------------------------------------------

def _fsync_dir(path: str) -> None:
    """Best-effort fsync of the containing directory, so that the rename
    itself is durable (not every platform or filesystem allows it)."""
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                     os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_savez(path: str, arrays: dict, injector=None) -> str:
    """Write an npz atomically (tmp, fsync, os.replace) and return its
    SHA-256.  An injected write failure raises after the payload was
    staged and before the rename: the file under ``path`` is never
    torn."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
            if injector is not None:
                injector.fire("ckpt_save", path=path)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _fsync_dir(path)
    return _sha256_file(path)


def _atomic_write_text(path: str, text: str) -> None:
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _fsync_dir(path)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


# -- leaves: numpy and torch, native and not -----------------------------------

_UINT_BY_ITEMSIZE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_INT_BY_ITEMSIZE = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}
_TORCH_INT_BY_ITEMSIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}


def _host(a):
    """A leaf as (numpy array npz can hold, dtype name or None): native
    numpy dtypes as they are; bfloat16 and other dtypes numpy has no
    native form of as an unsigned-int view of their bits, with the name
    the reference records (``str`` of the ml_dtypes dtype)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.is_floating_point() and t.dtype not in (
                torch.float16, torch.float32, torch.float64):
            bits = t.view(_TORCH_INT_BY_ITEMSIZE[t.element_size()]).numpy()
            return (bits.view(_UINT_BY_ITEMSIZE[t.element_size()]),
                    str(t.dtype).removeprefix("torch."))
        return t.numpy(), None
    a = np.asarray(a)
    if a.dtype.kind in "biufcSU":
        return a, None
    return a.view(_UINT_BY_ITEMSIZE[a.dtype.itemsize]), str(a.dtype)


def _encode_arrays(arrays: dict):
    out, dtypes = {}, {}
    for k, a in arrays.items():
        out[k], name = _host(a)
        if name is not None:
            dtypes[k] = name
    return out, dtypes


def _decode_arrays(arrays: dict, dtypes: dict) -> dict:
    """Undo _encode_arrays: each leaf named in ``dtypes`` becomes a torch
    tensor of that dtype holding the stored bits (torch names bfloat16 and
    the float8 types as ml_dtypes does)."""
    for k, name in (dtypes or {}).items():
        if k not in arrays:
            continue
        dt = getattr(torch, name, None)
        if not isinstance(dt, torch.dtype):
            raise CorruptCheckpointError(
                f"checkpoint leaf {k!r} has dtype {name!r}, which torch "
                f"does not name")
        bits = arrays[k]
        arrays[k] = torch.from_numpy(np.ascontiguousarray(
            bits.view(_INT_BY_ITEMSIZE[bits.dtype.itemsize]))).view(dt)
    return arrays


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def jsonify_tree(obj, arrays: dict, prefix: str = "blob"):
    """Split a plain-data structure (dicts, lists, tuples, scalars, numpy
    arrays, torch tensors) into a JSON-able skeleton and the arrays it
    held.  Each array leaf becomes ``{"__npz__": key}`` and goes into
    ``arrays`` under that key; tuples are tagged so they come back as
    tuples.  Dict keys must be strings: an int key would come back a
    string (FedState stores its int-keyed maps as sorted item lists)."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        key = f"{prefix}/{len(arrays)}"
        arrays[key] = obj
        return {_ARRAY_KEY: key}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, dict):
        for k in obj:
            if not isinstance(k, str):
                raise TypeError(f"jsonify_tree: dict keys must be str, "
                                f"got {k!r}")
        return {k: jsonify_tree(v, arrays, prefix)
                for k, v in obj.items()}
    if isinstance(obj, tuple):
        return {_TUPLE_KEY: [jsonify_tree(v, arrays, prefix) for v in obj]}
    if isinstance(obj, list):
        return [jsonify_tree(v, arrays, prefix) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"jsonify_tree: unsupported type {type(obj)!r}")


def dejsonify_tree(obj, arrays: dict):
    """Inverse of jsonify_tree: put the extracted arrays back."""
    if isinstance(obj, dict):
        if set(obj) == {_ARRAY_KEY}:
            return arrays[obj[_ARRAY_KEY]]
        if set(obj) == {_TUPLE_KEY}:
            return tuple(dejsonify_tree(v, arrays)
                         for v in obj[_TUPLE_KEY])
        return {k: dejsonify_tree(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [dejsonify_tree(v, arrays) for v in obj]
    return obj


# -- params only ---------------------------------------------------------------

def save_checkpoint(path: str, params, step: int = 0, extra: dict = None):
    os.makedirs(path, exist_ok=True)
    enc, dtypes = _encode_arrays(_flatten(params))
    manifest = {
        "step": step,
        "keys": {k: {"shape": list(a.shape),
                     "dtype": dtypes.get(k, str(a.dtype))}
                 for k, a in enc.items()},
        "extra": extra or {},
    }
    sha = _atomic_savez(os.path.join(path, "params.npz"), enc)
    manifest["array_dtypes"] = dtypes
    manifest["npz_sha256"] = sha
    _atomic_write_text(os.path.join(path, "manifest.json"),
                       json.dumps(manifest, indent=2))


def load_checkpoint(path: str, verify: bool = True):
    manifest = _read_manifest(os.path.join(path, "manifest.json"))
    npz = os.path.join(path, "params.npz")
    if verify:
        _verify_npz(npz, manifest)
    flat = _decode_arrays(_read_npz(npz), manifest.get("array_dtypes"))
    return _unflatten(flat), manifest


def _read_manifest(path: str) -> dict:
    try:
        with open(path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise
    except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
        raise CorruptCheckpointError(
            f"unreadable checkpoint manifest {path!r}: {e}") from e
    if not isinstance(manifest, dict):
        raise CorruptCheckpointError(
            f"unreadable checkpoint manifest {path!r}: not a JSON object")
    return manifest


def _read_npz(path: str) -> dict:
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise
    except Exception as e:      # zip and npy format errors of a torn file
        raise CorruptCheckpointError(
            f"unreadable checkpoint payload {path!r}: {e}") from e


def _verify_file(path: str, want: str, what: str) -> None:
    try:
        got = _sha256_file(path)
    except OSError as e:
        raise CorruptCheckpointError(
            f"unreadable {what} {path!r}: {e}") from e
    if got != want:
        raise CorruptCheckpointError(
            f"{what} {path!r} fails its manifest checksum (expected "
            f"sha256 {want[:12]}…, got {got[:12]}…): torn write or "
            f"bitrot; restore from an older snapshot")


def _verify_npz(path: str, manifest: dict) -> None:
    """Checksum gate (manifests written before checksums carry none and
    skip it)."""
    want = manifest.get("npz_sha256")
    if want is not None:
        _verify_file(path, want, "checkpoint payload")


# -- federation runs (params + FedState + history) -----------------------------

def save_fed_checkpoint(path: str, params, state: dict, *,
                        history: dict = None, config: dict = None,
                        extra: dict = None, injector=None,
                        telemetry=None, client_chunks: bool = False) -> None:
    """Persist a federation run's whole restart state.

    ``params``: a dict tree of arrays or tensors, in the layout the
    reader expects (``StreamScheduler.save`` writes the reference's);
    ``state``: ``FedState.to_dict()``; ``history``:
    ``fed.stream.history_to_dict``; ``config``: the engine geometry
    (``StreamScheduler.engine_config``).  One npz holds the param leaves
    (``params/...``) and every array of state and history
    (``blob/...``); the manifest holds their JSON skeletons, the npz's
    SHA-256 and the dtype of every non-native leaf.

    ``client_chunks=True`` (``fed-checkpoint-v2``) writes each client's
    payload as its own ``clients/client-<id>.npz``, one at a time, with
    its SHA-256 in the manifest.  Chunks, then the main npz, then the
    manifest, each atomically: a kill at any byte leaves the previous
    checkpoint loadable.  Chunk files beyond the committed count (left by
    an earlier save of more clients) are removed after the commit."""
    tel = resolve_telemetry(telemetry)
    with tel.span("ckpt.save", path=path):
        npz_path, saved_bytes = _save_fed(
            path, params, state, history=history, config=config,
            extra=extra, injector=injector, client_chunks=client_chunks)
        tel.counter("ckpt_saves_total", "fed checkpoints written").inc()
        tel.counter("ckpt_save_bytes_total",
                    "npz bytes written by fed checkpoint saves").inc(
            saved_bytes)
        if injector is not None:
            injector.fire("ckpt_written", path=npz_path)


def _save_fed(path: str, params, state: dict, *, history, config, extra,
              injector, client_chunks: bool):
    """save_fed_checkpoint's files: (the npz's path, the bytes of the npz
    and of every client chunk)."""
    os.makedirs(path, exist_ok=True)
    chunk_recs = None
    chunk_bytes = 0
    if client_chunks:
        state = dict(state)
        clients = state.pop("clients")
        chunk_dir = os.path.join(path, "clients")
        os.makedirs(chunk_dir, exist_ok=True)
        chunk_recs = []
        for idx, cdict in enumerate(clients):
            c_arrays: dict = {}
            skel = jsonify_tree(cdict, c_arrays, prefix="c")
            enc, dtypes = _encode_arrays(c_arrays)
            fname = f"client-{idx:08d}.npz"
            fpath = os.path.join(chunk_dir, fname)
            sha = _atomic_savez(fpath, enc, injector=injector)
            chunk_recs.append({"file": f"clients/{fname}",
                               "skeleton": skel, "array_dtypes": dtypes,
                               "sha256": sha})
            chunk_bytes += os.path.getsize(fpath)
        state["clients"] = []       # stored chunked; see the manifest
    flat = _flatten(params)
    arrays = {f"params/{k}": v for k, v in flat.items()}
    manifest = {
        "format": ("fed-checkpoint-v2" if client_chunks
                   else "fed-checkpoint-v1"),
        "state": jsonify_tree(state, arrays, prefix="blob/state"),
        "history": (jsonify_tree(history, arrays, prefix="blob/history")
                    if history is not None else None),
        "config": config or {},
        "extra": extra or {},
        "param_keys": sorted(flat),
    }
    if chunk_recs is not None:
        manifest["client_chunks"] = chunk_recs
    enc, dtypes = _encode_arrays(arrays)
    npz_path = os.path.join(path, "fed_checkpoint.npz")
    sha = _atomic_savez(npz_path, enc, injector=injector)
    manifest["array_dtypes"] = dtypes
    manifest["npz_sha256"] = sha
    _atomic_write_text(os.path.join(path, "fed_manifest.json"),
                       json.dumps(manifest, indent=2))
    if chunk_recs is not None:
        _prune_stale_chunks(os.path.join(path, "clients"), len(chunk_recs))
    return npz_path, os.path.getsize(npz_path) + chunk_bytes


def _prune_stale_chunks(chunk_dir: str, n_live: int) -> None:
    """Best-effort removal of chunk files beyond the committed count (the
    loader reads only the files its manifest lists)."""
    try:
        names = os.listdir(chunk_dir)
    except OSError:
        return
    for name in names:
        if not (name.startswith("client-") and name.endswith(".npz")):
            continue
        try:
            idx = int(name[len("client-"):-len(".npz")])
        except ValueError:
            continue
        if idx >= n_live:
            try:
                os.unlink(os.path.join(chunk_dir, name))
            except OSError:
                pass


def load_fed_checkpoint(path: str, verify: bool = True, telemetry=None):
    """Returns (params, state_dict, history_dict, config, extra).

    Raises CorruptCheckpointError when the manifest is unreadable or
    incomplete, a file fails its recorded checksum, or a payload cannot
    be parsed."""
    tel = resolve_telemetry(telemetry)
    with tel.span("ckpt.load", path=path):
        try:
            out = _load_fed(path, verify)
        except CorruptCheckpointError:
            tel.counter("ckpt_checksum_failures_total",
                        "fed checkpoint loads rejected as corrupt "
                        "(bad checksum / unreadable payload)").inc()
            raise
        tel.counter("ckpt_loads_total", "fed checkpoints loaded").inc()
        tel.counter("ckpt_load_bytes_total",
                    "npz bytes read by fed checkpoint loads").inc(
            os.path.getsize(os.path.join(path, "fed_checkpoint.npz")))
    return out


def _load_fed(path: str, verify: bool):
    npz_path = os.path.join(path, "fed_checkpoint.npz")
    manifest = _read_manifest(os.path.join(path, "fed_manifest.json"))
    fmt = manifest.get("format")
    if fmt not in ("fed-checkpoint-v1", "fed-checkpoint-v2"):
        raise CorruptCheckpointError(
            f"not a fed checkpoint: {path!r} ({fmt!r})")
    if verify:
        _verify_npz(npz_path, manifest)
    arrays = _decode_arrays(_read_npz(npz_path),
                            manifest.get("array_dtypes"))
    try:
        clients = None
        if fmt == "fed-checkpoint-v2":
            clients = []
            for rec in manifest["client_chunks"]:
                fpath = os.path.join(path, rec["file"])
                if verify:
                    _verify_file(fpath, rec["sha256"], "client chunk")
                c_arrays = _decode_arrays(_read_npz(fpath),
                                          rec.get("array_dtypes"))
                clients.append(dejsonify_tree(rec["skeleton"], c_arrays))
        params = _unflatten({k[len("params/"):]: v
                             for k, v in arrays.items()
                             if k.startswith("params/")})
        state = dejsonify_tree(manifest["state"], arrays)
        if clients is not None:
            state["clients"] = clients
        history = (dejsonify_tree(manifest["history"], arrays)
                   if manifest["history"] is not None else None)
        return params, state, history, manifest["config"], manifest["extra"]
    except (KeyError, TypeError) as e:
        raise CorruptCheckpointError(
            f"checkpoint {path!r} does not match its manifest: {e!r}") from e
