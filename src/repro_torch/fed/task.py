"""ClientTask: the model/step layer behind the federation engine.

Counterpart of ``repro/fed/task.py`` (``BufferSpec``, ``ClientTask``,
``ArrayTask``, ``LMTask``).  A task names the per-sample arrays a client
contributes (``buffers``), presents a gathered batch to the loss
(``make_batch``) and carries the loss itself.  The port's losses take a
leading client axis on params and batch and return the (C,) per-client
losses (``models.small.make_loss_fn``; the LM task's runs its clients one
after another, ``core.fed_step.per_client_loss``).

Usage::

    task = LMTask(get_config("mamba2-130m").reduced(), seq_len=64)
    clients = [Client(x=task.token_stream(rng, n=40, domain=d),
                      trace=TRACES[d]) for d in range(4)]
    eng = RoundEngine(task=task, clients=clients, local_epochs=2,
                      batch_size=2, mode="client_sequential", device="cpu")
    params = task.init_params(0, device="cpu")
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import params as layout
from repro_torch.configs.paper import PAPER_CONFIGS

from repro_torch.core.fed_step import flatten_tree, per_client_loss
from repro_torch.data.tokens import client_token_stream
from repro_torch.models import transformer
from repro_torch.models.params import init_params

__all__ = ["BufferSpec", "ClientTask", "ArrayTask", "LMTask"]


@dataclass(frozen=True)
class BufferSpec:
    """One per-sample device-resident buffer: the engine stores it as a
    ``(capacity, Nmax) + shape`` stack of the given dtype."""
    shape: Tuple[int, ...]
    dtype: Any = np.float32


class ClientTask:
    """Protocol (duck-typed base) between the federation engine and a
    model family.  Subclasses define:

    buffers          — dict name -> BufferSpec of per-sample arrays.
    loss_fn(p, b)    — (C,) per-client training losses on one batch, with
                       a leading client axis on p and b.
    client_arrays(c) — dict name -> (n, *spec.shape) arrays for a Client.
    make_batch(g)    — map gathered buffers (each (..., B) + spec.shape)
                       to the loss_fn batch.
    init_params(key) — fresh parameter dict.
    param_specs(p)   — per-leaf placement specs, or None to replicate (the
                       paper models; the port shards no params yet).
    disk_params(p, kind), params_from_disk(p, kind, device)
                     — the params as ``checkpoint.io`` stores them in the
                       reference's layout, and back (default: the paper
                       models' layout for the engine's ``model_kind``).
    """

    buffers: Dict[str, BufferSpec] = {}

    def loss_fn(self, params, batch):
        raise NotImplementedError

    def client_arrays(self, client) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def make_batch(self, gathered: Dict[str, Any]):
        return gathered

    def init_params(self, key):
        raise NotImplementedError

    def param_specs(self, params):
        return None

    def disk_params(self, params, model_kind: Optional[str] = None):
        return reference_params(params, model_kind)

    def params_from_disk(self, params, model_kind: Optional[str], device):
        return port_params(params, model_kind, device)


class ArrayTask(ClientTask):
    """Feature/label clients for the paper's small models:
    ``loss_fn(params, {"x": ..., "y": ...})``; ``init_fn(key)``, where
    given, draws the params ``init_params`` returns."""

    def __init__(self, loss_fn, feature_shape: Tuple[int, ...], *,
                 init_fn=None, label_dtype=np.int32):
        self._loss_fn = loss_fn
        self._init_fn = init_fn
        self.buffers = {"x": BufferSpec(tuple(feature_shape), np.float32),
                        "y": BufferSpec((), label_dtype)}

    def loss_fn(self, params, batch):
        return self._loss_fn(params, batch)

    def client_arrays(self, client):
        return {"x": np.asarray(client.x, np.float32),
                "y": np.asarray(client.y, self.buffers["y"].dtype)}

    def init_params(self, key):
        if self._init_fn is None:
            raise NotImplementedError("ArrayTask built without init_fn")
        return self._init_fn(key)


class LMTask(ClientTask):
    """Next-token prediction over an ``ArchConfig`` of the LM zoo: the
    large-model federation path.

    Clients hold raw token streams shaped ``(n, seq_len + 1)`` (``(K,)``
    codebooks appended for the audio archs) in ``Client.x``; a training
    batch slices ``tokens = t[..., :-1]`` and ``labels = t[..., 1:]`` on
    the device, so one int32 buffer per client serves both sides of the
    shift.  ``loss_fn`` is the engine's (C,)-per-client loss over the flat
    leaves of ``core.fed_step.flatten_tree``; ``client_loss`` is one
    client's scalar ``transformer.train_loss`` over the nested tree.
    ``fsdp`` is recorded as given: the port shards no params yet (ROADMAP
    item 6), so ``param_specs`` is None."""

    def __init__(self, cfg, *, seq_len: int = 128, fsdp: bool = True):
        self.cfg = cfg
        self.seq_len = int(seq_len)
        self.fsdp = fsdp
        tail: Tuple[int, ...] = (self.seq_len + 1,)
        if cfg.n_codebooks:
            tail = tail + (cfg.n_codebooks,)
        self.buffers = {"tokens": BufferSpec(tail, np.int32)}
        self.loss_fn = per_client_loss(self.client_loss)

    # -- engine protocol ------------------------------------------------------
    def client_loss(self, params, batch):
        """One client's training loss: params the nested tree, batch
        without a client axis."""
        return transformer.train_loss(params, self.cfg, batch)

    def client_arrays(self, client):
        t = np.asarray(client.x, np.int32)
        want = self.buffers["tokens"].shape
        if t.shape[1:] != want:
            raise ValueError(f"client token stream shaped {t.shape[1:]}, "
                             f"task expects {want} (seq_len+1[, K])")
        return {"tokens": t}

    def make_batch(self, gathered):
        t = gathered["tokens"]
        # the seq axis sits before the codebook axis for audio archs
        ax = t.ndim - 2 if self.cfg.n_codebooks else t.ndim - 1
        sl = [slice(None)] * t.ndim
        sl[ax] = slice(None, -1)
        tokens = t[tuple(sl)]
        sl[ax] = slice(1, None)
        labels = t[tuple(sl)]
        return {"tokens": tokens, "labels": labels}

    def init_params(self, key, device=None):
        """The port's draw (``models.params.init_params``) from the seed
        ``key`` on ``device`` (the CUDA device unless ``"cpu"``), as the
        flat leaves the engine trains (``flatten_tree``: the reference's
        keys, "/"-joined)."""
        return flatten_tree(init_params(self.cfg, seed=int(key),
                                        device=device))

    def disk_params(self, params, model_kind: Optional[str] = None):
        """The flat leaves as they are: the reference's tree under its
        "/"-joined keys, in its layout (``checkpoint.io`` nests them and
        stores bf16 as bits)."""
        return params

    def params_from_disk(self, params, model_kind: Optional[str], device):
        """The nested tree ``checkpoint.io`` loads (numpy leaves, bf16 as
        torch tensors) -> the flat leaves the engine trains, on device,
        bit for bit."""
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.array(v))).to(device)
                for k, v in flatten_tree(params).items()}

    # -- client construction helpers ------------------------------------------
    def token_stream(self, rng: np.random.Generator, *, n: int,
                     domain: int = 0, zipf_a: float = 1.2) -> np.ndarray:
        """A client's dataset: ``n`` sequences of ``seq_len + 1`` tokens
        from the synthetic non-IID Zipf stream (``data/tokens.py``), the
        reference's draw from the same ``rng``."""
        K = max(1, self.cfg.n_codebooks)
        flat = client_token_stream(rng, self.cfg.vocab, domain,
                                   n * (self.seq_len + 1) * K,
                                   zipf_a=zipf_a)
        return flat.reshape((n,) + self.buffers["tokens"].shape)


# -- params on disk: the reference's layout ------------------------------------

_CONFIG_OF_KIND = {cfg.kind: cfg for cfg in PAPER_CONFIGS.values()}


def _config_of(kind: Optional[str], params):
    """The paper model config whose layout ``kind`` names; None where the
    two packages' layouts are one.  A 4-D leaf (a convolution's weights)
    with no kind raises: its layout would be a guess."""
    if kind is None:
        if any(np.ndim(v) == 4 for v in params.values()):
            raise ValueError(
                "parameters with a 4-D (convolution) leaf need the model's "
                "kind (RoundEngine(model_kind=...) or restore(model_kind="
                "...)): the CNN's layout on disk is the reference's, not "
                "the port's")
        return None
    if kind not in _CONFIG_OF_KIND:
        raise ValueError(f"unknown model kind {kind!r}; expected one of "
                         f"{sorted(_CONFIG_OF_KIND)}")
    return _CONFIG_OF_KIND[kind]


_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)
_TORCH_INT_BY_ITEMSIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}


def _as_bits(params) -> Tuple[dict, dict]:
    """Split leaves numpy has no dtype for (bfloat16, the float8 types) into
    a signed-int view of their bits on the host, so the layout functions
    can move them, and the dtype each had: (leaves, {name: dtype})."""
    out, dtypes = {}, {}
    for k, v in params.items():
        if isinstance(v, torch.Tensor) and v.is_floating_point() \
                and v.dtype not in _NUMPY_FLOATS:
            dtypes[k] = v.dtype
            v = v.detach().cpu().view(_TORCH_INT_BY_ITEMSIZE[v.element_size()])
        out[k] = v
    return out, dtypes


def reference_params(params, kind: Optional[str]) -> dict:
    """The port's params as the reference lays them out on disk: numpy,
    except bf16 (and float8) leaves, which stay torch tensors for
    ``checkpoint.io`` to store as bits under their dtype's name."""
    cfg = _config_of(kind, params)
    params, dtypes = _as_bits(params)
    if cfg is None:
        out = {k: v.detach().cpu().numpy() for k, v in params.items()}
    else:
        out = layout.to_numpy(params, cfg)
    for k, dt in dtypes.items():
        out[k] = torch.from_numpy(out[k]).view(dt)
    return out


def port_params(params, kind: Optional[str], device) -> dict:
    """The reference's layout on disk -> the port's tensors on device, bf16
    (and float8) leaves, as ``checkpoint.io`` loads them, bit for bit."""
    cfg = _config_of(kind, params)
    params, dtypes = _as_bits(params)
    params = {k: v.numpy() if isinstance(v, torch.Tensor) else v
              for k, v in params.items()}
    if cfg is None:
        out = {k: torch.tensor(np.asarray(v), device=device)
               for k, v in params.items()}
    else:
        out = layout.from_jax(params, cfg, device)
    for k, dt in dtypes.items():
        out[k] = out[k].view(dt)
    return out
