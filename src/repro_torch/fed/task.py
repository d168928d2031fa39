"""ClientTask: the model/step layer behind the federation engine.

Counterpart of ``repro/fed/task.py`` (``BufferSpec``, ``ClientTask``,
``ArrayTask``; the LM task waits for the LM slice).  A task names the
per-sample arrays a client contributes (``buffers``), presents a gathered
batch to the loss (``make_batch``) and carries the loss itself.  The
port's losses take a leading client axis on params and batch and return
the (C,) per-client losses (``models.small.make_loss_fn``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np

__all__ = ["BufferSpec", "ClientTask", "ArrayTask"]


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
