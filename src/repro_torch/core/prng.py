"""Counter-based random draws, bit for bit as ``jax.random`` makes them.

Counterpart of the ``jax.random`` calls the reference's device-mode
sampling makes (``repro/fed/engine.py``: ``PRNGKey``, ``fold_in``,
``split``, ``uniform``).  jax's default generator is Threefry-2x32 with
``jax_threefry_partitionable`` on (the default since jax 0.5), in 32-bit
mode (``jax_enable_x64`` off), which is how the reference runs:

  * a key is two 32-bit words; ``prng_key(seed)`` is ``(0, seed mod 2^32)``;
  * ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under the key;
  * ``split(key, num)`` hashes the pairs ``(0, i)``, i < num, each pair's
    two output words making one new key;
  * ``random_bits(key, shape)`` hashes ``(0, i)`` for every flat index i of
    ``shape`` and xors the two output words;
  * ``uniform(key, shape)`` puts the top 23 of those bits under the
    exponent of 1.0 and subtracts 1.0: an f32 in [0, 1).

Words are held in ``torch.int64`` tensors and masked to 32 bits after every
add and shift (``torch.uint32`` lacks shifts and adds on some devices), so
the same functions run on the CPU and on the card and give the same bits.
Every function takes a batch of keys, shape ``(..., 2)``, as ``jax.vmap``
over a key would: the leading axes come first in the result.  Plain torch
tensor ops, one elementwise pass each: the reference too draws outside any
Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

MASK = 0xFFFFFFFF
# Threefry-2x32's rotations, alternating by group of four rounds, and the
# key schedule's parity word
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA

Key = torch.Tensor      # (..., 2) int64: two 32-bit words


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under
    key words (k0, k1); all four int64 tensors of 32-bit words,
    broadcast together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for g in range(5):
        for r in ROTATIONS[g % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` in 32-bit mode: the words (0, seed mod
    2^32)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _words(key: Key):
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is (..., 2) words, got shape "
                         f"{tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def fold_in(key: Key, data: Union[int, torch.Tensor]) -> Key:
    """``jax.random.fold_in(key, data)``: a key per ``data`` (an int or an
    integer tensor, taken mod 2^32), shape ``(*batch, *data.shape, 2)``
    for keys of shape ``(*batch, 2)``."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & MASK
    k0, k1 = (w.reshape(w.shape + (1,) * data.dim()) for w in _words(key))
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def _counts(shape: Sequence[int], device) -> torch.Tensor:
    size = math.prod(shape)
    if size >= 2 ** 32:
        raise ValueError(f"{size} draws exceed the 32-bit counter")
    return torch.arange(size, dtype=torch.int64, device=device).reshape(
        tuple(shape))


def _hash_counts(key: Key, shape: Sequence[int]):
    """Both hash words of the counters (0, i) over ``shape``, under each
    key of the batch: ``(*batch, *shape)`` each."""
    lo = _counts(shape, key.device)
    k0, k1 = (w.reshape(w.shape + (1,) * lo.dim()) for w in _words(key))
    return threefry2x32(k0, k1, torch.zeros_like(lo), lo)


def split(key: Key, num: int = 2) -> Key:
    """``jax.random.split(key, num)``: ``(*batch, num, 2)`` keys."""
    y0, y1 = _hash_counts(key, (num,))
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit): ``(*batch, *shape)``
    int64 tensor of 32-bit words."""
    y0, y1 = _hash_counts(key, tuple(shape))
    return y0 ^ y1


def uniform(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (f32 in [0, 1)):
    ``(*batch, *shape)``."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
