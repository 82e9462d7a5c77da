"""The JAX threefry functions the sampling draws use, bit for bit, in torch.

A port of the parts of ``jax.random`` that lightgbm_tpu/ops/sampling.py
reaches, so a device draw here gives the JAX package's mask bit for bit:

- ``prng_key(seed)``: ``jax.random.PRNGKey`` (``threefry_seed``,
  jax/_src/prng.py): the 64-bit seed split into (high word, low word);
- ``threefry2x32``: the Threefry-2x32 hash, 20 rounds (``_threefry2x32_
  lowering``);
- ``fold_in(key, data)``: the hash of the counter pair (0, data)
  (``threefry_fold_in``);
- ``random_bits(key, n)``: 32-bit bits under the *partitionable* scheme
  (``_threefry_random_bits_partitionable``, the default of the JAX this
  package is checked against): element i hashes the counter pair
  (i >> 32, i & 0xFFFFFFFF) and keeps the XOR of the two output words;
- ``uniform(key, n)``: float32 in [0, 1) (jax/_src/random.py
  ``_uniform``): the bits shifted right by 9, ORed with the bits of 1.0,
  read as float32, minus 1.

Keys are pairs of Python ints.  Words are held in int64 tensors masked to
32 bits, so every shift and add is exact on any device.
"""
from __future__ import annotations

from typing import Tuple

import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: (seed >> 32, seed & 0xFFFFFFFF).  A
    seed of 32 bits, signed or not, has a high word of 0 there (JAX's
    default mode holds it in 32 bits before the shift)."""
    seed = int(seed)
    if -(1 << 31) <= seed < (1 << 32):
        return (0, seed & _M32)
    return ((seed >> 32) & _M32, seed & _M32)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash of the counter words (x0, x1) (int64
    tensors of 32-bit values) under ``key``; returns the two output
    words."""
    ks = (key[0] & _M32, key[1] & _M32,
          (key[0] ^ key[1] ^ _PARITY) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    y0, y1 = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _M32]))
    return int(y0), int(y1)


def random_bits(key: Key, n: int, device=None) -> torch.Tensor:
    """[n] int64 of 32-bit values: ``jax.random.bits(key, (n,))`` under
    the partitionable scheme."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, idx >> 32, idx & _M32)
    return y0 ^ y1


def uniform(key: Key, n: int, device=None) -> torch.Tensor:
    """[n] float32 in [0, 1): ``jax.random.uniform(key, (n,))``."""
    bits = (random_bits(key, n, device) >> 9) | _ONE_F32_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0


__all__ = ["Key", "fold_in", "prng_key", "random_bits", "threefry2x32",
           "uniform"]
