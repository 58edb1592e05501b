"""Bit-exact threefry2x32 random numbers, in JAX's partitionable layout.

The reference draws every random number through `jax.random` with the
threefry2x32 generator and `jax_threefry_partitionable=True`. A run of
the port reproduces a reference run only if it draws the same bits, so
this module re-implements the generator and the samplers the engine
uses, following `jax/_src/prng.py` and `jax/_src/random.py`:

  key(seed)            [0, seed mod 2**32] (64-bit seeds are off)
  split(key, n)        threefry(key, (0, i)) for i < n, words stacked
  fold_in(key, d)      threefry(key, (0, d)) on a single count pair
  random_bits          bits1 ^ bits2 of threefry(key, (0, i))
  uniform              23 random mantissa bits under exponent 0, - 1
  bernoulli            uniform < p, both float32
  permutation          `_shuffle`: rounds of stable sorts on 32-bit draws

A key is a CPU tensor of two uint32 words held as int64, so splitting
and folding run on the host and never wait for the card; only the
samplers, which take a `device`, produce device tensors. All 32-bit
arithmetic runs in int64 masked to 32 bits, which gives the same bits on
the CPU and on CUDA.
"""
from __future__ import annotations

import math

import torch

from repro_torch.fp32 import f32, fma32

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of count pairs (x1, x2) under
    the key words (k1, k2). Each may be a Python int or an int64 tensor
    holding uint32 values; returns two such values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def _words(key) -> tuple:
    k = key.tolist()
    return int(k[0]), int(k[1])


def key(seed: int):
    """The key `jax.random.key(seed)` holds (its `key_data`)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def wrap_key_data(data):
    """A key from its two uint32 words (numpy or tensor)."""
    return torch.as_tensor([int(w) for w in list(data)], dtype=torch.int64)


def split(key, n: int = 2):
    """(n, 2) keys, as `jax.random.split(key, n)` (hashed on the host,
    in Python integers)."""
    k1, k2 = _words(key)
    return torch.tensor([threefry2x32(k1, k2, 0, i) for i in range(n)],
                        dtype=torch.int64)


def fold_in(key, data: int):
    """`jax.random.fold_in(key, data)`."""
    k1, k2 = _words(key)
    return torch.tensor(threefry2x32(k1, k2, 0, int(data) & _MASK),
                        dtype=torch.int64)


def random_bits(key, shape, device=None):
    """32-bit draws (int64 holding uint32) of `shape`, as
    `jax.random.bits(key, shape, uint32)`."""
    k1, k2 = _words(key)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise NotImplementedError("more than 2**32 draws from one key")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, 0, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None):
    """float32 draws in [minval, maxval), as `jax.random.uniform`. The
    scale-and-shift is one float32 multiply-add rounded once, the
    fused form XLA compiles it to (a plain multiply when minval is 0)."""
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - 1.0
    lo, hi = f32(minval), f32(maxval)
    if lo == 0.0:
        return floats * hi
    return fma32(floats, f32(hi - lo), lo).clamp(min=lo)


def bernoulli(key, p: float, shape, device=None):
    """bool draws with P(True) = p, as `jax.random.bernoulli` (mode
    "low": one float32 uniform against float32 p)."""
    return uniform(key, shape, device=device) < f32(p)


def permutation(key, x):
    """A shuffle of the 1-D tensor `x`, as `jax.random.permutation(key,
    x)`: `num_rounds` stable sorts, each keyed on fresh 32-bit draws."""
    n = x.shape[0]
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))
    for _ in range(rounds):
        key, sub = split(key)
        sort_keys = random_bits(sub, (n,), device=x.device)
        idx = torch.sort(sort_keys, stable=True).indices
        x = x[idx]
    return x

