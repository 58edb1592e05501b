"""Bit-exact threefry2x32 random numbers, in JAX's partitionable layout.

The reference draws every random number through `jax.random` with the
threefry2x32 generator and `jax_threefry_partitionable=True`. A run of
the port reproduces a reference run only if it draws the same bits, so
this module re-implements the generator and the samplers the engine
uses, following `jax/_src/prng.py` and `jax/_src/random.py`:

  key(seed)            [0, seed mod 2**32] (64-bit seeds are off)
  split(key, n)        threefry(key, (0, i)) for i < n, words stacked
  fold_in(key, d)      threefry(key, (0, d)) on a single count pair
  random_bits, bits    bits1 ^ bits2 of threefry(key, (0, i))
  uniform              23 random mantissa bits under exponent 0, - 1
  bernoulli            uniform < p, both float32
  permutation          `_shuffle`: rounds of stable sorts on 32-bit draws

A key is a CPU tensor of two uint32 words held as int64, so splitting
and folding run on the host and never wait for the card; only the
samplers, which take a `device`, produce device tensors. All 32-bit
arithmetic runs in int64 masked to 32 bits, which gives the same bits on
the CPU and on CUDA.

A key batch (`keys(seeds)`) is an (R, 2) tensor, one replica's key a
row: what `jax.vmap` of each function computes, row r bit-equal to the
solo call on key r. `split` of a batch returns (n, R, 2) (subkey i of
every replica in row i), so `a, b = split(k)` unpacks a batch as it
unpacks one key. Splitting and folding hash the R keys together in
numpy int64 arrays; a sampler draws (R, *shape) in one set of tensor
ops, with the R key words handed to the card by a non-blocking copy
from a fresh pinned buffer (PyTorch's pinned-memory cache does not hand
the buffer out again until the copy has run).
"""
from __future__ import annotations

import math

import numpy as np
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


def _batch_words(keys) -> tuple:
    """A key batch's two words, as (R,) numpy int64 arrays."""
    a = keys.numpy()
    return a[:, 0], a[:, 1]


def key(seed: int):
    """The key `jax.random.key(seed)` holds (its `key_data`)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def keys(seeds):
    """(R, 2): the keys of `seeds`, one a row (`key(seeds[r])`)."""
    return torch.tensor([[0, int(s) & _MASK] for s in seeds],
                        dtype=torch.int64).reshape(-1, 2)


def wrap_key_data(data):
    """A key, or an (R, 2) key batch, from its uint32 words (numpy or
    tensor)."""
    return torch.from_numpy(
        np.asarray(data).astype(np.uint32).astype(np.int64))


def split(key, n: int = 2):
    """(n, 2) keys, as `jax.random.split(key, n)` (hashed on the host,
    in Python integers). A batch gives (n, R, 2): row i is
    `jax.vmap(split)(keys)[:, i]`."""
    if key.dim() == 2:
        k1, k2 = _batch_words(key)
        i = np.arange(n, dtype=np.int64)[:, None]
        a, b = threefry2x32(k1[None, :], k2[None, :], 0, i)
        return torch.from_numpy(np.stack([a, b], axis=-1))
    k1, k2 = _words(key)
    return torch.tensor([threefry2x32(k1, k2, 0, i) for i in range(n)],
                        dtype=torch.int64)


def fold_in(key, data: int):
    """`jax.random.fold_in(key, data)`, of one key or of each key of a
    batch."""
    d = int(data) & _MASK
    if key.dim() == 2:
        k1, k2 = _batch_words(key)
        return torch.from_numpy(np.stack(threefry2x32(k1, k2, 0, d),
                                         axis=-1))
    k1, k2 = _words(key)
    return torch.tensor(threefry2x32(k1, k2, 0, d), dtype=torch.int64)


def _words_on(keys, device):
    """The (R, 2) key batch on `device`: on the card through a fresh
    pinned buffer, copied without blocking the host."""
    if device is None or torch.device(device).type == "cpu":
        return keys
    return keys.pin_memory().to(device, non_blocking=True)


def random_bits(key, shape, device=None):
    """32-bit draws (int64 holding uint32) of `shape`, as
    `jax.random.bits(key, shape, uint32)`; (R, *shape) from a batch,
    row r the draw from key r."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise NotImplementedError("more than 2**32 draws from one key")
    if key.dim() == 2:
        if key.shape[0] == 1:  # one replica: its words as scalars
            return random_bits(key[0], shape, device)[None]
        kd = _words_on(key, device)
        k1, k2 = kd[:, :1], kd[:, 1:]
    else:
        k1, k2 = _words(key)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, 0, lo)
    return (b1 ^ b2).reshape(tuple(b1.shape[:-1]) + shape)


def bits(key, shape, device=None):
    """`jax.random.bits(key, shape, jnp.uint32)`: the uint32 draws, held
    in int64 (the module's word type), of `shape`."""
    return random_bits(key, shape, device)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None):
    """float32 draws in [minval, maxval), as `jax.random.uniform` (of
    `shape`, or (R, *shape) from a key batch). The
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

