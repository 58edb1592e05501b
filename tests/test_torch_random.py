"""The port's threefry2x32 generator against `jax.random`, bit for bit.

Every trajectory test of the port rests on these draws, so each sampler
is held bitwise to JAX's on 24 seeds, at the engine's shapes (10000, 2)
and at odd sizes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import random as trandom  # noqa: E402

SEEDS = list(range(20)) + [12345, 2**31 - 1, 2**32 + 5, -3]
SHAPES = [(10000, 2), (7,), (1,), (333, 3)]


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.reshape(-1).view(np.uint8),
                          b.reshape(-1).view(np.uint8))


def _key_ops(seed):
    jk, tk = jax.random.key(seed), trandom.key(seed)
    assert np.array_equal(_words(jk), tk.numpy())
    for n in (2, 3, 5):
        assert np.array_equal(_words(jax.random.split(jk, n)),
                              trandom.split(tk, n).numpy())
    for d in (0, 1, 2, 0x6b0a, 0x7a47, 2**32 - 1):
        assert np.array_equal(_words(jax.random.fold_in(jk, d)),
                              trandom.fold_in(tk, d).numpy())


def _bits(seed):
    jk, tk = jax.random.key(seed), trandom.key(seed)
    for shape in SHAPES:
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        got = trandom.random_bits(tk, shape).numpy().astype(np.uint32)
        _bits_equal(want, got)


def _uniform(seed):
    jk, tk = jax.random.key(seed), trandom.key(seed)
    for shape in SHAPES:
        for lo, hi in ((0.0, 1.0), (0.0, 10000.0), (-3.7, 11.3)):
            want = jax.random.uniform(jk, shape, minval=lo, maxval=hi)
            got = trandom.uniform(tk, shape, minval=lo, maxval=hi)
            _bits_equal(want, got.numpy())


def _bernoulli(seed):
    jk, tk = jax.random.key(seed), trandom.key(seed)
    for shape in SHAPES:
        for p in (0.2, 0.5, 0.97):
            want = jax.random.bernoulli(jk, p, shape)
            _bits_equal(want, trandom.bernoulli(tk, p, shape).numpy())


def _permutation(seed):
    jk, tk = jax.random.key(seed), trandom.key(seed)
    for n, n_lp in ((4, 4), (300, 4), (10000, 4), (4097, 7)):
        want = jax.random.permutation(jk, jnp.arange(n) % n_lp)
        got = trandom.permutation(
            tk, (torch.arange(n) % n_lp).to(torch.int32))
        _bits_equal(want, got.numpy())


@pytest.mark.parametrize("check", [_key_ops, _bits, _uniform, _bernoulli,
                                   _permutation],
                         ids=["key_split_fold_in", "random_bits", "uniform",
                              "bernoulli", "permutation"])
def test_bitwise_equal_to_jax(check):
    for seed in SEEDS:
        check(seed)


def test_key_words_from_key_data():
    """A key carried across from the reference (its two uint32 words)
    draws what the reference's key draws."""
    jk = jax.random.fold_in(jax.random.key(9), 77)
    tk = trandom.wrap_key_data(np.asarray(jax.random.key_data(jk)))
    _bits_equal(jax.random.uniform(jk, (100,)),
                trandom.uniform(tk, (100,)).numpy())


def _nearest_f32(q):
    """The float32 nearest the rational q (ties to even)."""
    from fractions import Fraction

    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - q),
                                     int(np.array(x).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """fma32 is a fused multiply-add: on random float32 triples it
    equals a*b+c computed exactly (rationals) and rounded once to
    float32, where a multiply-then-add does not."""
    from fractions import Fraction

    from repro_torch.fp32 import fma32

    rng = np.random.default_rng(0)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * 1e-3).astype(np.float32)
    got = fma32(torch.from_numpy(a), torch.from_numpy(b),
                torch.from_numpy(c)).numpy()
    exact = np.array([_nearest_f32(Fraction(float(x)) * Fraction(float(y))
                                   + Fraction(float(z)))
                      for x, y, z in zip(a, b, c)], dtype=np.float32)
    plain = (a * b) + c
    assert np.array_equal(got, exact)
    assert not np.array_equal(plain, exact)
