"""The port's device PRNG keys against ``jax.random`` (partitionable
threefry, as ``tests/conftest.py`` sets it): every key, split, fold and
draw must be bit-equal, including seeds at and above 2**32 (PRNGKey keeps
only the low 32 bits with x64 off)."""

import numpy
import pytest

import jax

from veles_tpu import prng as jax_prng
from veles_tpu_torch import prng

SEEDS = [0, 1, 7, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 5, 2 ** 62 + 12345,
         2 ** 63 - 1]


def _eq(got, ref):
    numpy.testing.assert_array_equal(got, numpy.asarray(ref))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    _eq(prng.PRNGKey(seed), key)
    for data in (0, 1, 5, 2 ** 31 + 3):
        _eq(prng.fold_in(prng.PRNGKey(seed), data),
            jax.random.fold_in(key, data))


@pytest.mark.parametrize("num", [1, 2, 3, 17])
def test_split(num):
    key = jax.random.PRNGKey(123)
    _eq(prng.split(prng.PRNGKey(123), num), jax.random.split(key, num))


@pytest.mark.parametrize("shape", [(1,), (5, 7), (3, 4, 129)])
def test_bits_uniform_bernoulli(shape):
    key = jax.random.PRNGKey(99)
    host = prng.PRNGKey(99)
    _eq(prng.random_bits(host, shape), jax.random.bits(key, shape))
    _eq(prng.uniform(host, shape), jax.random.uniform(key, shape))
    for p in (0.5, 0.3, 0.9):
        _eq(prng.bernoulli(host, p, shape),
            jax.random.bernoulli(key, p, shape))


@pytest.mark.parametrize("lo,hi", [(0, 2), (0, 30), (0, 29), (-5, 70001),
                                   (3, 3)])
def test_randint(lo, hi):
    key = jax.random.PRNGKey(5)
    _eq(prng.randint(prng.PRNGKey(5), (64,), lo, hi),
        jax.random.randint(key, (64,), lo, hi))


@pytest.mark.parametrize("seed", [1, 42, 2 ** 40 + 9])
def test_stream_keys_match_reference(seed):
    prng.reset()
    prng.seed_all(seed)
    jax_prng.reset()
    jax_prng.seed_all(seed)
    got = [prng.get("dropout").key() for _ in range(4)]
    ref = [jax_prng.get("dropout").key() for _ in range(4)]
    for g, r in zip(got, ref):
        _eq(g, r)
    _eq(prng.get("lm").base_key(), jax_prng.get("lm").base_key())
    _eq(prng.get("lm").key_at(3, 1000), jax_prng.get("lm").key_at(3, 1000))
    # the key counter survives a snapshot round trip
    state = prng.get("dropout").state_dict()
    nxt = prng.get("dropout").key()
    prng.get("dropout").load_state_dict(state)
    _eq(prng.get("dropout").key(), nxt)
    prng.reset()
