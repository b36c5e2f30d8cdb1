"""Named deterministic random streams — the host half.

Port of ``veles_tpu/prng.py``: every consumer of host randomness (weight
init, shuffles) pulls from a named stream whose numpy ``RandomState`` is
seeded from sha256(``"<name>:<seed>"``), exactly as in the reference, so
``init_transformer_params`` gives bit-equal weights in both packages for
the same seed, and the training slice's initial weights, synthetic data
and loader shuffles are bit-equal too.

The device half: ``key``, ``base_key`` and ``key_at`` return the keys
the reference draws from ``jax.random`` — two uint32 words, computed on
the host by a numpy threefry2x32 that reproduces jax 0.9's
partitionable-mode streams (``jax_threefry_partitionable`` on) bit for
bit: ``PRNGKey``, ``fold_in``, ``split``, 32-bit ``random_bits`` (the
flat index split into hi/lo counter words; bits = out0 ^ out1),
``uniform``, ``bernoulli`` and ``randint``.  A step hashes a few words
on the host and uploads nothing it must read back; the dropout kernel
runs the same hash on the card (``csrc/dropout.cu``).
"""

from __future__ import annotations

import hashlib

import numpy

_MASK32 = 0xFFFFFFFF
#: threefry2x32's rotation schedule and key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x0, x1)``
    under key ``(k0, k1)``, as ``jax._src.prng._threefry2x32_lowering``.

    Works on Python ints, numpy uint64 arrays and torch int64 tensors
    alike (every operand holds a value below 2**32; each step masks back
    to 32 bits), so the host keys and the dropout kernel's plain version
    share it.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = ((x1 << r) & _MASK32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def _hash(key, hi, lo):
    k0, k1 = (numpy.uint64(int(w)) for w in key)
    return threefry2x32(k0, k1, numpy.asarray(hi, numpy.uint64),
                        numpy.asarray(lo, numpy.uint64))


def _key(words):
    return numpy.asarray(words, numpy.uint64).astype(numpy.uint32)


def PRNGKey(seed):
    """``jax.random.PRNGKey(seed)`` with x64 off: the seed is cut to its
    low 32 bits (``PRNGKey(2**62 + 12345)`` is ``[0, 12345]``)."""
    return _key([0, int(seed) & _MASK32])


def fold_in(key, data):
    """``jax.random.fold_in``: the hash of the counter (0, data), on
    Python ints (one counter: ~10x faster than the numpy path, and a
    train step folds a few keys)."""
    k0, k1 = (int(w) for w in key)
    return _key(threefry2x32(k0, k1, 0, int(data) & _MASK32))


def _counters(n):
    idx = numpy.arange(n, dtype=numpy.uint64)
    return idx >> numpy.uint64(32), idx & numpy.uint64(_MASK32)


def split(key, num=2):
    """``jax.random.split`` (partitionable): key i is the hash of the
    counter (hi(i), lo(i)); returns (num, 2) uint32."""
    o0, o1 = _hash(key, *_counters(num))
    return _key(numpy.stack([o0, o1], axis=1))


def random_bits(key, shape):
    """32-bit ``jax.random.bits`` (partitionable): element i hashes the
    counter (hi(i), lo(i)) of its flat index; bits = out0 ^ out1."""
    shape = tuple(int(d) for d in shape)
    o0, o1 = _hash(key, *_counters(int(numpy.prod(shape, dtype=numpy.int64))))
    return (o0 ^ o1).astype(numpy.uint32).reshape(shape)


def bits_to_unit_float(bits):
    """float32 in [0, 1) from 32 random bits, as ``jax.random.uniform``:
    the top 23 bits become the mantissa of a float in [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).view(numpy.float32) - numpy.float32(1)


def uniform(key, shape):
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1)."""
    return bits_to_unit_float(random_bits(key, shape))


def bernoulli(key, p, shape):
    """``jax.random.bernoulli(key, p, shape)``: uniform < float32(p)."""
    return uniform(key, shape) < numpy.float32(p)


def randint(key, shape, minval, maxval):
    """int32 ``jax.random.randint``: two bit draws from ``split(key)``
    folded into the span by jax's double-width modulus."""
    minval, maxval = int(minval), int(maxval)
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise ValueError("randint bounds must fit in int32")
    k1, k2 = split(key)
    higher = random_bits(k1, shape).astype(numpy.uint64)
    lower = random_bits(k2, shape).astype(numpy.uint64)
    span = numpy.uint64(1 if maxval <= minval
                        else (maxval - minval) & _MASK32)
    mask = numpy.uint64(_MASK32)
    multiplier = numpy.uint64(2 ** 16) % span
    multiplier = (multiplier * multiplier & mask) % span
    offset = ((higher % span) * multiplier & mask) + lower % span
    offset = (offset & mask) % span
    return (minval + offset.astype(numpy.int64)).astype(numpy.int32)


class RandomGenerator:
    """One named deterministic stream of host randomness."""

    def __init__(self, name, seed=None):
        self.name = name
        self._seed = None
        self._key_counter = 0
        self.seed(seed if seed is not None else 1)

    @property
    def initial_seed(self):
        return self._seed

    def seed(self, seed):
        """(Re)seed the host state.  The stream name is folded into the
        seed so streams sharing one CLI seed are decorrelated."""
        self._seed = int(seed)
        digest = hashlib.sha256(
            ("%s:%d" % (self.name, self._seed)).encode()).digest()
        derived = int.from_bytes(digest[:8], "little")
        self.state = numpy.random.RandomState(derived % (2 ** 32))
        self._derived_seed = derived
        self._key_counter = 0

    def shuffle(self, arr):
        self.state.shuffle(arr)

    def permutation(self, n):
        return self.state.permutation(n)

    def randint(self, low, high=None, size=None):
        return self.state.randint(low, high, size)

    def normal(self, loc=0.0, scale=1.0, size=None):
        return self.state.normal(loc, scale, size)

    def uniform(self, low=0.0, high=1.0, size=None):
        return self.state.uniform(low, high, size)

    def fill(self, arr, vle_min=-1.0, vle_max=1.0):
        """In-place uniform fill of a numpy array (reference init idiom)."""
        arr[...] = self.state.uniform(vle_min, vle_max,
                                      arr.shape).astype(arr.dtype)
        return arr

    def fill_normal(self, arr, mean=0.0, stddev=1.0):
        arr[...] = self.state.normal(mean, stddev, arr.shape).astype(arr.dtype)
        return arr

    # -- device-side keys (host values) -------------------------------------
    def key(self):
        """A fresh key; successive calls never repeat."""
        self._key_counter += 1
        return fold_in(self.base_key(), self._key_counter)

    def base_key(self):
        """The stream's root key; never advances the counter."""
        return PRNGKey(self._derived_seed % (2 ** 63))

    def key_at(self, *coords):
        """The root key with each coordinate folded in, in order."""
        key = self.base_key()
        for c in coords:
            key = fold_in(key, int(c))
        return key

    # -- snapshot support ----------------------------------------------------
    def state_dict(self):
        return {"seed": self._seed, "numpy_state": self.state.get_state(),
                "key_counter": self._key_counter}

    def load_state_dict(self, d):
        self.seed(d["seed"])
        self.state.set_state(d["numpy_state"])
        self._key_counter = d["key_counter"]


_streams = {}
_pinned = set()

_default_seed = 1

#: seed for pinned (dataset-generating) streams: fixed, so varying the
#: run seed changes weight init and shuffling but NOT synthetic data
_DATA_SEED = 1


def get(name="default", pinned=False):
    """Fetch (creating on first use) the named stream.  ``pinned=True``
    marks a dataset-generation stream: it is seeded from the fixed
    ``_DATA_SEED`` and ``seed_all`` leaves it alone."""
    stream = _streams.get(name)
    if stream is None:
        stream = RandomGenerator(name,
                                 _DATA_SEED if pinned else _default_seed)
        _streams[name] = stream
        if pinned:
            _pinned.add(name)
    return stream


def seed_all(seed):
    """Seed every existing non-pinned stream and set the default for new
    ones (pinned data streams keep their fixed seed)."""
    global _default_seed
    _default_seed = seed
    for name, stream in _streams.items():
        if name not in _pinned:
            stream.seed(seed)


def reset():
    """Drop all streams (test isolation)."""
    _streams.clear()
    _pinned.clear()


def state_dict():
    return {"streams": {name: s.state_dict()
                        for name, s in _streams.items()},
            "pinned": sorted(_pinned)}


def load_state_dict(d):
    streams = d.get("streams", d if "pinned" not in d else {})
    pinned = set(d.get("pinned", ()))
    for name, sd in streams.items():
        get(name, pinned=name in pinned).load_state_dict(sd)
