"""Named deterministic random streams — the host half.

Port of ``veles_tpu/prng.py``: every consumer of host randomness (weight
init, shuffles) pulls from a named stream whose numpy ``RandomState`` is
seeded from sha256(``"<name>:<seed>"``), exactly as in the reference, so
``init_transformer_params`` gives bit-equal weights in both packages for
the same seed, and the training slice's initial weights, synthetic data
and loader shuffles are bit-equal too.  The reference's device keys
(``jax.random``: ``key``, ``base_key``, ``key_at``) have no counterpart
yet; they raise until the first device-side consumer ports them (ROADMAP
Queue 2a, item 9).
"""

from __future__ import annotations

import hashlib

import numpy


class RandomGenerator:
    """One named deterministic stream of host randomness."""

    def __init__(self, name, seed=None):
        self.name = name
        self._seed = None
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

    # -- device-side keys (not ported) ---------------------------------------
    def key(self):
        raise NotImplementedError(
            "device PRNG keys are not ported yet: ROADMAP Queue 2a, item 9")

    base_key = key_at = key

    # -- snapshot support ----------------------------------------------------
    def state_dict(self):
        return {"seed": self._seed, "numpy_state": self.state.get_state(),
                "key_counter": 0}

    def load_state_dict(self, d):
        self.seed(d["seed"])
        self.state.set_state(d["numpy_state"])


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
