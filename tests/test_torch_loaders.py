"""The LMDB/MDB, pickle and image loaders of the port, and the wine and
image_dir samples, against the JAX package on the CPU.

Both packages get the same numpy inputs from a seed (Datums, pickles and
PNG trees written here; PIL decodes the PNGs).  Tolerances: LMDB
environments and the record files ``lmdb_to_records`` writes are
byte-equal, and each package reads the other's; every minibatch of two
epochs (class, live count, indices, data, labels, mask) is bit-equal for
``LMDBLoader``, ``PicklesLoader``, ``FullBatchImageLoader`` and
``AutoSplitImageLoader`` (both packages run the same numpy arithmetic);
the samples have equal validation and train ``n_err`` every epoch, and
weights within ``CONV_ATOL`` (conv) and ``FC_ATOL`` (FC) of the
reference's, the port's existing limits (the two packages' CPU products
sum in different orders, and the reference's default update divides by
the batch where the port's kernel multiplies: ROADMAP Queue 3, items 2
and 5).  Torch is pinned to one thread.
"""

import os
import pickle

import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.loader import image as jax_image
from veles_tpu.loader import lmdb as jax_lmdb
from veles_tpu.loader import mdb as jax_mdb
from veles_tpu.loader import pickles as jax_pickles
from veles_tpu.samples import image_dir as jax_image_dir
from veles_tpu.samples import wine as jax_wine
from veles_tpu.workflow import Workflow as JaxWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader import image, lmdb, mdb, pickles, records
from veles_tpu_torch.samples import image_dir, wine
from veles_tpu_torch.workflow import Workflow

SEED = 5
CONV_ATOL = 1e-6
FC_ATOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seed(*mods):
    for mod in mods:
        mod.reset()
        mod.seed_all(SEED)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ----------------------------------------------------------------- mdb/lmdb
def _datums(n, chw, seed=0):
    rng = numpy.random.RandomState(seed)
    samples = rng.randint(0, 256, (n,) + chw).astype(numpy.uint8)
    labels = rng.randint(0, 1000, n)
    return samples, labels


def _items(module, samples, labels):
    return [(b"%08d" % i, module.serialize_datum(samples[i], labels[i]))
            for i in range(len(samples))]


def test_serialize_datum_byte_equal_and_parsed_back():
    samples, labels = _datums(3, (3, 7, 5))
    for (_, ours), (_, theirs) in zip(_items(lmdb, samples, labels),
                                      _items(jax_lmdb, samples, labels)):
        assert ours == theirs
        pixels, label = lmdb._parse_datum(theirs)
        ref_pixels, ref_label = jax_lmdb._parse_datum(ours)
        numpy.testing.assert_array_equal(pixels, ref_pixels)
        assert label == ref_label
    with pytest.raises(ValueError, match="negative varint"):
        lmdb._varint(-1)


@pytest.mark.parametrize("case", ["inline_branch_overflow", "empty"])
def test_write_env_byte_equal_and_cross_read(tmp_path, case):
    rng = numpy.random.RandomState(0)
    if case == "empty":
        items = []
    else:
        items = [(b"k%04d" % i, bytes(rng.randint(0, 256, i % 60 + 1,
                                                  dtype=numpy.uint8)))
                 for i in range(400)]                  # > 1 leaf page
        items += [(b"z%04d" % i,
                   bytes(rng.randint(0, 256, 10000, dtype=numpy.uint8)))
                  for i in range(3)]                   # overflow values
    ours = mdb.write_env(str(tmp_path / "ours"), items)
    theirs = jax_mdb.write_env(str(tmp_path / "theirs"), items)
    assert _bytes(ours) == _bytes(theirs)
    for module, path in ((mdb, theirs), (jax_mdb, ours)):
        with module.open_env(path) as env:
            assert env.stat()["entries"] == len(items)
            assert [(bytes(k), bytes(v)) for k, v in env.items()] == sorted(
                items)


def test_mdb_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.mdb"
    bad.write_bytes(b"\0" * 8192)
    with pytest.raises(mdb.MDBFormatError, match="magic"):
        mdb.open_env(str(bad))
    short = tmp_path / "short.mdb"
    short.write_bytes(b"x")
    with pytest.raises(ValueError, match="too small"):
        mdb.open_env(str(short))


def test_lmdb_to_records_byte_equal(tmp_path):
    samples, labels = _datums(12, (3, 9, 7), seed=1)
    env = os.path.dirname(mdb.write_env(str(tmp_path / "env"),
                                        _items(lmdb, samples, labels)))
    ours = lmdb.lmdb_to_records(env, str(tmp_path / "ours.rec"),
                                class_lengths=[0, 4, 8])
    theirs = jax_lmdb.lmdb_to_records(env, str(tmp_path / "theirs.rec"),
                                      class_lengths=[0, 4, 8])
    assert _bytes(ours) == _bytes(theirs)
    # and equal to write_records of the same HWC arrays
    direct = records.write_records(str(tmp_path / "direct.rec"),
                                   samples.transpose(0, 2, 3, 1), labels,
                                   [0, 4, 8])
    assert _bytes(ours) == _bytes(direct)
    assert not any(name.endswith(".tmp") for name in os.listdir(tmp_path))


def test_lmdb_to_records_errors(tmp_path):
    empty = os.path.dirname(mdb.write_env(str(tmp_path / "empty"), []))
    with pytest.raises(ValueError, match="empty LMDB"):
        lmdb.lmdb_to_records(empty, str(tmp_path / "a.rec"))
    mixed = os.path.dirname(mdb.write_env(str(tmp_path / "mixed"), [
        (b"0", lmdb.serialize_datum(numpy.zeros((3, 4, 4), numpy.uint8))),
        (b"1", lmdb.serialize_datum(numpy.zeros((3, 5, 5), numpy.uint8)))]))
    with pytest.raises(ValueError, match="uniform shapes"):
        lmdb.lmdb_to_records(mixed, str(tmp_path / "b.rec"))
    with pytest.raises(ValueError, match="don't sum"):
        lmdb.lmdb_to_records(mixed, str(tmp_path / "c.rec"),
                             class_lengths=[0, 1, 2])
    assert not os.path.exists(tmp_path / "b.rec")


# ------------------------------------------------------------ minibatches
def _minibatch(loader):
    return (loader.minibatch_class, loader.minibatch_size,
            numpy.array(loader.minibatch_indices.mem),
            numpy.array(loader.minibatch_data.mem),
            numpy.array(loader.minibatch_labels.mem),
            numpy.array(loader.minibatch_mask.mem))


def _same_streams(ours, theirs):
    """Both loaders initialized from one seed, then two epochs compared
    minibatch by minibatch, bit for bit."""
    _seed(prng, jax_prng)
    ours.initialize(device=CPU)
    theirs.initialize()
    steps = 0
    while theirs.epoch_number < 2:
        ours.run()
        theirs.run()
        got, want = _minibatch(ours), _minibatch(theirs)
        assert got[:2] == want[:2]
        for g, w in zip(got[2:], want[2:]):
            assert g.dtype == w.dtype and g.shape == w.shape
            numpy.testing.assert_array_equal(g.view(numpy.uint8),
                                             w.view(numpy.uint8))
        steps += 1
    assert ours.epoch_number == 2
    return steps


def test_lmdb_loader_stream_equal(tmp_path):
    train, train_labels = _datums(20, (3, 6, 6), seed=3)
    valid, valid_labels = _datums(8, (3, 6, 6), seed=4)
    t_dir = os.path.dirname(mdb.write_env(
        str(tmp_path / "train"), _items(lmdb, train, train_labels)))
    v_dir = os.path.dirname(mdb.write_env(
        str(tmp_path / "valid"), _items(lmdb, valid, valid_labels)))
    kw = dict(train_path=t_dir, validation_path=v_dir, minibatch_size=6,
              name="loader")
    ours = lmdb.LMDBLoader(Workflow(None), **kw)
    theirs = jax_lmdb.LMDBLoader(JaxWorkflow(None), **kw)
    assert _same_streams(ours, theirs) == 2 * (2 + 4)
    assert ours.class_lengths == [0, 8, 20]
    idx = numpy.asarray([3, 27, 0], numpy.int32)
    for got, want in zip(ours.gather_window(idx), theirs.gather_window(idx)):
        numpy.testing.assert_array_equal(got, want)


def _pickle(path, payload):
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return str(path)


def test_pickles_loader_stream_equal(tmp_path):
    rng = numpy.random.RandomState(0)
    paths = {
        "test_path": _pickle(tmp_path / "test.pickle", {
            "data": rng.normal(size=(5, 6)).astype(numpy.float32),
            "labels": numpy.arange(5) % 3}),
        "validation_path": _pickle(tmp_path / "v.pickle", (
            rng.normal(size=(8, 6)), (numpy.arange(8) % 3))),
        "train_path": _pickle(tmp_path / "t.pickle", (
            rng.normal(size=(24, 6)).astype(numpy.float32),
            (numpy.arange(24) % 3).astype(numpy.int32)))}
    ours = pickles.PicklesLoader(Workflow(None), minibatch_size=8,
                                 name="loader", **paths)
    theirs = jax_pickles.PicklesLoader(JaxWorkflow(None), minibatch_size=8,
                                       name="loader", **paths)
    _same_streams(ours, theirs)
    assert ours.class_lengths == [5, 8, 24] and ours.has_labels


def test_pickles_loader_errors(tmp_path):
    rng = numpy.random.RandomState(0)
    bare = _pickle(tmp_path / "bare.pickle",
                   rng.normal(size=(8, 4)).astype(numpy.float32))
    labelled = _pickle(tmp_path / "l.pickle", (
        rng.normal(size=(24, 4)).astype(numpy.float32),
        (numpy.arange(24) % 3).astype(numpy.int32)))
    short = _pickle(tmp_path / "s.pickle", (
        rng.normal(size=(6, 4)).astype(numpy.float32), numpy.arange(5)))
    for kwargs, match in (({"validation_path": bare, "train_path": labelled},
                           "mixed"),
                          ({"train_path": short}, "5 labels for 6"),
                          ({}, "no pickle paths")):
        loader = pickles.PicklesLoader(Workflow(None), minibatch_size=8,
                                       **kwargs)
        with pytest.raises(ValueError, match=match):
            loader.initialize(device=CPU)


def _write_images(base, classes, per_class=6, size=(12, 10)):
    from PIL import Image
    rng = numpy.random.RandomState(len(classes))
    for k, cls in enumerate(classes):
        d = base / cls
        d.mkdir(parents=True, exist_ok=True)
        for i in range(per_class):
            arr = rng.randint(0, 60, size + (3,)).astype(numpy.uint8)
            arr[..., k % 3] += 150
            arr[i % size[0], :, :] = 255
            Image.fromarray(arr).save(d / ("img_%d.png" % i))
    return str(base)


def test_image_loaders_stream_equal(tmp_path):
    directory = _write_images(tmp_path / "all", ("red", "green", "blue"))
    kw = dict(validation_ratio=0.25, scale=(8, 8), minibatch_size=4,
              name="loader")
    ours = image.AutoSplitImageLoader(Workflow(None), directory, **kw)
    theirs = jax_image.AutoSplitImageLoader(JaxWorkflow(None), directory,
                                            **kw)
    _same_streams(ours, theirs)
    assert ours.label_names == theirs.label_names == ["blue", "green", "red"]
    assert ours.class_lengths == [0, 5, 13]

    train = _write_images(tmp_path / "train", ("ant", "bee", "cat"),
                          per_class=3)
    valid = _write_images(tmp_path / "valid", ("bee", "cat"), per_class=2)
    kw = dict(validation_paths=valid, train_paths=train, scale=(10, 9),
              crop=(6, 7), color_space="GRAY", minibatch_size=4,
              name="loader")
    ours = image.FullBatchImageLoader(Workflow(None), **kw)
    theirs = jax_image.FullBatchImageLoader(JaxWorkflow(None), **kw)
    _same_streams(ours, theirs)
    assert ours.label_names == ["ant", "bee", "cat"]
    assert ours.original_data.shape == (13, 6, 7, 1)


def test_decode_and_scan_equal(tmp_path):
    directory = _write_images(tmp_path / "flat", ("x",), per_class=3)
    flat = os.path.join(directory, "x")
    assert image.scan_directory(flat) == jax_image.scan_directory(flat)
    path = image.scan_directory(flat)[0][0]
    for kw in ({}, {"size": (5, 4)}, {"color_space": "GRAY", "crop": (3, 3)}):
        numpy.testing.assert_array_equal(image.decode_image(path, **kw),
                                         jax_image.decode_image(path, **kw))
    with pytest.raises(ValueError, match="crop"):
        image.decode_image(path, crop=(50, 50))


# ------------------------------------------------------------------ samples
class _JaxConfig:
    def __init__(self, name, cfg):
        self.name, self.cfg = name, cfg

    def __enter__(self):
        self.saved = jax_root.__dict__.pop(self.name, None)
        getattr(jax_root, self.name).update(self.cfg)

    def __exit__(self, *exc):
        jax_root.__dict__.pop(self.name, None)
        if self.saved is not None:
            jax_root.__dict__[self.name] = self.saved
        jax_prng.reset()


def _assert_same_training(wf, ref, epochs, n_params):
    got, want = wf.decision.epoch_metrics, ref.decision.epoch_metrics
    assert len(got) == len(want) == epochs
    for g, r in zip(got, want):
        for split in ("validation", "train"):
            assert g[split]["n_err"] == r[split]["n_err"]
    params = 0
    for f, r in zip(wf.forwards, ref.forwards):
        if f.has_params:
            params += 1
            atol = CONV_ATOL if f.weights.mem.ndim == 4 else FC_ATOL
            for a, b in ((f.weights, r.weights), (f.bias, r.bias)):
                numpy.testing.assert_allclose(a.mem, numpy.asarray(b.mem),
                                              rtol=0, atol=atol)
    assert params == n_params


def test_wine_full_width_matches_jax():
    """13 → 8 tanh → 3 softmax at the sample's defaults, cut to 12
    epochs."""
    cfg = {"decision": {"max_epochs": 12}}
    _seed(jax_prng)
    with _JaxConfig("wine", cfg):
        ref = jax_wine.train()
        ref.snapshot_state()
    _seed(prng)
    root.__dict__.pop("wine", None)
    root.wine.update(cfg)
    wf = wine.train(device="cpu")
    wf.snapshot_state()
    root.__dict__.pop("wine", None)
    numpy.testing.assert_array_equal(wf.loader.original_data.mem,
                                     numpy.asarray(
                                         ref.loader.original_data.mem))
    assert [f.weights.mem.shape for f in wf.forwards] == [(13, 8), (8, 3)]
    _assert_same_training(wf, ref, 12, 2)


def test_image_dir_sample_matches_jax(tmp_path):
    directory = _write_images(tmp_path / "tree", ("cat", "dog", "eel"),
                              per_class=8, size=(20, 18))
    loader = {"directory": directory, "minibatch_size": 4,
              "scale": (16, 16)}
    decision = {"max_epochs": 2}
    _seed(jax_prng)
    with _JaxConfig("image_dir", {}):
        ref = jax_image_dir.train(loader=loader, decision=decision)
        ref.snapshot_state()
    _seed(prng)
    root.__dict__.pop("image_dir", None)
    wf = image_dir.train(device="cpu", loader=loader, decision=decision)
    wf.snapshot_state()
    root.__dict__.pop("image_dir", None)
    assert wf.forwards[-1].output.shape == (4, 3)
    _assert_same_training(wf, ref, 2, 3)


def test_image_dir_needs_a_directory():
    root.__dict__.pop("image_dir", None)
    with pytest.raises(ValueError, match="loader.directory"):
        image_dir.build()
