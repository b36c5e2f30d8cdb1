"""Record files and the record loaders of the port against the JAX
package on the CPU.

Both packages get the same numpy inputs from a seed: small uint8 record
files (16×16×3 or 32×32×3 pixels, class prototypes plus noise) written
here.  Tolerances: record files are byte-equal, and each package reads
the other's; every minibatch of two epochs (class, live count, indices,
pixels, labels, mask) is bit-equal — with ``prefetch`` off and on, after
a stale prefetched plan, with a mean image; the prefetched stream also
under microsecond thread switching — since both packages gather
through the same native library (``tests/test_torch_native.py``).  The
ImageNet sample on a record file (``tiny_layers``, fused, 2 epochs) has
equal validation and train ``n_err`` every epoch, and weights within
``CONV_ATOL`` (conv) and ``FC_ATOL`` (FC) of the reference's, the port's
existing limits: the two packages' CPU convolutions and GEMMs sum in
different orders, and the reference's default update divides by the
batch where the port's kernel multiplies (ROADMAP Queue 3, items 2
and 5).  Torch is pinned to one thread.
"""

import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.loader import records as jax_records
from veles_tpu.samples import imagenet as jax_imagenet
from veles_tpu.workflow import Workflow as JaxWorkflow
from veles_tpu_torch import native, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader import records
from veles_tpu_torch.samples import imagenet
from veles_tpu_torch.workflow import Workflow

SEED = 11
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


def _dataset(n_valid, n_train, hw=16, n_classes=4, seed=0):
    """uint8 (n, hw, hw, 3) class prototypes plus noise, labels, and the
    train mean image in the loader's [-1, 1] scale."""
    rng = numpy.random.RandomState(seed)
    n = n_valid + n_train
    protos = rng.randint(40, 216, (n_classes, hw, hw, 3))
    labels = (numpy.arange(n) % n_classes).astype(numpy.int32)
    rng.shuffle(labels)
    noise = rng.randint(-40, 41, (n, hw, hw, 3))
    data = numpy.clip(protos[labels] + noise, 0, 255).astype(numpy.uint8)
    mean = (data[n_valid:].astype(numpy.float32) / 127.5 - 1.0).mean(0)
    return data, labels, mean.astype(numpy.float32)


@pytest.fixture(scope="module")
def record_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("records")
    data, labels, mean = _dataset(20, 44)
    path = str(d / "set.rec")
    records.write_records(path, data, labels, [0, 20, 44])
    mean_path = str(d / "mean.npy")
    numpy.save(mean_path, mean)
    return path, mean_path, data, labels


def test_write_records_byte_equal_and_cross_read(tmp_path):
    data, labels, _ = _dataset(3, 9, hw=5)
    for name, lab, lengths in (("labelled", labels, [2, 3, 7]),
                               ("labelless", None, [0, 0, 12])):
        ours = str(tmp_path / (name + ".port"))
        theirs = str(tmp_path / (name + ".ref"))
        records.write_records(ours, data, lab, lengths)
        jax_records.write_records(theirs, data, lab, lengths)
        assert open(ours, "rb").read() == open(theirs, "rb").read()
        for reader, path in ((records.open_records, theirs),
                             (jax_records.open_records, ours)):
            header, mapped, mapped_labels = reader(path)
            assert header["class_lengths"] == lengths
            numpy.testing.assert_array_equal(numpy.asarray(mapped), data)
            if lab is None:
                assert mapped_labels is None
            else:
                numpy.testing.assert_array_equal(mapped_labels, lab)
    f32 = numpy.random.RandomState(1).randn(4, 3).astype(numpy.float32)
    records.write_records(str(tmp_path / "f.port"), f32, None, [0, 1, 3])
    jax_records.write_records(str(tmp_path / "f.ref"), f32, None, [0, 1, 3])
    assert (open(tmp_path / "f.port", "rb").read()
            == open(tmp_path / "f.ref", "rb").read())
    assert records.MAGIC == jax_records.MAGIC


def test_bad_files_raise(tmp_path):
    with pytest.raises(ValueError, match="don't sum"):
        records.write_records(str(tmp_path / "x"), numpy.zeros((3, 2)),
                              None, [1, 1, 2])
    junk = tmp_path / "junk.rec"
    junk.write_bytes(b"not a record file")
    with pytest.raises(ValueError, match="not a record file"):
        records.open_records(str(junk))
    loader = records.RecordsLoader(Workflow(None), path=str(tmp_path / "no"))
    with pytest.raises(ValueError, match="not found"):
        loader.initialize(device=CPU)


def _loaders(port_cls, ref_cls, **kwargs):
    _seed(prng, jax_prng)
    ours = port_cls(Workflow(None, name="wf"), name="loader", **kwargs)
    ours.initialize(device=CPU)
    theirs = ref_cls(JaxWorkflow(None, name="wf"), name="loader", **kwargs)
    theirs.initialize()
    return ours, theirs


def _minibatch(loader):
    return (loader.minibatch_class, loader.minibatch_size,
            numpy.array(loader.minibatch_indices.mem),
            numpy.array(loader.minibatch_data.mem),
            numpy.array(loader.minibatch_labels.mem),
            numpy.array(loader.minibatch_mask.mem))


def _assert_same(got, want):
    assert got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        numpy.testing.assert_array_equal(g.view(numpy.uint8),
                                         w.view(numpy.uint8))


def _two_epochs(ours, theirs, edit=None):
    """Run both loaders over two epochs, minibatch by minibatch, and
    compare; ``edit(loader, step)`` may change a loader's plan first."""
    steps = 0
    try:
        while theirs.epoch_number < 2:
            for loader in (ours, theirs):
                if edit is not None:
                    edit(loader, steps)
                loader.run()
            _assert_same(_minibatch(ours), _minibatch(theirs))
            steps += 1
        assert ours.epoch_number == 2
    finally:
        ours.stop()
        theirs.stop()
    return steps


@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetch"])
def test_records_loader_stream_equal(record_file, prefetch):
    path = record_file[0]
    ours, theirs = _loaders(records.RecordsLoader, jax_records.RecordsLoader,
                            path=path, minibatch_size=8, prefetch=prefetch)
    assert ours._ring is None            # the CPU uploads nothing
    native.reset_call_counts()
    steps = _two_epochs(ours, theirs)
    assert steps == 2 * (3 + 6)
    # the port's library gathers once a minibatch, prefetched or not
    assert native.call_counts()["gather_u8_to_f32"] == steps


def test_stale_prefetch_is_discarded(record_file):
    """A plan changed under a staged prefetch: the stale gather is
    dropped and the fresh rows gathered, in both packages alike."""
    def edit(loader, step):
        if step == 4:
            cls, chunk, actual = loader._order[loader._position]
            loader._order[loader._position] = (cls, chunk[::-1].copy(),
                                               actual)

    ours, theirs = _loaders(records.RecordsLoader, jax_records.RecordsLoader,
                            path=record_file[0], minibatch_size=8,
                            prefetch=True)
    _two_epochs(ours, theirs, edit)


def test_prefetch_under_fast_thread_switching(record_file):
    """The prefetch worker and the main thread hand minibatches over
    through a future while the interpreter switches threads every
    microsecond: the stream equals the synchronous one, and the locked
    native call counter loses no call."""
    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        streams = []
        for prefetch in (False, True):
            _seed(prng)
            loader = imagenet.ImagenetRecordsLoader(
                Workflow(None), path=record_file[0],
                mean_path=record_file[1], minibatch_size=4,
                prefetch=prefetch)
            loader.initialize(device=CPU)
            native.reset_call_counts()
            stream = []
            while loader.epoch_number < 3:
                loader.run()
                stream.append(_minibatch(loader))
            loader.stop()
            assert native.call_counts()["gather_u8_to_f32"] == len(stream)
            streams.append(stream)
    finally:
        sys.setswitchinterval(interval)
    assert len(streams[0]) == len(streams[1]) == 3 * (5 + 11)
    for got, want in zip(*streams):
        _assert_same(got, want)


@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetch"])
def test_imagenet_records_loader_with_mean_equal(record_file, prefetch):
    path, mean_path, data, _ = record_file
    ours, theirs = _loaders(imagenet.ImagenetRecordsLoader,
                            jax_imagenet.ImagenetRecordsLoader, path=path,
                            mean_path=mean_path, minibatch_size=8,
                            prefetch=prefetch)
    mean = numpy.load(mean_path)
    ours.run()
    theirs.run()
    idx = ours.minibatch_indices.mem
    want = (data[idx].astype(numpy.float32) * numpy.float32(1 / 127.5)
            + numpy.float32(-1.0)) - mean
    numpy.testing.assert_array_equal(ours.minibatch_data.mem, want)
    _assert_same(_minibatch(ours), _minibatch(theirs))
    _two_epochs(ours, theirs)


def test_gather_window_equal(record_file):
    path, mean_path = record_file[:2]
    idx = numpy.asarray([5, 0, 63, 17, 17], numpy.int32)
    for port_cls, ref_cls, kw in (
            (records.RecordsLoader, jax_records.RecordsLoader, {}),
            (imagenet.ImagenetRecordsLoader,
             jax_imagenet.ImagenetRecordsLoader, {"mean_path": mean_path})):
        ours, theirs = _loaders(port_cls, ref_cls, path=path,
                                minibatch_size=8, **kw)
        for got, want in zip(ours.gather_window(idx),
                             theirs.gather_window(idx)):
            numpy.testing.assert_array_equal(got, want)


def test_unsharded_shard_api(record_file):
    loader = records.RecordsLoader(Workflow(None), path=record_file[0],
                                   minibatch_size=8)
    assert loader.local_minibatch_size == 8
    chunk = numpy.arange(8, dtype=numpy.int32)
    assert loader.local_chunk(chunk) is chunk
    # sharded (tests/test_torch_parallel.py holds the rows): the SPMD
    # shard's local rows are its contiguous slice of the global chunk
    loader.shard_spmd(1, 2)
    assert loader.local_minibatch_size == 4
    numpy.testing.assert_array_equal(loader.local_chunk(chunk), chunk[4:])
    with pytest.raises(ValueError, match="not divisible"):
        loader.shard_spmd(0, 3)


def test_make_loader_and_default_config_pick_records(record_file):
    path, mean_path = record_file[:2]
    root.__dict__.pop("imagenet", None)
    root.imagenet.loader.records_path = path
    cfg = imagenet.default_config()
    layers = cfg.layers
    assert layers == imagenet.alexnet_layers()
    assert layers[1]["n_kernels"] == 96 and layers[-1][
        "output_sample_shape"] == 1000
    loader = imagenet.make_loader(Workflow(None), records_path=path,
                                  mean_path=mean_path, n_train=5,
                                  image_hw=(8, 8), n_classes=3)
    assert isinstance(loader, imagenet.ImagenetRecordsLoader)
    missing = imagenet.make_loader(Workflow(None), records_path=path + "x",
                                   mean_path=mean_path)
    assert isinstance(missing, imagenet.ImagenetSyntheticLoader)
    root.__dict__.pop("imagenet", None)


def _configure(cfg_root, module, path, mean_path):
    cfg_root.imagenet.update({
        "loader": {"minibatch_size": 16, "records_path": path,
                   "mean_path": mean_path},
        "decision": {"max_epochs": 2, "fail_iterations": 10},
        "layers": module.tiny_layers(n_classes=4, crop=(28, 28), lr=0.02),
    })


@pytest.fixture(scope="module")
def sample_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("sample")
    data, labels, mean = _dataset(32, 96, hw=32, seed=3)
    path = str(d / "set.rec")
    records.write_records(path, data, labels, [0, 32, 96])
    mean_path = str(d / "mean.npy")
    numpy.save(mean_path, mean)
    return path, mean_path


def test_imagenet_sample_on_records_matches_jax(sample_file):
    path, mean_path = sample_file
    _seed(jax_prng)
    saved = jax_root.__dict__.pop("imagenet", None)
    try:
        _configure(jax_root, jax_imagenet, path, mean_path)
        ref = jax_imagenet.train(fused=True)
        ref.snapshot_state()
    finally:
        jax_root.__dict__.pop("imagenet", None)
        if saved is not None:
            jax_root.__dict__["imagenet"] = saved
        jax_prng.reset()
    _seed(prng)
    root.__dict__.pop("imagenet", None)
    _configure(root, imagenet, path, mean_path)
    wf = imagenet.train(fused=True, device="cpu")
    wf.snapshot_state()
    root.__dict__.pop("imagenet", None)
    assert isinstance(wf.loader, imagenet.ImagenetRecordsLoader)
    got, want = wf.decision.epoch_metrics, ref.decision.epoch_metrics
    assert len(got) == len(want) == 2
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
    assert params == 4
