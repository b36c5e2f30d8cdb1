"""The lines and video_ae samples of the port against the JAX package on
the CPU: the generated sets (``draw_lines``, ``synth_video``) bit-equal
from the same pinned stream, and each sample at a small config trained
from one seed in fused mode (lines: conv_str, max pool, conv_str, max
pool, softmax; video_ae: conv_tanh, avg pool, depooling, deconv, MSE).

Tolerances: data and labels bit-equal; weights within 1e-6 (measured
2.2e-8 for lines and 7.5e-8 for video_ae: the two packages' CPU
convolutions sum in other orders, and the reference's default update
divides by the batch where the port's kernel multiplies, ROADMAP Queue
3 items 2 and 5); validation ``n_err`` equal per epoch (lines) and
validation loss within 1e-6 relative (video_ae, measured 4.7e-7: a sum
of 24,576 squared errors in another order).  Torch is pinned to one
thread.
"""

import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.samples import lines as jax_lines
from veles_tpu.samples import video_ae as jax_video_ae
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import hopper_kernels as HK
from veles_tpu_torch.samples import lines, video_ae

SEED = 5
WEIGHT_ATOL = 1e-6

LINES_SMALL = {"loader": {"minibatch_size": 50, "n_train": 200,
                          "n_valid": 100, "hw": 16},
               "decision": {"max_epochs": 2, "fail_iterations": 20}}
VIDEO_SMALL = {"loader": {"minibatch_size": 50, "n_train": 200,
                          "n_valid": 96, "hw": 16},
               "decision": {"max_epochs": 2, "fail_iterations": 20}}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,hw", [(64, 16), (7, 32)])
def test_draw_lines_bit_equal(n, hw):
    data, labels = lines.draw_lines(prng.get("t_lines", pinned=True), n,
                                    hw=hw)
    want, want_labels = jax_lines.draw_lines(
        jax_prng.get("t_lines", pinned=True), n, hw=hw)
    assert data.shape == (n, hw, hw, 1) and data.dtype == numpy.float32
    assert numpy.array_equal(data, want)
    assert numpy.array_equal(labels, want_labels)
    prng.reset()


@pytest.mark.parametrize("seqs,frames,hw", [(4, 6, 20), (3, 8, 24)])
def test_synth_video_bit_equal(seqs, frames, hw):
    got = video_ae.synth_video(prng.get("t_video", pinned=True), seqs,
                               frames, hw=hw)
    want = jax_video_ae.synth_video(jax_prng.get("t_video", pinned=True),
                                    seqs, frames, hw=hw)
    assert got.shape == (seqs * frames, hw, hw, 1)
    assert numpy.array_equal(got, want)
    prng.reset()


def test_video_loader_needs_whole_sequences():
    with pytest.raises(ValueError, match="whole sequences"):
        video_ae.VideoAELoader(None, n_train=100, n_valid=16)


def _train_both(name, cfg, jax_module, module):
    jax_prng.reset()
    jax_prng.seed_all(SEED)
    jax_root.__dict__.pop(name, None)
    jax_module.default_config()
    getattr(jax_root, name).update(cfg)
    try:
        ref = jax_module.train(fused=True)
    finally:
        jax_root.__dict__.pop(name, None)
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop(name, None)
    module.default_config()
    getattr(root, name).update(cfg)
    HK.reset_launch_counts()
    try:
        wf = module.build(fused=True)
        wf.initialize(device="cpu")
        wf.run()
    finally:
        root.__dict__.pop(name, None)
    return wf, ref


def _same_model(wf, ref):
    assert numpy.array_equal(wf.loader.original_data.mem,
                             numpy.asarray(ref.loader.original_data.mem))
    assert numpy.array_equal(wf.loader.original_labels.mem,
                             numpy.asarray(ref.loader.original_labels.mem))
    assert ([f.layer_type for f in wf.forwards]
            == [f.layer_type for f in ref.forwards])
    for f, r in zip(wf.forwards, ref.forwards):
        if f.has_params:
            for mine, theirs in ((f.weights, r.weights), (f.bias, r.bias)):
                numpy.testing.assert_allclose(
                    mine.mem, numpy.asarray(theirs.mem), rtol=0,
                    atol=WEIGHT_ATOL)
    # the CPU runs the update's plain version: no kernel launch
    assert all(n == 0 for n in HK.launch_counts().values())


def test_lines_matches_reference():
    wf, ref = _train_both("lines", LINES_SMALL, jax_lines, lines)
    _same_model(wf, ref)
    got = [m["validation"]["n_err"] for m in wf.decision.epoch_metrics]
    want = [m["validation"]["n_err"] for m in ref.decision.epoch_metrics]
    assert len(got) == 2 and got == want
    assert wf.fused_step.train_steps == 2 * 4


def test_video_ae_matches_reference():
    wf, ref = _train_both("video_ae", VIDEO_SMALL, jax_video_ae, video_ae)
    _same_model(wf, ref)
    got = [m["validation"]["loss"] for m in wf.decision.epoch_metrics]
    want = [m["validation"]["loss"] for m in ref.decision.epoch_metrics]
    assert len(got) == 2 and got[-1] < got[0]
    numpy.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert wf.loss_function == "mse"
    assert [f.layer_type for f in wf.forwards] == [
        "conv_tanh", "avg_pooling", "depooling", "deconv"]
