#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits nonzero before the final line is printed):

1. device — the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build — the CUDA kernels compiled from ``veles_tpu_torch/csrc/``
   (``paged_flash_attention.cu``, ``fused_sgd.cu``, ``lrn.cu``,
   ``dropout.cu``, ``flash_attention.cu``; one nvcc per source, all
   started together) into
   ``build/kernels/``, and the loader's ``native/dataio.cpp`` with g++
   into ``build/native/`` (it must build: no numpy fallback here);
3. kernels — each kernel against its plain PyTorch version on the card
   at its main path's shapes, with kernel, plain-version and library
   card times (CUDA events; see ``time_ms``) and the card's bound for
   the same work: the paged attention kernels at the serving shapes
   (library: scaled_dot_product_attention on the gathered view), then
   (checked, not timed) long page tables — a 16384-token lane view at
   head_dim 128 — and a head_dim that is neither a multiple of 4 nor
   below 256, and the split-KV decode's edges on a 16384-token view
   (lanes short of their first page's end, a window with sinks that
   empties the splits between); each decode call's split count, one
   call under ``set_sync_debug_mode("error")`` (the wrapper never reads
   the card on the host) and a bit-equal second launch; the split-KV
   prefill's edges (no history, one page, GQA, head_dim 18 with page 8,
   head_dim 320 with page 64, a window with sinks), each with its split
   count, a bit-equal install and a bit-equal second launch; the time of
   an empty launch, the floor of a one-launch call; the fused SGD
   kernel, one launch for a whole list, at MNIST-FC's four parameters,
   AlexNet's sixteen, a 4096x4096 weight, odd sizes, weight decay with
   an L1 mix, a clip, per-tensor scalars, mixed alignment and 50 tensors
   (two launches), each list also timed as one launch per tensor (no
   library call computes that function); the
   LRN forward and backward kernels at AlexNet's two LRN layers (library:
   ``local_response_norm`` on the NCHW view and its autograd backward),
   each also against an fp64 plain version and launched twice
   (bit-equal), then checked, not timed, on every path the kernels
   split on (C = 200 with n = 4, C = 98, pointers 4 bytes off
   alignment, C = 3 with n = 5, n = 1 and 7, C = 3000, a partial last
   tile and ring stage, rows too wide for the ring); dropout at
   AlexNet's two dropout inputs and at sizes 1, 127 and 2**16 + 3,
   bit-equal to its plain version (no library call draws jax's mask);
   the RBM's Bernoulli draw (``dropout.cu``'s second entry, no TPU
   kernel's port) at 100x784 and 100x256 (timed) and sizes 1, 127 and
   2**16 + 3, each with uniform p and with exact 0.0 and 1.0 entries,
   bit-equal to its plain version and to a second launch;
4. serve — the paged LM engine at the full width of the repo's LM
   config (vocab 256, d_model 512, 8 heads, 8 layers, learned positions,
   max_len 512, fp32, random weights from a seed) answers 16 requests
   through the kernels, then every emitted token is checked against a
   teacher-forced pass of the plain attention path;
5. train — the MNIST-FC sample (784→100 tanh→10 softmax, minibatch 100,
   60,000 train / 10,000 validation synthetic samples, 2 epochs, fused
   mode) through ``samples.mnist.train`` on the card: validation error
   below 5%, validation loss falling, every dispatched train minibatch's
   four momentum updates in one kernel launch; then the same seed on the
   card and on the CPU for 50 committed updates, weights within 1e-4,
   and a seeded rerun of that card run bit-equal;
6. alexnet — the ImageNet sample at full AlexNet width
   (``alexnet_layers()``: crop 227, five conv blocks with two LRN and
   three max-pooling layers, two dropout-FC 4096 layers, softmax 1000;
   minibatch 128; the synthetic loader at 256x256, 640 train / 128
   validation, 2 epochs) through ``samples.imagenet.train`` on the card:
   finite losses, and per dispatched train step exactly 2 LRN forward
   (plus 2 per validation minibatch), 2 LRN backward, 4 dropout and 1
   fused SGD launch (all 16 parameters); then the same seed on the card
   and on the CPU at
   minibatch 16 for 3 committed updates, each layer's weight gap within
   its limit (``ALEXNET_*_SHARE``) after the first update and after the
   third, and two faulty card runs rejected by the same limits; then
   records — the same sample trained from a record file, the way
   ``configs[2]`` reads real data: a seeded 256x256x3 uint8 file (1,280
   train / 256 validation, labels in [0, 1000), 302 MB) and its train
   mean written to a temporary directory outside the repo, only
   ``records_path``/``mean_path`` set so ``default_config`` picks
   ``alexnet_layers()``; 2 epochs (20 steps, 4 validation minibatches)
   with prefetch off and on: the native library live, the AlexNet launch
   formula, one native gather, mean and label call a minibatch, a bit
   digest of every device minibatch equal on and off, the first one
   equal to numpy's ``u8 * scale + offset - mean``; samples/s over
   whole epochs, the steady minibatch's host ms (gather+convert, mean,
   pinned and pageable upload, step), the unit loop's (loader, fused
   step, commit) host ms and busy share, with prefetch off and on; card
   vs CPU at minibatch 16 within the ``ALEXNET_*`` limits (the small
   card run rerun bit-equal), broken by two planted loader faults (mean
   not subtracted, labels shifted by one);
   64 Datums written with ``mdb.write_env`` and converted by
   ``lmdb_to_records``, byte-equal to ``write_records``; then wine at its
   defaults through ``wine.train`` (one fused-SGD launch a step,
   validation n_err at most the reference's bar; the whole seeded run
   repeated, bit-equal weights and epoch metrics);
7. lm_train — the char-LM sample at the repo's full LM width (vocab 256,
   d_model 512, 8 heads, 8 layers, s 512, minibatch 32; 10 train steps
   and 2 validation minibatches) through ``samples.char_lm.train``'s
   build + initialize + run under ``set_attention_backend('flash_pallas')``:
   exactly 8 launches of each flash kernel a train step and 8 of the
   forward a validation minibatch, finite and falling losses; tokens/s
   and the card's busy share of a steady step under 'flash_pallas' and
   under 'xla'; greedy ``sample_tokens`` on the card checked against a
   teacher-forced plain pass; then card vs CPU at 2 layers, s 128,
   minibatch 4 after the first and the third Adam update
   (``LM_*_SHARE``; that card run rerun, bit-equal after every update),
   and two faulty card runs rejected by those limits;
8. the conv zoo — first the transposed conv and its backward (stride 2,
   k 5, SAME and int padding) on the card against the CPU (checked, not
   timed); then each of ``cifar`` (``BASELINE.json`` configs[1]: 3
   conv_str, 3 pools, softmax; 50,000 / 10,000 synthetic 32x32x3),
   ``mnist_conv``, ``cifar_resnet`` (stem, identity block, downsampling
   block with a projected skip, identity block) and ``mnist_ae`` (conv,
   avg pool, depooling, deconv; MSE) through its sample's own ``train``
   on the card at the default, full-width config for 2 epochs (minibatch
   100): falling validation loss (RMSE for the AE), CIFAR's validation
   error below 10%, exactly one fused-SGD launch a dispatched train step
   covering every parameter (``ZOO``), wall and run seconds, samples/s
   and the card's busy share of two steady steps; then a seeded rerun
   of the small card run that must repeat bit for bit and, but for
   MNIST-conv, card vs CPU at minibatch 100 after the first and third
   committed update (``ZOO_*_SHARE``) and the faulty card runs
   (``ZOO_FAULTS``) rejected by the first-update limit;
9. the non-SGD trainers and the streams — ``kohonen`` (``BASELINE.json``
   configs[3]'s SOM: 8x8 map, 2,000 points, minibatch 100, 10 epochs)
   through ``kohonen.train``: falling qerr, 200 updates, wins on at
   least 4 neurons, no kernel launched, a bit-equal seeded rerun, the
   steady step's host ms and busy share, card vs CPU codebook after the
   first and third update (``SOM_*_SHARE``) and a planted fault (σ for
   σ²) rejected; ``mnist_rbm`` at its default widths (784 -> 256, 60,000
   synthetic samples, minibatch 100, cd_k 1; ``RBM_EPOCHS`` epochs):
   falling recon_err, 1 + cd_k Bernoulli launches a train step, the
   steady step, then small runs (``RBM_SMALL``) with none drawn on
   validation, a bit-equal rerun (parameters and draws), card vs CPU
   (``RBM_*_SHARE``, visible draws equal, hidden flips counted) and a
   planted fault (the Gibbs key not folded) rejected; ``lines`` and
   ``video_ae`` through their own ``train`` at their defaults (10
   epochs): lines' validation error below 15%, video_ae's validation
   loss falling, one fused-SGD launch a train step, the whole seeded run
   repeated bit-equal, the steady step; the streams — a small RBM's
   first epoch captured on the card by ``MinibatchesSaver`` and replayed
   by ``MinibatchesLoader`` into a fresh RBM (bit-equal parameters), and
   the SOM's points fed through ``InteractiveLoader`` into a
   ``KohonenForward`` (winners equal to a direct pass); then the
   Bernoulli draw's JSON line (its times, bound and launches);
10. the script's seconds, the card's name and power limit, one JSON line
   listing every ported TPU kernel, then the JSON result line.

The kernels phase also holds the three flash-attention kernels (forward,
dK/dV pass, dQ pass; ``flash_attention.cu``) at the LM's train shape
(32 x 8 heads, s 512, head_dim 64, causal), with kernel, plain and SDPA
times, the 3xTF32 and fp32-FMA bounds, and the elements six faulty
plain versions put outside the limits (among them the forward and the
backward in single TF32 products, and the forward without the
small(P).big(v) term); then, checked only, s 200 non-causal at
head_dim 32, 40, 128 and 37 (rows not 16-byte aligned), and scores
peaked at ±100.  In every case each kernel is launched twice
(bit-equal) and held against an fp64 plain version: its error at most
``FLASH_FP64_FACTOR`` times the fp32 plain version's.

It imports nothing of JAX and nothing of the ``veles_tpu`` package.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time
import numpy

SEED = 20261016
#: H100 SXM data-sheet peaks: HBM bytes/s, fp32 (non-tensor) flop/s and
#: dense TF32 tensor-core flop/s
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
#: 32-bit integer operations/s: 64 INT32 lanes per SM (half the 128 fp32
#: lanes behind the 67 TFLOP/s; Hopper white paper) x 132 SMs x 1.98 GHz
INT32_OP_S = 64 * 132 * 1.98e9
#: threefry2x32 per element: 20 rounds of add, rotate, xor; 5 key
#: injections of 3 adds; 2 initial adds; then xor, shift, or, subtract,
#: compare and select to turn the words into a kept-or-zero output
DROPOUT_OPS = 20 * 3 + 5 * 3 + 2 + 6
#: copies of each timed kernel's inputs, cycled so that every call finds
#: its operands cold in the 50 MB L2 (4 x 16.8 MB of decode pools)
COPIES = 4
#: fp32 kernel vs plain version, outputs O(1): the two sum up to 512
#: keys in different orders (~1e-6 expected); 1e-4 leaves 100x margin
KERNEL_ATOL = 1e-4
#: teacher-forced check: an emitted token's logit may sit below its
#: row's max by at most this much (fp32 near-ties between the kernel
#: path and the plain path; logits are O(1))
LOGIT_TOL = 1e-3

#: jax's bundled TPU flash attention, which veles_tpu/ops/attention.py:190
#: calls; its three pallas_call sites
BUNDLED = "jax/experimental/pallas/ops/tpu/flash_attention.py"
REPLACES = {
    "flash_attention_fwd": BUNDLED + ":758",
    "flash_attention_bwd_dkv": BUNDLED + ":1121",
    "flash_attention_bwd_dq": BUNDLED + ":1456",
    "fused_sgd_update": "veles_tpu/ops/pallas_kernels.py:92",
    "lrn_forward": "veles_tpu/ops/pallas_kernels.py:226",
    "lrn_backward": "veles_tpu/ops/pallas_kernels.py:244",
    "dropout": "veles_tpu/ops/pallas_kernels.py:272",
    "paged_flash_decode": "veles_tpu/ops/pallas_kernels.py:367",
    "paged_flash_prefill": "veles_tpu/ops/pallas_kernels.py:443",
}
SOURCES = {
    "flash_attention_fwd": "veles_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dkv": "veles_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq": "veles_tpu_torch/csrc/flash_attention.cu",
    "fused_sgd_update": "veles_tpu_torch/csrc/fused_sgd.cu",
    "lrn_forward": "veles_tpu_torch/csrc/lrn.cu",
    "lrn_backward": "veles_tpu_torch/csrc/lrn.cu",
    "dropout": "veles_tpu_torch/csrc/dropout.cu",
    "paged_flash_decode": "veles_tpu_torch/csrc/paged_flash_attention.cu",
    "paged_flash_prefill": "veles_tpu_torch/csrc/paged_flash_attention.cu",
}
#: fused SGD kernel vs plain version: at most 1 ulp per element (the
#: plain version rounds each fused multiply-add once from float64)
SGD_MAX_ULPS = 1.0
#: history: PR 6's card time of a step's updates, one launch per tensor
#: (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W)
SGD_PR6_MS = {"mnist_fc_step": 0.0089664, "alexnet_step": 0.48084}
#: MNIST-FC's parameters: (784, 100) and (100,) tanh, (100, 10) and (10,)
MNIST_PARAMS = ((784, 100), (100,), (100, 10), (10,))
#: AlexNet's sixteen: five HWIO convs and three FC layers, with biases
ALEXNET_PARAMS = ((11, 11, 3, 96), (96,), (5, 5, 96, 256), (256,),
                  (3, 3, 256, 384), (384,), (3, 3, 384, 384), (384,),
                  (3, 3, 384, 256), (256,), (9216, 4096), (4096,),
                  (4096, 4096), (4096,), (4096, 1000), (1000,))
#: LRN kernels vs plain versions: they differ only where CUDA's powf and
#: PyTorch's pow round differently (the window sums are in one order);
#: the reference's own Pallas-vs-XLA tolerances
LRN_FWD_TOL = (2e-6, 2e-6)           # (rtol, atol)
LRN_BWD_TOL = (3e-5, 3e-6)
#: the LRN kernels against an fp64 plain version on the same inputs:
#: their max abs error at most this many times the fp32 plain version's
LRN_FP64_FACTOR = 2.0
#: AlexNet's LRN inputs: conv1's and conv2's NHWC outputs
LRN_SHAPES = {"lrn1": (128, 55, 55, 96), "lrn2": (128, 27, 27, 256)}
#: AlexNet's dropout inputs: pool5 flattened, and fc6's output
DROPOUT_SHAPES = {"dropout6": (128, 9216), "dropout7": (128, 4096)}
#: card vs CPU AlexNet at minibatch 16, one seed.  A layer's gap is max
#: |card - CPU| over its weights and bias, as a share of its movement,
#: max |CPU - initial| (initial weights are bit-equal).  cuDNN (TF32 off)
#: and the CPU sum the convolutions in other orders (activations ~3e-6
#: apart, relative), so a max-pool window whose two largest inputs are
#: that close picks another argmax on one side (a flip: 3 of pool2's
#: 692,224 windows in the first step) and routes one gradient element
#: elsewhere.  After the first committed update:
#: - a layer above every max pool (the FC layers) sees no flip; only
#:   summation order parts the runs (~1e-9 absolute, a ~1e-6 share):
ALEXNET_FC_SHARE = 1e-4
#: - a layer under a max pool takes the flips' rerouted elements, each one
#:   term of a weight gradient's sum over 16 x 27 x 27 positions or more:
ALEXNET_CONV_SHARE = 0.1
#: After the third, every layer's forward carries the first step's flips
#: (the last run read 7.6e-5 to 1.6e-4 absolute at conv3-fc7):
ALEXNET_DRIFT_SHARE = 0.25
#: faulty card runs, each against the same CPU run, that the first-update
#: limits must reject: every dropout key folded once more (another mask;
#: every layer's gradient changes), and the LRN backward given the
#: denominator of k = 1 where the forward used k = 2 (conv1's and conv2's
#: gradients scale by 2^0.75, a share of ~0.68)
ALEXNET_FAULTS = ("dropout_key", "lrn_backward_k")
#: card vs CPU weights after 50 committed updates: cuBLAS and the CPU
#: sum the GEMMs in different orders over 50 steps; weights are O(0.1)
TRAIN_ATOL = 1e-4
#: the repo's LM config at full width (bench.py's lm config)
LM_CONFIG = dict(vocab=256, d_model=512, n_heads=8, n_layers=8, max_len=512)
#: the flash kernels' main shape: (b, h, s, dh) of that config's train
#: step at minibatch 32, causal
FLASH_MAIN = (32, 8, 512, 64)
#: flash kernels vs plain versions, outputs and gradients O(1): sums of up
#: to 512 terms in another order than cuBLAS's (~1e-6 expected); the
#: peaked case (scores near ±100) scales the limit by the output's size
FLASH_ATOL = 1e-4
#: the flash kernels (3xTF32 on the tensor cores) against an fp64 plain
#: version on the same inputs: their max abs error at most this many times
#: the fp32 plain version's (fp32 accuracy; one TF32 product would not be)
FLASH_FP64_FACTOR = 4.0
#: the char-LM train phase: loader seq_len 513 (s = 512 after the shift),
#: 320 train / 64 validation sequences at minibatch 32 = 10 train steps
#: and 2 validation minibatches in one epoch
LM_TRAIN = {"loader": {"minibatch_size": 32, "n_train": 320, "n_valid": 64,
                       "seq_len": 513, "vocab": 256},
            "trainer": dict(LM_CONFIG, learning_rate=1e-3),
            "decision": {"max_epochs": 1, "fail_iterations": 10}}
#: card vs CPU at d_model 512, 8 heads, 2 layers, s 128, minibatch 4: one
#: validation minibatch, then 3 Adam updates
LM_SMALL = {"loader": {"minibatch_size": 4, "n_train": 12, "n_valid": 4,
                       "seq_len": 129, "vocab": 256},
            "trainer": dict(LM_CONFIG, n_layers=2, learning_rate=1e-3),
            "decision": {"max_epochs": 1, "fail_iterations": 10}}
#: a tensor's gap is ||card - CPU|| / ||CPU - initial|| (initial weights
#: are bit-equal).  Adam's first updates are close to lr.sign(g), so an
#: element whose gradient is near 0 and differs in sign by roundoff moves
#: a whole step the other way; a norm weighs such elements against the
#: tensor's whole movement.  Limits after the first and the third update,
#: set from one sound run (worst tensor 1.1e-4 after the first update,
#: 2.0e-3 after the third) and the two faulty runs below (worst 1.48 and
#: 0.89 after the first): 87x above the sound reading and 89x below the
#: weaker fault; the third-update limit 25x above its sound reading
LM_FIRST_SHARE = 0.01
LM_THIRD_SHARE = 0.05
#: faulty card runs the first-update limit must reject: the flash backward
#: launched with causal=False, and given the sm_scale of head_dim / 2
LM_FAULTS = ("bwd_not_causal", "bwd_other_scale")
#: the conv-zoo phases, each through its sample's own ``train`` at the
#: default (full-width) config for 2 epochs, and the tensors that one
#: fused-SGD launch a train step updates: weights and biases of every
#: parameterized layer (``residual_proj`` is bias-free)
ZOO = {"cifar": 8, "mnist_conv": 8, "cifar_resnet": 17, "mnist_ae": 4}
#: the reference's own bar for CIFAR's default topology
#: (``tests/test_cifar.py:52``)
CIFAR_MAX_ERR_PCT = 10.0
#: card vs CPU at the default width and minibatch 100: 400 train / 100
#: validation samples, one epoch, so 4 train minibatches, the last gated
#: by Decision: 3 committed updates
ZOO_SMALL = {"n_train": 400, "n_valid": 100}
#: a layer's gap as a share of its movement (``weight_gaps``), after the
#: first and after the third committed update.  cuDNN (TF32 off) and the
#: CPU sum ~1e-6 apart (relative), so a max-pool argmax or a ReLU gate
#: whose inputs are that close to a tie flips on one side and moves one
#: term of a weight gradient's sum.  Set from one sound card run (NVIDIA
#: H100 80GB HBM3, 700.00 W; worst layer after the first update: cifar
#: 1.96e-4, cifar_resnet 9.7e-4, mnist_ae 4.5e-6; after the third: 9.0e-4,
#: 2.85e-3, 2.4e-6) and the faulty runs below (worst layer after the
#: first: 0.59, 1.22, 1.0): 10x above the sound reading, 59x below the
#: weakest fault; the third-update limit 17x above its sound reading
ZOO_FIRST_SHARE = 0.01
ZOO_THIRD_SHARE = 0.05
#: faulty card runs the first-update limit must reject: every conv weight
#: gradient spatially flipped (CIFAR), the skip error left unstashed, and
#: the projection's weight gradient dropped (ResNet).  A dropped
#: strict-ReLU tie mask is not among them: the phases count the exact
#: z == 0 ties their card runs meet (``strict_relu_ties``, 0 in every run
#: so far), and a fault that no input exercises cannot fail a limit
ZOO_FAULTS = {"cifar": ("conv_wgrad_flipped",),
              "cifar_resnet": ("skip_unstashed", "proj_wgrad_dropped")}
#: deconv on the card vs the CPU, outputs and gradients: max gap as a
#: share of the largest CPU element (cuDNN's sums in another order)
DECONV_SHARE = 1e-5
#: the Bernoulli draw (the RBM's visible and hidden shapes at minibatch
#: 100), timed; then sizes 1, 127 and 2**16 + 3, checked only
BERNOULLI_SHAPES = {"rbm_visible": (100, 784), "rbm_hidden": (100, 256)}
#: the reference's bar for the SOM's spread (``tests/test_kohonen.py:73``)
KOHONEN_MIN_NEURONS = 4
#: card vs CPU SOM codebook after the first and third update (minibatch
#: 100, 3 updates), as a share of its movement: the update's products
#: sum 100 rows in another order (~1e-7 relative), and a winner picked
#: differently at a near tie moves one row's pull (~1e-2 of the
#: movement).  The planted fault, a neighbourhood divided by 2σ where
#: it should be 2σ² (σ = 4 at the start), reshapes every pull (~0.5)
SOM_FIRST_SHARE = 0.01
SOM_THIRD_SHARE = 0.05
#: the RBM phase: epochs at the sample's default widths (cut for time;
#: the sample's default is 10), and its small card-vs-CPU runs: 300 train
#: samples (3 updates) and 100 validation (one minibatch, no draw)
RBM_EPOCHS = 2
RBM_SMALL = {"n_train": 300, "n_valid": 100}
#: card vs CPU RBM parameters after the first and third update, the
#: worst tensor's gap as a share of its movement: the products differ
#: ~1e-7 relative (~1e-6 of the movement), and a hidden sample that flips
#: (u between the two sides' p) moves one row's reconstruction by
#: ~W (0.01): ~3e-5 of the movement.  The planted fault, Gibbs samples
#: drawn with an unfolded key (another sample for every hidden unit),
#: moves the negative phase by ~1e-2 of the movement
RBM_FIRST_SHARE = 1e-3
RBM_THIRD_SHARE = 1e-2
#: the reference's bar for lines (``tests/test_lines.py:40``)
LINES_MAX_ERR_PCT = 15.0
#: the streams phase: one train epoch of a small MNIST-RBM captured (5
#: minibatches of 100, the last padded to 30 live rows)
STREAM_RBM = {"n_train": 430, "n_valid": 0}


def check(cond, what):
    if not cond:
        raise RuntimeError("chip smoke failed: %s" % what)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def time_ms(fns, torch, calls=10, reps=25):
    """Median over ``reps`` of the card time of one call, each rep
    timing ``calls`` back-to-back calls between two CUDA events.  The
    calls cycle through ``fns`` (one per copy of the inputs, so a call
    finds its operands cold in the 50 MB L2, as a serving step finds the
    next layer's pool), and a spin kernel keeps the card busy while the
    host enqueues them, so the host's per-call overhead stays out of the
    card time."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # spin for twice the host's enqueue time (at most 2.5 GHz)
    cycles = int(2 * 2.5e9 * host_s * calls) + 100000
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for k in range(calls):
            fns[k % len(fns)]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(n_bytes, n_flops, flop_s=FP32_FLOP_S):
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_flops / flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ kernels
def live_pages(ptab_width, page, pos, c, window=None, sinks=0,
               prefill=False):
    """How many pages of each lane's table hold a key live for any of
    its query rows — the pages the CUDA kernels read (``page_live`` in
    the source), which is what a bound counts."""
    out = []
    for p in pos:
        n = 0
        for j in range(ptab_width):
            kb = j * page
            live = kb < p if prefill else kb <= p + c - 1
            if window:
                live = live and (kb + page - 1 > p - window or kb < sinks)
            n += bool(live)
        out.append(n)
    return out


def decode_case(torch, HK, A, b=8, h=8, kv=8, c=1, dh=64, page=32, m=16,
                window=None, sinks=0, seed=0, timed=True, shallow=False):
    """Kernel 5 against its plain version; the wrapper's call made under
    ``set_sync_debug_mode("error")`` (it must not read the card on the
    host: pos stays there), and repeated (bit-equal: the splits meet in a
    fixed order).  Lanes sit deep in their tables, as a long-running
    batch does, or with ``shallow`` below their first page's end (every
    split but the first empty)."""
    dev = torch.device("cuda")
    rng = numpy.random.RandomState(seed)
    n_pages = b * m + 1
    q = torch.as_tensor(rng.randn(b, h, c, dh).astype(numpy.float32),
                        device=dev)
    kp = torch.as_tensor(rng.randn(n_pages, kv, page, dh).astype(
        numpy.float32), device=dev)
    vp = torch.as_tensor(rng.randn(n_pages, kv, page, dh).astype(
        numpy.float32), device=dev)
    ptab_h = (1 + rng.permutation(b * m)).reshape(b, m).astype(numpy.int32)
    if shallow:
        pos_h = rng.randint(0, page - c + 1, b).astype(numpy.int32)
    else:
        pos_h = rng.randint(m * page - 32, m * page - c + 1, b).astype(
            numpy.int32)
    ptab = torch.as_tensor(ptab_h, device=dev)
    pos = torch.as_tensor(pos_h, device=dev)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = HK.paged_flash_decode(q, kp, vp, ptab, pos, window, sinks)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again = HK.paged_flash_decode(q, kp, vp, ptab, pos, window, sinks)
    ref = HK.paged_flash_decode_ref(q, kp, vp, ptab, pos, window, sinks)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(err <= KERNEL_ATOL, "decode max abs err %g > %g" % (err,
                                                             KERNEL_ATOL))
    check(torch.equal(got, again), "decode: two launches differ")
    pages = live_pages(m, page, pos_h, c, window, sinks)
    shape = {"b": b, "h": h, "kv": kv, "c": c, "dh": dh, "page": page,
             "m": m, "window": window, "sinks": sinks,
             "splits": HK.decode_splits(b, h, kv, c, dh, m),
             "live_pages": sum(pages)}
    if not timed:
        return {"kernel": "paged_flash_decode", "shape": shape,
                "max_abs_err": err, "no_host_sync": True,
                "bit_equal_repeat": True}
    pools = [(kp, vp)] + [(kp.clone(), vp.clone()) for _ in range(COPIES - 1)]
    ms = time_ms([lambda k=k, v=v: HK.paged_flash_decode(
        q, k, v, ptab, pos, window, sinks) for k, v in pools], torch)
    plain_ms = time_ms([lambda k=k, v=v: HK.paged_flash_decode_ref(
        q, k, v, ptab, pos, window, sinks) for k, v in pools], torch)
    # library yardstick: SDPA on the gathered, head-repeated view
    views = [(A._repeat_kv(A.paged_view(k, ptab), h),
              A._repeat_kv(A.paged_view(v, ptab), h)) for k, v in pools]
    mask = A.chunk_live_mask(pos.long(), c, m * page, window, sinks)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_err = (sdpa(q, *views[0], attn_mask=mask)
                   - ref).abs().max().item()
    library_ms = time_ms([lambda kx=kx, vx=vx: sdpa(q, kx, vx,
                                                    attn_mask=mask)
                          for kx, vx in views], torch)
    n_bytes = (2 * q.numel() * 4 + ptab.numel() * 4 + pos.numel() * 4
               + sum(pages) * 2 * kv * page * dh * 4)
    n_flops = 4 * (h // kv) * c * sum(pages) * kv * page * dh
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return {"kernel": "paged_flash_decode", "shape": shape,
            "no_host_sync": True, "bit_equal_repeat": True,
            "max_abs_err": err, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": library_err,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes}


def prefill_case(torch, HK, A, n_hist, b=1, h=8, kv=8, dh=64, page=32,
                 m=16, window=None, sinks=0, seed=1, timed=True):
    """Kernel 6 against its plain version, lanes ``n_hist`` pages deep:
    the output within ``KERNEL_ATOL``, the install bit-equal, and a
    second launch bit-equal to the first (the splits meet in a fixed
    order); the record names the split count."""
    dev = torch.device("cuda")
    rng = numpy.random.RandomState(seed)
    n_pages = b * m + 1
    c = page

    def t(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(numpy.float32),
                               device=dev)

    q, kn, vn = t(b, h, c, dh), t(b, kv, c, dh), t(b, kv, c, dh)
    kp, vp = t(n_pages, kv, page, dh), t(n_pages, kv, page, dh)
    ptab = torch.as_tensor((1 + rng.permutation(b * m)).reshape(b, m)
                           .astype(numpy.int32), device=dev)
    pos_h = numpy.full(b, n_hist * page, numpy.int32)
    pos = torch.as_tensor(pos_h, device=dev)
    kr, vr = kp.clone(), vp.clone()
    got, _, _ = HK.paged_flash_prefill(q, kn, vn, kp, vp, ptab, pos,
                                       window, sinks)
    again, _, _ = HK.paged_flash_prefill(q, kn, vn, kp, vp, ptab, pos,
                                         window, sinks)
    ref, _, _ = HK.paged_flash_prefill_ref(q, kn, vn, kr, vr, ptab, pos,
                                           window, sinks)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(err <= KERNEL_ATOL, "prefill max abs err %g > %g"
          % (err, KERNEL_ATOL))
    check(torch.equal(kp, kr) and torch.equal(vp, vr),
          "prefill install is not bit-equal to the plain version's")
    check(torch.equal(got, again), "prefill: two launches differ")
    shape = {"b": b, "h": h, "kv": kv, "c": c, "dh": dh, "page": page,
             "m": m, "window": window, "sinks": sinks, "n_hist": n_hist,
             "splits": HK.prefill_splits(b, h, kv, c, dh, m)}
    if not timed:
        return {"kernel": "paged_flash_prefill", "shape": shape,
                "max_abs_err": err, "bit_equal_repeat": True}
    pools = [(kp, vp)] + [(kp.clone(), vp.clone()) for _ in range(COPIES - 1)]
    ms = time_ms([lambda k=k, v=v: HK.paged_flash_prefill(
        q, kn, vn, k, v, ptab, pos, window, sinks) for k, v in pools], torch)
    plain_ms = time_ms([lambda k=k, v=v: HK.paged_flash_prefill_ref(
        q, kn, vn, k, v, ptab, pos, window, sinks) for k, v in pools], torch)
    views = [(A._repeat_kv(A.paged_view(k, ptab), h),
              A._repeat_kv(A.paged_view(v, ptab), h)) for k, v in pools]
    mask = A.chunk_live_mask(pos.long(), c, m * page, window, sinks)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_err = (sdpa(q, *views[0], attn_mask=mask)
                   - ref).abs().max().item()
    library_ms = time_ms([lambda kx=kx, vx=vx: sdpa(q, kx, vx,
                                                    attn_mask=mask)
                          for kx, vx in views], torch)
    hist = sum(live_pages(m, page, pos_h, c, window, sinks,
                             prefill=True))
    keys = c * hist * page + b * c * (c + 1) // 2      # over all rows
    n_bytes = (2 * q.numel() * 4 + 4 * kn.numel() * 4 + ptab.numel() * 4
               + pos.numel() * 4 + hist * 2 * kv * page * dh * 4)
    n_flops = 4 * h * keys * dh
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return {"kernel": "paged_flash_prefill",
            "shape": dict(shape, history_pages=hist),
            "bit_equal_repeat": True,
            "max_abs_err": err, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": library_err,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes}


# ---------------------------------------------------------------- fused SGD
def sgd_operands(torch, shape, seed, copies=1, offset=0):
    """``copies`` sets of (p, v, g) of ``shape`` on the card (g a batch
    sum of 100 samples); ``offset`` > 0 starts each tensor that many
    floats into its buffer (16-byte alignment lost: the scalar path)."""
    rng = numpy.random.RandomState(seed)
    n = int(numpy.prod(shape))
    dev = torch.device("cuda")

    def t(a):
        buf = torch.empty(n + offset, device=dev)
        buf[offset:] = torch.as_tensor(a.astype(numpy.float32), device=dev)
        return buf[offset:].view(shape)

    out = [(t(rng.uniform(-0.3, 0.3, n)), t(rng.randn(n) * 0.01),
            t(rng.randn(n) * 5))]
    return out + [tuple(t(x.cpu().numpy().reshape(-1)) for x in out[0])
                  for _ in range(copies - 1)]


def sgd_ulps(torch, got, ref):
    """(max |got - ref| in ulps of ref, count of unequal elements)."""
    a = ref.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return ((got - ref).abs() / ulp).max().item(), int((got != ref).sum())


def sgd_case(torch, HK, shapes, name, wd=0.0, l1=0.0, clip=None, seed=0,
             copies=1, scalars=None, offsets=None):
    """One update of each of ``shapes`` (momentum 0.9, lr 0.03, batch
    100, unless ``scalars`` gives each tensor its own) as ONE
    ``fused_sgd_update_multi`` call: checked against the plain version
    per tensor, the launch count read, then timed as that one call and,
    beside it, as one single-tensor call per tensor (the PR 6 route)."""
    offsets = offsets or [0] * len(shapes)
    sets = [sgd_operands(torch, shape, seed + i, copies, off)
            for i, (shape, off) in enumerate(zip(shapes, offsets))]
    scalars = scalars or [(100, 0.03, 0.9, wd, l1, clip)] * len(shapes)
    ps, vs, gs = (list(x) for x in zip(*[ops[0] for ops in sets]))
    before = HK.fused_sgd_update.launches
    got = HK.fused_sgd_update_multi(ps, vs, gs, scalars)
    launches = HK.fused_sgd_update.launches - before
    ref = HK.fused_sgd_update_multi_ref(ps, vs, gs, scalars)
    torch.cuda.synchronize()
    check(launches == -(-len(shapes) // HK.SGD_MAX_TENSORS),
          "fused_sgd_update %s: %d launches for %d tensors"
          % (name, launches, len(shapes)))
    worst, unequal, err = 0.0, 0, 0.0
    for x, y in zip(got[0] + got[1], ref[0] + ref[1]):
        ulps, neq = sgd_ulps(torch, x, y)
        worst, unequal = max(worst, ulps), unequal + neq
        err = max(err, (x - y).abs().max().item())
    check(worst <= SGD_MAX_ULPS, "fused_sgd_update %s: %g ulps > %g"
          % (name, worst, SGD_MAX_ULPS))

    def multi(fn, k):
        ops = [o[k] for o in sets]
        return lambda: fn(*[list(x) for x in zip(*ops)], scalars)

    def per_tensor(k):
        return lambda: [HK.fused_sgd_update(*o[k], *sc)
                        for o, sc in zip(sets, scalars)]

    ms = time_ms([multi(HK.fused_sgd_update_multi, k)
                  for k in range(copies)], torch)
    per_tensor_ms = time_ms([per_tensor(k) for k in range(copies)], torch)
    plain_ms = time_ms([multi(HK.fused_sgd_update_multi_ref, k)
                        for k in range(copies)], torch, calls=3, reps=5)
    n = sum(int(numpy.prod(s)) for s in shapes)
    # read p, v, g and write p', v' once: 20 bytes; ~10 flops an element
    bound_ms, bound_by = bound(20 * n, 10 * n)
    return {"kernel": "fused_sgd_update", "case": name,
            "shapes": [list(s) for s in shapes], "elements": n,
            "scalars": [list(x) for x in scalars], "offsets": offsets,
            "launches": launches, "max_abs_err": err,
            "max_ulps": worst, "unequal": unequal, "kernel_ms": ms,
            "per_tensor_launches_ms": per_tensor_ms,
            "pr6_per_tensor_ms": SGD_PR6_MS.get(name),
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def sgd_cases(torch, HK):
    big = (4096, 4096)
    # a weight and its bias with their own learning rate and decay
    own = [(100, 0.03, 0.9, 0.0005, 0.3, None), (100, 0.06, 0.9, 0.0, 0.3,
                                                 None)] * 2
    many = [(int(n),) for n in
            numpy.random.RandomState(60).randint(1, 5000, 50)]
    return [sgd_case(torch, HK, MNIST_PARAMS, "mnist_fc_step"),
            sgd_case(torch, HK, ALEXNET_PARAMS, "alexnet_step", wd=0.0005,
                     seed=50),
            sgd_case(torch, HK, [big], "fc_4096x4096", seed=10, copies=2),
            sgd_case(torch, HK, [(1,), (127,), (129,)], "odd_sizes",
                     seed=20),
            sgd_case(torch, HK, MNIST_PARAMS, "decay_l1_mix", wd=0.0005,
                     l1=0.3, seed=30),
            sgd_case(torch, HK, MNIST_PARAMS, "clip", wd=0.0005, l1=0.3,
                     clip=0.05, seed=40),
            sgd_case(torch, HK, MNIST_PARAMS, "per_tensor_scalars",
                     scalars=own, seed=70),
            sgd_case(torch, HK, MNIST_PARAMS, "mixed_alignment", seed=80,
                     offsets=[0, 1, 0, 3]),
            sgd_case(torch, HK, many, "two_tables", seed=90)]


# ---------------------------------------------------------------------- LRN
def close(torch, got, ref, tol):
    """Elementwise: |got - ref| <= atol + rtol |ref|."""
    rtol, atol = tol
    return (got - ref).abs() <= atol + rtol * ref.abs()


def within(torch, got, ref, tol):
    """(max |got - ref|, True when every element is within atol + rtol
    |ref|)."""
    return (got - ref).abs().max().item(), bool(close(torch, got, ref,
                                                      tol).all())


def lrn_faults(torch, HK, x, dy, y_ref, d_ref, dx_ref, hyper, k):
    """({fault: elements outside the limits}, the cross-channel term's
    rms share of dx) for faulty plain versions: the forward without its
    window (d = k), the backward without its cross-channel term, and
    (even n only) the backward summing the forward's window instead of
    its transpose.  Each count must be nonzero, or the check could not
    see that fault."""
    alpha, beta, n = hyper
    s = HK._lrn_scalars(alpha, beta, n, k)
    d_flat = torch.full_like(x, float(s["k"]))
    dpow = torch.pow(d_ref, float(s["neg_beta_1"]))
    direct = dy * (d_ref * dpow)
    out = {"fwd_without_window": int((~close(
               torch, x * torch.pow(d_flat, float(s["neg_beta"])), y_ref,
               LRN_FWD_TOL)).sum() + (~close(torch, d_flat, d_ref,
                                            LRN_FWD_TOL)).sum()),
           "bwd_without_cross_term": int((~close(
               torch, direct, dx_ref, LRN_BWD_TOL)).sum())}
    if n % 2 == 0:
        inner = HK._window_sum(dy * x * dpow, n, n // 2)
        out["bwd_forward_window"] = int((~close(
            torch, direct - float(s["coef"]) * x * inner, dx_ref,
            LRN_BWD_TOL)).sum())
    return out, ((direct - dx_ref).norm() / dx_ref.norm()).item()


def lrn_case(torch, HK, name, shape, n=5, seed=0, timed=True, offset=0):
    """Kernels 2 and 3 on an NHWC ``shape`` against their plain versions
    (and, timed, against local_response_norm on the NCHW view); each also
    against an fp64 plain version (``LRN_FP64_FACTOR``) and launched
    twice (bit-equal).  ``offset`` > 0 starts x and dy that many floats
    into their buffers (16-byte alignment lost: the 4-byte instance).
    The records name the launch plan (``HK.lrn_plan``)."""
    dev = torch.device("cuda")
    rng = numpy.random.RandomState(seed)
    c = shape[-1]
    rows = int(numpy.prod(shape[:-1]))

    def place(a):
        buf = torch.empty(a.size + offset, device=dev)
        buf[offset:] = torch.as_tensor(a.reshape(-1), device=dev)
        return buf[offset:].view(shape)

    # non-negative inputs (post-ReLU) of rms 3 and an O(1) cotangent, so
    # that the window term of d and the backward's cross-channel term
    # both sit well above the limits (``lrn_faults`` counts by how much)
    x = place(3 * numpy.abs(rng.randn(*shape)).astype(numpy.float32))
    dy = place(rng.randn(*shape).astype(numpy.float32))
    hyper = (1e-4, 0.75, n)
    y, d = HK.lrn_forward(x, *hyper, 2.0)
    dx = HK.lrn_backward(x, d, dy, *hyper)
    y2, d2 = HK.lrn_forward(x, *hyper, 2.0)
    dx2 = HK.lrn_backward(x, d, dy, *hyper)
    y_ref, d_ref = HK.lrn_forward_ref(x, *hyper, 2.0)
    dx_ref = HK.lrn_backward_ref(x, d_ref, dy, *hyper)
    torch.cuda.synchronize()
    check(torch.equal(y, y2) and torch.equal(d, d2),
          "lrn_forward %s: two launches differ" % name)
    check(torch.equal(dx, dx2), "lrn_backward %s: two launches differ"
          % name)
    # the same functions in fp64 on the same inputs
    y64, d64 = HK.lrn_forward_ref(x.double(), *hyper, 2.0)
    dx64 = HK.lrn_backward_ref(x.double(), d64, dy.double(), *hyper)
    fp64 = {}
    for what, got, plain, want in (("y", y, y_ref, y64), ("d", d, d_ref, d64),
                                   ("dx", dx, dx_ref, dx64)):
        fp64[what] = {"kernel": (got.double() - want).abs().max().item(),
                      "plain_fp32": (plain.double() - want).abs().max()
                      .item()}
        check(fp64[what]["kernel"]
              <= LRN_FP64_FACTOR * fp64[what]["plain_fp32"],
              "lrn %s %s against fp64: kernel %g > %g x the fp32 plain "
              "version's %g" % (name, what, fp64[what]["kernel"],
                                LRN_FP64_FACTOR, fp64[what]["plain_fp32"]))
    vec = offset % 4 == 0
    fwd_err, fwd_ok = within(torch, y, y_ref, LRN_FWD_TOL)
    d_err, d_ok = within(torch, d, d_ref, LRN_FWD_TOL)
    bwd_err, bwd_ok = within(torch, dx, dx_ref, LRN_BWD_TOL)
    check(fwd_ok and d_ok, "lrn_forward %s: max abs err %g / %g beyond "
          "%r" % (name, fwd_err, d_err, LRN_FWD_TOL))
    check(bwd_ok, "lrn_backward %s: max abs err %g beyond %r"
          % (name, bwd_err, LRN_BWD_TOL))
    faults, cross_share = lrn_faults(torch, HK, x, dy, y_ref, d_ref, dx_ref,
                                     hyper, 2.0)
    check(all(v > 0 for v in faults.values()), "lrn %s: a fault would pass "
          "the limits: %r" % (name, faults))
    shape = {"rows": rows, "c": c, "n": n, "offset": offset}
    fwd = {"kernel": "lrn_forward", "case": name, "shape": shape,
           "plan": HK.lrn_plan(rows, c, n, vec),
           "max_abs_err": max(fwd_err, d_err), "faults_caught": {
               k: v for k, v in faults.items() if k.startswith("fwd")},
           "fp64_err": {k: fp64[k] for k in ("y", "d")},
           "bit_equal_repeat": True}
    bwd = {"kernel": "lrn_backward", "case": name, "shape": shape,
           "plan": HK.lrn_plan(rows, c, n, vec, backward=True),
           "max_abs_err": bwd_err, "cross_term_rms_share": cross_share,
           "faults_caught": {k: v for k, v in faults.items()
                             if k.startswith("bwd")},
           "fp64_err": {"dx": fp64["dx"]}, "bit_equal_repeat": True}
    if not timed:
        return fwd, bwd
    xs = [x] + [x.clone() for _ in range(COPIES - 1)]
    ds = [d] + [d.clone() for _ in range(COPIES - 1)]
    # the library: local_response_norm on the NHWC tensor's NCHW view
    lib = torch.nn.functional.local_response_norm
    xv = [t.permute(0, 3, 1, 2) for t in xs]
    lib_err = (lib(xv[0], n, *hyper[:2], 2.0).permute(0, 2, 3, 1)
               - y_ref).abs().max().item()
    leaves = [t.detach().clone().requires_grad_() for t in xv]
    outs = [lib(t, n, *hyper[:2], 2.0) for t in leaves]
    dyv = dy.permute(0, 3, 1, 2)
    elems = rows * c
    fwd.update(
        kernel_ms=time_ms([lambda t=t: HK.lrn_forward(t, *hyper, 2.0)
                           for t in xs], torch),
        plain_ms=time_ms([lambda t=t: HK.lrn_forward_ref(t, *hyper, 2.0)
                          for t in xs], torch, calls=3, reps=5),
        library_ms=time_ms([lambda t=t: lib(t, n, *hyper[:2], 2.0)
                            for t in xv], torch, calls=3, reps=5),
        library_max_abs_err=lib_err, bytes=12 * elems)
    fwd["bound_ms"], fwd["bound_by"] = bound(12 * elems, (n + 4) * elems)
    bwd.update(
        kernel_ms=time_ms([lambda t=t, e=e: HK.lrn_backward(t, e, dy,
                                                            *hyper)
                           for t, e in zip(xs, ds)], torch),
        plain_ms=time_ms([lambda t=t, e=e: HK.lrn_backward_ref(t, e, dy,
                                                               *hyper)
                          for t, e in zip(xs, ds)], torch, calls=3,
                         reps=5),
        library_ms=time_ms([lambda o=o, t=t: torch.autograd.grad(
            o, t, dyv, retain_graph=True) for o, t in zip(outs, leaves)],
            torch, calls=3, reps=5),
        bytes=16 * elems)
    bwd["bound_ms"], bwd["bound_by"] = bound(16 * elems, (n + 8) * elems)
    return fwd, bwd


def lrn_ragged_rows(HK, c=96):
    """A row count of ``c`` channels whose forward and backward plans
    both end in a partial tile, with the busiest block's last ring stage
    only partly used (its tiles not a multiple of the stages): the
    first such count from four full rounds of the LRN1 grid upwards."""
    base = HK.lrn_plan(LRN_SHAPES["lrn1"][0] * 55 * 55, c)
    start = 4 * base["blocks"] * base["rows_per_tile"]

    def ragged(rows, plan):
        tiles = -(-rows // plan["rows_per_tile"])
        busiest = -(-tiles // plan["blocks"])
        return rows % plan["rows_per_tile"] and busiest % plan["stages"]

    for rows in range(start + 1, start + 4000):
        if all(ragged(rows, HK.lrn_plan(rows, c, backward=b))
               for b in (False, True)):
            return rows
    check(False, "no ragged LRN row count found")


def lrn_edge_cases(torch, HK):
    """Kernels 2 and 3, checked not timed, on every path they split on:
    C % 4 != 0, pointers 4 bytes off 16-byte alignment, n > C, the
    runtime-n instance (n 1 and 7, and even n 4), one row a tile, a
    partial last tile and ring stage, and rows too wide for the ring
    (backward at C 12000, forward at C 30000)."""
    ragged = lrn_ragged_rows(HK)
    cases = [("c200_n4", (4, 32, 32, 200), 4, 0),
             ("c98", (8, 13, 13, 98), 5, 0),
             ("unaligned", (16, 27, 27, 256), 5, 1),
             ("c3_n5", (8, 27, 27, 3), 5, 0),
             ("n1", (8, 27, 27, 96), 1, 0),
             ("n7", (8, 27, 27, 96), 7, 0),
             ("c3000", (4, 7, 3000), 5, 0),
             ("ragged", (ragged, 96), 5, 0),
             ("bwd_wide_c12000", (16, 12000), 5, 0),
             ("fwd_wide_c30000", (8, 30000), 3, 0)]
    out = [rec for i, (name, shape, n, offset) in enumerate(cases)
           for rec in lrn_case(torch, HK, name, shape, n=n, seed=5 + i,
                               timed=False, offset=offset)]
    paths = {r["case"] + "/" + r["kernel"]: r["plan"] for r in out}
    want = {"c98/lrn_forward": (1, 5, 0), "unaligned/lrn_backward": (1, 5, 0),
            "c3_n5/lrn_forward": (1, 5, 0), "n7/lrn_forward": (4, 0, 0),
            "n1/lrn_backward": (4, 0, 0),
            "bwd_wide_c12000/lrn_backward": (4, 0, 1),
            "fwd_wide_c30000/lrn_forward": (4, 0, 1)}
    for key, w in want.items():
        p = paths[key]
        check((p["width"], p["template_n"], p["wide"]) == w,
              "lrn %s took the plan %r, not %r" % (key, p, w))
    check(paths["c3000/lrn_forward"]["rows_per_tile"] == 1
          and paths["c3000/lrn_backward"]["rows_per_tile"] == 1,
          "lrn c3000: not one row a tile")
    return out


# ------------------------------------------------------------------ dropout
def dropout_case(torch, HK, prng, name, shape, rate=0.5, seed=0,
                 timed=True):
    """Kernel 4 against its plain version: bit-equal, 0 unequal."""
    dev = torch.device("cuda")
    x = torch.as_tensor(numpy.random.RandomState(seed).randn(*shape)
                        .astype(numpy.float32), device=dev)
    key = prng.fold_in(prng.PRNGKey(SEED), seed)
    got = HK.dropout(x, key, rate)
    ref = HK.dropout_ref(x, key, rate)
    torch.cuda.synchronize()
    unequal = int((got != ref).sum().item())
    check(unequal == 0, "dropout %s: %d elements differ from the plain "
          "version" % (name, unequal))
    n = x.numel()
    out = {"kernel": "dropout", "case": name, "shape": list(shape),
           "rate": rate, "unequal": unequal,
           "max_abs_err": (got - ref).abs().max().item(),
           "kept_share": (got != 0).float().mean().item()}
    if not timed:
        return out
    xs = [x] + [x.clone() for _ in range(COPIES - 1)]
    out.update(
        kernel_ms=time_ms([lambda t=t: HK.dropout(t, key, rate)
                           for t in xs], torch),
        plain_ms=time_ms([lambda t=t: HK.dropout_ref(t, key, rate)
                          for t in xs], torch, calls=3, reps=5),
        library_ms=None, bytes=8 * n, int_ops=DROPOUT_OPS * n)
    t_bytes = 8 * n / HBM_BYTES_S * 1e3
    t_ops = DROPOUT_OPS * n / INT32_OP_S * 1e3
    out["bound_ms"], out["bound_by"] = ((t_bytes, "bytes") if t_bytes >= t_ops
                                        else (t_ops, "operations"))
    return out


def bernoulli_case(torch, HK, prng, name, shape, exact, seed=0,
                   timed=True):
    """The Bernoulli draw against its plain version: bit-equal, and a
    second launch bit-equal to the first.  ``exact`` puts exact 0.0 and
    1.0 among the probabilities (every third element each)."""
    dev = torch.device("cuda")
    p = numpy.random.RandomState(seed).rand(*shape).astype(numpy.float32)
    if exact:
        flat = p.reshape(-1)
        flat[::3], flat[1::3] = 0.0, 1.0
    p = torch.as_tensor(p, device=dev)
    key = prng.fold_in(prng.PRNGKey(SEED), 0xB1 + seed)
    got = HK.bernoulli(key, p)
    again = HK.bernoulli(key, p)
    ref = HK.bernoulli_ref(key, p)
    torch.cuda.synchronize()
    unequal = int((got != ref).sum().item())
    check(unequal == 0, "bernoulli %s: %d elements differ from the plain "
          "version" % (name, unequal))
    check(torch.equal(got, again), "bernoulli %s: a second launch differs"
          % name)
    if exact:
        flat = got.reshape(-1)
        check(not flat[::3].any().item() and flat[1::3].all().item(),
              "bernoulli %s: p = 0 drew 1 or p = 1 drew 0" % name)
    n = p.numel()
    out = {"kernel": "bernoulli", "case": name, "shape": list(shape),
           "exact_0_1": exact, "unequal": unequal,
           "max_abs_err": (got - ref).abs().max().item(),
           "repeat_bit_equal": True, "ones_share": got.mean().item()}
    if not timed:
        return out
    ps = [p] + [p.clone() for _ in range(COPIES - 1)]
    out.update(
        kernel_ms=time_ms([lambda t=t: HK.bernoulli(key, t) for t in ps],
                          torch),
        plain_ms=time_ms([lambda t=t: HK.bernoulli_ref(key, t) for t in ps],
                         torch, calls=3, reps=5),
        library_ms=None, bytes=8 * n, int_ops=DROPOUT_OPS * n)
    t_bytes = 8 * n / HBM_BYTES_S * 1e3
    t_ops = DROPOUT_OPS * n / INT32_OP_S * 1e3
    out["bound_ms"], out["bound_by"] = ((t_bytes, "bytes") if t_bytes >= t_ops
                                        else (t_ops, "operations"))
    return out


# ------------------------------------------------------- flash attention
def tf32_round(torch, x):
    """x rounded to TF32 (its top 19 bits, to nearest, ties away from
    zero): the kernels' big part of a 3xTF32 split."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def flash_faults(torch, HK, q, k, v, do, causal, o_ref, grads_ref, limit):
    """{fault: elements outside the limits} for six faulty plain versions:
    the causal mask as col < row (the forward; its row 0 has no key left,
    so NaN, which counts as outside), the forward's two products as one
    TF32 product each, the forward's o += P v without the small(P).big(v)
    term (P rounded to TF32, as a kernel that dropped it computes), the
    backward without di, dQ without sm_scale, and the backward's products
    as one TF32 product each (what a kernel that dropped 3xTF32's small
    parts computes).  Each count must be nonzero, or the checks could not
    see that fault."""
    scale = float(1.0 / q.shape[-1] ** 0.5)

    def outside(got, want):
        return int((~((got - want).abs() <= limit)).sum().item())

    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    rows = torch.arange(q.shape[-2], device=q.device)[:, None]
    cols = torch.arange(k.shape[-2], device=q.device)[None, :]
    o_bad = torch.matmul(torch.softmax(s.masked_fill(
        cols >= rows, float("-inf")), dim=-1), v)
    del s
    out = {"mask_col_lt_row": outside(o_bad, o_ref)}
    del o_bad
    o, lse = HK.flash_attention_ref(q, k, v, causal)
    p = torch.exp(HK._flash_scores(q, k, causal, scale) - lse[..., None])
    out["fwd_without_small_big"] = outside(torch.matmul(tf32_round(torch, p),
                                                        v), o_ref)
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out["fwd_tf32_single_product"] = outside(
            HK.flash_attention_ref(q, k, v, causal)[0], o_ref)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prior
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * dp                                  # without di
    out["bwd_without_di"] = (outside(torch.matmul(ds, k) * scale,
                                     grads_ref[0])
                             + outside(torch.matmul(ds.transpose(-1, -2), q)
                                       * scale, grads_ref[1]))
    ds = p * (dp - (o * do).sum(-1)[..., None])
    out["dq_without_scale"] = outside(torch.matmul(ds, k), grads_ref[0])
    del p, dp, ds
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = HK.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prior
    out["tf32_single_product"] = sum(outside(got, want)
                                     for got, want in zip(tf32, grads_ref))
    return out


def flash_case(torch, HK, b, h, s, dh, causal=True, seed=0, timed=True,
               peak=None):
    """Kernels 7a, 7b, 7c at (b, h, s, dh) against their plain versions
    (both backward kernels take the plain forward's o and lse, so each
    is held alone); each kernel also against an fp64 plain version beside
    the fp32 one, and launched twice (bit-equal); timed, also against
    SDPA and its autograd backward.  ``peak`` scales q so
    the largest score reaches it.  Returns three records: forward, dK/dV,
    dQ."""
    dev = torch.device("cuda")
    rng = numpy.random.RandomState(seed)

    def t():
        return torch.as_tensor(rng.randn(b, h, s, dh).astype(numpy.float32),
                               device=dev)

    q, k, v, do = t(), t(), t(), t()
    if peak:
        q = q * (peak / (torch.matmul(q, k.transpose(-1, -2))
                         / dh ** 0.5).abs().max())
    o, lse = HK.flash_attention_fwd(q, k, v, causal)
    o2, lse2 = HK.flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = HK.flash_attention_ref(q, k, v, causal)
    inputs = (q, k, v, o_ref, lse_ref, do)
    dk, dv = HK.flash_attention_bwd_dkv(*inputs, causal)
    dq = HK.flash_attention_bwd_dq(*inputs, causal)
    # no atomics in either pass: a second launch repeats bit for bit
    dk2, dv2 = HK.flash_attention_bwd_dkv(*inputs, causal)
    dq2 = HK.flash_attention_bwd_dq(*inputs, causal)
    grads_ref = HK.flash_attention_bwd_ref(*inputs, causal)
    torch.cuda.synchronize()
    shape = (b, h, s, dh, causal, peak)
    fwd_repeat = torch.equal(o, o2) and torch.equal(lse, lse2)
    check(fwd_repeat, "flash forward at %r: two launches differ" % (shape,))
    repeat = all(torch.equal(x, y) for x, y in ((dq, dq2), (dk, dk2),
                                                 (dv, dv2)))
    check(repeat, "flash backward at %r: two launches differ" % (shape,))
    del o2, lse2, dq2, dk2, dv2
    errs = {}
    for name, got, want in (("o", o, o_ref), ("lse", lse, lse_ref),
                            ("dq", dq, grads_ref[0]), ("dk", dk, grads_ref[1]),
                            ("dv", dv, grads_ref[2])):
        limit = FLASH_ATOL * (max(want.abs().max().item(), 1.0) if peak
                              else 1.0)
        errs[name] = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()) and errs[name] <= limit,
              "flash %s at %r: max abs err %g > %g"
              % (name, shape, errs[name], limit))
    # the same functions in fp64 on the same inputs: the kernels' error
    # beside the fp32 plain version's
    grads64 = HK.flash_attention_bwd_ref(*(x.double() for x in inputs),
                                         causal)
    fwd64 = HK.flash_attention_ref(q.double(), k.double(), v.double(), causal)
    fp64 = {}
    for name, got, plain, want in zip(("o", "lse", "dq", "dk", "dv"),
                                      (o, lse, dq, dk, dv),
                                      (o_ref, lse_ref) + tuple(grads_ref),
                                      fwd64 + tuple(grads64)):
        fp64[name] = {"kernel": (got.double() - want).abs().max().item(),
                      "plain_fp32": (plain.double() - want).abs().max()
                      .item()}
        check(fp64[name]["kernel"]
              <= FLASH_FP64_FACTOR * fp64[name]["plain_fp32"],
              "flash %s at %r against fp64: kernel %g > %g x the fp32 "
              "plain version's %g" % (name, shape, fp64[name]["kernel"],
                                      FLASH_FP64_FACTOR,
                                      fp64[name]["plain_fp32"]))
    del grads64, fwd64
    shape = {"b": b, "h": h, "s": s, "dh": dh, "causal": causal,
             "peak": peak}
    recs = [{"kernel": "flash_attention_fwd", "shape": shape,
             "max_abs_err": max(errs["o"], errs["lse"]),
             "fp64_err": {n: fp64[n] for n in ("o", "lse")},
             "bit_equal_repeat": fwd_repeat},
            {"kernel": "flash_attention_bwd_dkv", "shape": shape,
             "max_abs_err": max(errs["dk"], errs["dv"]),
             "fp64_err": {n: fp64[n] for n in ("dk", "dv")},
             "bit_equal_repeat": repeat},
            {"kernel": "flash_attention_bwd_dq", "shape": shape,
             "max_abs_err": errs["dq"], "fp64_err": {"dq": fp64["dq"]},
             "bit_equal_repeat": repeat}]
    if not timed:
        return recs
    faults = flash_faults(torch, HK, q, k, v, do, causal, o_ref, grads_ref,
                          FLASH_ATOL)
    check(all(n > 0 for n in faults.values()), "flash: a fault would pass "
          "the limits: %r" % faults)
    recs[0]["faults_caught"] = {n: faults[n] for n in (
        "mask_col_lt_row", "fwd_without_small_big",
        "fwd_tf32_single_product")}
    recs[1]["faults_caught"] = {n: faults[n] for n in (
        "bwd_without_di", "tf32_single_product")}
    recs[2]["faults_caught"] = {n: faults[n] for n in (
        "dq_without_scale", "bwd_without_di", "tf32_single_product")}
    del grads_ref
    # the main path hands both backward kernels one di per backward
    operands = inputs + (HK.flash_attention_di(o_ref, do),)
    sets = [operands] + [tuple(x.clone() for x in operands)
                         for _ in range(COPIES - 1)]
    fwd_ms = time_ms([lambda a=a: HK.flash_attention_fwd(*a[:3], causal)
                      for a in sets], torch)
    dkv_ms = time_ms([lambda a=a: HK.flash_attention_bwd_dkv(
        *a[:6], causal, di=a[6]) for a in sets], torch)
    dq_ms = time_ms([lambda a=a: HK.flash_attention_bwd_dq(
        *a[:6], causal, di=a[6]) for a in sets], torch)
    di_ms = time_ms([lambda a=a: HK.flash_attention_di(a[3], a[5])
                     for a in sets], torch)
    fwd_plain = time_ms([lambda a=a: HK.flash_attention_ref(*a[:3], causal)
                         for a in sets[:2]], torch, calls=3, reps=5)
    bwd_plain = time_ms([lambda a=a: HK.flash_attention_bwd_ref(
        *a[:6], causal) for a in sets[:2]], torch, calls=3, reps=5)
    # the library: SDPA (fp32, is_causal) and its autograd backward, which
    # computes dq, dk and dv in one call (timed here, never used by the port)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = (sdpa(q, k, v, is_causal=causal) - o_ref).abs().max().item()
    lib_fwd = time_ms([lambda a=a: sdpa(*a[:3], is_causal=causal)
                       for a in sets], torch, calls=3, reps=5)
    graphs = []
    for a in sets[:2]:
        leaves = [x.detach().clone().requires_grad_() for x in a[:3]]
        graphs.append((sdpa(*leaves, is_causal=causal), leaves, a[5]))
    lib_bwd = time_ms([lambda g=g: torch.autograd.grad(
        g[0], g[1], g[2], retain_graph=True) for g in graphs], torch,
        calls=3, reps=5)
    del graphs, sets
    # the work these inputs need: live (row, key) pairs, 2 flops a pair
    # and head column per product; each input read once, each output
    # written once.  The bound is 3xTF32 on the tensor cores (three TF32
    # products for each fp32-accurate one), the least time the card could
    # take for fp32 accuracy; fma_bound_ms is the same work as fp32 FMA
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    product = 2 * pairs * dh
    tensor = b * h * s * dh * 4
    row = b * h * s * 4
    for rec, n_products, n_bytes, ms, plain, lib in (
            (recs[0], 2, 4 * tensor + row, fwd_ms, fwd_plain, lib_fwd),
            (recs[1], 4, 6 * tensor + 2 * row, dkv_ms, bwd_plain, lib_bwd),
            (recs[2], 3, 5 * tensor + 2 * row, dq_ms, bwd_plain, lib_bwd)):
        flops = n_products * product
        rec["bound_ms"], rec["bound_by"] = bound(n_bytes, 3 * flops,
                                                 TF32_FLOP_S)
        rec.update(kernel_ms=ms, plain_ms=plain, library_ms=lib,
                   bytes=n_bytes, flops=flops,
                   fma_bound_ms=bound(n_bytes, flops)[0],
                   tflops_per_s=flops / ms * 1e-9)
    recs[0]["library_max_abs_err"] = lib_err
    for rec in recs[1:]:
        rec["plain_computes"] = rec["library_computes"] = "dq, dk and dv"
    # the backward's own work is 5 products (S, dP, dV, dK, dQ) from q, k,
    # v, o, do and lse to dq, dk, dv; the two passes recompute S and dP, 7
    # in all.  Beside SDPA's one backward call: the pair, and the pair with
    # the di reduction the backward runs before it
    recs[1]["backward_bound_ms"] = bound(8 * tensor + row, 3 * 5 * product,
                                         TF32_FLOP_S)[0]
    recs[1].update(di_ms=di_ms, pair_ms=dkv_ms + dq_ms,
                   pair_with_di_ms=dkv_ms + dq_ms + di_ms,
                   pair_over_library=(dkv_ms + dq_ms + di_ms) / lib_bwd)
    return recs


# -------------------------------------------------------------------- serve
def profile_steps(torch, step, n):
    """(busy share, {kernel: card us per step}) over ``n`` synchronous
    steps under torch.profiler.  The busy share is the union of the
    trace's kernel intervals over the wall time (None when the trace
    holds no kernel); the profiler's own host cost makes it a lower
    bound.  Kernel times sum each kernel's own intervals (the profiler's
    per-op device totals count a kernel twice: under the op that
    launched it and as itself)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            step()
        wall_us = (time.monotonic() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    per_kernel = {}
    for e in kernels:
        per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                              + e.time_range.elapsed_us() / n)
    return (busy / wall_us if kernels else None), per_kernel


def teacher_forced(torch, T, engine, seq, true_len, emitted):
    """Re-run ``seq`` (prompt + emitted) through the plain attention
    path on a fresh single-lane pool; returns (worst logit shortfall of
    an emitted token below its row max, exact argmax matches)."""
    page, dev = engine.prefill_chunk, engine.device
    n = -(-len(seq) // page)
    pools = [(torch.zeros((n + 1,) + k.shape[1:], device=dev),
              torch.zeros((n + 1,) + k.shape[1:], device=dev))
             for k, _ in engine._kv_pools]
    ptab = torch.zeros(1, engine.max_len // page, dtype=torch.int32,
                       device=dev)
    ptab[0, :n] = torch.arange(1, n + 1, dtype=torch.int32)
    toks = numpy.zeros(n * page, numpy.int32)
    toks[:len(seq)] = seq
    logits = []
    for start in range(0, n * page, page):
        h, _ = T.paged_chunk_apply(
            engine.params, torch.as_tensor(toks[None, start:start + page],
                                           device=dev),
            pools, ptab, torch.tensor([start], dtype=torch.int32,
                                      device=dev),
            engine.n_heads, attn_kernel=None)
        logits.append(T.head_logits(engine.params, h)[0])
    logits = torch.cat(logits)[true_len - 1:true_len - 1 + len(emitted)]
    tok = torch.as_tensor(emitted, device=dev).long()
    picked = logits.gather(1, tok[:, None])[:, 0]
    short = (logits.max(dim=1).values - picked).max().item()
    exact = int((logits.argmax(dim=1) == tok).sum().item())
    return short, exact


def serve(torch, HK, T, S, card):
    from veles_tpu_torch import prng
    cfg = LM_CONFIG
    t0 = time.monotonic()
    host = T.init_transformer_params(
        prng.RandomGenerator("init", SEED), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg["n_layers"], max_len=cfg["max_len"])
    engine = S.LMEngine(host, cfg["n_heads"], cfg["max_len"], slots=8,
                        paged_kv=True, prefill_chunk=32, device="cuda",
                        name="chip_smoke")
    engine.start()
    setup_s = time.monotonic() - t0
    rng = numpy.random.RandomState(SEED)
    reqs = [(rng.randint(0, cfg["vocab"], rng.randint(20, 301))
             .astype(numpy.int32), int(rng.randint(32, 65)))
            for _ in range(16)]
    HK.reset_launch_counts()
    t0 = time.monotonic()
    futures = [engine.submit(p, k) for p, k in reqs]
    outs = [f.result(timeout=300) for f in futures]
    wall = time.monotonic() - t0
    launches = HK.launch_counts()
    engine.stop()
    m = engine.metrics
    check(m.errors == 0, "%d engine errors" % m.errors)
    for out, (_, k) in zip(outs, reqs):
        check(out.shape == (k,) and out.min() >= 0
              and out.max() < cfg["vocab"], "malformed output %r" % out)
    steps, chunks = (m.counter("decode_dispatches"),
                     m.counter("prefill_dispatches"))
    check(launches["paged_flash_decode"] == cfg["n_layers"] * steps > 0,
          "decode launches %d for %d steps" % (launches["paged_flash_decode"],
                                               steps))
    check(launches["paged_flash_prefill"] == cfg["n_layers"] * chunks > 0,
          "prefill launches %d for %d chunks"
          % (launches["paged_flash_prefill"], chunks))
    inv = engine.verify_pool_invariants()
    check(inv["free_pages"] == engine._pool.num_pages,
          "pool did not get every page back: %r" % inv)

    worst, exact, total = 0.0, 0, 0
    with torch.inference_mode():
        for (prompt, _), out in zip(reqs, outs):
            seq = numpy.concatenate([prompt, out])
            short, n_exact = teacher_forced(torch, T, engine, seq,
                                            len(prompt), out)
            worst = max(worst, short)
            exact += n_exact
            total += len(out)
        check(worst <= LOGIT_TOL, "an emitted token's logit sits %g below "
              "its row max (tolerance %g)" % (worst, LOGIT_TOL))
        # decode step alone: all 8 lanes 16 pages deep, every table
        # entry a distinct pool page (the 128 pages the serve freed)
        w = engine._max_pages
        ptabs = (1 + numpy.arange(engine.slots * w, dtype=numpy.int32)
                 ).reshape(engine.slots, w)
        pos = numpy.full(engine.slots, engine.max_len - 1, numpy.int32)
        last = numpy.zeros(engine.slots, numpy.int32)
        engine._step_program(ptabs, last, pos)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        for _ in range(20):
            engine._step_program(ptabs, last, pos)
        step_ms = (time.monotonic() - t1) / 20 * 1e3
        busy, _ = profile_steps(torch, lambda: engine._step_program(
            ptabs, last, pos), 10)
    ttft = sorted(f.ttft_s for f in futures)
    tokens = sum(len(o) for o in outs)
    report = {"phase": "serve", "card": card, "config": cfg,
              "slots": 8, "page": 32, "requests": len(reqs),
              "tokens": tokens, "wall_s": wall,
              "tokens_per_s": tokens / wall,
              "ttft_p50_s": statistics.median(ttft),
              "ttft_max_s": ttft[-1],
              "dispatch_ms_mean": m.decode_step.sum / m.decode_step.total
              * 1e3,
              "decode_step_ms_full_width": step_ms,
              "decode_step_device_busy_share": busy,
              "decode_dispatches": steps, "prefill_dispatches": chunks,
              "launches": launches, "setup_s": setup_s,
              "teacher_forced": {"worst_shortfall": worst,
                                 "exact_argmax": exact, "tokens": total,
                                 "tolerance": LOGIT_TOL}}
    print(json.dumps(report), flush=True)
    return launches


# -------------------------------------------------------------------- train
def mnist_run(prng, root, mnist, device, **overrides):
    """Seeded MNIST-FC sample run through ``mnist.train`` (sample
    defaults: 784→100 tanh→10 softmax, minibatch 100, lr 0.03, momentum
    0.9), with ``overrides`` for the loader and decision."""
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("mnist", None)
    mnist.default_config()
    return mnist.train(fused=True, device=device, **overrides)


def train(torch, HK, card, device="cuda"):
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import mnist

    # full width and full data, 2 epochs
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("mnist", None)
    mnist.default_config()
    t0 = time.monotonic()
    wf = mnist.build(fused=True, decision={"max_epochs": 2})
    wf.initialize(device=device)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    HK.reset_launch_counts()
    t0 = time.monotonic()
    wf.run()
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    launches = HK.launch_counts()
    metrics = wf.decision.epoch_metrics
    check(len(metrics) == 2, "%d epochs ran, not 2" % len(metrics))
    val = [m["validation"] for m in metrics]
    steps = wf.fused_step.train_steps
    check(val[-1]["err_pct"] < 5.0, "validation err_pct %g >= 5"
          % val[-1]["err_pct"])
    check(val[1]["loss"] < val[0]["loss"], "validation loss did not fall: "
          "%r" % [v["loss"] for v in val])
    check(steps == 2 * 600 and launches["fused_sgd_update"] == steps,
          "fused_sgd_update launches %d for %d train minibatches"
          % (launches["fused_sgd_update"], steps))
    weights = [f.weights.mem for f in wf.forwards]
    check(all(numpy.isfinite(w).all() for w in weights),
          "non-finite weights after training")

    # device busy share of one fused train step (profiler, 20 steps)
    runner, loader = wf._fused_runner, wf.loader
    x = loader.original_data.devmem[:100]
    y = loader.original_labels.devmem[:100]
    mask = torch.ones(100, device=device)
    busy, _ = profile_steps(torch, lambda: (
        runner._train_step(runner.state, x, y, mask, 100),
        torch.cuda.synchronize()), 20)

    # the same seed on the card and on the CPU: 51 train minibatches, the
    # last gated by Decision (max_epochs 1), so 50 committed updates
    small = {"loader": {"n_train": 5100, "n_valid": 1000},
             "decision": {"max_epochs": 1}}
    on_card = mnist_run(prng, root, mnist, device, **small)
    # a seeded rerun on the card repeats bit for bit
    repeat = all(numpy.array_equal(va.mem, vb.mem) for a, b in zip(
        on_card.forwards, mnist_run(prng, root, mnist, device,
                                    **small).forwards)
        for va, vb in ((a.weights, b.weights), (a.bias, b.bias)))
    on_cpu = mnist_run(prng, root, mnist, "cpu", **small)
    worst = 0.0
    for a, b in zip(on_card.forwards, on_cpu.forwards):
        for va, vb in ((a.weights, b.weights), (a.bias, b.bias)):
            worst = max(worst, float(numpy.abs(va.mem - vb.mem).max()))
    check(worst <= TRAIN_ATOL, "card vs CPU weights differ by %g > %g"
          % (worst, TRAIN_ATOL))
    report = {"phase": "train", "card": card,
              "config": {"layers": "784-100tanh-10softmax",
                         "minibatch": 100, "n_train": 60000,
                         "n_valid": 10000, "epochs": 2, "fused": True},
              "setup_s": setup_s, "run_s": run_s,
              "s_per_epoch": run_s / 2,
              "train_samples_per_s": 2 * 60000 / run_s,
              "train_steps": steps, "launches": launches,
              "step_device_busy_share": busy,
              "validation": [{k: v[k] for k in ("n_err", "err_pct", "loss")}
                             for v in val],
              "card_vs_cpu_max_abs_weight_diff": worst,
              "card_vs_cpu_committed_updates": 50,
              "tolerance": TRAIN_ATOL, "card_rerun_bit_equal": repeat}
    print(json.dumps(report), flush=True)
    check(repeat, "train: a seeded rerun on the card changed the weights")
    return launches


# ------------------------------------------------------------------ alexnet
def imagenet_build(prng, root, imagenet, layers, **loader):
    """A seeded ImageNet-sample workflow at ``layers`` on the synthetic
    loader (defaults: minibatch 128, 256x256, 1000 classes, 640 train /
    128 validation, 2 epochs)."""
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("imagenet", None)
    loader = dict({"minibatch_size": 128, "records_path": None,
                   "n_train": 640, "n_valid": 128,
                   "image_hw": (256, 256), "n_classes": 1000}, **loader)
    epochs = loader.pop("epochs", 2)
    root.imagenet.update({"loader": loader,
                          "decision": {"max_epochs": epochs,
                                       "fail_iterations": 10},
                          "layers": layers})
    return imagenet.build(fused=True)


def committed_weights(run, device):
    """Initialize ``run`` on ``device`` and run it; returns each
    parameterized layer's (weights, bias) on the host at set-up and after
    every committed update."""
    run.initialize(device=device)
    runner, commit = run._fused_runner, run.fused_commit
    inner = commit.run

    def grab():
        return [[e[k].cpu().numpy().copy() for k in ("w", "b") if k in e]
                for e in runner.state if e]

    def run_and_keep():
        pending = run.fused_step.pending_state is not None
        inner()
        if pending:
            kept.append(grab())

    kept = [grab()]
    commit.run = run_and_keep
    run.run()
    return kept


def weight_gaps(card, cpu):
    """Per committed update (after the first, ..., the last) and per
    layer: the max |card - CPU| gap over weights and bias ("abs"), the
    CPU run's movement max |w - w0| ("movement"), and the gap as a share
    of the movement ("share")."""
    out = {"abs": [], "movement": [], "share": []}
    for k in range(1, len(cpu)):
        gaps = [max(float(numpy.abs(a - b).max()) for a, b in zip(x, y))
                for x, y in zip(card[k], cpu[k])]
        moved = [max(float(numpy.abs(a - b).max()) for a, b in zip(x, y))
                 for x, y in zip(cpu[k], cpu[0])]
        out["abs"].append(gaps)
        out["movement"].append(moved)
        out["share"].append([g / m for g, m in zip(gaps, moved)])
    return out


def same_metrics(a, b):
    """True when two runs' epoch metrics (lists of dicts of dicts of
    numbers and arrays) are bit-equal."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_metrics(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(same_metrics(x, y) for x, y in zip(a, b)))
    if isinstance(a, numpy.ndarray):
        return numpy.array_equal(a, b)
    return a == b


def same_weights(a, b):
    """True when two runs' kept weights (``committed_weights``) are
    bit-equal at every committed update."""
    return len(a) == len(b) and all(
        numpy.array_equal(u, v) for x, y in zip(a, b) for p, q in zip(x, y)
        for u, v in zip(p, q))


@contextlib.contextmanager
def fault(prng, name):
    """Within the block, ``name`` of ``ALEXNET_FAULTS`` is planted in the
    port's functional layer (the units look its functions up per call)."""
    from veles_tpu_torch.ops import functional as F
    if name == "dropout_key":
        attr, inner = "dropout", F.dropout

        def planted(x, rng, rate, train):
            return inner(x, rng if rng is None else prng.fold_in(rng, 1),
                         rate, train)
    else:
        attr, inner = "lrn_backward", F.lrn_backward

        def planted(x, d, err, *hyper):
            return inner(x, d - 1.0, err, *hyper)
    setattr(F, attr, planted)
    try:
        yield
    finally:
        setattr(F, attr, inner)


def alexnet(torch, HK, card, device="cuda", layers=None, small=None,
            **loader):
    """The ImageNet sample at full AlexNet width through
    ``imagenet.train``'s build + initialize + run, then card vs CPU."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import imagenet
    layers = layers or imagenet.alexnet_layers()
    t0 = time.monotonic()
    wf = imagenet_build(prng, root, imagenet, layers, **loader)
    wf.initialize(device=device)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    HK.reset_launch_counts()
    t0 = time.monotonic()
    wf.run()
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    launches = HK.launch_counts()
    metrics = wf.decision.epoch_metrics
    check(len(metrics) == 2, "%d epochs ran, not 2" % len(metrics))
    steps = wf.fused_step.train_steps
    ld = wf.loader
    mb = ld.max_minibatch_size
    valid_mbs = 2 * -(-ld.class_lengths[1] // mb)
    check(steps == 2 * -(-ld.class_lengths[2] // mb),
          "%d train steps dispatched" % steps)
    # per train step: each LRN forward and backward once, each dropout
    # forward and backward, and one update launch for every parameter
    # (weights, bias) of the step; each validation minibatch runs the LRN
    # forwards (AlexNet: 2, 2, 4, 1 per step)
    n_lrn = sum(1 for f in wf.forwards if f.layer_type == "norm")
    n_drop = sum(1 for f in wf.forwards if f.layer_type == "dropout")
    n_params = sum(2 for f in wf.forwards if f.has_params)
    want = {"lrn_forward": n_lrn * (steps + valid_mbs),
            "lrn_backward": n_lrn * steps, "dropout": 2 * n_drop * steps,
            "fused_sgd_update": -(-n_params // HK.SGD_MAX_TENSORS) * steps}
    got = {k: launches[k] for k in want}
    check(got == want, "alexnet launches %r, expected %r" % (got, want))
    losses = [m[s]["loss"] for m in metrics for s in ("validation", "train")]
    check(all(numpy.isfinite(v) for v in losses), "non-finite loss %r"
          % losses)
    check(all(numpy.isfinite(f.weights.mem).all() for f in wf.forwards
              if f.has_params), "non-finite weights after training")

    # one steady train step: host clock over 5 synchronous steps, and the
    # card's busy share of it (profiler, 5 steps)
    runner = wf._fused_runner
    x = ld.original_data.devmem[:mb]
    y = ld.original_labels.devmem[:mb]
    mask = torch.ones(mb, device=device)
    key = prng.PRNGKey(SEED)

    def step():
        runner._train_step(runner.state, x, y, mask, mb, key)
        torch.cuda.synchronize()

    step()
    t0 = time.monotonic()
    for _ in range(5):
        step()
    step_s = (time.monotonic() - t0) / 5
    busy, per_kernel = profile_steps(torch, step, 5)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    ported = {tag: sum(v for k, v in per_kernel.items() if tag in k)
              for tag in ("lrn_fwd_kernel", "lrn_bwd_kernel",
                          "dropout_kernel", "fused_sgd_kernel")}

    # the same seed on the card and on the CPU at minibatch 16: 4 train
    # minibatches, the last gated by Decision (max_epochs 1), so 3
    # committed updates; then the faulty card runs
    small = dict(small or {"minibatch_size": 16, "n_train": 64,
                           "n_valid": 16}, epochs=1)

    def small_run(dev):
        return committed_weights(imagenet_build(
            prng, root, imagenet, layers, **dict(loader, **small)), dev)

    on_card, on_cpu = small_run(device), small_run("cpu")
    under_pool = [any(g.layer_type == "max_pooling"
                      for g in wf.forwards[i + 1:])
                  for i, f in enumerate(wf.forwards) if f.has_params]
    limits = [ALEXNET_CONV_SHARE if u else ALEXNET_FC_SHARE
              for u in under_pool]
    sound = weight_gaps(on_card, on_cpu)
    faults = {}
    for name in ALEXNET_FAULTS:
        with fault(prng, name):
            gaps = weight_gaps(small_run(device), on_cpu)
        faults[name] = {"abs": gaps["abs"], "share": gaps["share"]}
    card_vs_cpu = {
        "minibatch": small["minibatch_size"],
        "committed_updates": len(on_cpu) - 1,
        "layers": [f.layer_type for f in wf.forwards if f.has_params],
        "under_a_max_pool": under_pool, "first_update_limits": limits,
        "third_update_limit": ALEXNET_DRIFT_SHARE,
        "sound": sound, "faults": faults}
    report = {"phase": "alexnet", "card": card,
              "config": {"layers": "alexnet_layers()", "crop": 227,
                         "minibatch": mb, "image_hw": list(ld.image_hw),
                         "n_classes": ld.n_classes,
                         "n_train": ld.class_lengths[2],
                         "n_valid": ld.class_lengths[1], "epochs": 2,
                         "fused": True},
              "setup_s": setup_s, "run_s": run_s, "train_steps": steps,
              "validation_minibatches": valid_mbs,
              "s_per_step": step_s, "samples_per_s": mb / step_s,
              "step_device_busy_share": busy,
              "step_card_us": sum(per_kernel.values()),
              "step_top_kernels_us": [[k[:80], v] for k, v in top],
              "step_ported_kernels_us": ported,
              "launches": launches,
              "losses": [{s: m[s]["loss"] for s in ("validation", "train")}
                         for m in metrics],
              "card_vs_cpu": card_vs_cpu}
    print(json.dumps(report), flush=True)
    check(card_vs_cpu["committed_updates"] == 3, "%d committed updates, "
          "not 3" % card_vs_cpu["committed_updates"])
    check(all(g <= lim for g, lim in zip(sound["share"][0], limits))
          and max(sound["share"][-1]) <= ALEXNET_DRIFT_SHARE,
          "card vs CPU AlexNet weight gaps beyond their limits: %r"
          % sound["share"])
    for name, gaps in faults.items():
        check(any(g > lim for g, lim in zip(gaps["share"][0], limits)),
              "the card-vs-CPU check passed the faulty run %r: %r"
              % (name, gaps["share"][0]))
    synthetic = {"s_per_step": step_s, "step_samples_per_s": mb / step_s,
                 "run_s": run_s,
                 "epoch_train_samples_per_s": steps * mb / run_s,
                 "step_device_busy_share": busy}
    return launches, synthetic


# ------------------------------------------------------------------ records
#: the records phase's sets as (validation, train) counts: 256x256x3
#: uint8, labels in [0, 1000); "full" at minibatch 128 is 2 validation
#: and 10 train minibatches an epoch (20 steps in 2 epochs), "small" is
#: the card-vs-CPU set at minibatch 16 (1 + 4 minibatches, the last
#: gated by Decision: 3 committed updates)
RECORDS_SETS = {"full": (256, 1280), "small": (16, 64)}
RECORDS_HW = 256
RECORDS_CLASSES = 1000
#: ImageNet's RGB channel means (0-255): the class prototypes sit around
#: them, so the train mean the loader subtracts is far from zero
IMAGENET_RGB_MEAN = (123.68, 116.78, 103.94)
#: RecordsLoader's uint8 scaling: float(u8) * (1/127.5) + (-1)
RECORDS_SCALE, RECORDS_OFFSET = 1.0 / 127.5, -1.0
RECORDS_FAULTS = ("mean_not_subtracted", "labels_shifted")
#: the LMDB leg: Datums of the full set's first images, converted
LMDB_DATUMS = 64
#: wine's validation bar, the reference's (tests/test_loader_extra.py)
WINE_MAX_N_ERR = 3


def write_record_set(directory, name, n_valid, n_train, hw=RECORDS_HW,
                     n_classes=RECORDS_CLASSES, seed=SEED, chunk=128):
    """A seeded uint8 record file laid out [0 | n_valid | n_train] of
    hw x hw x 3 images — class prototypes (8 x 8 cells blown up to hw,
    around ImageNet's channel means) plus noise, labels in
    [0, n_classes) — and its train mean image (float32 .npy, in the
    loader's [-1, 1] scale).  Returns (record path, mean path)."""
    import os
    from veles_tpu_torch.loader.records import write_records
    rng = numpy.random.default_rng(seed)
    n, cell = n_valid + n_train, hw // 8
    protos = numpy.clip(numpy.asarray(IMAGENET_RGB_MEAN).round()
                        + rng.integers(-72, 73, (n_classes, 8, 8, 3)),
                        0, 255).astype(numpy.int16)
    labels = rng.integers(0, n_classes, n).astype(numpy.int32)
    data = numpy.empty((n, hw, hw, 3), numpy.uint8)
    for at in range(0, n, chunk):
        up = protos[labels[at:at + chunk]].repeat(cell, 1).repeat(cell, 2)
        up += rng.integers(-32, 33, up.shape, dtype=numpy.int16)
        data[at:at + len(up)] = numpy.clip(up, 0, 255)
    mean = (data[n_valid:].mean(axis=0, dtype=numpy.float64)
            * RECORDS_SCALE + RECORDS_OFFSET).astype(numpy.float32)
    path = write_records(os.path.join(directory, name + ".rec"), data,
                         labels, [0, n_valid, n_train])
    mean_path = os.path.join(directory, name + "_mean.npy")
    numpy.save(mean_path, mean)
    return path, mean_path


def records_build(prng, root, imagenet, files, layers=None, epochs=2,
                  **loader):
    """A seeded ImageNet-sample workflow on a record file: only
    ``records_path``/``mean_path`` (and ``loader``) are set, so
    ``default_config`` picks ``alexnet_layers()`` itself unless
    ``layers`` is given (a rehearsal)."""
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("imagenet", None)
    cfg = {"loader": dict(loader, records_path=files[0],
                          mean_path=files[1]),
           "decision": {"max_epochs": epochs, "fail_iterations": 10}}
    if layers is not None:
        cfg["layers"] = layers
    root.imagenet.update(cfg)
    return imagenet.build(fused=True)


def bit_digest(torch, tensors, cache):
    """One int64 per tensor, on its device: the position-weighted sum of
    its 32-bit words (wrapping), so equal digests mean equal bits but
    for a 2**-64 chance.  ``cache`` keeps the weights by length."""
    out = []
    for t in tensors:
        bits = t.reshape(-1).view(torch.int32).to(torch.int64)
        key = (bits.numel(), str(bits.device))
        w = cache.get(key)
        if w is None:
            w = (torch.arange(bits.numel(), dtype=torch.int64,
                              device=bits.device) * 2654435761
                 % 2147483647 + 1)
            cache[key] = w
        out.append((bits * w).sum())
    return out


@contextlib.contextmanager
def records_fault(name):
    """Within the block, ``name`` of ``RECORDS_FAULTS`` is planted in the
    port's record loaders (host side, before the upload)."""
    from veles_tpu_torch.loader import records as R
    from veles_tpu_torch.samples import imagenet
    if name == "mean_not_subtracted":
        cls = imagenet.ImagenetRecordsLoader

        def planted(self, indices, batch=None, labels=None):
            return R.RecordsLoader._gather(self, indices, batch, labels)
    else:
        cls = R.RecordsLoader
        inner = cls._gather

        def planted(self, indices, batch=None, labels=None):
            batch, labels = inner(self, indices, batch, labels)
            labels += 1
            labels %= RECORDS_CLASSES
            return batch, labels
    saved = cls.__dict__["_gather"]
    cls._gather = planted
    try:
        yield
    finally:
        cls._gather = saved


def records_run(torch, HK, native, prng, root, imagenet, files, device,
                layers, prefetch):
    """One 2-epoch run of the ImageNet sample on the record file
    ``files`` through build + initialize + run, a bit digest of every
    minibatch the step reads and the first minibatch kept; returns the
    workflow and what was counted."""
    t0 = time.monotonic()
    wf = records_build(prng, root, imagenet, files, layers,
                       prefetch=prefetch)
    wf.initialize(device=device)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    ld = wf.loader
    check(isinstance(ld, imagenet.ImagenetRecordsLoader),
          "the records run loads through %s" % type(ld).__name__)
    check((ld._ring is not None) == (torch.device(device).type == "cuda"),
          "the pinned staging ring %s on %s"
          % ("is missing" if ld._ring is None else "exists", device))
    digests, first, cache = [], [], {}
    inner = ld.fill_minibatch

    def fill(indices, actual):
        inner(indices, actual)
        x, y = ld.minibatch_data.devmem, ld.minibatch_labels.devmem
        check(x.device.type == torch.device(device).type,
              "a records minibatch lies on %s" % x.device)
        digests.append(bit_digest(torch, (x, y), cache))
        if not first:
            first.append((numpy.array(indices), x.clone()))

    ld.fill_minibatch = fill
    HK.reset_launch_counts()
    native.reset_call_counts()
    t0 = time.monotonic()
    wf.run()
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    launches, calls = HK.launch_counts(), native.call_counts()
    del ld.fill_minibatch
    return wf, {"setup_s": setup_s, "run_s": run_s, "launches": launches,
                "native_calls": calls,
                "digests": [[int(d) for d in pair] for pair in digests],
                "first": first[0]}


def median_ms(fn, reps=5):
    """Median host milliseconds of ``fn`` over ``reps`` calls after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def unit_loop(torch, wf, n_valid_mbs):
    """One train minibatch of the whole unit loop — loader (gather,
    mean, upload), fused step, commit — ended by a synchronize; and a
    reset that puts the loader back at the first train minibatch of a
    fresh plan (10 train minibatches at full size)."""
    ld, fused, commit = wf.loader, wf.fused_step, wf.fused_commit

    def reset():
        ld._plan_epoch()
        ld._position = n_valid_mbs

    def step():
        ld.run()
        fused.run()
        commit.run()
        torch.cuda.synchronize()
    return reset, step


def host_split(torch, native, wf, device):
    """Host ms of one steady train minibatch's parts: gather+convert
    (pixels and labels, into a pinned buffer on the card), mean, upload
    (pinned, and pageable for comparison) and the fused step."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader.base import TRAIN
    ld, runner = wf.loader, wf._fused_runner
    idx = next(chunk for cls, chunk, _ in ld._order if cls == TRAIN)
    mb = len(idx)
    shape = (mb,) + ld._data.shape[1:]
    card = torch.device(device).type == "cuda"
    pinned = torch.empty(shape, dtype=torch.float32, pin_memory=card)
    host, labels = pinned.numpy(), numpy.empty(mb, numpy.int32)
    source = numpy.asarray(ld._labels)

    def gather():
        native.gather_convert(ld._data, idx, RECORDS_SCALE, RECORDS_OFFSET,
                              out=host)
        native.gather_labels(source, idx, out=labels)

    gather()
    dev = torch.empty(shape, dtype=torch.float32, device=device)
    pageable = numpy.array(host)
    y = torch.as_tensor(labels.copy()).to(device)
    mask = torch.ones(mb, device=device)
    key = prng.PRNGKey(SEED)
    out = {"gather_convert_ms": median_ms(gather),
           "mean_ms": median_ms(lambda: native.subtract_mean(host,
                                                             ld._mean)),
           "upload_pinned_ms": median_ms(lambda: (
               dev.copy_(pinned, non_blocking=True),
               torch.cuda.synchronize())),
           "upload_pageable_ms": median_ms(lambda: (
               torch.as_tensor(pageable).to(device),
               torch.cuda.synchronize())),
           "step_ms": median_ms(lambda: (
               runner._train_step(runner.state, dev, y, mask, mb, key),
               torch.cuda.synchronize()))}
    out["bytes"] = {"uint8_gathered": int(host.size),
                    "float32_converted": int(host.nbytes),
                    "uploaded": int(host.nbytes)}
    return out


def lmdb_leg(directory, files, n=LMDB_DATUMS):
    """``n`` Datums of the record file's first images written with the
    port's ``mdb.write_env``; ``lmdb_to_records`` must write the same
    bytes as ``write_records`` of the same HWC arrays."""
    import filecmp
    import os
    from veles_tpu_torch.loader import lmdb, mdb
    from veles_tpu_torch.loader import records as R
    _, data, labels = R.open_records(files[0])
    hwc, lab = numpy.array(data[:n]), numpy.array(labels[:n])
    lengths = [0, n // 4, n - n // 4]
    t0 = time.monotonic()
    env = mdb.write_env(os.path.join(directory, "lmdb"), [
        (b"%08d" % i, lmdb.serialize_datum(hwc[i].transpose(2, 0, 1),
                                           lab[i])) for i in range(n)])
    converted = lmdb.lmdb_to_records(os.path.dirname(env),
                                     os.path.join(directory, "lmdb.rec"),
                                     class_lengths=lengths)
    took = time.monotonic() - t0
    direct = R.write_records(os.path.join(directory, "direct.rec"), hwc,
                             lab, lengths)
    same = filecmp.cmp(converted, direct, shallow=False)
    check(same, "lmdb_to_records differs from write_records of the same "
          "HWC arrays")
    return {"datums": n, "shape": list(hwc.shape[1:]),
            "env_bytes": os.path.getsize(env),
            "record_bytes": os.path.getsize(converted),
            "write_and_convert_s": took, "byte_equal": same}


def records(torch, HK, card, device="cuda", layers=None, sets=None,
            hw=RECORDS_HW, synthetic=None):
    """The ImageNet sample trained from a record file at full AlexNet
    width (the records branch of ``make_loader``), with prefetch off and
    on; the host ms split, the unit loop's busy share; card vs CPU at
    minibatch 16 with two planted loader faults; the LMDB leg."""
    import shutil
    import tempfile
    from veles_tpu_torch import native, prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.loader import records as R
    from veles_tpu_torch.samples import imagenet
    began = time.monotonic()
    sets = sets or RECORDS_SETS
    check(native.available(), "the native dataio library is not live: %s"
          % native.build_error())
    directory = tempfile.mkdtemp(prefix="veles_records_")
    try:
        t0 = time.monotonic()
        full = write_record_set(directory, "full", *sets["full"], hw=hw)
        small = write_record_set(directory, "small", *sets["small"], hw=hw,
                                 seed=SEED + 1)
        write_s = time.monotonic() - t0
        runs, wfs = {}, {}
        for prefetch in (False, True):
            wfs[prefetch], runs[prefetch] = records_run(
                torch, HK, native, prng, root, imagenet, full, device,
                layers, prefetch)
        wf = wfs[False]
        ld, mb = wf.loader, wf.loader.max_minibatch_size
        steps = wf.fused_step.train_steps
        valid_mbs = 2 * -(-ld.class_lengths[1] // mb)
        minibatches = steps + valid_mbs
        check(steps == 2 * -(-ld.class_lengths[2] // mb),
              "%d train steps dispatched" % steps)
        n_lrn = sum(1 for f in wf.forwards if f.layer_type == "norm")
        n_drop = sum(1 for f in wf.forwards if f.layer_type == "dropout")
        n_params = sum(2 for f in wf.forwards if f.has_params)
        want = {"lrn_forward": n_lrn * (steps + valid_mbs),
                "lrn_backward": n_lrn * steps,
                "dropout": 2 * n_drop * steps,
                "fused_sgd_update": -(-n_params // HK.SGD_MAX_TENSORS)
                * steps}
        want_calls = {"gather_u8_to_f32": minibatches, "gather_f32": 0,
                      "subtract_mean": minibatches,
                      "gather_i32": minibatches}
        for prefetch, run in runs.items():
            got = {k: run["launches"][k] for k in want}
            check(got == want, "records (prefetch %s) launches %r, "
                  "expected %r" % (prefetch, got, want))
            check(run["native_calls"] == want_calls,
                  "records (prefetch %s) native calls %r, expected %r"
                  % (prefetch, run["native_calls"], want_calls))
            check(len(run["digests"]) == minibatches,
                  "%d minibatches read" % len(run["digests"]))
        check(runs[False]["digests"] == runs[True]["digests"],
              "the device minibatches differ with prefetch on and off")
        # the first device minibatch against numpy on the mapped file
        idx, first = runs[False]["first"]
        _, mapped, _ = R.open_records(full[0])
        want_x = (mapped[idx].astype(numpy.float32)
                  * numpy.float32(RECORDS_SCALE)
                  + numpy.float32(RECORDS_OFFSET)) - numpy.load(full[1])
        got_x = first.cpu().numpy()
        first_equal = bool(numpy.array_equal(got_x.view(numpy.int32),
                                             want_x.view(numpy.int32)))
        check(first_equal, "the first device minibatch is not numpy's "
              "u8 * scale + offset - mean bit for bit (max gap %g)"
              % float(numpy.abs(got_x - want_x).max()))
        for prefetch, w in wfs.items():
            losses = [m[s]["loss"] for m in w.decision.epoch_metrics
                      for s in ("validation", "train")]
            check(len(w.decision.epoch_metrics) == 2
                  and all(numpy.isfinite(v) for v in losses),
                  "records (prefetch %s) losses %r" % (prefetch, losses))
            check(all(numpy.isfinite(f.weights.mem).all()
                      for f in w.forwards if f.has_params),
                  "records (prefetch %s): non-finite weights" % prefetch)

        # the steady step's host split, then the unit loop (loader, fused
        # step, commit) with prefetch off and on: host ms and busy share
        split = host_split(torch, native, wf, device)
        loop = {}
        for prefetch, w in wfs.items():
            reset, step = unit_loop(torch, w, valid_mbs // 2)
            reset()
            loop_ms = median_ms(step)
            reset()
            busy, per_kernel = profile_steps(torch, step, 5)
            w.loader.stop()
            loop[prefetch] = {"step_ms": loop_ms,
                              "samples_per_s": mb / loop_ms * 1e3,
                              "device_busy_share": busy,
                              "card_us": sum(per_kernel.values())}

        # the same seed on the card and on the CPU at minibatch 16: 3
        # committed updates; then the faulty card runs
        def small_run(dev):
            return committed_weights(records_build(
                prng, root, imagenet, small, layers, epochs=1,
                minibatch_size=16), dev)

        on_card, on_cpu = small_run(device), small_run("cpu")
        # a seeded rerun of the small card run repeats bit for bit
        repeat = same_weights(on_card, small_run(device))
        under_pool = [any(g.layer_type == "max_pooling"
                          for g in wf.forwards[i + 1:])
                      for i, f in enumerate(wf.forwards) if f.has_params]
        limits = [ALEXNET_CONV_SHARE if u else ALEXNET_FC_SHARE
                  for u in under_pool]
        sound = weight_gaps(on_card, on_cpu)
        faults = {}
        for name in RECORDS_FAULTS:
            with records_fault(name):
                gaps = weight_gaps(small_run(device), on_cpu)
            faults[name] = {"abs": gaps["abs"], "share": gaps["share"]}
        lmdb = lmdb_leg(directory, full)
    finally:
        shutil.rmtree(directory)
    report = {
        "phase": "records", "card": card,
        "config": {"layers": "alexnet_layers()" if layers is None
                   else "given", "crop": 227, "minibatch": mb,
                   "image_hw": list(ld._data.shape[1:3]),
                   "n_classes": RECORDS_CLASSES,
                   "n_train": ld.class_lengths[2],
                   "n_valid": ld.class_lengths[1], "epochs": 2,
                   "fused": True, "record_bytes": int(ld._data.nbytes)},
        "write_s": write_s, "train_steps": steps,
        "validation_minibatches": valid_mbs,
        "native_calls": runs[False]["native_calls"],
        "first_minibatch_bit_equal": first_equal,
        "digests_equal_prefetch_on_off": True,
        "host_split_ms": split, "unit_loop": {
            "prefetch_off": loop[False], "prefetch_on": loop[True]},
        "synthetic": synthetic,
        "lmdb": lmdb,
        "card_vs_cpu": {"minibatch": 16,
                        "committed_updates": len(on_cpu) - 1,
                        "first_update_limits": limits,
                        "third_update_limit": ALEXNET_DRIFT_SHARE,
                        "card_rerun_bit_equal": repeat,
                        "sound": sound, "faults": faults}}
    for prefetch, run in runs.items():
        n_samples = 2 * (ld.class_lengths[1] + ld.class_lengths[2])
        report["prefetch_on" if prefetch else "prefetch_off"] = {
            "setup_s": run["setup_s"], "run_s": run["run_s"],
            "samples_per_s": n_samples / run["run_s"],
            "train_samples_per_s": steps * mb / run["run_s"],
            "launches": run["launches"],
            "losses": [{s: m[s]["loss"] for s in ("validation", "train")}
                       for m in wfs[prefetch].decision.epoch_metrics]}
    report["phase_s"] = time.monotonic() - began
    print(json.dumps(report), flush=True)
    check(repeat, "records: a seeded rerun on the card changed the weights")
    check(len(on_cpu) == 4, "%d committed updates, not 3"
          % (len(on_cpu) - 1))
    check(all(g <= lim for g, lim in zip(sound["share"][0], limits))
          and max(sound["share"][-1]) <= ALEXNET_DRIFT_SHARE,
          "card vs CPU records weight gaps beyond their limits: %r"
          % sound["share"])
    for name, gaps in faults.items():
        check(any(g > lim for g, lim in zip(gaps["share"][0], limits)),
              "the card-vs-CPU check passed the faulty run %r: %r"
              % (name, gaps["share"][0]))
    total = dict(runs[False]["launches"])
    for k, v in runs[True]["launches"].items():
        total[k] += v
    return total


def wine_phase(torch, HK, card, device="cuda"):
    """The wine sample (13 -> 8 tanh -> 3 softmax) through its own
    ``train`` at its defaults on the card: one fused-SGD launch a train
    step, the reference's validation bar."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import wine

    def seeded():
        prng.reset()
        prng.seed_all(SEED)
        root.__dict__.pop("wine", None)
        wine.default_config()
        return wine.train(device=None if device == "cuda" else device)

    HK.reset_launch_counts()
    t0 = time.monotonic()
    wf = seeded()
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = HK.launch_counts()
    steps = wf.fused_step.train_steps
    metrics = wf.decision.epoch_metrics
    val = metrics[-1]["validation"]
    # the whole seeded run again: bit-equal weights and epoch metrics
    again = seeded()
    repeat = same_metrics(again.decision.epoch_metrics, metrics) and all(
        numpy.array_equal(u.mem, v.mem) for a, b in zip(wf.forwards,
                                                        again.forwards)
        for u, v in ((a.weights, b.weights), (a.bias, b.bias)))
    report = {"phase": "wine", "card": card,
              "config": {"layers": "13-8tanh-3softmax", "minibatch":
                         wf.loader.max_minibatch_size,
                         "n_train": wf.loader.class_lengths[2],
                         "n_valid": wf.loader.class_lengths[1],
                         "epochs": len(metrics), "fused": True},
              "wall_s": wall_s, "train_steps": steps, "launches": launches,
              "validation_n_err": [m["validation"]["n_err"]
                                   for m in metrics],
              "max_n_err": WINE_MAX_N_ERR, "card_rerun_bit_equal": repeat}
    print(json.dumps(report), flush=True)
    check(repeat, "wine: a seeded rerun on the card changed the weights or "
          "the epoch metrics")
    check(steps > 0 and launches["fused_sgd_update"] == steps,
          "wine: %d fused_sgd_update launches for %d train steps"
          % (launches["fused_sgd_update"], steps))
    check(val["n_err"] <= WINE_MAX_N_ERR, "wine: validation n_err %d > %d"
          % (val["n_err"], WINE_MAX_N_ERR))
    return launches


# ----------------------------------------------------------------- lm_train
def lm_build(prng, root, char_lm, cfg):
    """A seeded char-LM sample workflow at ``cfg`` (loader, trainer,
    decision sections)."""
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("char_lm", None)
    root.char_lm.update(cfg)
    return char_lm.build()


def flat_params(tree, prefix=""):
    """{name: host copy} of a param tree's leaves."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in flat_params(tree[key], prefix + "/" + key).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, item in enumerate(tree)
                for k, v in flat_params(item, "%s/%d" % (prefix, i)).items()}
    return {prefix: tree.detach().to("cpu", copy=True).numpy()}


def lm_committed(prng, root, char_lm, device, cfg):
    """The char-LM sample run on ``device``: the params at set-up and
    after every Adam update."""
    wf = lm_build(prng, root, char_lm, cfg)
    wf.initialize(device=device)
    trainer = wf.trainer
    inner = trainer.run
    kept = [flat_params(trainer.params)]

    def run_and_keep():
        train = trainer.is_train_minibatch()
        inner()
        if train:
            kept.append(flat_params(trainer.params))

    trainer.run = run_and_keep
    wf.run()
    return kept


def lm_shares(card, cpu):
    """Per update (after the first, ...) the per-tensor gap
    ||card - CPU|| / ||CPU - initial||."""
    return [{name: float(numpy.linalg.norm(card[k][name] - cpu[k][name])
                         / max(numpy.linalg.norm(cpu[k][name]
                                                 - cpu[0][name]), 1e-30))
             for name in cpu[k]} for k in range(1, len(cpu))]


@contextlib.contextmanager
def lm_fault(HK, name):
    """Within the block, the flash backward runs ``name`` of
    ``LM_FAULTS``: both passes launched with causal=False, or given the
    sm_scale of head_dim / 2 (FlashAttention looks them up per call)."""
    inner = (HK.flash_attention_bwd_dkv, HK.flash_attention_bwd_dq)

    def planted(fn):
        def call(q, k, v, o, lse, do, causal=True, sm_scale=None, di=None):
            if name == "bwd_not_causal":
                return fn(q, k, v, o, lse, do, False, sm_scale, di=di)
            return fn(q, k, v, o, lse, do, causal,
                      float(1.0 / (q.shape[-1] / 2) ** 0.5), di=di)
        # the wrapper counts its launch under its module name, which now
        # names this function (the counts are not read in a faulty run)
        call.launches = 0
        return call

    HK.flash_attention_bwd_dkv, HK.flash_attention_bwd_dq = map(planted,
                                                                inner)
    try:
        yield
    finally:
        HK.flash_attention_bwd_dkv, HK.flash_attention_bwd_dq = inner


def lm_train(torch, HK, card, device="cuda", cfg=None, small=None,
             steady_steps=3):
    """The char-LM sample at the repo's full LM width through
    ``char_lm.train``'s build + initialize + run under the 'flash_pallas'
    backend, then a steady step under each backend, greedy sampling, and
    card vs CPU at 2 layers."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import attention as A
    from veles_tpu_torch.ops import transformer as T
    from veles_tpu_torch.samples import char_lm
    cfg, small = cfg or LM_TRAIN, small or LM_SMALL
    names = ("flash_attention_fwd", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")
    A.set_attention_backend("flash_pallas")
    try:
        t0 = time.monotonic()
        wf = lm_build(prng, root, char_lm, cfg)
        wf.initialize(device=device)
        torch.cuda.synchronize()
        setup_s = time.monotonic() - t0
        trainer, ld = wf.trainer, wf.loader
        inner, step_losses = trainer.run, []

        def run_and_keep():
            train = trainer.is_train_minibatch()
            inner()
            if train:
                step_losses.append(trainer.metrics["loss_sum"]
                                   / trainer.metrics["tokens"])

        trainer.run = run_and_keep
        HK.reset_launch_counts()
        t0 = time.monotonic()
        wf.run()
        torch.cuda.synchronize()
        run_s = time.monotonic() - t0
        launches = HK.launch_counts()
        trainer.run = inner
        mb = ld.max_minibatch_size
        steps, n_layers = trainer.time, trainer.n_layers
        valid_mbs = -(-ld.class_lengths[1] // mb)
        check(steps == -(-ld.class_lengths[2] // mb),
              "%d train steps dispatched" % steps)
        want = {names[0]: n_layers * (steps + valid_mbs),
                names[1]: n_layers * steps, names[2]: n_layers * steps}
        got = {k: launches[k] for k in names}
        check(got == want, "lm_train launches %r, expected %r" % (got, want))
        losses = [float(x) for x in torch.stack(step_losses).cpu()]
        metrics = wf.decision.epoch_metrics
        check(all(numpy.isfinite(losses)) and all(
            numpy.isfinite(m[s]["loss"]) for m in metrics
            for s in ("validation", "train")), "non-finite loss %r" % losses)
        check(numpy.mean(losses[-3:]) < numpy.mean(losses[:3]),
              "train loss did not fall: %r" % losses)

        # one steady train step under each backend: host clock over
        # ``steady_steps`` synchronous steps, then the profiler's busy share
        tokens = ld.original_data.devmem[:mb]
        mask = torch.ones(mb, device=device)

        def step():
            trainer._train(trainer.params, trainer.opt_state, tokens, mask,
                           trainer.time)
            torch.cuda.synchronize()

        steady = {}
        for backend in ("flash_pallas", "xla"):
            A.set_attention_backend(backend)
            step()
            t0 = time.monotonic()
            for _ in range(steady_steps):
                step()
            step_s = (time.monotonic() - t0) / steady_steps
            busy, per_kernel = profile_steps(torch, step, 2)
            top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
            steady[backend] = {
                "step_s": step_s, "tokens_per_s": mb * (ld.seq_len - 1)
                / step_s, "step_device_busy_share": busy,
                "step_card_us": sum(per_kernel.values()),
                "step_top_kernels_us": [[k[:80], v] for k, v in top],
                "step_flash_kernels_us": {
                    tag: sum(v for k, v in per_kernel.items() if tag in k)
                    for tag in ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                                "flash_bwd_dq_kernel")}}
        A.set_attention_backend("flash_pallas")

        # greedy sampling on the card (the prefill through kernel 7a), each
        # emitted token held against a teacher-forced pass of the plain path
        prompt = ld.original_data.mem[:2, :64]
        before = HK.flash_attention_fwd.launches
        out = char_lm.sample_tokens(wf, prompt, n_new=32)
        prefill_launches = HK.flash_attention_fwd.launches - before
        check(out.shape == (2, 96) and out.min() >= 0 and out.max() < 256
              and (out[:, :64] == prompt).all(), "malformed sample %r" % out)
        check(prefill_launches == n_layers, "sample prefill launched 7a %d "
              "times" % prefill_launches)
        A.set_attention_backend("xla")
        with torch.no_grad():
            logits = T.transformer_forward(
                trainer.params, torch.as_tensor(out, device=device),
                trainer.n_heads)[:, 63:95]
        emitted = torch.as_tensor(out[:, 64:], device=device).long()
        picked = logits.gather(-1, emitted[..., None])[..., 0]
        short = (logits.max(dim=-1).values - picked).max().item()
        exact = int((logits.argmax(dim=-1) == emitted).sum().item())
        check(short <= LOGIT_TOL, "a sampled token's logit sits %g below "
              "its row max (tolerance %g)" % (short, LOGIT_TOL))
        del wf, trainer, tokens, logits

        # card vs CPU at 2 layers, then the faulty card runs
        A.set_attention_backend("flash_pallas")
        on_card = lm_committed(prng, root, char_lm, device, small)
        # a seeded rerun on the card: bit-equal params after every update
        rerun = lm_committed(prng, root, char_lm, device, small)
        repeat = len(rerun) == len(on_card) and all(
            numpy.array_equal(a[k], b[k]) for a, b in zip(on_card, rerun)
            for k in a)
        on_cpu = lm_committed(prng, root, char_lm, "cpu", small)
        sound = lm_shares(on_card, on_cpu)
        faults = {}
        for name in LM_FAULTS:
            with lm_fault(HK, name):
                faults[name] = lm_shares(lm_committed(
                    prng, root, char_lm, device, small), on_cpu)
    finally:
        A.set_attention_backend("xla")

    def worst(shares):
        return [max(d.values()) for d in shares]

    report = {"phase": "lm_train", "card": card,
              "config": {"vocab": 256, "d_model": cfg["trainer"]["d_model"],
                         "n_heads": cfg["trainer"]["n_heads"],
                         "n_layers": n_layers, "seq": ld.seq_len - 1,
                         "minibatch": mb, "n_train": ld.class_lengths[2],
                         "n_valid": ld.class_lengths[1], "epochs": 1,
                         "backend": "flash_pallas"},
              "setup_s": setup_s, "run_s": run_s, "train_steps": steps,
              "validation_minibatches": valid_mbs, "launches": launches,
              "train_step_losses": losses,
              "validation_loss": metrics[0]["validation"]["loss"],
              "steady": steady,
              "sample": {"prompts": 2, "prompt_len": 64, "new": 32,
                         "prefill_launches": prefill_launches,
                         "teacher_forced_worst_shortfall": short,
                         "exact_argmax": exact, "tolerance": LOGIT_TOL},
              "card_vs_cpu": {
                  "config": small, "limits": [LM_FIRST_SHARE,
                                              LM_THIRD_SHARE],
                  "card_rerun_bit_equal": repeat,
                  "sound_worst": worst(sound), "sound": sound,
                  "faults_worst": {k: worst(v) for k, v in faults.items()},
                  "faults_first": {k: v[0] for k, v in faults.items()}}}
    print(json.dumps(report), flush=True)
    check(repeat, "lm_train: a seeded rerun on the card changed the params")
    check(len(sound) == 3, "%d committed updates, not 3" % len(sound))
    check(worst(sound)[0] <= LM_FIRST_SHARE
          and worst(sound)[-1] <= LM_THIRD_SHARE,
          "card vs CPU LM weight gaps beyond their limits: %r"
          % worst(sound))
    for name, shares in faults.items():
        check(worst(shares)[0] > LM_FIRST_SHARE, "the card-vs-CPU check "
              "passed the faulty run %r: %r" % (name, worst(shares)))
    return launches


# ------------------------------------------------------------------ the zoo
@contextlib.contextmanager
def update_sizes(F):
    """Within the block, the number of tensors each fused update call
    (``F.sgd_update_multi``, one kernel launch on the card) takes."""
    inner, sizes = F.sgd_update_multi, []

    def counted(items):
        sizes.append(len(items))
        return inner(items)

    F.sgd_update_multi = counted
    try:
        yield sizes
    finally:
        F.sgd_update_multi = inner


@contextlib.contextmanager
def strict_relu_ties(F):
    """Within the block, the number of exact z == 0 ties each strict-ReLU
    conv backward meets (its ``tie`` mask, the 8th argument)."""
    inner, ties = F.conv2d_backward, []

    def counted(*args):
        if len(args) > 7 and args[7] is not None:
            ties.append(int(args[7].sum()))
        return inner(*args)

    F.conv2d_backward = counted
    try:
        yield ties
    finally:
        F.conv2d_backward = inner


@contextlib.contextmanager
def zoo_fault(name):
    """Within the block, ``name`` of ``ZOO_FAULTS`` is planted (the units
    look the patched functions up per call)."""
    from veles_tpu_torch.ops import functional as F
    from veles_tpu_torch.ops.residual import Residual, ResidualProjection
    owner, attr, inner = F, "conv2d_backward", F.conv2d_backward
    if name == "conv_wgrad_flipped":
        def planted(*args, **kwargs):
            err_in, grad_w, grad_b = inner(*args, **kwargs)
            return err_in, grad_w.flip((0, 1)), grad_b
    elif name == "skip_unstashed":
        owner, attr = Residual, "chain_backward"
        inner = owner.chain_backward

        def planted(self, *args, **kwargs):
            err, src, d_src, grads = inner(self, *args, **kwargs)
            return err, src, d_src * 0.0, grads
    else:
        owner, attr = ResidualProjection, "chain_backward"
        inner = owner.chain_backward

        def planted(self, *args, **kwargs):
            err, src, d_src, (d_w, d_b) = inner(self, *args, **kwargs)
            return err, src, d_src, (d_w * 0.0, d_b)
    setattr(owner, attr, planted)
    try:
        yield
    finally:
        setattr(owner, attr, inner)


def zoo_build(prng, root, module, name, **loader):
    """A seeded workflow of the sample ``module`` at its default config
    (``loader`` overrides; ``epochs`` its max_epochs, default 1)."""
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop(name, None)
    module.default_config()
    epochs = loader.pop("epochs", 1)
    return module.build(fused=True, loader=loader,
                        decision={"max_epochs": epochs})


def zoo(torch, HK, card, name, device="cuda", small=None, **loader):
    """The conv-zoo sample ``name`` through its own ``train`` at its
    default config on the card (2 epochs; ``loader`` overrides only for
    a rehearsal), then, where ``ZOO_FAULTS`` or the AE ask for it, card
    vs CPU at minibatch 100 after the first and third committed update
    and the faulty card runs."""
    import importlib
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import functional as F
    module = importlib.import_module("veles_tpu_torch.samples." + name)
    began = time.monotonic()
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop(name, None)
    module.default_config()
    HK.reset_launch_counts()
    t0 = time.monotonic()
    with update_sizes(F) as sizes:
        wf = module.train(device=None if device == "cuda" else device,
                          loader=loader, decision={"max_epochs": 2})
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = HK.launch_counts()
    run_s = sum(u.run_time for u in wf.units)
    metrics = wf.decision.epoch_metrics
    check(len(metrics) == 2, "%s: %d epochs ran, not 2"
          % (name, len(metrics)))
    ld, mse = wf.loader, wf.loss_function == "mse"
    val = [m["validation"] for m in metrics]
    key = "rmse" if mse else "loss"
    falls = [v[key] for v in val]
    check(all(numpy.isfinite(falls)) and falls[1] < falls[0],
          "%s: validation %s did not fall: %r" % (name, key, falls))
    if not mse:
        check(val[1]["err_pct"] <= val[0]["err_pct"],
              "%s: validation error rose: %r"
              % (name, [v["err_pct"] for v in val]))
    if name == "cifar":
        check(val[-1]["err_pct"] < CIFAR_MAX_ERR_PCT,
              "cifar: validation err_pct %g >= %g"
              % (val[-1]["err_pct"], CIFAR_MAX_ERR_PCT))
    steps = wf.fused_step.train_steps
    n_tensors = sum(1 + bool(f.include_bias) for f in wf.forwards
                    if f.has_params)
    check(steps == 2 * -(-ld.class_lengths[2] // ld.max_minibatch_size),
          "%s: %d train steps dispatched" % (name, steps))
    check(launches["fused_sgd_update"] == steps == len(sizes)
          and set(sizes) == {n_tensors} and n_tensors == ZOO[name],
          "%s: %d fused_sgd_update launches, %d update calls of %r tensors "
          "for %d train steps (%d tensors, expected %d)"
          % (name, launches["fused_sgd_update"], len(sizes), sorted(
              set(sizes)), steps, n_tensors, ZOO[name]))
    check(all(numpy.isfinite(f.weights.mem).all() for f in wf.forwards
              if f.has_params), "%s: non-finite weights" % name)

    # two steady train steps: host clock and the card's busy share
    runner, mb = wf._fused_runner, ld.max_minibatch_size
    x = ld.original_data.devmem[:mb]
    y = x if mse else ld.original_labels.devmem[:mb]
    mask = torch.ones(mb, device=x.device)

    def step():
        runner._train_step(runner.state, x, y, mask, mb)
        torch.cuda.synchronize()

    step()
    t0 = time.monotonic()
    for _ in range(5):
        step()
    step_s = (time.monotonic() - t0) / 5
    busy, per_kernel = profile_steps(torch, step, 2)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    report = {"phase": name, "card": card,
              "config": {"layers": [f.layer_type for f in wf.forwards],
                         "minibatch": mb, "n_train": ld.class_lengths[2],
                         "n_valid": ld.class_lengths[1], "epochs": 2,
                         "fused": True},
              "wall_s": wall_s, "run_s": run_s, "setup_s": wall_s - run_s,
              "s_per_epoch": run_s / 2,
              "train_samples_per_s": 2 * ld.class_lengths[2] / run_s,
              "train_steps": steps, "launches": launches,
              "update_tensors": n_tensors, "s_per_step": step_s,
              "step_samples_per_s": mb / step_s,
              "step_device_busy_share": busy,
              "step_card_us": sum(per_kernel.values()),
              "step_top_kernels_us": [[k[:80], v] for k, v in top],
              "validation": [{k: x for k, x in v.items()
                              if isinstance(x, (int, float))} for v in val]}
    small = dict(small or ZOO_SMALL)

    def small_run(dev):
        return committed_weights(zoo_build(prng, root, module, name,
                                           **small), dev)

    with strict_relu_ties(F) as ties:
        on_card = small_run(device)
    # a seeded rerun on the card repeats bit for bit (cuDNN's
    # deterministic algorithms, which every precision mode pins)
    repeat = same_weights(on_card, small_run(device))
    if name == "mnist_conv":
        report["card_rerun"] = {"committed_updates": len(on_card) - 1,
                                "bit_equal": repeat}
        report["phase_s"] = time.monotonic() - began
        print(json.dumps(report), flush=True)
        check(repeat, "%s: a seeded rerun on the card changed the weights"
              % name)
        return launches

    # the same seed on the CPU at minibatch 100 (3 committed updates);
    # then the faulty card runs
    on_cpu = small_run("cpu")
    sound = weight_gaps(on_card, on_cpu)
    faults = {}
    for fault in ZOO_FAULTS.get(name, ()):
        with zoo_fault(fault):
            gaps = weight_gaps(small_run(device), on_cpu)
        faults[fault] = {"abs": gaps["abs"], "share": gaps["share"]}
    report["card_vs_cpu"] = {
        "minibatch": mb, "committed_updates": len(on_cpu) - 1,
        "layers": [f.layer_type for f in wf.forwards if f.has_params],
        "first_update_limit": ZOO_FIRST_SHARE,
        "third_update_limit": ZOO_THIRD_SHARE,
        "strict_relu_ties": sum(ties), "card_rerun_bit_equal": repeat,
        "sound": sound, "faults": faults}
    report["phase_s"] = time.monotonic() - began
    print(json.dumps(report), flush=True)
    check(repeat, "%s: a seeded rerun on the card changed the weights"
          % name)
    check(len(on_cpu) == 4, "%s: %d committed updates, not 3"
          % (name, len(on_cpu) - 1))
    check(max(sound["share"][0]) <= ZOO_FIRST_SHARE
          and max(sound["share"][-1]) <= ZOO_THIRD_SHARE,
          "%s: card vs CPU weight gaps beyond their limits: %r"
          % (name, sound["share"]))
    for fault, gaps in faults.items():
        check(max(gaps["share"][0]) > ZOO_FIRST_SHARE,
              "%s: the card-vs-CPU check passed the faulty run %r: %r"
              % (name, fault, gaps["share"][0]))
    return launches


def deconv_check(torch, F, card, device="cuda"):
    """The transposed conv and its backward at stride 2, k 5 (the AE
    mirror of a 28 -> 14 conv), SAME and int padding, on the card against
    the CPU on the same inputs (checked, not timed)."""
    F.pin_fp32_matmul()
    rs = numpy.random.RandomState(SEED)
    x = rs.randn(100, 14, 14, 16).astype(numpy.float32)
    w = (0.1 * rs.randn(5, 5, 16, 8)).astype(numpy.float32)
    b = rs.randn(8).astype(numpy.float32)
    g = rs.randn(100, 28, 28, 8).astype(numpy.float32)
    out = []
    for padding, extra in (("SAME", 0), (2, 1)):
        runs = []
        for dev in (device, "cpu"):
            xt, wt, bt, gt = (torch.as_tensor(a, device=dev)
                              for a in (x, w, b, g))
            y = F.deconv2d_forward(xt, wt, bt, (2, 2), padding, "tanh",
                                   extra)
            runs.append([t.cpu().numpy() for t in (y,) + tuple(
                F.deconv2d_backward(xt, y, gt, wt, (2, 2), padding, "tanh",
                                    extra))])
        shares = [float(numpy.abs(a - b_).max() / numpy.abs(b_).max())
                  for a, b_ in zip(*runs)]
        out.append({"padding": padding, "output_padding": extra,
                    "shape": list(runs[0][0].shape),
                    "shares_y_dx_dw_db": shares})
        check(runs[0][0].shape == (100, 28, 28, 8)
              and max(shares) <= DECONV_SHARE,
              "deconv card vs CPU at padding %r: shares %r"
              % (padding, shares))
    report = {"phase": "deconv_check", "card": card, "limit": DECONV_SHARE,
              "cases": out}
    print(json.dumps(report), flush=True)


# ------------------------------------------------- the non-SGD trainers
def shares(card, cpu):
    """Per update (after the first, ...) the worst tensor's gap as a
    share of its movement (``weight_gaps``, one tensor a "layer")."""
    return [max(s) for s in weight_gaps(card, cpu)["share"]]


def trainer_committed(wf, device, keys):
    """Initialize ``wf`` on ``device`` and run it; returns its trainer's
    ``keys`` tensors on the host, each as a one-tensor layer, at set-up
    and after every train step (``committed_weights``' layout)."""
    wf.initialize(device=device)
    trainer = wf.trainer
    inner = trainer.run

    def grab():
        return [[getattr(trainer, k).mem.copy()] for k in keys]

    def run_and_keep():
        train = trainer.is_train_minibatch()
        inner()
        if train:
            kept.append(grab())

    kept = [grab()]
    trainer.run = run_and_keep
    wf.run()
    return kept


def steady_steps(torch, step, n=5):
    """Host ms of one synchronous ``step`` (median of ``n``) and the
    card's busy share over two more."""
    step()
    times = []
    for _ in range(n):
        t0 = time.monotonic()
        step()
        times.append((time.monotonic() - t0) * 1e3)
    busy, per_kernel = profile_steps(torch, step, 2)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"host_ms": statistics.median(times),
            "device_busy_share": busy,
            "card_us": sum(per_kernel.values()),
            "top_kernels_us": [[k[:80], v] for k, v in top]}


@contextlib.contextmanager
def som_fault(F):
    """Within the block, the SOM's neighbourhood divides by 2σ, not 2σ²:
    the trainer's σ is handed to ``kohonen_update`` as √σ."""
    inner = F.kohonen_update

    def planted(weights, x, mask, grid, learning_rate, sigma):
        return inner(weights, x, mask, grid, learning_rate, sigma ** 0.5)

    F.kohonen_update = planted
    try:
        yield
    finally:
        F.kohonen_update = inner


def kohonen_phase(torch, HK, card, device="cuda", **loader):
    """The Kohonen SOM sample through ``kohonen.train`` at its defaults
    (8x8 map, 2,000 points, minibatch 100, 10 epochs), a seeded rerun,
    the steady step, card vs CPU after the first and third update and a
    planted fault.  Returns the trained workflow (the streams phase
    feeds its points back)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import functional as F
    from veles_tpu_torch.samples import kohonen
    began = time.monotonic()

    def seeded(**overrides):
        prng.reset()
        prng.seed_all(SEED)
        root.__dict__.pop("kohonen", None)
        kohonen.default_config()
        return kohonen.build(loader=dict(loader, **overrides.pop(
            "loader", {})), **overrides)

    def train(dev):
        wf = seeded()
        wf.initialize(device=None if dev == "cuda" else dev)
        wf.run()
        return wf

    HK.reset_launch_counts()
    t0 = time.monotonic()
    wf = train(device)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = HK.launch_counts()
    run_s = sum(u.run_time for u in wf.units)
    ld, trainer = wf.loader, wf.trainer
    mb, n = ld.max_minibatch_size, ld.class_lengths[2]
    qerr = [m["train"]["qerr"] for m in wf.decision.epoch_metrics]
    epochs, updates = len(qerr), trainer.time
    hits = wf.forward.hits
    again = train(device)
    repeat = (numpy.array_equal(again.trainer.weights.mem,
                                trainer.weights.mem)
              and [m["train"]["qerr"] for m in again.decision.epoch_metrics]
              == qerr and numpy.array_equal(again.forward.hits, hits))
    steady = steady_steps(torch, lambda: (trainer.run(),
                                          torch.cuda.synchronize()))

    # card vs CPU: 3 updates at minibatch 100, then the planted fault
    def small(dev):
        return trainer_committed(seeded(loader={"n_train": 3 * mb},
                                        decision={"max_epochs": 1}),
                                 dev, ("weights",))

    on_card, on_cpu = small(device), small("cpu")
    sound = shares(on_card, on_cpu)
    with som_fault(F):
        fault = shares(small(device), on_cpu)
    report = {"phase": "kohonen", "card": card,
              "config": {"shape": list(trainer.shape), "n_train": n,
                         "minibatch": mb, "epochs": epochs,
                         "decay_steps": trainer.decay_steps},
              "wall_s": wall_s, "run_s": run_s, "setup_s": wall_s - run_s,
              "s_per_epoch": run_s / epochs,
              "train_samples_per_s": epochs * n / run_s,
              "updates": updates, "launches": launches, "qerr": qerr,
              "neurons_hit": int((hits > 0).sum()),
              "hits_total": int(hits.sum()), "steady_step": steady,
              "card_rerun_bit_equal": repeat,
              "card_vs_cpu": {"updates": len(on_cpu) - 1,
                              "limits": [SOM_FIRST_SHARE, SOM_THIRD_SHARE],
                              "sound": sound,
                              "faults": {"sigma_not_squared": fault}},
              "phase_s": time.monotonic() - began}
    print(json.dumps(report), flush=True)
    check(epochs == 10 and qerr[-1] < qerr[0],
          "kohonen: qerr over %d epochs did not fall: %r" % (epochs, qerr))
    check(updates == epochs * -(-n // mb) == 200,
          "kohonen: %d updates" % updates)
    check((hits > 0).sum() >= KOHONEN_MIN_NEURONS and hits.sum() == mb,
          "kohonen: wins %r" % hits.tolist())
    check(not any(launches.values()), "kohonen launched kernels: %r"
          % launches)
    check(repeat, "kohonen: a seeded rerun on the card changed the codebook")
    check(len(sound) == 3 and sound[0] <= SOM_FIRST_SHARE
          and sound[-1] <= SOM_THIRD_SHARE,
          "kohonen: card vs CPU codebook gaps %r" % sound)
    check(fault[0] > SOM_FIRST_SHARE, "kohonen: the card-vs-CPU check "
          "passed the faulty neighbourhood: %r" % fault)
    return wf


@contextlib.contextmanager
def recorded_draws(F):
    """Within the block, every Bernoulli draw's output, on the host, in
    order (the RBM looks ``F.bernoulli`` up per call; the kernel's
    wrapper below it still counts its launches)."""
    inner, draws = F.bernoulli, []

    def recording(key, p):
        out = inner(key, p)
        draws.append(out.cpu().numpy())
        return out

    F.bernoulli = recording
    try:
        yield draws
    finally:
        F.bernoulli = inner


@contextlib.contextmanager
def rbm_fault(F):
    """Within the block, every Gibbs step draws with the step key itself,
    not ``fold_in(key, i)``."""
    inner_step = F.rbm_cd_step

    def planted(weights, vbias, hbias, v0, mask, rng, *args):
        draw = F.bernoulli
        F.bernoulli = lambda key, p: draw(rng, p)
        try:
            return inner_step(weights, vbias, hbias, v0, mask, rng, *args)
        finally:
            F.bernoulli = draw

    F.rbm_cd_step = planted
    try:
        yield
    finally:
        F.rbm_cd_step = inner_step


def rbm_phase(torch, HK, card, device="cuda", **loader):
    """The MNIST-RBM sample through ``mnist_rbm.train`` at its default
    widths (784 -> 256, 60,000 synthetic samples, minibatch 100, cd_k 1)
    for ``RBM_EPOCHS`` epochs: falling reconstruction error, 1 + cd_k
    Bernoulli launches a train step; the steady step; then small runs:
    a seeded rerun, card vs CPU after the first and third update with
    the flipped hidden samples counted, and a planted fault."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import functional as F
    from veles_tpu_torch.samples import mnist_rbm
    began = time.monotonic()

    def seeded(**overrides):
        prng.reset()
        prng.seed_all(SEED)
        root.__dict__.pop("mnist_rbm", None)
        mnist_rbm.default_config()
        return mnist_rbm.build(loader=dict(loader, **overrides.pop(
            "loader", {})), **overrides)

    wf = seeded(decision={"max_epochs": RBM_EPOCHS})
    t0 = time.monotonic()
    wf.initialize(device=None if device == "cuda" else device)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    HK.reset_launch_counts()
    t0 = time.monotonic()
    wf.run()
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    launches = HK.launch_counts()
    ld, trainer = wf.loader, wf.trainer
    mb, n = ld.max_minibatch_size, ld.class_lengths[2]
    errs = [m["train"]["recon_err"] for m in wf.decision.epoch_metrics]
    steps, draws_per_step = trainer.time, 1 + trainer.cd_k
    params = [getattr(trainer, k).mem for k in ("weights", "vbias", "hbias")]
    steady = steady_steps(torch, lambda: (trainer.run(),
                                          torch.cuda.synchronize()))

    # small runs: 3 train minibatches and one validation minibatch
    keys = ("weights", "vbias", "hbias")

    def small(dev):
        before = HK.launch_counts()["bernoulli"]
        with recorded_draws(F) as draws:
            kept = trainer_committed(
                seeded(loader=dict(RBM_SMALL, minibatch_size=mb),
                       decision={"max_epochs": 1}), dev, keys)
        return kept, draws, HK.launch_counts()["bernoulli"] - before

    on_card, card_draws, small_launches = small(device)
    rerun, rerun_draws, _ = small(device)
    repeat = same_weights(on_card, rerun) and all(
        numpy.array_equal(a, b) for a, b in zip(card_draws, rerun_draws))
    on_cpu, cpu_draws, _ = small("cpu")
    sound = shares(on_card, on_cpu)
    binarize_equal = all(numpy.array_equal(card_draws[i], cpu_draws[i])
                         for i in range(0, len(cpu_draws), draws_per_step))
    flips = [int((card_draws[i] != cpu_draws[i]).sum())
             for i in range(len(cpu_draws)) if i % draws_per_step]
    with rbm_fault(F):
        fault_run, _, _ = small(device)
    fault = shares(fault_run, on_cpu)
    report = {"phase": "mnist_rbm", "card": card,
              "config": {"n_visible": params[0].shape[0],
                         "n_hidden": trainer.n_hidden, "n_train": n,
                         "n_valid": ld.class_lengths[1], "minibatch": mb,
                         "cd_k": trainer.cd_k, "epochs": len(errs)},
              "setup_s": setup_s, "run_s": run_s,
              "s_per_epoch": run_s / len(errs),
              "train_samples_per_s": len(errs) * n / run_s,
              "updates": steps, "launches": launches,
              "recon_err": errs, "steady_step": steady,
              "card_rerun_bit_equal": repeat,
              "card_vs_cpu": {
                  "config": RBM_SMALL, "updates": len(on_cpu) - 1,
                  "bernoulli_launches": small_launches,
                  "limits": [RBM_FIRST_SHARE, RBM_THIRD_SHARE],
                  "sound": sound, "binarize_draws_equal": binarize_equal,
                  "hidden_draws": int(sum(d.size for i, d in
                                          enumerate(cpu_draws)
                                          if i % draws_per_step)),
                  "hidden_flips": flips,
                  "faults": {"gibbs_key_not_folded": fault}},
              "phase_s": time.monotonic() - began}
    print(json.dumps(report), flush=True)
    check(len(errs) == RBM_EPOCHS and errs[-1] < errs[0],
          "mnist_rbm: recon_err did not fall: %r" % errs)
    check(steps == RBM_EPOCHS * -(-n // mb) == 1200,
          "mnist_rbm: %d train steps" % steps)
    check(launches["bernoulli"] == draws_per_step * steps,
          "mnist_rbm: %d bernoulli launches for %d train steps"
          % (launches["bernoulli"], steps))
    check(all(numpy.isfinite(p).all() for p in params),
          "mnist_rbm: non-finite parameters")
    check(small_launches == draws_per_step * (len(on_card) - 1) == 6,
          "mnist_rbm: %d bernoulli launches in 3 train steps and one "
          "validation minibatch" % small_launches)
    check(repeat, "mnist_rbm: a seeded rerun on the card changed the "
          "parameters or the draws")
    check(binarize_equal, "mnist_rbm: the visible draws differ card vs CPU")
    check(len(sound) == 3 and sound[0] <= RBM_FIRST_SHARE
          and sound[-1] <= RBM_THIRD_SHARE,
          "mnist_rbm: card vs CPU parameter gaps %r" % sound)
    check(fault[0] > RBM_FIRST_SHARE, "mnist_rbm: the card-vs-CPU check "
          "passed the unfolded Gibbs key: %r" % fault)
    return launches


def sgd_sample_phase(torch, HK, card, name, device="cuda", **loader):
    """``lines`` or ``video_ae`` through its own ``train`` at its
    defaults (10 epochs): the sample's bar, one fused-SGD launch a train
    step covering every parameter, the whole seeded run repeated bit for
    bit, and the steady step."""
    import importlib
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import functional as F
    module = importlib.import_module("veles_tpu_torch.samples." + name)
    began = time.monotonic()

    def seeded():
        prng.reset()
        prng.seed_all(SEED)
        root.__dict__.pop(name, None)
        module.default_config()
        return module.train(device=None if device == "cuda" else device,
                            loader=loader)

    HK.reset_launch_counts()
    t0 = time.monotonic()
    with update_sizes(F) as sizes:
        wf = seeded()
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = HK.launch_counts()
    run_s = sum(u.run_time for u in wf.units)
    ld, mse = wf.loader, wf.loss_function == "mse"
    mb, n = ld.max_minibatch_size, ld.class_lengths[2]
    metrics = wf.decision.epoch_metrics
    val = [{k: x for k, x in m["validation"].items()
            if isinstance(x, (int, float))} for m in metrics]
    steps = wf.fused_step.train_steps
    n_tensors = sum(1 + bool(f.include_bias) for f in wf.forwards
                    if f.has_params)
    weights = [f.weights.mem.copy() for f in wf.forwards if f.has_params]
    again = seeded()
    repeat = same_metrics(again.decision.epoch_metrics, metrics) and all(
        numpy.array_equal(a, f.weights.mem) for a, f in zip(
            weights, [f for f in again.forwards if f.has_params]))
    runner = wf._fused_runner
    x = ld.original_data.devmem[:mb]
    y = x if mse else ld.original_labels.devmem[:mb]
    mask = torch.ones(mb, device=x.device)
    steady = steady_steps(torch, lambda: (
        runner._train_step(runner.state, x, y, mask, mb),
        torch.cuda.synchronize()))
    report = {"phase": name, "card": card,
              "config": {"layers": [f.layer_type for f in wf.forwards],
                         "minibatch": mb, "n_train": n,
                         "n_valid": ld.class_lengths[1],
                         "epochs": len(metrics), "fused": True},
              "wall_s": wall_s, "run_s": run_s, "setup_s": wall_s - run_s,
              "s_per_epoch": run_s / len(metrics),
              "train_samples_per_s": len(metrics) * n / run_s,
              "train_steps": steps, "launches": launches,
              "update_tensors": n_tensors, "steady_step": steady,
              "validation": val, "card_rerun_bit_equal": repeat,
              "phase_s": time.monotonic() - began}
    print(json.dumps(report), flush=True)
    check(len(metrics) == 10, "%s: %d epochs" % (name, len(metrics)))
    if mse:
        losses = [v["loss"] for v in val]
        check(all(numpy.isfinite(losses)) and losses[-1] < losses[0],
              "%s: validation loss %r" % (name, losses))
    else:
        check(val[-1]["err_pct"] < LINES_MAX_ERR_PCT,
              "%s: validation err_pct %g >= %g"
              % (name, val[-1]["err_pct"], LINES_MAX_ERR_PCT))
    check(steps == len(metrics) * -(-n // mb)
          and launches["fused_sgd_update"] == steps == len(sizes)
          and set(sizes) == {n_tensors},
          "%s: %d fused_sgd_update launches, %d update calls of %r tensors "
          "for %d train steps" % (name, launches["fused_sgd_update"],
                                  len(sizes), sorted(set(sizes)), steps))
    check(repeat, "%s: a seeded rerun on the card changed the weights or "
          "the epoch metrics" % name)
    return launches


def rbm_replay(path, trainer_config, epochs=1):
    """An RBM cycle whose loader replays the capture at ``path``:
    Repeater -> MinibatchesLoader -> RBMTrainer -> RBMDecision."""
    from veles_tpu_torch.loader.saver import MinibatchesLoader
    from veles_tpu_torch.ops.nn_units import NNWorkflow
    from veles_tpu_torch.ops.rbm import RBMDecision, RBMTrainer
    from veles_tpu_torch.workflow import Repeater
    wf = NNWorkflow(None, name="replay")
    wf.repeater = Repeater(wf, name="repeater")
    wf.repeater.link_from(wf.start_point)
    wf.loader = MinibatchesLoader(wf, path=path, name="loader")
    wf.loader.link_from(wf.repeater)
    wf.trainer = RBMTrainer(wf, name="trainer", **trainer_config)
    wf.trainer.link_from(wf.loader)
    wf.trainer.link_attrs(wf.loader, ("input", "minibatch_data"),
                          ("mask", "minibatch_mask"), "minibatch_class")
    wf.decision = RBMDecision(wf, name="decision", max_epochs=epochs)
    wf.decision.link_from(wf.trainer)
    wf.decision.link_attrs(wf.loader, "minibatch_class", "minibatch_size",
                           "last_minibatch", "class_lengths", "epoch_number")
    wf.decision.link_attrs(wf.trainer, "metrics")
    wf.repeater.link_from(wf.decision)
    wf.end_point.link_from(wf.decision)
    wf.end_point.gate_block = ~wf.decision.complete
    return wf


def streams_phase(torch, card, som, device="cuda"):
    """The first train epoch of a small MNIST-RBM captured on the card
    with ``MinibatchesSaver`` and replayed through ``MinibatchesLoader``
    into a fresh RBM (bit-equal parameters); the trained SOM's points
    fed through ``InteractiveLoader`` into a ``KohonenForward`` (winners
    equal to a direct pass over the same rows)."""
    import shutil
    import tempfile
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.loader.interactive import InteractiveLoader
    from veles_tpu_torch.loader.saver import MinibatchesSaver
    from veles_tpu_torch.ops import functional as F
    from veles_tpu_torch.ops.kohonen import KohonenForward
    from veles_tpu_torch.samples import mnist_rbm
    began = time.monotonic()
    dev = None if device == "cuda" else device
    keys = ("weights", "vbias", "hbias")
    directory = tempfile.mkdtemp(prefix="veles_stream_")
    try:
        path = directory + "/capture.pickle"
        prng.reset()
        prng.seed_all(SEED)
        root.__dict__.pop("mnist_rbm", None)
        mnist_rbm.default_config()
        wf = mnist_rbm.build(loader=STREAM_RBM, decision={"max_epochs": 1})
        MinibatchesSaver.attach_to(wf.loader, path)
        wf.initialize(device=dev)
        wf.run()
        direct = [getattr(wf.trainer, k).mem for k in keys]
        captured = wf.loader.epoch_number, wf.trainer.time
        capture_bytes = len(open(path, "rb").read())
        prng.reset()
        prng.seed_all(SEED)
        replay = rbm_replay(path, {k: getattr(wf.trainer, k) for k in (
            "n_hidden", "learning_rate", "cd_k")})
        replay.initialize(device=dev)
        replay.run()
        replayed = [getattr(replay.trainer, k).mem for k in keys]
        replay_equal = all(numpy.array_equal(a, b)
                           for a, b in zip(direct, replayed))
        replay_steps = replay.trainer.time
        replay.loader.stop()
    finally:
        shutil.rmtree(directory)

    # the SOM's points through the interactive loader
    points = som.loader.original_data.mem
    weights = som.trainer.weights
    mb = som.loader.max_minibatch_size
    feed = InteractiveLoader(None, sample_shape=points.shape[1:],
                             minibatch_size=mb)
    fwd = KohonenForward(None)
    fwd.link_attrs(feed, ("input", "minibatch_data"),
                   ("mask", "minibatch_mask"))
    fwd.weights = weights
    feed.initialize(device=weights.devmem.device)
    fwd.initialize(device=weights.devmem.device)
    feed.feed(points)
    same, rows = True, 0
    for at in range(0, len(points), mb):
        feed.run()
        fwd.run()
        live = feed.minibatch_size
        direct_win, _ = F.kohonen_winners(
            torch.as_tensor(points[at:at + mb], device=weights.devmem.device),
            weights.devmem)
        same = same and numpy.array_equal(fwd.output.mem[:live],
                                          direct_win.cpu().numpy()[:live])
        rows += live
    report = {"phase": "streams", "card": card,
              "capture": {"config": STREAM_RBM, "minibatches": captured[1],
                          "bytes": capture_bytes,
                          "replay_steps": replay_steps,
                          "replay_bit_equal": replay_equal},
              "interactive": {"points": rows, "minibatch": mb,
                              "winners_equal_direct": same,
                              "hits_total": int(fwd.hits.sum())},
              "phase_s": time.monotonic() - began}
    print(json.dumps(report), flush=True)
    check(captured == (1, 5) and replay_steps == 5,
          "streams: %r epochs/steps captured, %d replayed"
          % (captured, replay_steps))
    check(replay_equal, "streams: the replayed RBM differs from the direct "
          "run")
    check(rows == len(points) and same and fwd.hits.sum() == len(points),
          "streams: the interactive SOM forward differs from a direct pass")


def main():
    started = time.monotonic()
    import torch
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device", file=sys.stderr)
        return 2
    from veles_tpu_torch.ops import _build
    from veles_tpu_torch.ops import attention as A
    from veles_tpu_torch.ops import hopper_kernels as HK
    from veles_tpu_torch.ops import transformer as T
    from veles_tpu_torch import native, prng, serving as S

    # 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print("device: %s (count %d) | nvidia-smi: %s" % (name, count, smi),
          flush=True)
    print("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda),
          flush=True)

    # 2. build, one nvcc per source, all started together
    t0 = time.monotonic()
    names = ("paged_flash_attention", "fused_sgd", "lrn", "dropout",
             "flash_attention")
    _build.load_all(names)
    libs = [str(_build.library_path(_build.CSRC_DIR / (n + ".cu"))
                .relative_to(_build.PACKAGE_DIR.parent)) for n in names]
    # the loader's host library, with g++ (no fallback on this path)
    check(native.available(), "the native dataio library did not build: %s"
          % native.build_error())
    libs.append(str(native.library_path().relative_to(
        _build.PACKAGE_DIR.parent)))
    print("build: %.2f s -> %s" % (time.monotonic() - t0, ", ".join(libs)),
          flush=True)

    # 3. kernels against their plain versions, at the serving shapes
    cases = [decode_case(torch, HK, A),
             decode_case(torch, HK, A, kv=2, seed=1),
             decode_case(torch, HK, A, c=4, seed=2),
             decode_case(torch, HK, A, window=100, sinks=4, seed=3),
             prefill_case(torch, HK, A, 0),
             prefill_case(torch, HK, A, 15)]
    # no limit on the table width or head_dim: long tables (a
    # 16384-token view) and odd or wide heads, checked only
    checks = [decode_case(torch, HK, A, dh=128, m=512, seed=4, timed=False),
              decode_case(torch, HK, A, kv=2, c=4, dh=128, m=512,
                          window=3000, sinks=4, seed=5, timed=False),
              decode_case(torch, HK, A, b=2, h=4, kv=2, dh=18, page=8,
                          m=40, seed=6, timed=False),
              decode_case(torch, HK, A, b=2, h=4, kv=4, dh=320, page=64,
                          m=8, seed=7, timed=False),
              # split-KV edges on a 16384-token view: lanes short of their
              # first page's end (every split but the first empty), and a
              # window with sinks (the splits between empty)
              decode_case(torch, HK, A, m=512, seed=9, timed=False,
                          shallow=True),
              decode_case(torch, HK, A, m=512, window=256, sinks=4,
                          seed=10, timed=False),
              prefill_case(torch, HK, A, 400, kv=2, dh=128, m=512, seed=8,
                           timed=False),
              # split-KV prefill edges: one history page, GQA, a head_dim
              # not a multiple of 4, feature blocks with page 64, and a
              # window with sinks that empties the splits between
              prefill_case(torch, HK, A, 1, seed=11, timed=False),
              prefill_case(torch, HK, A, 15, kv=2, seed=12, timed=False),
              prefill_case(torch, HK, A, 23, b=2, h=4, kv=2, dh=18, page=8,
                           m=40, seed=13, timed=False),
              prefill_case(torch, HK, A, 5, h=4, kv=4, dh=320, page=64,
                           m=8, seed=14, timed=False),
              prefill_case(torch, HK, A, 50, b=2, kv=2, dh=128, page=8,
                           m=64, window=100, sinks=4, seed=15,
                           timed=False)]
    sgd = sgd_cases(torch, HK)
    lrn = [c for i, (name, shape) in enumerate(LRN_SHAPES.items())
           for c in lrn_case(torch, HK, name, shape, seed=i)]
    lrn_checks = lrn_edge_cases(torch, HK)
    drop = [dropout_case(torch, HK, prng, name, shape, seed=i)
            for i, (name, shape) in enumerate(DROPOUT_SHAPES.items())]
    drop_checks = [dropout_case(torch, HK, prng, "n%d" % n, (n,), rate,
                                seed=10 + n, timed=False)
                   for n, rate in ((1, 0.5), (127, 0.3), (2 ** 16 + 3, 0.7))]
    draws = [bernoulli_case(torch, HK, prng, name, shape, exact, seed=i)
             for i, (name, shape) in enumerate(BERNOULLI_SHAPES.items())
             for exact in (False, True)]
    draws += [bernoulli_case(torch, HK, prng, "n%d" % n, (n,), exact,
                             seed=20 + n, timed=False)
              for n in (1, 127, 2 ** 16 + 3) for exact in (False, True)]
    flash = flash_case(torch, HK, *FLASH_MAIN)
    flash_checks = [rec for kw in (dict(dh=32), dict(dh=40), dict(dh=128))
                    for rec in flash_case(torch, HK, 2, 4, 200, causal=False,
                                          seed=kw["dh"], timed=False, **kw)]
    flash_checks += flash_case(torch, HK, 2, 4, 256, 64, seed=3, timed=False,
                               peak=100.0)
    # rows not 16-byte aligned: the backward stages by 4-byte copies
    flash_checks += flash_case(torch, HK, 2, 4, 200, 37, causal=False,
                               seed=37, timed=False)
    # the floor of a one-launch call: back-to-back empty launches
    floor_ms = time_ms([lambda: torch.cuda._sleep(0)], torch)
    print(json.dumps({"empty_launch_ms": floor_ms, "card": smi}),
          flush=True)
    for case in (cases + checks + sgd + lrn + lrn_checks + drop + drop_checks
                 + draws + flash + flash_checks):
        print(json.dumps(dict(case, card=smi)), flush=True)

    # 4. serve through the engine
    launches = serve(torch, HK, T, S, smi)

    # 5. train MNIST-FC through the sample's entry point
    launches["fused_sgd_update"] = train(torch, HK, smi)["fused_sgd_update"]

    # 6. train full-width AlexNet through the ImageNet sample, on the
    # synthetic set, then from a record file (and the LMDB leg)
    alex, synthetic = alexnet(torch, HK, smi)
    for k in ("lrn_forward", "lrn_backward", "dropout"):
        launches[k] = alex[k]
    launches["fused_sgd_update"] += alex["fused_sgd_update"]
    rec = records(torch, HK, smi, synthetic=synthetic)
    for k in ("lrn_forward", "lrn_backward", "dropout", "fused_sgd_update"):
        launches[k] += rec[k]
    launches["fused_sgd_update"] += wine_phase(torch, HK, smi)[
        "fused_sgd_update"]

    # 7. train the full-width LM through the char-LM sample
    lm = lm_train(torch, HK, smi)
    for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
              "flash_attention_bwd_dq"):
        launches[k] = lm[k]

    # 8. the conv zoo through the samples' own train
    from veles_tpu_torch.ops import functional as F
    deconv_check(torch, F, smi)
    for sample in ZOO:
        launches["fused_sgd_update"] += zoo(torch, HK, smi, sample)[
            "fused_sgd_update"]

    # 9. the non-SGD trainers, the lines and video_ae samples, the streams
    som = kohonen_phase(torch, HK, smi)
    rbm = rbm_phase(torch, HK, smi)
    for sample in ("lines", "video_ae"):
        launches["fused_sgd_update"] += sgd_sample_phase(
            torch, HK, smi, sample)["fused_sgd_update"]
    streams_phase(torch, smi, som)
    # the Bernoulli draw is no TPU kernel's port: a line of its own
    print(json.dumps({"bernoulli": {
        "route": "cuda", "source": SOURCES["dropout"],
        "replaces": None, "launches": rbm["bernoulli"],
        "cases": [{k: c[k] for k in ("case", "shape", "exact_0_1",
                                     "max_abs_err", "kernel_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}
                  for c in draws if "kernel_ms" in c],
        "empty_launch_ms": floor_ms, "card": smi}}), flush=True)

    # 10. the kernels line and the result
    main_case = {"flash_attention_fwd": flash[0],
                 "flash_attention_bwd_dkv": flash[1],
                 "flash_attention_bwd_dq": flash[2],
                 "fused_sgd_update": sgd[0],
                 "lrn_forward": lrn[0], "lrn_backward": lrn[1],
                 "dropout": drop[0],
                 "paged_flash_decode": cases[0],
                 "paged_flash_prefill": cases[5]}
    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k],
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": c["max_abs_err"], "ms": c["kernel_ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"]}
               for k, c in main_case.items()]
    # beside the calls that are one or two short launches, the floor
    for row in kernels:
        if row["name"] in ("fused_sgd_update", "paged_flash_decode",
                           "paged_flash_prefill"):
            row["empty_launch_ms"] = floor_ms
    print("chip smoke: %.1f s" % (time.monotonic() - started), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
