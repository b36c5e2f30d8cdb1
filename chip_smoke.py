#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits nonzero before the final line is printed):

1. device — the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build — the CUDA kernels compiled from ``veles_tpu_torch/csrc/``
   (``paged_flash_attention.cu``, ``fused_sgd.cu``, ``lrn.cu``,
   ``dropout.cu``, ``flash_attention.cu``, and ``graph_while.cu``, the
   while megastep's conditional-node loop; one nvcc per source, all
   started together) into
   ``build/kernels/``, and the loader's ``native/dataio.cpp`` with g++
   into ``build/native/`` (it must build: no numpy fallback here);
3. kernels — each kernel against its plain PyTorch version on the card
   at its main path's shapes, with kernel, plain-version and library
   card times (CUDA events; see ``time_ms``) and the card's bound for
   the same work: the paged attention kernels at the serving shapes
   (decode also at the speculative verify's c = 5; library:
   scaled_dot_product_attention on the gathered view), then
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
   timed); stochastic and stochastic-abs pooling at CIFAR's first
   pooling input (100 x 32 x 32 x 32, 2x2) on the card against the CPU
   with one key: the drawn positions and outputs equal but at counted
   near ties (``POOL_TIE``), eval within 1e-5, the backward bit-equal,
   and a two-step train of a small conv workflow with both layers
   (``POOL_TRAIN``: finite losses, one SGD launch a step); then each of ``cifar`` (``BASELINE.json`` configs[1]: 3
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
10. harness — the run harness through the CLI (``veles_tpu_torch.
   __main__``): MNIST-FC at ``configs[0]``'s widths for 3 epochs (4,950
   train samples, so each epoch ends in a 50-row minibatch) trained by
   the graph loop in a ``python -m veles_tpu_torch`` subprocess (its
   result file and per-epoch snapshots read back), then in this process
   by the epoch scan (captured CUDA-graph steps) in chunks of 1 and 3:
   final weights and velocities bit-equal to the loop's, equal
   ``n_err``, losses within 1e-6 relative, one fused-SGD launch a step
   counted through the replays; an ``exp`` lr policy bit-equal between
   loop and scan; runs resumed at epoch 1 through ``--snapshot auto``
   bit-equal to the uninterrupted ones on both drivers; ``--evaluate``
   from the final snapshot leaving the weights bit-equal; a
   ``grad_accum=4`` step within rtol 1e-5 / atol 1e-6 of the monolithic
   one; cifar (``configs[1]``, 2,450 / 10,000, 2 epochs) scan bit-equal
   to its loop; full-width AlexNet (600 / 128, minibatch 128, 2 epochs)
   scanned twice, bit-equal, with exact LRN / dropout / SGD launch
   counts, and card vs the port's CPU scan at minibatch 16 step by step
   (``ALEXNET_*`` limits); AlexNet from a 1,208 / 256 record file
   streamed in windows of 4, stage-ahead 1 and 2 bit-equal, exact
   launches, and a dense net on the same file streamed bit-equal to its
   loop; four planted faults (``HARNESS_FAULTS``: inv_batch frozen at
   capture, keys not folded per step, the policy read at step + 1, a
   snapshot without velocities), each caught; steady steps loop vs scan
   (ms, samples/s, busy share) for MNIST-FC, cifar and AlexNet, capture
   seconds, the graphs' launches per replay; its JSON line
   (``{"harness": ...}``).  The kernels phase also checks and times
   kernels 1 and 4's device-operand entries (the ones a captured step
   replays) against their by-value entries;
11. parallel — data- and tensor-parallel training of full-width AlexNet
   (``configs[4]``'s model; ``alexnet_layers()``, crop 227, minibatch
   128, the seeded 256x256 synthetic images): (a) NCCL at world 1
   through the CLI (``--distributed --num-processes 1 --process-id 0
   --coordinator-address 127.0.0.1:<port>``), the graph loop and
   ``--epoch-scan 1`` (the all-reduce captured in the CUDA graph), each
   bit-equal in weights and epoch metrics to the harness's run of the
   same command without ``--distributed``, one gradient all-reduce a
   train step (counted at capture and per replay), exact kernel
   launches, backend ``nccl``; then two gloo ranks sharing ``cuda:0``
   (this script with ``--parallel-rank``; NCCL refuses two ranks on one
   device): (b) data-parallel through the launcher, 64 rows a rank, 6
   steps, both ranks' weights bit-equal after every step, exact
   launches, and 3 data-parallel steps on fixed batches within the
   ``ALEXNET_*_SHARE`` limits of the same split arithmetic in one
   process after the first and third update; (c) tensor parallelism of
   the two 4096-wide FC layers (2048-wide slices), 3 steps on fixed
   batches, within the same limits of a single-process trajectory; (d) a record
   file sharded two ways, each rank's device minibatch its rows of the
   global minibatch bit for bit; (e) three planted faults (the gradient
   all-reduce skipped, rank 1's dropout at offset 0, the split layers'
   input gradient not reduced) that must break those limits; steady step
   ms and busy share of each run and the gloo all-reduce's ms; its JSON
   line (``{"parallel": ...}``).  The kernels phase also checks kernel
   4's element-offset entry (rank 1's rows of dropout6) against the
   global launch's rows and times it;
12. moe — mixture of experts (``ops/moe.py``) at the full LM width:
   (a) ``moe_train``, the char-LM sample with a top-1-routed mixture of 4
   experts a block (``MOE_TRAIN``: ``LM_TRAIN`` with ``n_experts=4``,
   ``moe_aux_coef=1e-2``) through its build + initialize + run under
   'flash_pallas', 10 train steps and 2 validation minibatches: exact
   flash launches (7a-7c), falling train loss, the validation loss
   falling between the epoch's scoring and the trained weights', a
   seeded rerun bit-equal (losses and params), the steady step's ms,
   tokens/s, busy share, top kernels and peak card memory against the
   dense LM step of phase 7; then card vs CPU at 2 layers
   (``MOE_SMALL``) with every card MoE call in the CPU call's region
   (its expert choices and its experts' ReLU signs; the card's own
   other choices counted, expert flips at margins below
   ``MOE_FLIP_MARGIN``) within ``LM_*_SHARE``, the run held to the
   expert choices alone reported, and three faulty card
   runs (``MOE_FAULTS``: gate dropped, aux term dropped, second-choice
   expert) rejected; (b) ``moe_serve``, ``LMEngine`` over the same
   config's seeded MoE weights answering 8 requests through kernels 5
   and 6 (exact launches, every emitted token checked as in phase 4);
   (c) ``moe_ep``, expert parallelism at the full block shape
   (``MOE_EP``: 16,384 tokens, d 512, d_ff 2048, 4 experts): NCCL at
   world 1 bit-equal to ``moe_ffn`` in values and gradients, then two
   gloo ranks sharing cuda:0 (this script with ``--moe-rank``), each
   holding only its 2 experts (``moe.expert_slice``: half the whole
   tree's expert-weight bytes, reported), bit-equal to each other and to
   the same split
   arithmetic in one process, within the reference's bars of
   ``moe_ffn``, ``ep_all_reduce`` and ``ep_input_grad_all_reduce``
   counted, their ms; its JSON line (``{"moe_ep": ...}``);
13. pipeline and ring — GPipe (``parallel/pipeline.py``) and ring
   attention (``parallel/ring.py``) at the full LM width, under
   'flash_pallas': (a) in this process at one stage (no joined run), the
   char-LM sample at ``LM_TRAIN``'s size with 4 microbatches
   (``PIPE_TRAIN``): exact flash launches (4 microbatches x 8 layers a
   step), falling train loss, the steady
   step, and the params after the first and third update within
   ``LM_*_SHARE`` of the sequential run (microbatching changes the GEMM
   shapes); the MoE run of ``docs/USAGE.md`` (``PIPE_MOE``: 4 experts, 8
   layers, 3 train steps) at one stage; (b) four gloo ranks sharing
   cuda:0 (this script with ``--pipeline-rank``), 2 layers a stage:
   the dense and the MoE runs, each rank's flash launches exact, its
   losses and replicated leaves after every update bit-equal to (a)'s
   and to each other, the gathered final params bit-equal to (a)'s;
   three planted faults (``PIPE_FAULTS``) that must move the loss or a
   gradient or make the ranks disagree; each rank's steady step (ms,
   tokens/s, busy share), peak card memory, the host-staged hop of one
   microbatch's activations and the outputs' all-reduce timed alone;
   (c) ring attention on the same ranks (``RING_SHAPE``: b 1, 8 heads,
   s 8192, head_dim 64, fp32) causal, and with window 1024 and sinks 4:
   output and dq, dk, dv within ``RING_TOL`` of dense ``attention`` on
   the card, the ranks bit-equal, the skipped attends exact
   (``RING_LIVE``), ring and dense ms, two planted faults
   (``RING_FAULTS``) outside the bars; its JSON line
   (``{"pipeline": ...}``);
14. rolling decode, population training and ZeroMQ — (a) the
   rolling-cache decode (``generate_rolling``) at the full LM width
   built with RoPE (``LM_CONFIG``, no positional table, fp32, TF32 off;
   ``ROLLING``: batch 8, seeded 128-token prompts, a 256-slot ring
   behind 4 pinned sinks) for 384 new tokens (prompt + new = max_len
   512: the tokens equal to ``generate``'s counted) and for 768: every
   step's logits within ``LOGIT_TOL`` of a teacher-forced plain
   ``transformer_forward`` (rope, window 256, sinks 4, 'xla') over the
   emitted sequence, the loop's peak card memory flat in ``n_new``
   (``ROLLING_PEAK_SLACK``), ms a decode step and tokens/s, the card's
   busy share over a 16-token decode (profiler), and two planted
   faults (``ROLLING_FAULTS``, 192 new tokens) at least
   ``FAULT_FACTOR`` times the limit; (b) the genetic optimizer and the
   ensemble on MNIST-FC (``configs[0]``'s widths, minibatch 100 and
   10,000 validation samples; the GA trains one minibatch an epoch,
   see ``GA``, the ensemble the full 60,000): the GA over layer 0's
   learning rate in this process and across 3 worker processes sharing
   the card — equal winner, fitness and history, every worker's fitness
   equal to the sequential one, the winner's direct ``run_sample``
   scoring its fitness, kernel 1's launches in this process exact; a
   2-member ensemble in this process and in 2 workers (restored from
   their snapshots): equal summaries, weights and combined errors, each
   member under 5% validation error; two planted faults
   (``POP_FAULTS``: the workers skip ``set_leaf``, the restore skipped)
   caught; set-up seconds and each worker batch's seconds beyond its
   longest run in this process; (c) one seeded stream (``ZMQ``)
   through ``ZeroMQLoader`` to the card, every device minibatch
   bit-equal to the host samples, the end of the stream flipping
   ``complete``;
15. deploy — full-width AlexNet (``alexnet_layers()``, crop 227, 1000
   classes; ``DEPLOY_LOADER``: 3 train minibatches of 128 on the seeded
   256x256 synthetic set) trained, then (a) exported with
   ``export.export_model`` in fp32 and int8 (bytes and seconds), loaded
   on the card with ``load_model``, ``predict`` at batch 1, 7 and 128
   against the workflow's eval forward (equal argmax, max abs gap within
   ``DEPLOY_ATOL``, whether bit-equal, exactly 2 LRN forward launches a
   predict: the kernel inside the exported program), the same file
   loaded on the CPU within ``DEPLOY_CROSS_ATOL`` of the card, the int8
   artifact's exact check (stored arrays equal a plain per-output-channel
   quantization, each loaded tensor scale x int8, outputs bit-equal to an
   fp32 artifact of the dequantized weights) and its argmax agreement
   with fp32 (reported); (b) ``serve_artifact`` direct and with
   ``max_batch`` 32, 32 one-image requests from 8 client threads each:
   every reply against a direct predict of its row, 2 LRN launches a
   forward, the batched run's mean batch above 1, a 413 and a 400,
   requests/s, p50/max and one request's JSON and forward seconds; (c)
   ``export_native_bundle`` at batch 8 (AOTInductor, weights baked in)
   of the trained model cut after pool2 with a softmax head
   (``native_layers``: both LRN layers stay), run by the libtorch runner
   (``native/artifact_runner.cpp``, built with g++) on 8 rows: within
   ``DEPLOY_CROSS_ATOL`` of the cut model's eval forward, equal argmax,
   exactly 2 LRN launches, the compile, build and run seconds and the
   runner's card memory; (d) ``python -m veles_tpu_torch
   veles_tpu_torch.samples.mnist --serve 0 --serve-batch 8`` at
   ``configs[0]``'s widths (``DEPLOY_CLI``) in a subprocess, 16 rows
   posted one a request, bit-equal to ``serve_snapshot`` of its final
   snapshot; (e) four planted faults (``DEPLOY_FAULTS``) caught; its
   JSON line (``{"deploy": ...}``);
16. observe — MNIST-FC at ``configs[0]``'s widths (the sample's
   defaults, 3 epochs) through the Launcher, graph loop and epoch scan,
   each with and without the observers (``link_plotters`` into a
   ``GraphicsServer`` with a subscriber here, a dashboard with its
   ``StatusReporter``, an events file) and required bit-equal to the
   unobserved run: (a) the specs received equal the plotters' history,
   numpy only, the curve equals ``epoch_metrics``, the confusion matrix
   the decision's (its sum the validation count, its trace count -
   n_err), the last ``Weights2D`` spec the committed weights transposed
   to 28x28 and no plot the initial weights; under the scan no plotter
   fires (as in the reference); every spec rendered to a PNG when
   matplotlib imports; each run's dashboard row is its result; (b) a
   ``python -m veles_tpu_torch ... --web-status-url --events-file``
   child reports into a dashboard here (row = its result file, the
   graph as .dot and .svg, ``veles_workflow_*`` in ``/metrics``,
   ``/timeseries.json`` 404, the events with the reference's keys), and
   a ``--stream-window`` run puts the ``veles_stream_*`` gauges in
   ``/metrics`` with one dispatch a graph replay; (c) ``Publisher``'s
   Markdown, HTML and JSON (PDF with matplotlib) of the loop run, the
   JSON epochs equal to ``epoch_metrics``; (d) four planted faults
   (``OBSERVE_FAULTS``) caught; (e) the plotters' and the reporter's
   host ms an epoch and the runs' seconds with and without them; one
   SGD launch a train step in every run; its JSON line
   (``{"observe": ...}``);
17. serve_fastpath — the paged engine at the full LM width (8 slots,
   page 32, seeded weights) with its fast-path knobs: (a) 16 requests
   sharing a 256-token prefix (8 full pages) with distinct suffixes of 1
   to 64 tokens (two of them agree on a page but for its last token),
   served without the prefix cache (every full prompt page kept as its
   lane finishes) and with ``prefix_cache=64``: the hits equal a host
   count of the repeated full chunks (at least 15 x 256 tokens), the
   prefilled tokens equal the prompts' less the hits, kernel 6's launches
   are 8 a prefill dispatch, every trie page bit-equal to the cache-off
   engine's page for the same prefix, a planted copy-on-write of a trie
   page leaves it bit-equal and makes a bit-equal copy, every emitted
   token within ``LOGIT_TOL`` of a teacher-forced plain pass (phase 4's
   check), the pool full again once the trie is flushed, the TTFT p50
   with and without the cache; (b) ``spec_k=4`` on the 8 candidate
   prompts (a's and 8 periodic ones) whose greedy tokens from the plain
   engine replay the most accepted prompt-lookup drafts on the host:
   kernel 5's launches 8 a verify dispatch, all at c = 5, more tokens
   than dispatches, accepted drafts, the teacher-forced check, the
   verify step at full width against the plain step; three planted
   faults (``FAST_FAULTS``: a trie keyed on a chunk's first 31 tokens, a
   verify accepting drafts unchecked, a copy-on-write that skips the
   copy) caught; its JSON line (``{"serve_fastpath": ...}``);
18. serve_megastep — the fused K-step decode (``megastep=K``: one CUDA
   graph a live-width ladder entry, captured at the engine's start) at
   the full LM width, 8 slots, page 32: (a) K = 8 with a 64-chunk
   prefix cache on phase 4's requests, (b) ``spec_k=4`` at K = 4 on
   phase 17's periodic candidates (drafts found in the graph), (c) the
   MoE engine at K = 4 on 4 requests.  Each run: every emitted token
   within ``LOGIT_TOL`` of a teacher-forced plain pass, the tokens that
   differ from the per-tick engine's counted (phase 4's and phase 17's
   plain runs), the ``megastep_*`` books closed, kernel 5's launches 8
   x K a dispatch and kernel 6's 8 a prefill dispatch, the pool full
   again; (a) no frozen lane writes past its last position or into a
   trie page, (b) accepted drafts and more than one token a live
   lane-iteration.  Three planted faults (``MEGA_FAULTS``: the write
   mask dropped, a stale staged page table after a slot refills, one
   draft token accepted past the first mismatch) caught.  Timed at the
   widest table against the per-tick step (ms a dispatch and a token,
   busy shares, capture seconds); its JSON line
   (``{"serve_megastep": ...}``);
19. serve_whilestep — the while megastep (``megastep_mode="while"``:
   K conditional graph nodes a live-width ladder entry, built from the
   captured set-up, one captured iteration and the packing by
   ``csrc/graph_while.cu``; a node whose predicate reads false is
   skipped on the card) and the standby refill ring at the full LM
   width, 8 slots, page 32: (a) the alias ``megastep="while"`` (K = 16)
   with ``refill_ring=2`` on phase 4's 16 requests, and without the
   ring for tokens/s; (b) ``spec_k=4`` at K = 4 with a ring of 2 on
   phase 17's periodic candidates, each sent twice (16 requests on 8
   slots); (c) one lane with n_new 6 at K = 16 against the scan at the
   same K (5 realised iterations and 0 wasted against 16 and 11).  Each
   run: every emitted token within ``LOGIT_TOL`` of a teacher-forced
   plain pass, the tokens that differ from the per-tick engine's
   counted, the books closed with realised iterations, every
   dispatch's ``assign`` and early exit within the program's contract,
   kernel 5's launches 8 a realised iteration and kernel 6's 8 a prompt
   chunk (the ring's standby chunks included), the pool full again; (a)
   and (b) ``megastep_refills`` > 0.  Three planted faults
   (``WHILE_FAULTS``: an arm that ignores ``count``, a predicate that
   ignores the ring, a predicate never updated) caught.  Timed at the
   widest table: the while dispatch at 1, 4, 8 and 16 realised
   iterations (and at 0) against the scan's K = 16 dispatch, host clock
   and card time a dispatch and a realised iteration, and the capture
   seconds a ladder width; its JSON line (``{"serve_whilestep": ...}``);
20. serve_sampling — seeded sampling (``SAMPLE_KW``: temperature 0.8,
   top_k 40, sample_seed 123) at the full LM width, 8 slots, page 32,
   every token drawn by the draw kernel (``dropout.cu``'s third entry,
   ``HK.sample_token``: the keys fold_in(fold_in(base, admission id),
   position) made on the card, jax's gumbel-max rule): (a) the engine on
   phase 4's 16 requests per tick, at scan K = 8, while K = 16 with a
   ring of 2, and ``spec_k`` 4 at K = 4 (``SAMPLE_MODES``): every
   emitted token's perturbed score (its teacher-forced plain logit over
   T after the top-k mask, plus the plain draw's gumbel at its (seed,
   position)) within ``LOGIT_TOL`` / T of its row's best, the tokens
   that differ from the per-tick run counted, the books closed, kernels
   5 and 6 counted as in phases 17–19 and the draw once a prompt chunk
   and once a decode dispatch or (realised) iteration, the pool full
   again; (b) a sampled while launch (16 realised iterations) and
   per-tick step at the widest table against a greedy engine's in the
   same run, and the draw kernel alone at 8 and 40 rows of 256 against
   its plain version (tokens equal but at plain near ties, a bit-equal
   repeat) with its bound; (c) ``generate`` sampling at batch 8, 64
   tokens (one draw a token), checked as (a) under generate's split
   chain; (d) ``serve_lm`` over HTTP: 16 greedy requests through its
   engine against ``generate``'s tokens (a reply that differs held to
   the teacher-forced check),
   16 seeded sampled requests through the direct path equal to
   ``trainer_sample_tokens`` in process, requests/s and p50; its JSON
   line (``{"serve_sampling": ...}``);
21. serve_ops — crash-safe serving and hot weight swap at the full LM
   width, 8 slots, page 32, a prefix cache of 128 chunks: (a) on each
   decode path (per tick, scan K = 8, while K = 16 with a ring of 2)
   phase 4's 16 requests twice, ``swap_weights`` asked for once every
   slot is busy — weights A (phase 4's) to B (a second seeded draw)
   finish-on-old, then back to A with ``drain=True``: stamps of both
   versions, every token within ``LOGIT_TOL`` of a teacher-forced plain
   pass on the weights of its stamped version, 0 tokens differing from
   phase 4's (A) or a fresh engine's on B, the prefix cache empty after
   each apply, requests requeued, the pool full again; the swap's
   staging (host clock) and in-place apply (card time) against its
   bytes' bound; two planted faults (``OPS_FAULTS``: a swap that
   reassigns ``params``, which leaves the captured scan graphs on A,
   and a swap that keeps the prefix cache) caught; (b) fault plans: per
   tick with ``spec_k`` 4 an ``engine.verify`` and an ``engine.chunk``
   fault, an ``engine.tick`` freeze released after 0.2 s, and an
   ``engine.cow`` fault on the first page copy, made due at the freeze
   by a second reference to a page one busy lane writes next (served
   traffic never writes into a shared page), then the same site on a
   direct call of the page guard; while K = 16 with a ring of 2 an
   ``engine.step`` fault: exactly the participants fail, the survivors
   and the next 16 requests pass the check, the pool full again; a plan
   with no rule launches kernels 5 and 6 as no plan does; (c) a freeze
   mid-traffic, ``checkpoint()``, release, stop, and ``restore`` into a
   fresh engine: 0 tokens differing from the uncrashed run; its JSON
   line (``{"serve_ops": ...}``);
22. serve_observe — request tracing and live telemetry at the full LM
   width, 8 slots, page 32: (a) on each decode path (``TRACE_PATHS``:
   per tick, ``spec_k`` 4, scan K = 8, while K = 16 with a ring of 2) a
   fresh engine a mode serves phase 4's 16 requests untraced and under
   the tracer mode ``all``, per tick, at ``spec_k`` 4 and at scan K = 8
   also ``sample:0.25`` (seeded), and per tick ``errors``
   (``TRACE_PATH_MODES``): tokens, kernel 5/6 launches and
   decode dispatches
   equal to the untraced run's, every retained tree sound
   (``verify_integrity``), one ledger dispatch a decode step or graph
   replay and one a prompt chunk (``all``, ``errors``), tokens/s a mode
   against untraced; (b) fencing: behind every prompt chunk and the swap
   apply a spin of >= 5 ms and a CUDA event, every span's close finds
   its event complete; (c) ``errors`` mode with
   faults at ``engine.chunk`` and ``engine.step``: the ring retains
   exactly the failed requests; three planted faults
   (``TRACE_FAULTS``: the fence removed, K spans a replay, the span's
   call moved inside the captured body) caught; (d) ``serve_lm`` over
   HTTP with ``trace="all"``, telemetry every 0.05 s, the stock SLOs and
   the scan at K = 8: ``/trace.json``, ``/ledger.json``,
   ``/timeseries.json``, ``/slo.json``, ``/metrics.json`` strict JSON and
   ``/status`` text, ``compile_programs`` the captured graphs,
   ``0 < device_mem_bytes <= torch.cuda.memory_reserved()``, the
   ``tokens_per_s`` gauge integrated over the window within 10% of the
   tokens counted on the host clock, ``sample_once`` ms, the
   ``/trace.json`` bytes for 16 requests; its JSON line
   (``{"serve_observe": ...}``);
23. serve_guarded — the lock-order witness
   (``serving/lockcheck.py``) and the transfer guard
   (``serving/xfer.py``, ``"disallow"``: the card's sync debug mode
   ``"error"`` while a worker's turn runs outside a declared boundary)
   armed at the full LM width, 8 slots, page 32: (a) which host/card
   operations the mode refuses on this card (``sync_probe``: a blocking
   upload, a blocking read, ``.item()`` and a stream synchronize must
   raise, non-blocking uploads and a card-to-card copy must not); (b)
   phase 4's 16 requests on each of phase 22's decode paths (per tick,
   ``spec_k`` 4, scan K = 8, while K = 16 with a ring of 2), then per
   tick sampled (``SAMPLE_KW``) and traced at ``sample:1.0`` (every fence
   runs), and a swap to seeded weights B under the scan's captured
   graphs: tokens, kernel 5/6 launches and dispatches equal to the
   unarmed runs (phase 22's untraced run a path; an unarmed run of the
   same script here for the sampled run and the swap), zero violations,
   the sync debug mode 0 after every ``stop()``, the witness's
   acquisitions, dispatch checks and role edge graph; (c) three planted
   faults (``GUARD_FAULTS``: ``lm_engine._cond`` held across the
   ``engine.step`` dispatch, a decode dispatch that reads a card value
   with ``.item()`` — its request fails with the sync error and the next
   is served —, a guard exit that leaves the mode set) caught; (d) the
   unarmed shims' µs a round trip on the host clock (``TrackedCondition``
   against ``threading.Condition``, ``TrackedLock`` against
   ``threading.Lock``, the null guard and boundary), charged the
   acquisitions the armed per-tick run made a decode dispatch, as a
   share of phase 4's decode step (under ``GUARD_SHIM_SHARE``); its JSON
   line (``{"serve_guarded": ...}``);
24. serve_fleet — two engine replicas on the card behind the router
   (``serving/router.py``; each replica its own weights copy, pools and
   captured graphs, 8 slots, page 32, full LM width): (a) phase 4's 16
   requests as one burst, under the ``metrics`` and ``round_robin``
   policies, per tick and at scan K = 8 (``FLEET_PATHS``), and at scan
   K = 8 also one at a time (``FLEET_SEQUENTIAL_PATHS``): the
   sequential placements alternate (every score 0: the fewest-routed
   tiebreak, or the counter), a burst's split within the reference's
   bound (``FLEET_BURST_SPREAD``; round robin exact), kernel 5/6
   launches n_layers x (K x) the replicas' summed decode dispatches and
   prompt chunks, the tokens that differ from phase 4's one engine
   counted and each differing row held to the teacher-forced plain pass
   (``LOGIT_TOL``), the pools full again, tokens/s against phase 4's;
   (b) a drain (replica 0 slowed by a ``latency`` plan, unregistered
   mid-decode: every request once and whole, requeued >= withdrawn,
   later placements on replica 1); (c) every replica refusing: the
   minimum ``Retry-After``, and ``NoLiveReplicas`` once none is live,
   and ``_order`` over ``FLEET_ORDER_FLEETS`` seeded stub fleets equal
   to a plain ordering; (d) three planted faults (``FLEET_FAULTS``: an
   ``_order`` that keeps a drained replica, a completion path that
   delivers a drained attempt's short result, a ``Retry-After`` from the
   last refusal) caught; (e) the router's host µs a placement (a stub
   fleet of settled futures) as a share of phase 4's decode step; its
   JSON line (``{"serve_fleet": ...}``).  The wedged drain and
   ``serve_lm`` over HTTP run in phase 25, armed;
25. serve_resilience — the router's resilience layer over two replicas
   on the card (full LM width, 8 slots, page 32), one fleet a path (per
   tick and scan K = 8, ``RES_PATHS``) reused across the legs with the
   fault plans swapped between them: (a) retries: replica 0 faulting
   every decode dispatch, ``retries=2``, phase 4's 16 requests as one
   burst, every one delivered by replica 1, ``requests_retried`` >= 1;
   then both replicas faulting: ``InjectedFault`` after exactly 2
   retries; (b) hedges: replica 0's dispatch slowed by
   ``RES_LATENCY_S``, ``hedge_after_s`` ``RES_HEDGE_AFTER_S``: hedges
   placed and won, every request delivered once, every loser cancelled
   and never delivered, both pools' invariants sound once quiet; per
   tick (``RES_UNHEDGED_PATHS``) the same burst unhedged for the slowed
   requests' p50 and max latency; (c) the circuit: replica 0 frozen at
   a loop turn mid-decode, ``HealthChecker.step()`` by hand
   (``RES_STALL_S`` staleness, ``RES_FAIL_THRESHOLD`` failures):
   quarantined through the drain with ``circuit_open_total`` 1, its
   wedged lanes force re-placed after ``RES_DRAIN_TIMEOUT_S`` and the
   zombies' late results ignored, every request once and whole, after the
   release and ``RES_COOLDOWN_S`` the half-open probe re-admits it and
   it serves again; ``note_slo_page`` x ``RES_FAIL_THRESHOLD`` opens
   the circuit the same way and a half-open probe closes it; in every
   leg kernel 5/6 launches n_layers x (K x) the replicas' summed
   dispatches and chunks (losers, retries and probes included), tokens
   differing from phase 4's counted and each differing row held to the
   teacher-forced plain pass; (d) ``serve_lm(replicas=2, health=True,
   retries=2, hedge=-1, slo=True, trace="all")`` over HTTP with one
   injected chunk fault: 16 replies 200, one retry, the launch formula,
   ``/metrics`` (one ``# TYPE`` a family, ``replica_health_state`` and
   ``tokens_out`` a row a replica), ``/metrics.json`` (both replicas'
   snapshots), ``/slo.json`` and ``/trace.json`` strict, every trace
   sound with an ``attempt`` span a placement, the checker stopped with
   the server; (e) four planted faults
   (``RES_FAULTS``: a retry that ignores ``exclude``, a ``_deliver``
   that lets a hedge loser overwrite the winner's stamps, a half-open
   probe that does not double the cooldown, a probe success that resets
   the SLO page streak) caught on stub fleets; (f) the router's host µs
   a placement armed but idle (``retries`` 2, a hedge loop running)
   against phase 24's unarmed figure; its JSON line
   (``{"serve_resilience": ...}``);
26. the script's seconds, the card's name and power limit, one JSON line
   listing every ported TPU kernel (kernel 1 with its launches in phase
   14's parent process, ``population_launches``, and in phase 16's,
   ``observe_launches``; kernel 2 with its
   launches on phase 15's deployment paths, ``deploy_launches``;
   kernels 5, 6 and 7a-7c
   with their launches on the MoE runs, ``moe_launches``, 7a-7c with
   theirs on the pipelined runs, ``pipeline_launches``, and 5 and 6 with
   theirs in phase 17, ``fastpath_launches``, in phase 18,
   ``megastep_launches``, in phase 19, ``whilestep_launches``, in
   phase 20, ``sampling_launches``, in phase 21, ``ops_launches``, in
   phase 22, ``observe_serve_launches``, in phase 23,
   ``guarded_launches``, in phase 24, ``fleet_launches``, and in phase
   25, ``resilience_launches``;
   kernels 1 and 4
   with their device-operand entries' times, bounds and launches, kernel
   4 with its offset entry's), the token draw's line
   (``{"sample_token": ...}``: no TPU kernel's port, as the Bernoulli
   draw), each phase's seconds (``phase_seconds``), then the JSON
   result line.

Phases 15 and 16 run in a second process (``beside_phases``), started
before phase 11 and joined before phase 14: they are host work, and
phases 11-13 leave the host's cores to it (their gloo ranks measure
arithmetic, not speed).  Their host clocks share the host with 11-13.
Seeded host draws of 4 M values or more (the synthetic sets, the weight
fills) are kept in each process and replayed bit-equal
(``memo_draws``); the kernels phase draws its inputs on the card.

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

Depth given up to pay for phase 24's seconds: phase 22(a) runs the
``errors`` tracer mode per tick only and ``sample:0.25`` not on the
while path (every path still runs untraced and under ``all``; (c) runs
``errors`` under faults); phase 11's data-parallel gloo run trains 6
steps, not 10, and rank 0 no longer repeats it as a single-process
graph loop, so the launcher-driven data-parallel run is no longer
compared with one process (that gap was reported, never checked; the
fixed-batch data-parallel steps are still held to one process); phase
18 no longer repeats its timing in a fresh child process.  And to pay
for phase 25: phase 24(a) runs phase 4's requests one at a time only
at scan K = 8 (per tick: the bursts alone, so the per-tick fleet's
one-at-a-time placements are no longer seen; their alternation is
still checked at K = 8); phase 24's wedged drain and its ``serve_lm``
over HTTP (round robin, unarmed) moved into phase 25's circuit and
HTTP legs (armed; the round-robin split over HTTP is no longer
checked, round robin is still held in (a)'s bursts); phase 13(a) no
longer reruns its one-stage run in process (its determinism is still
shown by the four ranks reproducing it bit for bit); phase 11's rank-0
gap sums (``weight_gaps``) reduce on torch's host threads and take each
reference's movement once (the same values).

It imports nothing of JAX and nothing of the ``veles_tpu`` package.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
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
#: the MoE runs: the repo's LM config with a top-1-routed mixture of 4
#: experts a block (the documented MoE run's count, docs/USAGE.md) and
#: the reference trainer's load-balancing weight; trained at LM_TRAIN's
#: loader (10 steps, 2 validation minibatches), card vs CPU at LM_SMALL's
MOE = {"n_experts": 4, "moe_aux_coef": 1e-2}
MOE_TRAIN = dict(LM_TRAIN, trainer=dict(LM_TRAIN["trainer"], **MOE))
MOE_SMALL = dict(LM_SMALL, trainer=dict(LM_SMALL["trainer"], **MOE))
#: faulty card runs the first-update limit (LM_FIRST_SHARE) must reject:
#: each token's output not scaled by its gate, the load-balancing term
#: left out of the train loss, and every token sent to its second-choice
#: expert
MOE_FAULTS = ("gate_dropped", "aux_dropped", "second_choice")
#: card vs CPU runs each card MoE call in the region of the CPU's same
#: call: its expert choices and its experts' ReLU signs (one ReLU kink
#: flipped by roundoff moves a block's input gradient, and Adam's first
#: update, ~lr·sign(g), spreads that over the tensors: the parallel
#: phase's kink, here between the card and the CPU; the report's
#: ``routing_only_worst`` is the run held to the expert choices alone).
#: The card's own other choices are counted; a roundoff flip of an
#: expert choice sits at a top-1/top-2 margin below this (the two runs'
#: weights drift apart by up to LM_THIRD_SHARE of their movement over 3
#: updates)
MOE_FLIP_MARGIN = 1e-3
#: requests the MoE serve answers (20-300 prompt, 32-64 new tokens)
MOE_SERVE_REQUESTS = 8
#: expert parallelism at the full-width block shape: tokens (minibatch
#: 32 x s 512), d_model, d_ff, experts (2 a rank on two ranks)
MOE_EP = (16384, 512, 2048, 4)
#: EP vs one-device ``moe_ffn``: the reference's bars (tests/test_moe.py),
#: (rtol, atol) of the output and of the gradients
MOE_EP_VALUE_TOL = (2e-5, 1e-6)
MOE_EP_GRAD_TOL = (2e-4, 1e-5)
#: timed forward + backward calls of each EP run
MOE_EP_TIMED = 5
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


#: a host draw of at least this many values is kept by ``memo_draws``
MEMO_DRAW_MIN = 1 << 22
#: the most bytes ``memo_draws`` keeps (the oldest draws go first)
MEMO_DRAW_BYTES = 16 << 30


def memo_draws(prng):
    """Keep this process's large seeded host draws.  Every sample run
    draws its synthetic set anew from a pinned stream at the same state,
    so the AlexNet, CIFAR and MNIST sets of the later phases repeat the
    first run's draws.  Each ``uniform`` or ``normal`` call of at least
    ``MEMO_DRAW_MIN`` values is kept under the stream's state and the
    call's arguments; a repeat returns a copy of the kept values and sets
    the stream to the state the draw left it in, which is what drawing
    again gives, bit for bit."""
    kept, cls = {}, prng.RandomGenerator

    def memo(name):
        inner = getattr(cls, name)

        def draw(self, *args, **kwargs):
            size = kwargs.get("size", args[2] if len(args) > 2 else None)
            if size is None or int(numpy.prod(size)) < MEMO_DRAW_MIN:
                return inner(self, *args, **kwargs)
            _, mt, pos, has_gauss, gauss = self.state.get_state()
            key = (name, mt.tobytes(), pos, has_gauss, gauss, args,
                   tuple(sorted(kwargs.items())))
            hit = kept.get(key)
            if hit is None:
                out = inner(self, *args, **kwargs)
                kept[key] = hit = (out, self.state.get_state())
                while sum(v[0].nbytes for v in kept.values()) \
                        > MEMO_DRAW_BYTES and len(kept) > 1:
                    del kept[next(iter(kept))]
            else:
                self.state.set_state(hit[1])
            return hit[0].copy()
        return draw

    for name in ("uniform", "normal"):
        setattr(cls, name, memo(name))

    # the weight fills, as ``RandomGenerator`` writes them, through the
    # kept draws
    def fill(self, arr, vle_min=-1.0, vle_max=1.0):
        arr[...] = self.uniform(vle_min, vle_max, arr.shape).astype(
            arr.dtype)
        return arr

    def fill_normal(self, arr, mean=0.0, stddev=1.0):
        arr[...] = self.normal(mean, stddev, arr.shape).astype(arr.dtype)
        return arr

    cls.fill, cls.fill_normal = fill, fill_normal


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
def card_draws(torch, rng):
    """A generator on the card seeded from ``rng``: the kernels' large
    random inputs are drawn there (a host draw of 10**8 normals takes
    seconds)."""
    return torch.Generator(device="cuda").manual_seed(
        int(rng.randint(2 ** 31)))


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
    g = card_draws(torch, rng)
    q = torch.randn(b, h, c, dh, generator=g, device=dev)
    kp = torch.randn(n_pages, kv, page, dh, generator=g, device=dev)
    vp = torch.randn(n_pages, kv, page, dh, generator=g, device=dev)
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
        q, k, v, ptab, pos, window, sinks) for k, v in pools], torch,
        calls=3, reps=5)
    # library yardstick: SDPA on the gathered, head-repeated view
    views = [(A._repeat_kv(A.paged_view(k, ptab), h),
              A._repeat_kv(A.paged_view(v, ptab), h)) for k, v in pools]
    mask = A.chunk_live_mask(pos.long(), c, m * page, window, sinks)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_err = (sdpa(q, *views[0], attn_mask=mask)
                   - ref).abs().max().item()
    library_ms = time_ms([lambda kx=kx, vx=vx: sdpa(q, kx, vx,
                                                    attn_mask=mask)
                          for kx, vx in views], torch, calls=3, reps=5)
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
    g = card_draws(torch, rng)

    def t(*shape):
        return torch.randn(*shape, generator=g, device=dev)

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
        q, kn, vn, k, v, ptab, pos, window, sinks) for k, v in pools], torch,
        calls=3, reps=5)
    views = [(A._repeat_kv(A.paged_view(k, ptab), h),
              A._repeat_kv(A.paged_view(v, ptab), h)) for k, v in pools]
    mask = A.chunk_live_mask(pos.long(), c, m * page, window, sinks)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_err = (sdpa(q, *views[0], attn_mask=mask)
                   - ref).abs().max().item()
    library_ms = time_ms([lambda kx=kx, vx=vx: sdpa(q, kx, vx,
                                                    attn_mask=mask)
                          for kx, vx in views], torch, calls=3, reps=5)
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
    n = int(numpy.prod(shape))
    dev = torch.device("cuda")
    g = card_draws(torch, numpy.random.RandomState(seed))

    def t(a):
        buf = torch.empty(n + offset, device=dev)
        buf[offset:] = a.reshape(-1)
        return buf[offset:].view(shape)

    out = [(t(torch.rand(n, generator=g, device=dev) * 0.6 - 0.3),
            t(torch.randn(n, generator=g, device=dev) * 0.01),
            t(torch.randn(n, generator=g, device=dev) * 5))]
    return out + [tuple(t(x) for x in out[0]) for _ in range(copies - 1)]


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

    g = card_draws(torch, rng)

    def place(a):
        buf = torch.empty(a.numel() + offset, device=dev)
        buf[offset:] = a.reshape(-1)
        return buf[offset:].view(shape)

    # non-negative inputs (post-ReLU) of rms 3 and an O(1) cotangent, so
    # that the window term of d and the backward's cross-channel term
    # both sit well above the limits (``lrn_faults`` counts by how much)
    x = place(3 * torch.randn(shape, generator=g, device=dev).abs())
    dy = place(torch.randn(shape, generator=g, device=dev))
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
    fwd["dispatch"] = lrn_dispatch(torch, HK, xs, hyper)
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


def host_us(fns, torch, calls=10, reps=25):
    """Median over ``reps`` of the host's time to enqueue one call, in
    microseconds: a spin kernel keeps the card busy meanwhile, so no call
    waits for the card and the reading is the host's work alone."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2 * 2.5e9 * host_s * calls) + 100000
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        for k in range(calls):
            fns[k % len(fns)]()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def lrn_dispatch(torch, HK, xs, hyper):
    """What the op ``veles_tpu_torch::lrn_forward`` adds to a forward
    launch: ``HK.lrn_forward`` (through the dispatcher) against a direct
    call of its CUDA implementation on the same inputs, the host's time
    a call (``host_us``) and the card's (``time_ms``), read in the order
    op, direct, direct, op."""
    ways = {"op": [lambda t=t: HK.lrn_forward(t, *hyper, 2.0) for t in xs],
            "direct": [lambda t=t: HK._lrn_forward_launch(t, *hyper, 2.0)
                       for t in xs]}
    out = {"%s_%s" % (w, unit): [] for w in ways for unit in ("host_us",
                                                              "ms")}
    for way in ("op", "direct", "direct", "op"):
        out[way + "_host_us"].append(host_us(ways[way], torch))
        out[way + "_ms"].append(time_ms(ways[way], torch))
    return out


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


def device_entry_cases(torch, HK, prng):
    """The device-operand entries of kernels 1 and 4 (operands read on
    the card when the kernel runs, the entries a captured step replays)
    against their by-value entries: bit-equal results, then both timed.
    SGD at MNIST-FC's four and AlexNet's sixteen parameters (inv_batch
    and the rates from a device row), dropout at AlexNet's dropout6
    input (the key from two words on the card)."""
    dev = torch.device("cuda")
    out = []
    for name, shapes, wd in (("mnist_fc_step", MNIST_PARAMS, 0.0),
                             ("alexnet_step", ALEXNET_PARAMS, 0.0005)):
        sets = [sgd_operands(torch, s, 100 + i, COPIES)
                for i, s in enumerate(shapes)]
        n_t = len(shapes)
        host = numpy.zeros(3 + n_t, numpy.float32)
        host[0] = 100
        host[1] = numpy.float32(1) / numpy.float32(100)
        host[3:] = 0.03
        row = torch.as_tensor(host, device=dev)
        at = [(1, 3 + i) for i in range(n_t)]
        hyper = [(0.9, wd, 0.0, None)] * n_t
        by_value = [(100, 0.03, 0.9, wd, 0.0, None)] * n_t

        def call(k, dev_entry):
            ps, vs, gs = (list(x) for x in zip(*[o[k] for o in sets]))
            if dev_entry:
                return lambda: HK.fused_sgd_update_multi_dev(
                    ps, vs, gs, row, at, hyper)
            return lambda: HK.fused_sgd_update_multi(ps, vs, gs, by_value)

        got, want = call(0, True)(), call(0, False)()
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got[0] + got[1],
                                                      want[0] + want[1]))
        check(equal, "fused_sgd_update %s: the device-operand entry "
              "differs from the by-value entry" % name)
        n = sum(int(numpy.prod(s)) for s in shapes)
        bound_ms, bound_by = bound(20 * n, 10 * n)
        out.append({"kernel": "fused_sgd_update", "entry": "device_operands",
                    "case": name, "elements": n, "bit_equal": equal,
                    "device_operand_ms": time_ms(
                        [call(k, True) for k in range(COPIES)], torch),
                    "by_value_ms": time_ms(
                        [call(k, False) for k in range(COPIES)], torch),
                    "bound_ms": bound_ms, "bound_by": bound_by})
    shape = DROPOUT_SHAPES["dropout6"]
    xs = [torch.as_tensor(numpy.random.RandomState(k).randn(*shape)
                          .astype(numpy.float32), device=dev)
          for k in range(COPIES)]
    key = prng.fold_in(prng.PRNGKey(SEED), 6)
    words = torch.as_tensor(key.view(numpy.int32), device=dev)
    equal = torch.equal(HK.dropout(xs[0], words, 0.5),
                        HK.dropout(xs[0], key, 0.5))
    check(equal, "dropout: the device-key entry differs from the by-value "
          "entry")
    n = xs[0].numel()
    t_bytes = 8 * n / HBM_BYTES_S * 1e3
    t_ops = DROPOUT_OPS * n / INT32_OP_S * 1e3
    out.append({"kernel": "dropout", "entry": "device_key",
                "case": "dropout6", "shape": list(shape), "bit_equal": equal,
                "device_operand_ms": time_ms(
                    [lambda t=t: HK.dropout(t, words, 0.5) for t in xs],
                    torch),
                "by_value_ms": time_ms(
                    [lambda t=t: HK.dropout(t, key, 0.5) for t in xs],
                    torch),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    # the element-offset entry: data rank 1's 64 rows of dropout6 under
    # the global kernel's key, against those rows of the global launch
    # (by value and through the key on the card), then timed against
    # the same rows at offset 0
    rows = shape[0] // 2
    halves = [t[rows:].contiguous() for t in xs]
    offset = rows * shape[1]
    whole = HK.dropout(xs[0], key, 0.5)
    equal = (torch.equal(HK.dropout(halves[0], key, 0.5, offset=offset),
                         whole[rows:])
             and torch.equal(HK.dropout(halves[0], words, 0.5,
                                        offset=offset), whole[rows:]))
    check(equal, "dropout: the offset entry differs from its rows of the "
          "global launch")
    n = halves[0].numel()
    t_bytes = 8 * n / HBM_BYTES_S * 1e3
    t_ops = DROPOUT_OPS * n / INT32_OP_S * 1e3
    out.append({"kernel": "dropout", "entry": "offset",
                "case": "dropout6_rank1_of_2", "shape": [rows, shape[1]],
                "offset": offset, "bit_equal_to_global_rows": equal,
                "offset_ms": time_ms(
                    [lambda t=t: HK.dropout(t, key, 0.5, offset=offset)
                     for t in halves], torch),
                "by_value_ms": time_ms(
                    [lambda t=t: HK.dropout(t, key, 0.5) for t in halves],
                    torch),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
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
    g = card_draws(torch, numpy.random.RandomState(seed))

    def t():
        return torch.randn(b, h, s, dh, generator=g, device=dev)

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


def teacher_forced(torch, T, engine, seq, true_len, emitted, params=None):
    """Re-run ``seq`` (prompt + emitted) through the plain attention
    path on a fresh single-lane pool (on ``params``, default the
    engine's weights); returns (worst logit shortfall of an emitted
    token below its row max, exact argmax matches)."""
    logits = teacher_logits(torch, T, engine, seq, true_len, len(emitted),
                            params)
    tok = torch.as_tensor(emitted, device=engine.device).long()
    picked = logits.gather(1, tok[:, None])[:, 0]
    short = (logits.max(dim=1).values - picked).max().item()
    exact = int((logits.argmax(dim=1) == tok).sum().item())
    return short, exact


def teacher_logits(torch, T, engine, seq, true_len, n, params=None):
    """The plain attention path's logits (n, vocab) after positions
    true_len - 1 .. true_len + n - 2 of ``seq``, on a fresh single-lane
    pool of the engine's geometry (on ``params``, default the engine's
    weights)."""
    params = engine.params if params is None else params
    page, dev = engine.prefill_chunk, engine.device
    pages = -(-len(seq) // page)
    pools = [(torch.zeros((pages + 1,) + k.shape[1:], device=dev),
              torch.zeros((pages + 1,) + k.shape[1:], device=dev))
             for k, _ in engine._kv_pools]
    ptab = torch.zeros(1, engine.max_len // page, dtype=torch.int32,
                       device=dev)
    ptab[0, :pages] = torch.arange(1, pages + 1, dtype=torch.int32)
    toks = numpy.zeros(pages * page, numpy.int32)
    toks[:len(seq)] = seq
    logits = []
    for start in range(0, pages * page, page):
        h, _ = T.paged_chunk_apply(
            params, torch.as_tensor(toks[None, start:start + page],
                                    device=dev),
            pools, ptab, torch.tensor([start], dtype=torch.int32,
                                      device=dev),
            engine.n_heads, attn_kernel=None)
        logits.append(T.head_logits(params, h)[0])
    return torch.cat(logits)[true_len - 1:true_len - 1 + n]


def serve_requests(vocab, n):
    """Phase 4's seeded requests: [(prompt of 20 to 300 tokens, n_new of
    32 to 64)]; a shorter list is a prefix of a longer one."""
    rng = numpy.random.RandomState(SEED)
    return [(rng.randint(0, vocab, rng.randint(20, 301))
             .astype(numpy.int32), int(rng.randint(32, 65)))
            for _ in range(n)]


def serve(torch, HK, T, S, card, n_experts=0, n_requests=16, keep=None):
    """The paged engine at the full LM width (MoE blocks when
    ``n_experts``) answering ``n_requests`` requests through kernels 5
    and 6, every emitted token held against a teacher-forced plain pass;
    the decode step alone timed.  Returns the kernels' launches; ``keep``
    (a dict) gets the requests, their tokens, tokens/s and the step's
    ms (phase 18 holds its runs against them)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import moe
    cfg = LM_CONFIG
    began = t0 = time.monotonic()
    host = T.init_transformer_params(
        prng.RandomGenerator("init", SEED), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg["n_layers"], max_len=cfg["max_len"],
        n_experts=n_experts)
    engine = S.LMEngine(host, cfg["n_heads"], cfg["max_len"], slots=8,
                        paged_kv=True, prefill_chunk=32, device="cuda",
                        name="chip_smoke")
    engine.start()
    setup_s = time.monotonic() - t0
    reqs = serve_requests(cfg["vocab"], n_requests)
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
    # the teacher-forced pass's routing (MoE): its smallest top-1/top-2
    # margin says how near a tie any token's expert choice sat
    routes = MoeRouting(torch, moe)
    with torch.inference_mode(), routes:
        for (prompt, _), out in zip(reqs, outs):
            seq = numpy.concatenate([prompt, out])
            short, n_exact = teacher_forced(torch, T, engine, seq,
                                            len(prompt), out)
            worst = max(worst, short)
            exact += n_exact
            total += len(out)
    with torch.inference_mode():
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
    report = {"phase": "moe_serve" if n_experts else "serve", "card": card,
              "config": dict(cfg, n_experts=n_experts),
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
                                 "tolerance": LOGIT_TOL,
                                 "min_router_margin": routes.min_margin()},
              "phase_s": time.monotonic() - began}
    print(json.dumps(report), flush=True)
    if keep is not None:
        keep.update(requests=reqs, outs=outs, tokens_per_s=tokens / wall,
                    step_ms=step_ms, busy=busy)
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


def _max_gap(a, b):
    """max |a - b| over two host arrays, in their type (the value
    numpy's ``abs(a - b).max()`` gives) on torch's host threads."""
    import torch
    return float(torch.from_numpy(numpy.asarray(a)).sub(
        torch.from_numpy(numpy.asarray(b))).abs_().max())


def movements(cpu):
    """Per committed update after the first and per layer: the run's
    movement max |w - w0| over weights and bias."""
    return [[max(_max_gap(a, b) for a, b in zip(x, y))
             for x, y in zip(cpu[k], cpu[0])] for k in range(1, len(cpu))]


def weight_gaps(card, cpu, moved=None):
    """Per committed update (after the first, ..., the last) and per
    layer: the max |card - CPU| gap over weights and bias ("abs"), the
    CPU run's movement max |w - w0| ("movement", or ``moved`` when the
    caller has it: :func:`movements` of ``cpu``), and the gap as a share
    of the movement ("share")."""
    out = {"abs": [], "movement": moved or movements(cpu), "share": []}
    for k in range(1, len(cpu)):
        gaps = [max(_max_gap(a, b) for a, b in zip(x, y))
                for x, y in zip(card[k], cpu[k])]
        out["abs"].append(gaps)
        out["share"].append([g / m for g, m in
                             zip(gaps, out["movement"][k - 1])])
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
    return launches, steady


# ------------------------------------------------------------------ the zoo
@contextlib.contextmanager
def update_sizes(F):
    """Within the block, the number of tensors each fused update call
    (``F.sgd_update_multi``, one kernel launch on the card) takes."""
    inner, sizes = F.sgd_update_multi, []

    def counted(items, *rest):
        sizes.append(len(items))
        return inner(items, *rest)

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


#: phase 8: stochastic pooling at CIFAR's first pooling input (minibatch
#: 100, 32x32, the sample's 32 kernels), card against the CPU; two scores
#: closer than this may swap (the gumbel's 4e-6, plus a few ulps of log p)
POOL_SHAPE, POOL_TIE = (100, 32, 32, 32), 1e-5
#: the two-step train: CIFAR's first conv and a stochastic pooling layer
POOL_TRAIN = {
    "loader": {"minibatch_size": 100, "n_train": 200, "n_valid": 100},
    "decision": {"max_epochs": 1, "fail_iterations": 50},
    "layers": [
        {"type": "conv_str", "n_kernels": 32, "kx": 5, "ky": 5,
         "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9,
         "weights_filling": "gaussian", "weights_stddev": 0.05},
        {"type": "stochastic_pooling", "kx": 2, "ky": 2},
        {"type": "stochastic_abs_pooling", "kx": 2, "ky": 2},
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": 0.02, "momentum": 0.9}]}


def stochastic_pool_check(torch, HK, F, card, device="cuda"):
    """Stochastic and stochastic-abs pooling on the card against the CPU
    with the same key: positions and outputs equal but at counted near
    ties, eval within 1e-5, the backward equal (near-tie windows' errors
    zeroed on both sides); then a two-step train of a small conv
    workflow with both layers, finite losses, one SGD launch a step.
    Plain PyTorch (the reference leaves the draw to XLA): no kernel."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import cifar
    began = time.monotonic()
    rs = numpy.random.RandomState(SEED)
    x = rs.randn(*POOL_SHAPE).astype(numpy.float32)
    err = rs.randn(POOL_SHAPE[0], POOL_SHAPE[1] // 2, POOL_SHAPE[2] // 2,
                   POOL_SHAPE[3]).astype(numpy.float32)
    key = prng.PRNGKey(SEED)
    cases = []
    for use_abs in (False, True):
        runs = {}
        for dev in (device, "cpu"):
            xt = torch.as_tensor(x, device=dev)
            y, idx = F.stochastic_pooling(xt, (2, 2), (2, 2), key, True,
                                          use_abs)
            ye, _ = F.stochastic_pooling(xt, (2, 2), (2, 2), None, False,
                                         use_abs)
            runs[dev] = (xt, y, idx, ye)
        xc, yc, ic, ec = runs["cpu"]
        # the CPU's scores, for the near ties
        patches = F._pool_patches(xc, (2, 2), (2, 2))
        weights = patches.abs() if use_abs else patches.clamp(min=0.0)
        total = weights.sum(dim=3, keepdim=True)
        probs = torch.where(total > 0, weights / total.clamp(min=1e-30),
                            torch.full_like(total, 0.25))
        k0, k1 = (int(w) for w in key)
        g = prng.gumbel_tensor(prng.bits_words(k0, k1, torch.arange(
            probs.numel(), dtype=torch.int64))).reshape(probs.shape)
        top = (probs.clamp(min=1e-30).log() + g).topk(2, dim=3).values
        near = (top[:, :, :, 0] - top[:, :, :, 1] < POOL_TIE).numpy()
        xd, yd, idd, ed = runs[device]
        far = ~near
        idx_card, idx_cpu = idd[:, :, :, 0].cpu().numpy(), ic[:, :, :, 0].numpy()
        y_card = yd.cpu().numpy()
        e = err.copy()
        e[near] = 0.0
        gd = F.stochastic_pooling_backward(
            xd, torch.as_tensor(e, device=device), idd, (2, 2)).cpu().numpy()
        gc = F.stochastic_pooling_backward(
            xc, torch.as_tensor(e), ic, (2, 2)).numpy()
        case = {"use_abs": use_abs, "shape": list(POOL_SHAPE),
                "windows": int(near.size), "near_ties": int(near.sum()),
                "positions_differing": int((idx_card != idx_cpu)[far].sum()),
                "outputs_differing": int((y_card != yc.numpy())[far].sum()),
                "eval_max_abs": float(numpy.abs(
                    ed.cpu().numpy() - ec.numpy()).max()),
                "backward_max_abs": float(numpy.abs(gd - gc).max())}
        cases.append(case)
        check(case["positions_differing"] == 0
              and case["outputs_differing"] == 0
              and case["eval_max_abs"] <= 1e-5
              and case["backward_max_abs"] == 0.0,
              "stochastic pooling card vs CPU: %r" % case)
    # the two-step train of a small conv workflow with both layers
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("cifar", None)
    root.cifar.update(POOL_TRAIN)
    HK.reset_launch_counts()
    wf = cifar.build(fused=True)
    wf.initialize(device=device)
    wf.run()
    [epoch] = wf.decision.epoch_metrics
    sgd = HK.launch_counts()["fused_sgd_update"]
    root.__dict__.pop("cifar", None)
    train = {"train_count": epoch["train"]["count"],
             "train_loss": epoch["train"]["loss"],
             "validation_loss": epoch["validation"]["loss"],
             "sgd_launches": sgd}
    check(train["train_count"] == 200
          and numpy.isfinite(train["train_loss"])
          and numpy.isfinite(train["validation_loss"]) and sgd == 2,
          "stochastic pooling train: %r" % train)
    del wf
    gc_cuda(torch)
    print(json.dumps({"phase": "stochastic_pooling", "card": card,
                      "tie": POOL_TIE, "cases": cases, "train": train,
                      "phase_s": time.monotonic() - began}), flush=True)


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


# ------------------------------------------------------------------ harness
#: the harness phase's MNIST-FC: configs[0]'s widths (784→100 tanh→10
#: softmax, minibatch 100, 10,000 validation) for 3 epochs, the train set
#: cut from 60,000 to 9,950 so that each epoch ends in a short minibatch
#: (50 live rows: a frozen inv_batch shows there)
HARNESS_MNIST_TRAIN = 9950
HARNESS_MNIST = ["root.mnist.loader.n_train=%d" % HARNESS_MNIST_TRAIN,
                 "root.mnist.decision.max_epochs=3"]
#: the exp policy run: every layer's rate decays 0.9995 a step
HARNESS_POLICY = ("root.mnist.layers=[{'type': 'all2all_tanh', "
                  "'output_sample_shape': 100, 'learning_rate': 0.03, "
                  "'momentum': 0.9, 'lr_policy': {'policy': 'exp', "
                  "'gamma': 0.9995}}, {'type': 'softmax', "
                  "'output_sample_shape': 10, 'learning_rate': 0.03, "
                  "'momentum': 0.9, 'lr_policy': {'policy': 'exp', "
                  "'gamma': 0.9995}}]")
#: scan vs loop: losses within this relative gap (the metric sums are
#: the same reduction, so they are expected equal)
HARNESS_LOSS_RTOL = 1e-6
#: grad_accum=4 against the monolithic step: the CPU tests' tolerance
#: (tests/test_torch_epoch_scan.py::test_accum_step_matches_monolithic)
ACCUM_RTOL, ACCUM_ATOL = 1e-5, 1e-6
#: cifar (configs[1]) at the sample's defaults but 2 epochs and 4,950
#: train samples (a short last minibatch)
HARNESS_CIFAR = 4950
#: AlexNet on the synthetic set: 600 train (4 full minibatches of 128 and
#: one of 88) / 128 validation, 2 epochs
HARNESS_ALEXNET = {"n_train": 600, "n_valid": 128}
#: AlexNet card vs CPU scan: minibatch 16, 40 train (2 full minibatches
#: and one of 8), 1 epoch; every train step's weights compared
HARNESS_ALEXNET_SMALL = {"minibatch_size": 16, "n_train": 40,
                         "n_valid": 16}
#: the record-file leg: the records phase's full set cut to 1,208 train
#: (9 full minibatches and one of 56) / 256 validation, windows of 4
HARNESS_RECORDS = (256, 1208)
HARNESS_WINDOW = 4
HARNESS_FAULTS = ("inv_batch_frozen", "key_not_folded",
                  "policy_step_plus_1", "snapshot_drops_velocities")


@contextlib.contextmanager
def harness_fault(name):
    """Within the block, ``name`` of ``HARNESS_FAULTS`` is planted in the
    epoch scan or the snapshotter."""
    from veles_tpu_torch import compiled, epoch_driver
    from veles_tpu_torch.ops.nn_units import GradientDescentBase
    if name == "inv_batch_frozen":
        cls, attr = compiled.ScanProgram, "operand_tables"
        inner = cls.operand_tables

        def planted(self, ops_list):
            scal, keys, crops = inner(self, ops_list)
            scal[:, 1] = scal[0, 1]          # the value at capture
            return scal, keys, crops
    elif name == "key_not_folded":
        cls, attr = epoch_driver.EpochScanDriver, "_operands"
        inner = cls._operands

        def planted(self, mask, step0, key, window=None):
            out = inner(self, mask, step0, key, window)
            if key is not None and not window:
                for ops in out:
                    ops.keys = [self.runner._stochastic_keys(key)]
            return out
    elif name == "policy_step_plus_1":
        cls, attr = epoch_driver.EpochScanDriver, "_operands"
        inner = cls._operands

        def planted(self, mask, step0, key, window=None):
            return inner(self, mask, step0 + 1, key, window)
    else:
        cls, attr = GradientDescentBase, "snapshot_attrs"
        inner = cls.snapshot_attrs
        planted = tuple(a for a in inner if not a.startswith("velocity"))
    setattr(cls, attr, planted)
    try:
        yield
    finally:
        setattr(cls, attr, inner)


def cli_run(argv, sample="mnist", config=None):
    """One CLI run in this process (``veles_tpu_torch.__main__.main``),
    from a fresh PRNG and config subtree (``config`` installed first);
    returns (workflow, launcher)."""
    from veles_tpu_torch import __main__ as cli, prng
    from veles_tpu_torch.config import root
    prng.reset()
    root.__dict__.pop(sample, None)
    if config:
        getattr(root, sample).update(config)
    check(cli.main(list(argv)) == 0, "CLI run %r failed" % (argv,))
    return cli.main.workflow, cli.main.launcher


def wf_params(wf):
    """Every parameterized layer's weights, bias and velocities (host)."""
    wf._fused_runner.sync_to_units()
    return [numpy.array(v.mem) for f, g in zip(wf.forwards, wf.gds)
            if f.has_params for v in (f.weights, f.bias,
                                      g.velocity_weights, g.velocity_bias)]


def snap_params(path, wf):
    """The same arrays as ``wf_params`` from a snapshot file, for the
    layers of ``wf``."""
    from veles_tpu_torch import snapshotter
    units = snapshotter.import_(path)["state"]["units"]
    return [units[u.name][attr][1] for f, g in zip(wf.forwards, wf.gds)
            if f.has_params for u, attr in ((f, "weights"), (f, "bias"),
                                            (g, "velocity_weights"),
                                            (g, "velocity_bias"))]


def bit_equal(a, b):
    return len(a) == len(b) and all(numpy.array_equal(x, y)
                                    for x, y in zip(a, b))


def metric_rows(epoch_metrics):
    return [{s: {k: m[s][k] for k in ("n_err", "loss")} for s in m}
            for m in epoch_metrics]


def same_run_metrics(a, b, rtol=HARNESS_LOSS_RTOL):
    """Equal n_err in every set and epoch, losses within ``rtol``."""
    return len(a) == len(b) and all(
        ma.keys() == mb.keys() and all(
            ma[s]["n_err"] == mb[s]["n_err"]
            and abs(ma[s]["loss"] - mb[s]["loss"])
            <= rtol * max(abs(mb[s]["loss"]), 1e-30) for s in ma)
        for ma, mb in zip(a, b))


def window_steps(torch, step, n):
    """(ms a step, card busy share) of ``n`` steps enqueued back to back
    and waited for once: the host clock over the window, and the union
    of the profiler's kernel intervals over the profiled window's wall
    time (None when the trace holds no kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return ms, (busy / wall_us if end is not None else None)


def loop_vs_scan_steps(torch, loop_wf, scan_launcher, n):
    """One train step of the graph loop (its key drawn and host operands
    built, then the fused step, eager) against one replay of the scan's
    captured step, ``n`` of each: ms, samples/s and busy share.  The
    loop's step reruns its last minibatch; the replays restart the scan's
    tables at row 0 and write its scratch buffers (the run is over)."""
    from veles_tpu_torch import prng
    runner = loop_wf._fused_runner
    x, y, mask, ops = runner._last_train_args
    mb = x.shape[0]

    def loop_step():
        key = (prng.get("dropout").key() if runner._has_stochastic
               else None)
        runner._step(runner.state, x, y, mask, runner.host_operands(
            ops.batch_size, ops.step, key))

    loop_ms, loop_busy = window_steps(torch, loop_step, n)
    program = scan_launcher.driver.program
    left = [0]

    def replay():
        if left[0] == 0:
            program.train.t.zero_()
            left[0] = program.train.rows
        program.replay_train()
        left[0] -= 1

    scan_ms, scan_busy = window_steps(torch, replay, n)
    return {"loop": {"ms": loop_ms, "samples_per_s": mb / loop_ms * 1e3,
                     "busy_share": loop_busy},
            "scan": {"ms": scan_ms, "samples_per_s": mb / scan_ms * 1e3,
                     "busy_share": scan_busy},
            "steps": n, "minibatch": mb}


def alexnet_launches(wf):
    """The launch formula of an ImageNet-sample run ``wf``: per train
    step each LRN layer's forward and backward, each dropout layer's
    two launches and one fused SGD launch; each LRN forward again per
    validation minibatch (AlexNet: 2, 2, 4, 1 and 2)."""
    steps = wf.fused_step.train_steps
    ld = wf.loader
    valid_mbs = len(wf.decision.epoch_metrics) * -(
        -ld.class_lengths[1] // ld.max_minibatch_size)
    n_lrn = sum(1 for f in wf.forwards if f.layer_type == "norm")
    n_drop = sum(1 for f in wf.forwards if f.layer_type == "dropout")
    return {"lrn_forward": n_lrn * (steps + valid_mbs),
            "lrn_backward": n_lrn * steps, "dropout": 2 * n_drop * steps,
            "fused_sgd_update": steps}


def scan_step_weights(torch, argv, config):
    """A CLI epoch-scan run of the ImageNet sample whose every train
    step's weights are kept: [initial, after step 1, ...] as
    ``committed_weights`` gives them (the last step's too, which the
    completion gate then drops)."""
    from veles_tpu_torch.compiled import ScanProgram
    kept, inner = [], ScanProgram.replay_train

    def grab(program):
        kept.append([[e[k].cpu().numpy().copy() for k in ("w", "b")
                      if k in e] for e in program.state if e])

    def replay_train(self, data_at=0):
        if not kept:
            grab(self)
        inner(self, data_at)
        grab(self)

    ScanProgram.replay_train = replay_train
    try:
        cli_run(argv + ["--epoch-scan", "1"], "imagenet", config)
    finally:
        ScanProgram.replay_train = inner
    return kept


def harness(torch, HK, card, device="cuda", keep=None):
    """Phase 11: the run harness through the CLI (see the module
    docstring); returns the kernels' launch counts of its runs.  The
    full-width AlexNet loop and scan runs' weights and epoch metrics go
    into ``keep`` (the parallel phase holds its runs against them)."""
    import os
    import shutil
    import tempfile
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import imagenet, mnist
    began = time.monotonic()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="veles_harness_")
    dev = [] if device == "cuda" else ["-d", device]
    base = (["veles_tpu_torch.samples.mnist", "--random-seed", str(SEED),
             "--no-stats"] + dev + HARNESS_MNIST)
    launches, checks, faults, report = {}, {}, {}, {"card": card}
    legs, mark = {}, [began]

    def leg(name):
        """The seconds since the previous leg, kept under ``name``."""
        now = time.monotonic()
        legs[name] = now - mark[0]
        mark[0] = now

    def counted(fn):
        """fn() with the kernels' counts of its run: (result, counts)."""
        HK.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = HK.launch_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return out, counts

    def resumed(src_dir, extra):
        """A run resumed at epoch 1 from ``src_dir``'s epoch-1 snapshot
        through ``--snapshot auto``."""
        first = [n for n in os.listdir(src_dir) if n.startswith("mnist_1_")]
        d = tempfile.mkdtemp(dir=tmp)
        shutil.copyfile(os.path.join(src_dir, first[0]),
                        os.path.join(d, "mnist_current.pickle.gz"))
        wf, la = cli_run(base + extra + ["--snapshot", "auto",
                                         "--snapshot-dir", d])
        check(la.restored_payload["epoch"] == 1, "resumed at epoch %r"
              % la.restored_payload["epoch"])
        return wf

    try:
        # MNIST-FC: the graph loop through `python -m veles_tpu_torch`,
        # read back from its result file and its snapshots
        d_loop = os.path.join(tmp, "loop")
        result = os.path.join(tmp, "loop.json")
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "veles_tpu_torch"] + base + [
                "--snapshot-dir", d_loop, "--result-file", result],
            cwd=repo, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=repo))
        loop_cli_s = time.monotonic() - t0
        check(proc.returncode == 0, "python -m veles_tpu_torch failed:\n%s"
              % proc.stderr[-3000:])
        with open(result, encoding="utf-8") as f:
            summary = json.load(f)
        final = os.path.join(d_loop, "mnist_3_%g.pickle.gz"
                             % summary["best_metric"])
        check(os.path.exists(final), "no epoch-3 snapshot %s" % final)

        # the scan, chunk 1 (with snapshots) and chunk 3
        d_scan = os.path.join(tmp, "scan")
        (scan1, la1), counts = counted(lambda: cli_run(
            base + ["--epoch-scan", "1", "--snapshot-dir", d_scan]))
        scan3, _ = cli_run(base + ["--epoch-scan", "3"])
        from veles_tpu_torch import snapshotter
        state = snapshotter.import_(final)["state"]["units"]
        w_loop = snap_params(final, scan1)
        m_loop = metric_rows(state["decision"]["epoch_metrics"])
        checks["result_file_read_back"] = (
            summary["best_epoch"] == state["decision"]["best_epoch"]
            and summary["last_epoch_metrics"]["validation"]["n_err"]
            == m_loop[-1]["validation"]["n_err"])
        checks["scan1_equals_loop"] = bit_equal(wf_params(scan1), w_loop)
        checks["scan3_equals_loop"] = bit_equal(wf_params(scan3), w_loop)
        checks["scan_metrics_equal_loop"] = all(
            same_run_metrics(metric_rows(wf.decision.epoch_metrics),
                             m_loop) for wf in (scan1, scan3))
        checks["scan_launches_exact"] = (
            counts["fused_sgd_update"] == scan1.fused_step.train_steps
            == state["fused_step"]["train_steps"]
            == 3 * -(-scan1.loader.class_lengths[2] // 100))
        program = la1.driver.program
        report["mnist"] = {
            "config": {"layers": "784-100tanh-10softmax", "minibatch": 100,
                       "n_train": HARNESS_MNIST_TRAIN, "n_valid": 10000,
                       "epochs": 3},
            "loop_cli_s": loop_cli_s, "scan_run_s": la1.run_seconds,
            "capture_s": program.capture_s,
            "graph_launches": {repr(k): v for k, v in
                               program.graph_launches.items()},
            "replays": {repr(k): v for k, v in program.replays.items()},
            "launches": counts,
            "validation": [m["validation"] for m in m_loop]}

        # the exp lr policy, loop and scan
        pol_loop, pla = cli_run(base + [HARNESS_POLICY])
        pol_scan, _ = cli_run(base + [HARNESS_POLICY, "--epoch-scan", "1"])
        w_pol = wf_params(pol_loop)
        checks["policy_scan_equals_loop"] = bit_equal(wf_params(pol_scan),
                                                      w_pol)
        checks["policy_moves_training"] = not bit_equal(w_pol, w_loop)
        report["mnist"]["loop_run_s"] = pla.run_seconds

        # resume at epoch 1 through --snapshot auto, both drivers
        checks["resume_loop_bit_equal"] = bit_equal(
            wf_params(resumed(d_loop, [])), w_loop)
        checks["resume_scan_bit_equal"] = bit_equal(
            wf_params(resumed(d_scan, ["--epoch-scan", "1"])),
            wf_params(scan1))

        # --evaluate from the final snapshot: the weights do not move
        ev, _ = cli_run(base + ["--snapshot", final, "--evaluate"])
        checks["evaluate_keeps_weights"] = bit_equal(wf_params(ev), w_loop)

        # grad_accum=4 against the monolithic step at full width
        steps = []
        for accum in (1, 4):
            prng.reset()
            prng.seed_all(SEED)
            root.__dict__.pop("mnist", None)
            mnist.default_config()
            wf = mnist.build(fused=True, grad_accum=accum)
            wf.initialize(device=None if device == "cuda" else device)
            runner, ld = wf._fused_runner, wf.loader
            x = ld.original_data.devmem[:100]
            y = ld.original_labels.devmem[:100]
            steps.append(runner._train_step(
                runner.state, x, y, torch.ones(100, device=x.device), 100))
        (s1, m1), (s4, m4) = steps
        excess = max(float(((a[k] - b[k]).abs() - ACCUM_RTOL
                            * b[k].abs()).max())
                     for a, b in zip(s4, s1) for k in a)
        checks["grad_accum_within_tolerance"] = (
            excess <= ACCUM_ATOL and int(m1["n_err"]) == int(m4["n_err"]))
        report["mnist"]["grad_accum_max_excess_over_rtol"] = excess

        # planted faults: each must break its check
        with harness_fault("inv_batch_frozen"):
            bad, _ = cli_run(base + ["--epoch-scan", "1"])
        faults["inv_batch_frozen"] = not bit_equal(wf_params(bad), w_loop)
        with harness_fault("policy_step_plus_1"):
            bad, _ = cli_run(base + [HARNESS_POLICY, "--epoch-scan", "1"])
        faults["policy_step_plus_1"] = not bit_equal(wf_params(bad), w_pol)
        with harness_fault("snapshot_drops_velocities"):
            d_bad = os.path.join(tmp, "bad")
            cli_run(base + ["--epoch-scan", "1", "--snapshot-dir", d_bad])
            bad = resumed(d_bad, ["--epoch-scan", "1"])
        faults["snapshot_drops_velocities"] = not bit_equal(
            wf_params(bad), wf_params(scan1))
        report["mnist"]["steady"] = loop_vs_scan_steps(torch, pol_loop,
                                                       la1, 200)
        report["mnist"]["measure_device_step_time_ms"] = (
            scan1._fused_runner.measure_device_step_time(20) * 1e3)
        leg("mnist")

        # cifar (configs[1]): loop and scan
        cifar_argv = ["veles_tpu_torch.samples.cifar", "--random-seed",
                      str(SEED), "--no-stats",
                      "root.cifar.decision.max_epochs=2",
                      "root.cifar.loader.n_train=%d" % HARNESS_CIFAR] + dev
        c_loop, cla = cli_run(cifar_argv, "cifar")
        (c_scan, csa), counts = counted(lambda: cli_run(
            cifar_argv + ["--epoch-scan", "1"], "cifar"))
        checks["cifar_scan_equals_loop"] = (
            bit_equal(wf_params(c_scan), wf_params(c_loop))
            and same_run_metrics(metric_rows(c_scan.decision.epoch_metrics),
                                 metric_rows(c_loop.decision.epoch_metrics)))
        checks["cifar_launches_exact"] = (counts["fused_sgd_update"]
                                          == c_scan.fused_step.train_steps)
        report["cifar"] = {
            "config": {"n_train": HARNESS_CIFAR, "n_valid": 10000,
                       "minibatch": 100, "epochs": 2},
            "loop_run_s": cla.run_seconds, "scan_run_s": csa.run_seconds,
            "capture_s": csa.driver.program.capture_s, "launches": counts,
            "steady": loop_vs_scan_steps(torch, c_loop, csa, 100)}
        leg("cifar")

        # AlexNet at full width on the synthetic set: the scan, a seeded
        # rerun, the loop
        alex = {"loader": dict({"minibatch_size": 128, "records_path": None,
                                "image_hw": (256, 256), "n_classes": 1000},
                               **HARNESS_ALEXNET),
                "decision": {"max_epochs": 2, "fail_iterations": 10},
                "layers": imagenet.alexnet_layers()}
        alex_argv = ["veles_tpu_torch.samples.imagenet", "--random-seed",
                     str(SEED), "--no-stats"]
        (a_scan, asa), counts = counted(lambda: cli_run(
            alex_argv + dev + ["--epoch-scan", "1"], "imagenet", alex))
        a_again, _ = cli_run(alex_argv + dev + ["--epoch-scan", "1"],
                             "imagenet", alex)
        a_loop, ala = cli_run(alex_argv + dev, "imagenet", alex)
        checks["alexnet_scan_rerun_bit_equal"] = bit_equal(
            wf_params(a_scan), wf_params(a_again))
        if keep is not None:
            keep["alexnet"] = {
                "argv": alex_argv + dev, "config": alex,
                "loop": (wf_params(a_loop), a_loop.decision.epoch_metrics),
                "scan": (wf_params(a_scan), a_scan.decision.epoch_metrics)}
        want = alexnet_launches(a_scan)
        checks["alexnet_launches_exact"] = all(counts[k] == v
                                               for k, v in want.items())
        # card vs the port's CPU scan at minibatch 16, every train step
        small = dict(alex, loader=dict(alex["loader"],
                                       **HARNESS_ALEXNET_SMALL),
                     decision={"max_epochs": 1, "fail_iterations": 10})
        leg("alexnet_runs")
        on_card = scan_step_weights(torch, alex_argv + dev, small)
        on_cpu = scan_step_weights(torch, alex_argv + ["-d", "cpu"], small)
        with harness_fault("key_not_folded"):
            bad = scan_step_weights(torch, alex_argv + dev, small)
        leg("alexnet_card_vs_cpu")
        under_pool = [any(g.layer_type == "max_pooling"
                          for g in a_scan.forwards[i + 1:])
                      for i, f in enumerate(a_scan.forwards) if f.has_params]
        limits = [ALEXNET_CONV_SHARE if u else ALEXNET_FC_SHARE
                  for u in under_pool]

        def within(gaps):
            return (all(g <= lim for g, lim in zip(gaps["share"][0], limits))
                    and max(gaps["share"][2]) <= ALEXNET_DRIFT_SHARE)

        sound, planted = (weight_gaps(on_card, on_cpu),
                          weight_gaps(bad, on_cpu))
        checks["alexnet_card_vs_cpu_within_limits"] = within(sound)
        faults["key_not_folded"] = not within(planted)
        report["alexnet"] = {
            "config": dict(HARNESS_ALEXNET, minibatch=128, epochs=2,
                           layers="alexnet_layers()"),
            "loop_run_s": ala.run_seconds, "scan_run_s": asa.run_seconds,
            "capture_s": asa.driver.program.capture_s, "launches": counts,
            "graph_launches": {repr(k): v for k, v in
                               asa.driver.program.graph_launches.items()},
            "card_vs_cpu": {"minibatch": 16, "steps": len(on_cpu) - 1,
                            "first_update_limits": limits,
                            "third_update_limit": ALEXNET_DRIFT_SHARE,
                            "share": sound["share"],
                            "fault_key_not_folded_share": planted["share"]},
            "steady": loop_vs_scan_steps(torch, a_loop, asa, 10)}
        leg("alexnet_steady")

        # AlexNet from a record file, streamed in windows of 4
        files = write_record_set(tmp, "harness", *HARNESS_RECORDS)
        rec_argv = (["veles_tpu_torch.samples.imagenet", "--random-seed",
                     str(SEED), "--no-stats",
                     "root.imagenet.loader.records_path=%s" % files[0],
                     "root.imagenet.loader.mean_path=%s" % files[1],
                     "root.imagenet.decision.max_epochs=2"] + dev)
        window = ["--stream-window", str(HARNESS_WINDOW)]
        (r1, rla), counts = counted(lambda: cli_run(rec_argv + window,
                                                    "imagenet"))
        r2, _ = cli_run(rec_argv + window + ["--stage-ahead", "2"],
                        "imagenet")
        checks["records_stream_stage_ahead_invariant"] = bit_equal(
            wf_params(r1), wf_params(r2))
        want = alexnet_launches(r1)
        checks["records_launches_exact"] = all(counts[k] == v
                                               for k, v in want.items())
        # the parity tests/test_streaming.py pins, on this record file: a
        # network with no stochastic layer streams bit-equal to the loop
        dense = ("root.imagenet.layers=[{'type': 'all2all_tanh', "
                 "'output_sample_shape': 64, 'learning_rate': 0.01, "
                 "'momentum': 0.9}, {'type': 'softmax', "
                 "'output_sample_shape': 1000, 'learning_rate': 0.01, "
                 "'momentum': 0.9}]")
        streamed, _ = cli_run(rec_argv + window + [dense], "imagenet")
        looped, _ = cli_run(rec_argv + [dense], "imagenet")
        checks["records_stream_equals_loop"] = bit_equal(
            wf_params(streamed), wf_params(looped))
        report["records"] = {
            "config": {"n_valid": HARNESS_RECORDS[0],
                       "n_train": HARNESS_RECORDS[1], "minibatch": 128,
                       "window": HARNESS_WINDOW, "epochs": 2},
            "run_s": rla.run_seconds, "stream_stats": r1._stream_stats,
            "capture_s": rla.driver.program.capture_s, "launches": counts}
        leg("records")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        prng.reset()
        for name in ("mnist", "cifar", "imagenet"):
            root.__dict__.pop(name, None)
    report.update(checks=checks, faults_caught=faults, launches=launches,
                  leg_s=legs, phase_s=time.monotonic() - began)
    print(json.dumps({"harness": report}, default=str), flush=True)
    failed = [k for k, v in checks.items() if not v]
    check(not failed, "harness checks failed: %s" % failed)
    missed = [k for k in HARNESS_FAULTS if not faults.get(k)]
    check(not missed, "planted harness faults passed their checks: %s"
          % missed)
    return launches


# ---------------------------------------------------------------- parallel
#: the parallel phase: full-width AlexNet (configs[4]'s model) at
#: minibatch 128 on the seeded 256x256 synthetic images.  (b) two gloo
#: ranks sharing cuda:0 train data-parallel through the launcher, 64 rows
#: a rank, 2 epochs of 384 train = 6 steps
PARALLEL_DP = {"n_train": 384, "n_valid": 128}
PARALLEL_DP_STEPS = 6
#: (c) tensor parallelism of the two 4096-wide FC layers and (e) the
#: planted faults: steps from the initial state on fixed global batches
PARALLEL_STEPS = 3
PARALLEL_FAULTS = ("all_reduce_skipped", "dropout_offset_zero_rank1",
                   "tp_input_grad_not_reduced")
#: (d) the record file sharded two ways: (validation, train) 256x256
#: images, minibatch 128, one epoch's minibatches compared
PARALLEL_RECORDS = (64, 256)
#: steady steps timed a run
PARALLEL_TIMED_STEPS = 5


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def host_weights(state):
    """Each parameterized layer's (weights, bias) on the host."""
    return [[e[k].detach().cpu().numpy().copy() for k in ("w", "b")
             if k in e] for e in state if e]


def weight_digest(state):
    """crc32 over every layer's weights and bias bits."""
    import zlib
    crc = 0
    for e in state:
        for k in ("w", "b"):
            if k in e:
                crc = zlib.crc32(e[k].detach().cpu().numpy().tobytes(), crc)
    return crc


@contextlib.contextmanager
def parallel_fault(name, rank):
    """Within the block, ``name`` of ``PARALLEL_FAULTS`` is planted: the
    gradient all-reduce skipped, rank 1's dropout drawn at element
    offset 0, or a split layer's input gradient not reduced."""
    from veles_tpu_torch import parallel
    from veles_tpu_torch.ops import functional as F
    if name == "dropout_offset_zero_rank1":
        mod, attr, inner = F, "dropout", F.dropout

        def planted(x, rng, rate, train):
            if rank == 1 and isinstance(rng, F.RowShard):
                rng = rng[0]
            return inner(x, rng, rate, train)
    else:
        mod = parallel
        attr = ("grad_all_reduce" if name == "all_reduce_skipped"
                else "tp_input_grad_all_reduce")
        inner = getattr(parallel, attr)

        def planted(*args):
            return None
    setattr(mod, attr, planted)
    try:
        yield
    finally:
        setattr(mod, attr, inner)


class SplitReference:
    """The plain single-process version of two ranks' arithmetic, set as
    the runner's hook (``runner.shard``) with no collective: as two data
    ranks (:meth:`dp_step`: each half of the rows with its rank's draws,
    the two gradient sums added in rank order) or as two model ranks
    (``split`` dense layers: each column half's product, concatenated;
    each half's partial input gradient, added in rank order)."""

    def __init__(self, runner, split=()):
        self.runner = runner
        self.split = {i: None for i in split}
        self.rank = None

    def layer_rngs(self, rngs):
        from veles_tpu_torch.ops import functional as F
        if self.rank is None:
            return rngs
        return [k if k is None or isinstance(k, F.CropDraws)
                else F.RowShard((k, self.rank, 2)) for k in rngs]

    @staticmethod
    def _halves(entry):
        h = entry["w"].shape[-1] // 2
        return [{k: v[..., lo:lo + h].contiguous() for k, v in entry.items()}
                for lo in (0, h)], h

    def tp_forward(self, i, fwd, x, entry, rng, train):
        import torch
        from veles_tpu_torch.ops import functional as F
        halves, _ = self._halves(entry)
        y = torch.cat([F.dense_forward(x, e["w"], e.get("b"),
                                       fwd.ACTIVATION) for e in halves], -1)
        return y.reshape((x.shape[0],) + tuple(fwd.output_sample_shape)), \
            None

    def tp_backward(self, i, gd, x, y, err, entry, rng, saved):
        import torch
        halves, h = self._halves(entry)
        y = y.reshape(y.shape[0], -1)
        err = err.reshape(err.shape[0], -1)
        parts = [gd.backward_fused(
            x, y[:, r * h:(r + 1) * h].contiguous(),
            err[:, r * h:(r + 1) * h].contiguous(), e, rng, saved)
            for r, e in enumerate(halves)]
        (e0, g0), (e1, g1) = parts
        err_in = None if e0 is None else e0 + e1
        return err_in, tuple(None if a is None else torch.cat([a, b], -1)
                             for a, b in zip(g0, g1))

    def reduce(self, all_grads, metrics):
        return all_grads, metrics

    def reduce_metrics(self, metrics):
        return metrics

    def step(self, state, x, y, mask, ops):
        """One train step: the runner's own (split layers) or, with no
        split, two data halves."""
        runner = self.runner
        runner.shard = self
        try:
            if self.split:
                return runner._step(state, x, y, mask, ops)[0]
            n, grads = x.shape[0] // 2, None
            for r in (0, 1):
                self.rank = r
                rows = slice(r * n, (r + 1) * n)
                g, _ = runner._grads_and_metrics(
                    state, x[rows], y[rows], mask[rows],
                    layer_rngs=runner._layer_rngs(ops, 0))
                grads = g if grads is None else [
                    None if a is None else tuple(
                        None if u is None else u + v for u, v in zip(a, b))
                    for a, b in zip(grads, g)]
            self.rank = None
            return runner._apply_updates(state, grads, ops)
        finally:
            runner.shard = None


def parallel_rank(rank, port, tmp, out_path):
    """One of the two gloo ranks sharing cuda:0 (``python3 chip_smoke.py
    --parallel-rank R PORT TMPDIR OUT``): (b) data-parallel AlexNet
    through the launcher, every step's weight digest; rank 0 also the
    single-process graph-loop run of the same seed; (c) tensor
    parallelism of the FC trunk and (e) the planted faults from one
    initial state on fixed batches, against a single-process trajectory
    (rank 0); (d) a record file sharded two ways.  Writes its report to
    ``out_path`` as JSON."""
    import os
    import torch
    from veles_tpu_torch import parallel, prng
    from veles_tpu_torch.compiled import FusedCommit, load_fused_state
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.ops import hopper_kernels as HK
    from veles_tpu_torch.samples import imagenet
    from veles_tpu_torch.workflow import Workflow
    began = time.monotonic()
    memo_draws(prng)
    addr = "127.0.0.1:%d" % port
    _, _, backend = parallel.initialize_multihost(addr, 2, rank)
    dev = parallel._JOINED["device"]
    report = {"rank": rank, "backend": backend, "device": str(dev),
              "join_s": time.monotonic() - began}
    legs, mark = {}, [time.monotonic()]

    def leg(name):
        now = time.monotonic()
        legs[name], mark[0] = now - mark[0], now
    layers = imagenet.alexnet_layers()

    # (b) data parallelism through the launcher: 6 steps, each step's
    # weights digested, the initial state kept
    digests, init = [], []
    inner = FusedCommit.run

    def commit(self):
        trainer = self.runner.wf._sharded_trainer
        pending = self.runner.wf.fused_step.pending_state is not None
        if not init:
            init.extend({k: v.clone() for k, v in e.items()}
                        for e in trainer.state)
        inner(self)
        if pending:
            digests.append(weight_digest(trainer.state))

    wf = imagenet_build(prng, root, imagenet, layers, **PARALLEL_DP)
    HK.reset_launch_counts()
    parallel.reset_collective_counts()
    FusedCommit.run = commit
    try:
        t0 = time.monotonic()
        Launcher(wf, distributed=True, coordinator_address=addr,
                 num_processes=2, process_id=rank, stats=False).boot()
        torch.cuda.synchronize()
        run_s = time.monotonic() - t0
    finally:
        FusedCommit.run = inner
    launches = HK.launch_counts()
    want = alexnet_launches(wf)
    trainer = wf._sharded_trainer
    ld = wf.loader
    report["dp"] = {
        "run_s": run_s, "train_steps": wf.fused_step.train_steps,
        "local_rows": ld.local_minibatch_size, "digests": digests,
        "launches": launches, "launches_want": want,
        "launches_exact": all(launches[k] == v for k, v in want.items()),
        "collectives": parallel.collective_counts(),
        "losses": [{s_: m[s_]["loss"] for s_ in ("validation", "train")}
                   for m in wf.decision.epoch_metrics]}

    leg("dp_launcher_run")

    # fixed global batches (train rows) and keys for (c), (e) and the
    # steady steps
    n_valid, mb = PARALLEL_DP["n_valid"], ld.max_minibatch_size
    data, labels = ld.original_data.devmem, ld.original_labels.devmem
    xs = [data[n_valid + s * mb:n_valid + (s + 1) * mb]
          for s in range(PARALLEL_STEPS)]
    ys = [labels[n_valid + s * mb:n_valid + (s + 1) * mb]
          for s in range(PARALLEL_STEPS)]
    ones = torch.ones(mb, device=dev)
    keys = [prng.fold_in(prng.PRNGKey(SEED), s)
            for s in range(PARALLEL_STEPS)]

    def dp_step():
        trainer.train_step_pending(trainer.local_rows(xs[0]),
                                   trainer.local_rows(ys[0]),
                                   trainer.local_rows(ones), mb, keys[0])

    ms, busy = window_steps(torch, dp_step, PARALLEL_TIMED_STEPS)
    n_params = sum(v.numel() for e in trainer.state for k, v in e.items()
                   if k in ("w", "b"))
    bucket = torch.zeros(n_params + 1000 * 1000 + 2, device=dev)
    group = trainer.mesh.data_group
    torch.distributed.all_reduce(bucket, group=group)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(3):
        torch.distributed.all_reduce(bucket, group=group)
    torch.cuda.synchronize()
    report["dp"].update(step_ms=ms, busy_share=busy,
                        gloo_all_reduce_ms=(time.monotonic() - t0) * 1e3 / 3,
                        bucket_floats=bucket.numel())
    del bucket

    runner = wf._fused_runner
    fc = parallel.model_shard_candidates(runner, min_width=4096)
    dp_mesh, tp_mesh = trainer.mesh, parallel.make_mesh(model_parallel=2)

    def trajectory(mesh, split):
        """PARALLEL_STEPS steps from the initial state on the fixed
        batches: each step's full weights (host)."""
        load_fused_state(wf, init)
        tr = parallel.ShardedTrainer(runner, mesh, split)
        out = [host_weights(init)]
        for s in range(PARALLEL_STEPS):
            tr.train_step(tr.local_rows(xs[s]), tr.local_rows(ys[s]),
                          tr.local_rows(ones), mb, keys[s], s)
            tr.sync_to_runner()
            out.append(host_weights(runner.state))
        return tr, out

    leg("dp_steady_and_all_reduce")
    dp = trajectory(dp_mesh, ())[1]
    tp_trainer, tp = trajectory(tp_mesh, fc)

    def tp_step():
        tp_trainer.train_step_pending(xs[0], ys[0], ones, mb, keys[0])

    tp_ms, tp_busy = window_steps(torch, tp_step, PARALLEL_TIMED_STEPS)
    report["tp"] = {"layers": fc, "local_widths": [
        int(tp_trainer.state[i]["w"].shape[-1]) for i in fc],
        "step_ms": tp_ms, "busy_share": tp_busy}
    leg("dp_tp_trajectories")
    faulty = {}
    for name in PARALLEL_FAULTS:
        with parallel_fault(name, rank):
            split = fc if name.startswith("tp_") else ()
            faulty[name] = trajectory(tp_mesh if split else dp_mesh,
                                      split)[1]

    leg("faults")

    # (d) a record file sharded two ways: each rank's device minibatch
    # against its rows of the unsharded host loader's
    if rank == 0:
        files = write_record_set(tmp, "sharded", *PARALLEL_RECORDS)
        with open(os.path.join(tmp, "files.json"), "w") as f:
            json.dump(files, f)
    torch.distributed.barrier()
    with open(os.path.join(tmp, "files.json")) as f:
        files = json.load(f)

    def records_loader(device, shard):
        prng.reset()
        prng.seed_all(SEED)
        loader = imagenet.ImagenetRecordsLoader(
            Workflow(None), path=files[0], mean_path=files[1],
            minibatch_size=mb, prefetch=True)
        if shard:
            loader.shard_spmd(rank, 2)
        loader.initialize(device=device)
        return loader

    sharded, whole = records_loader(dev, True), records_loader("cpu", False)
    rows = slice(rank * mb // 2, (rank + 1) * mb // 2)
    equal, n_mbs = True, 0
    while True:
        sharded.run()
        whole.run()
        n_mbs += 1
        equal = equal and (
            numpy.array_equal(sharded.minibatch_data.devmem.cpu().numpy(),
                              numpy.asarray(whole.minibatch_data.mem)[rows])
            and numpy.array_equal(
                sharded.minibatch_labels.devmem.cpu().numpy(),
                numpy.asarray(whole.minibatch_labels.mem)[rows])
            and numpy.array_equal(
                sharded.minibatch_mask.devmem.cpu().numpy(),
                numpy.asarray(whole.minibatch_mask.mem)[rows])
            and sharded.minibatch_size == whole.minibatch_size)
        if sharded.last_minibatch:
            break
    sharded.stop()
    whole.stop()
    report["records"] = {"minibatches": n_mbs, "bit_equal": bool(equal),
                         "local_rows": sharded.local_minibatch_size}

    # rank 0: the single-process runs the two ranks are held against:
    # the same arithmetic in one process (the same row halves, or column
    # halves, summed in rank order), and the plain step on whole rows
    if rank == 0:
        def single(hook):
            state = [dict(e) for e in init]
            out = [host_weights(init)]
            for s in range(PARALLEL_STEPS):
                ops = runner.host_operands(mb, s, keys[s])
                if hook is None:
                    runner.shard = None
                    state = runner._step(state, xs[s], ys[s], ones, ops)[0]
                else:
                    state = hook.step(state, xs[s], ys[s], ones, ops)
                out.append(host_weights(state))
            return out

        leg("records")
        alone = single(None)
        split_dp = single(SplitReference(runner))
        split_tp = single(SplitReference(runner, fc))
        report["kinks"] = kink_flips(runner, init, xs[0], keys[0], fc)
        leg("single_process_trajectories")
        under_pool = [any(g.layer_type == "max_pooling"
                          for g in wf.forwards[i + 1:])
                      for i, f in enumerate(wf.forwards) if f.has_params]
        limits = [ALEXNET_CONV_SHARE if u else ALEXNET_FC_SHARE
                  for u in under_pool]

        def within(gaps):
            return (all(g <= lim for g, lim in zip(gaps["share"][0],
                                                     limits))
                    and max(gaps["share"][-1]) <= ALEXNET_DRIFT_SHARE)

        # each reference trajectory's movement once, for every gap
        # held against it
        moved = {"dp": movements(split_dp), "tp": movements(split_tp),
                 "alone": movements(alone)}
        gaps = {"dp_split": weight_gaps(dp, split_dp, moved["dp"]),
                "tp_split": weight_gaps(tp, split_tp, moved["tp"]),
                "dp_plain": weight_gaps(dp, alone, moved["alone"]),
                "tp_plain": weight_gaps(tp, alone, moved["alone"])}
        refs = {"all_reduce_skipped": (split_dp, "dp"),
                "dropout_offset_zero_rank1": (split_dp, "dp"),
                "tp_input_grad_not_reduced": (split_tp, "tp")}
        fault_gaps = {name: weight_gaps(w, refs[name][0],
                                        moved[refs[name][1]])
                      for name, w in faulty.items()}
        report.update(
            limits={"first_update": limits,
                    "third_update": ALEXNET_DRIFT_SHARE},
            shares={k: v["share"] for k, v in gaps.items()},
            within={k: within(v) for k, v in gaps.items()},
            bit_equal_to_split={"dp": bit_equal(flat(dp), flat(split_dp)),
                                "tp": bit_equal(flat(tp), flat(split_tp))},
            fault_share={k: v["share"] for k, v in fault_gaps.items()},
            faults_caught={k: not within(v) for k, v in fault_gaps.items()})
    leg("rank0_gaps" if rank == 0 else "records")
    report["collectives"] = parallel.collective_counts()
    report["leg_s"] = legs
    report["rank_s"] = time.monotonic() - began
    with open(out_path, "w") as f:
        json.dump(report, f, default=str)
    parallel.shutdown()
    return 0


def kink_flips(runner, state, x, key, fc):
    """Where the split arithmetic turns rounding into a strict-ReLU
    kink: the first step's forward from ``state`` in one process as the
    plain 128-row chain, as two model ranks (the FC trunk in column
    halves) and as two data ranks (two 64-row halves with their ranks'
    draws); for each FC trunk layer the largest |dy| of its output
    against the plain chain's and the elements whose max(0, z) is 0 in
    one and not in the other."""
    import torch
    rngs = runner._stochastic_keys(key)
    runner.shard = None
    plain, _ = runner._forward_chain(state, x, train=True, layer_rngs=rngs)
    cols = SplitReference(runner, fc)
    runner.shard = cols
    tp, _ = runner._forward_chain(state, x, train=True, layer_rngs=rngs)
    rows = SplitReference(runner)
    runner.shard = rows
    n, halves = x.shape[0] // 2, []
    for r in (0, 1):
        rows.rank = r
        halves.append(runner._forward_chain(
            state, x[r * n:(r + 1) * n], train=True,
            layer_rngs=rows.layer_rngs(rngs))[0])
    runner.shard = None
    out = {}
    for i in fc:
        ref = plain[i + 1]
        dp = torch.cat([h[i + 1] for h in halves])
        out[str(i)] = {name: {"max_abs_dy": float((got - ref).abs().max()),
                              "relu_flips": int(((got > 0) != (ref > 0))
                                                .sum())}
                       for name, got in (("tp_cols", tp[i + 1]),
                                         ("dp_rows", dp))}
    return out


def flat(trajectory):
    """Every array of a list of per-step host weights, in order."""
    return [a for step in trajectory for layer in step for a in layer]


def dist_steps(torch, wf, launcher, n):
    """(ms, busy share) of a steady step of a distributed run: the
    trainer's graph-loop step on the last train minibatch, or one replay
    of the scan's captured step."""
    from veles_tpu_torch import prng
    if launcher.driver is None:
        trainer, ld = wf._sharded_trainer, wf.loader
        mb = ld.max_minibatch_size
        x = ld.original_data.devmem[-mb:]
        y = ld.original_labels.devmem[-mb:]
        mask = torch.ones(mb, device=x.device)
        return window_steps(torch, lambda: trainer.train_step_pending(
            x, y, mask, mb, prng.PRNGKey(SEED)), n)
    program = launcher.driver.program
    left = [0]

    def replay():
        if left[0] == 0:
            program.train.t.zero_()
            left[0] = program.train.rows
        program.replay_train()
        left[0] -= 1

    return window_steps(torch, replay, n)


def parallel_phase(torch, HK, card, keep):
    """Phase 12: data- and tensor-parallel AlexNet (see the module
    docstring); returns the kernels' launch counts of this process's
    runs."""
    import os
    import shutil
    import tempfile
    import gc
    from veles_tpu_torch import __main__ as cli, parallel
    began = time.monotonic()
    alex = keep["alexnet"]
    launches, checks, report = {}, {}, {"card": card}
    # the earlier phases' runs (and their captured graphs' memory pools)
    # go before this phase's runs and the two ranks take the card (the
    # CLI keeps its last run)
    cli.main.workflow = cli.main.launcher = None
    gc.collect()
    torch.cuda.empty_cache()

    # (a) NCCL at world 1 through the CLI: the graph loop and the scan
    # bit-equal to the harness's runs of the same command without
    # --distributed; one gradient all-reduce a train step
    dist = ["--distributed", "--num-processes", "1", "--process-id", "0",
            "--coordinator-address", "127.0.0.1:%d" % free_port()]
    runs = {}
    for name, extra in (("loop", []), ("scan", ["--epoch-scan", "1"])):
        HK.reset_launch_counts()
        parallel.reset_collective_counts()
        wf, la = cli_run(alex["argv"] + dist + extra, "imagenet",
                         alex["config"])
        torch.cuda.synchronize()
        counts, coll = HK.launch_counts(), parallel.collective_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        want = alexnet_launches(wf)
        params, metrics = alex[name]
        steps = wf.fused_step.train_steps
        checks["nccl_%s_bit_equal" % name] = (
            bit_equal(wf_params(wf), params)
            and same_metrics(wf.decision.epoch_metrics, metrics))
        checks["nccl_%s_all_reduce_per_step" % name] = (
            coll["grad_all_reduce"] == steps)
        checks["nccl_%s_launches_exact" % name] = all(
            counts[k] == v for k, v in want.items())
        checks["nccl_%s_backend" % name] = la.backend == "nccl"
        ms, busy = dist_steps(torch, wf, la, PARALLEL_TIMED_STEPS)
        runs[name] = {"backend": la.backend, "train_steps": steps,
                      "run_s": la.run_seconds, "collectives": coll,
                      "launches": counts, "step_ms": ms, "busy_share": busy}
        if la.driver is not None:
            runs[name].update(capture_s=la.driver.program.capture_s,
                              graph_launches={
                                  repr(k): v for k, v in
                                  la.driver.program.graph_launches.items()})
        del wf, la
    # the captured graphs go before the communicator they launch on, and
    # their memory back to the card before the two ranks start
    cli.main.workflow = cli.main.launcher = None
    gc.collect()
    torch.cuda.empty_cache()
    parallel.shutdown()
    report["nccl_world_1"] = runs

    # (b)-(e): two gloo ranks sharing cuda:0
    tmp = tempfile.mkdtemp(prefix="veles_parallel_")
    try:
        port = free_port()
        outs = [os.path.join(tmp, "rank%d.json" % r) for r in range(2)]
        here = os.path.abspath(__file__)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(here))
        t0 = time.monotonic()
        procs = [subprocess.Popen(
            [sys.executable, here, "--parallel-rank", str(r), str(port),
             tmp, outs[r]], env=env, cwd=os.path.dirname(here),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=600)
                errs.append((p.returncode, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.monotonic() - t0
        for code, err in errs:
            check(code == 0, "a parallel rank failed:\n%s" % err[-4000:])
        ranks = []
        for path in outs:
            with open(path, encoding="utf-8") as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0, r1 = ranks
    steps = r0["dp"]["train_steps"]
    checks["gloo_backend_on_one_card"] = all(
        r["backend"] == "gloo" and r["device"] == "cuda:0" for r in ranks)
    # the completion gate drops the stopping epoch's last update: 5
    # commits of 6 steps
    checks["dp_ranks_bit_equal_every_step"] = (
        steps == PARALLEL_DP_STEPS and len(r0["dp"]["digests"]) == steps - 1
        and r0["dp"]["digests"] == r1["dp"]["digests"])
    checks["dp_64_rows_a_rank"] = all(r["dp"]["local_rows"] == 64
                                      for r in ranks)
    checks["dp_launches_exact"] = all(r["dp"]["launches_exact"]
                                      for r in ranks)
    checks["dp_all_reduce_per_step"] = all(
        r["dp"]["collectives"]["grad_all_reduce"] == steps for r in ranks)
    checks["dp_within_alexnet_shares"] = r0["within"]["dp_split"]
    checks["tp_within_alexnet_shares"] = r0["within"]["tp_split"]
    checks["tp_2048_wide_slices"] = all(
        r["tp"]["local_widths"] == [2048, 2048] for r in ranks)
    checks["records_shards_bit_equal"] = all(r["records"]["bit_equal"]
                                             for r in ranks)
    faults = r0["faults_caught"]
    report.update(
        config={"layers": "alexnet_layers()", "crop": 227, "minibatch": 128,
                "image_hw": [256, 256], "dp": dict(PARALLEL_DP, epochs=2),
                "tp_and_fault_steps": PARALLEL_STEPS,
                "records": PARALLEL_RECORDS},
        backends={"world_1": runs["loop"]["backend"],
                  "two_ranks_one_card": r0["backend"]},
        gloo_ranks={
            "dp": {k: r0["dp"][k] for k in (
                "run_s", "train_steps", "step_ms", "busy_share",
                "gloo_all_reduce_ms", "bucket_floats", "launches",
                "collectives", "losses")},
            "dp_rank1_step_ms": r1["dp"]["step_ms"],
            "gloo_all_reduce_share_of_step": (
                r0["dp"]["gloo_all_reduce_ms"] / r0["dp"]["step_ms"]),
            "tp": r0["tp"], "records": r0["records"],
            "limits": r0["limits"], "shares": r0["shares"],
            "within": r0["within"],
            "bit_equal_to_split": r0["bit_equal_to_split"],
            "kinks": r0["kinks"],
            "fault_share": r0["fault_share"],
            "rank_s": [r["rank_s"] for r in ranks], "ranks_s": ranks_s,
            "rank_leg_s": [{"join_s": r["join_s"], **r["leg_s"]}
                           for r in ranks]},
        checks=checks, faults_caught=faults,
        phase_s=time.monotonic() - began)
    print(json.dumps({"parallel": report}, default=str), flush=True)
    failed = [k for k, v in checks.items() if not v]
    check(not failed, "parallel checks failed: %s" % failed)
    missed = [k for k in PARALLEL_FAULTS if not faults.get(k)]
    check(not missed, "planted parallel faults passed their checks: %s"
          % missed)
    return launches


# ------------------------------------------------------- mixture of experts
class MoeRouting:
    """Within ``with``, every MoE call either records on the host its
    router probabilities (``moe._route``) and, with ``signs``, its
    experts' ReLU signs (``moe._expert_ffn``: which hidden units z pass,
    z >= 0) — ``calls`` None: the run others are held against — or takes
    the recorded call at the same index: each token goes to the expert
    the recorded call chose, and with ``signs`` each hidden unit passes
    as the recorded one did (h = z·mask, which is ``clamp_min(z, 0)``
    where the signs agree, forward and backward).  Counted per call: the
    tokens whose own top-1 differs (``flips``) with those tokens'
    recorded top-1/top-2 margins, and the hidden units whose own sign
    differs (``sign_flips``).  ``fault`` plants one of ``MOE_FAULTS``."""

    def __init__(self, torch, moe, calls=None, fault=None, signs=False):
        self.torch, self.moe, self.fault = torch, moe, fault
        self.record, self.signs = calls is None, signs
        self.calls = ({"probs": [], "signs": []} if calls is None
                      else calls)
        self.at = {"probs": 0, "signs": 0}
        self.flips, self.margins, self.sign_flips = [], [], []

    def min_margin(self):
        """The smallest top-1/top-2 margin of the recorded calls."""
        if not self.calls["probs"]:
            return None
        return min(float(numpy.diff(numpy.sort(c, axis=-1)[:, -2:],
                                    axis=-1).min())
                   for c in self.calls["probs"])

    def _next(self, kind):
        want = self.calls[kind][self.at[kind]]
        self.at[kind] += 1
        return want

    def _route(self, params, flat):
        torch = self.torch
        probs, gate, onehot = self.real[0](params, flat)
        if self.record:
            self.calls["probs"].append(
                probs.detach().to("cpu", copy=True).numpy())
            return probs, gate, onehot
        want = self._next("probs")
        first = want.argmax(-1)
        top = first
        if self.fault == "second_choice":
            rest = want.copy()
            rest[numpy.arange(len(rest)), first] = -1.0
            top = rest.argmax(-1)
        flipped = probs.detach().argmax(-1).cpu().numpy() != first
        top2 = numpy.sort(want, axis=-1)[:, -2:]
        self.flips.append(int(flipped.sum()))
        self.margins.extend((top2[:, 1] - top2[:, 0])[flipped].tolist())
        top = torch.as_tensor(top, device=probs.device)
        gate = probs.gather(-1, top[:, None])
        if self.fault == "gate_dropped":
            gate = torch.ones_like(gate)
        experts = torch.arange(probs.shape[-1], device=probs.device)
        return probs, gate, (top[:, None] == experts).to(flat.dtype)

    def _expert_ffn(self, w1, b1, w2, b2, x):
        torch, matmul = self.torch, self.moe.matmul
        if self.record:
            with torch.no_grad():
                z = matmul(x.expand(w1.shape[0], *x.shape), w1) \
                    + b1.unsqueeze(-2)
                self.calls["signs"].append(
                    (numpy.packbits((z >= 0).cpu().numpy()), z.shape))
            return self.real[1](w1, b1, w2, b2, x)
        packed, shape = self._next("signs")
        z = matmul(x.expand(w1.shape[0], *x.shape), w1) + b1.unsqueeze(-2)
        want = torch.as_tensor(numpy.unpackbits(
            packed, count=int(numpy.prod(shape))).reshape(shape).astype(
            bool), device=z.device)
        self.sign_flips.append(int(((z >= 0) != want).sum()))
        return matmul(z * want.to(z.dtype), w2) + b2.unsqueeze(-2)

    def __enter__(self):
        moe = self.moe
        self.real = (moe._route, moe._expert_ffn, moe.load_balancing_loss)
        moe._route = self._route
        if self.signs:
            moe._expert_ffn = self._expert_ffn
        if self.fault == "aux_dropped":
            moe.load_balancing_loss = (
                lambda probs, onehot, token_mask=None: probs.sum() * 0.0)
        return self

    def __exit__(self, *exc):
        moe = self.moe
        moe._route, moe._expert_ffn, moe.load_balancing_loss = self.real


def per_block(counts, n_layers):
    """Per-call counts (the calls cycling through the blocks) summed a
    block."""
    return [sum(counts[b::n_layers]) for b in range(n_layers)]


def moe_run(torch, HK, prng, root, char_lm, cfg, device):
    """One seeded run of the MoE char-LM sample through its build +
    initialize + run: (workflow, {train step losses, launches, run and
    set-up s, peak card bytes, a copy of the final params})."""
    from veles_tpu_torch.ops.transformer import tree_leaves
    t0 = time.monotonic()
    wf = lm_build(prng, root, char_lm, cfg)
    wf.initialize(device=device)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    trainer = wf.trainer
    inner, step_losses = trainer.run, []

    def run_and_keep():
        train = trainer.is_train_minibatch()
        inner()
        if train:
            step_losses.append(trainer.metrics["loss_sum"]
                               / trainer.metrics["tokens"])

    trainer.run = run_and_keep
    HK.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    wf.run()
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    trainer.run = inner
    return wf, {"launches": HK.launch_counts(), "run_s": run_s,
                "setup_s": setup_s,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "losses": torch.stack(step_losses).cpu().numpy(),
                "params": [t.detach().clone()
                           for t in tree_leaves(trainer.params)]}


def moe_train(torch, HK, card, dense_step_s, device="cuda", cfg=None,
              small=None, steady_steps=3):
    """The char-LM sample with MoE blocks at the repo's full LM width
    through ``char_lm``'s build + initialize + run under 'flash_pallas'
    (exact flash launches, falling train and validation losses, a seeded
    rerun bit-equal), a steady step against the dense LM step of this
    run (``dense_step_s``), then card vs CPU at 2 layers with the CPU's
    routing, and three planted faults.  Returns the kernels' launches."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import attention as A
    from veles_tpu_torch.ops import moe
    from veles_tpu_torch.samples import char_lm
    cfg, small = cfg or MOE_TRAIN, small or MOE_SMALL
    names = ("flash_attention_fwd", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")
    began = time.monotonic()
    A.set_attention_backend("flash_pallas")
    try:
        wf, run = moe_run(torch, HK, prng, root, char_lm, cfg, device)
        trainer, ld = wf.trainer, wf.loader
        launches = run["launches"]
        mb, seq = ld.max_minibatch_size, ld.seq_len - 1
        steps, n_layers = trainer.time, trainer.n_layers
        n_valid = ld.class_lengths[1]
        valid_mbs = -(-n_valid // mb)
        check(steps == -(-ld.class_lengths[2] // mb),
              "%d MoE train steps dispatched" % steps)
        want = {names[0]: n_layers * (steps + valid_mbs),
                names[1]: n_layers * steps, names[2]: n_layers * steps}
        got = {k: launches[k] for k in names}
        check(got == want, "moe_train launches %r, expected %r"
              % (got, want))
        losses = [float(x) for x in run["losses"]]
        valid_before = wf.decision.epoch_metrics[0]["validation"]["loss"]
        check(all(numpy.isfinite(losses)) and numpy.isfinite(valid_before),
              "non-finite MoE loss %r" % losses)
        check(numpy.mean(losses[-3:]) < numpy.mean(losses[:3]),
              "MoE train loss did not fall: %r" % losses)
        # the validation minibatches again with the trained weights (the
        # epoch scored them before its first update)
        data = ld.original_data.devmem
        sums = [trainer._evalf(trainer.params, data[i:i + mb],
                               torch.ones(min(mb, n_valid - i),
                                          device=device))
                for i in range(0, n_valid, mb)]
        valid_after = float(sum(m["loss_sum"] for m in sums)
                            / sum(m["tokens"] for m in sums))
        check(valid_after < valid_before, "MoE validation loss did not "
              "fall: %g -> %g" % (valid_before, valid_after))

        # a steady train step: host clock, then the profiler's busy share
        # and top kernels
        tokens, mask = data[:mb], torch.ones(mb, device=device)

        def step():
            trainer._train(trainer.params, trainer.opt_state, tokens, mask,
                           trainer.time)
            torch.cuda.synchronize()

        step()
        t0 = time.monotonic()
        for _ in range(steady_steps):
            step()
        step_s = (time.monotonic() - t0) / steady_steps
        busy, per_kernel = profile_steps(torch, step, 2)
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
        del wf, trainer, ld, data, sums, tokens, mask, step
        gc_cuda(torch)
        # the seeded rerun: the same losses and params, bit for bit
        wf, rerun = moe_run(torch, HK, prng, root, char_lm, cfg, device)
        del wf
        repeat = (numpy.array_equal(run["losses"], rerun["losses"])
                  and all(torch.equal(a, b) for a, b in
                          zip(run.pop("params"), rerun.pop("params"))))
        gc_cuda(torch)

        # card vs CPU at 2 layers in the CPU run's region: the card
        # routes as the CPU routed and its ReLUs pass as the CPU's did
        on_cpu_routes = MoeRouting(torch, moe, signs=True)
        with on_cpu_routes:
            on_cpu = lm_committed(prng, root, char_lm, "cpu", small)
        card_routes = MoeRouting(torch, moe, on_cpu_routes.calls,
                                 signs=True)
        with card_routes:
            on_card = lm_committed(prng, root, char_lm, device, small)
        sound = lm_shares(on_card, on_cpu)
        # reported, not checked: the card held to the CPU's expert
        # choices alone, its ReLU signs its own
        with MoeRouting(torch, moe, on_cpu_routes.calls):
            routing_only = lm_shares(lm_committed(
                prng, root, char_lm, device, small), on_cpu)
        faults = {}
        for name in MOE_FAULTS:
            with MoeRouting(torch, moe, on_cpu_routes.calls, fault=name,
                            signs=True):
                faults[name] = lm_shares(lm_committed(
                    prng, root, char_lm, device, small), on_cpu)
    finally:
        A.set_attention_backend("xla")

    def worst(shares):
        return [max(d.values()) for d in shares]

    report = {"phase": "moe_train", "card": card,
              "config": {"vocab": 256, "d_model": cfg["trainer"]["d_model"],
                         "n_heads": cfg["trainer"]["n_heads"],
                         "n_layers": n_layers, "seq": seq, "minibatch": mb,
                         "n_experts": cfg["trainer"]["n_experts"],
                         "moe_aux_coef": cfg["trainer"]["moe_aux_coef"],
                         "n_train": cfg["loader"]["n_train"],
                         "n_valid": n_valid, "epochs": 1,
                         "backend": "flash_pallas"},
              "setup_s": run["setup_s"], "run_s": run["run_s"],
              "train_steps": steps, "validation_minibatches": valid_mbs,
              "launches": launches, "train_step_losses": losses,
              "validation_loss_before": valid_before,
              "validation_loss_after": valid_after,
              "rerun_bit_equal": repeat, "rerun_run_s": rerun["run_s"],
              "peak_memory_bytes": run["peak_bytes"],
              "steady": {"step_s": step_s,
                         "tokens_per_s": mb * seq / step_s,
                         "step_device_busy_share": busy,
                         "step_card_us": sum(per_kernel.values()),
                         "step_top_kernels_us": [[k[:80], v]
                                                 for k, v in top],
                         "dense_step_s": dense_step_s,
                         "over_dense": step_s / dense_step_s},
              "card_vs_cpu": {
                  "config": small, "limits": [LM_FIRST_SHARE,
                                              LM_THIRD_SHARE],
                  "moe_calls": len(on_cpu_routes.calls["probs"]),
                  "cpu_min_router_margin": on_cpu_routes.min_margin(),
                  "card_flips_per_block": per_block(
                      card_routes.flips, small["trainer"]["n_layers"]),
                  "card_flip_margins": card_routes.margins,
                  "card_relu_sign_flips_per_block": per_block(
                      card_routes.sign_flips, small["trainer"]["n_layers"]),
                  "flip_margin_limit": MOE_FLIP_MARGIN,
                  "sound_worst": worst(sound), "sound": sound,
                  "routing_only_worst": worst(routing_only),
                  "faults_worst": {k: worst(v) for k, v in faults.items()},
                  "faults_first": {k: v[0] for k, v in faults.items()}},
              "phase_s": time.monotonic() - began}
    print(json.dumps(report), flush=True)
    check(repeat, "moe_train: a seeded rerun on the card changed the "
          "losses or the params")
    check(card_routes.at == {k: len(v) for k, v in
                             on_cpu_routes.calls.items()},
          "the card run made %r MoE calls, the CPU run %r"
          % (card_routes.at, {k: len(v) for k, v in
                              on_cpu_routes.calls.items()}))
    check(all(m < MOE_FLIP_MARGIN for m in card_routes.margins),
          "the card routed a token otherwise than the CPU at a margin "
          "of %r" % card_routes.margins)
    check(len(sound) == 3, "%d committed MoE updates, not 3" % len(sound))
    check(worst(sound)[0] <= LM_FIRST_SHARE
          and worst(sound)[-1] <= LM_THIRD_SHARE,
          "card vs CPU MoE weight gaps beyond their limits: %r"
          % worst(sound))
    for name, shares in faults.items():
        check(worst(shares)[0] > LM_FIRST_SHARE, "the card-vs-CPU check "
              "passed the faulty MoE run %r: %r" % (name, worst(shares)))
    return launches


def gc_cuda(torch):
    """Collect the dropped runs and give their card memory back."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def moe_ep_inputs(torch, device):
    """The expert-parallel check's seeded inputs on ``device`` at
    ``MOE_EP``'s widths: MoE params (``init_moe_params``, biases drawn
    too so their gradients see every term), a block input x (T, d) and
    the output's cotangent."""
    from veles_tpu_torch.ops import moe
    from veles_tpu_torch import prng
    t, d, f, e = MOE_EP
    host = moe.init_moe_params(prng.RandomGenerator("init", SEED), d, f, e)
    rng = numpy.random.RandomState(SEED)
    for k in ("b1", "b2"):
        host[k] = rng.uniform(-0.1, 0.1, host[k].shape).astype(
            numpy.float32)
    params = {k: torch.tensor(v, device=device, requires_grad=True)
              for k, v in host.items()}
    x = torch.tensor(rng.randn(t, d).astype(numpy.float32), device=device,
                     requires_grad=True)
    g = torch.tensor(rng.randn(t, d).astype(numpy.float32), device=device)
    return params, x, g


def moe_ep_step(torch, fn, params, x, g):
    """(output, {param name or "x": gradient}) of ``fn(params, x)`` with
    the output's cotangent ``g``."""
    out = fn(params, x)
    grads = torch.autograd.grad(out, list(params.values()) + [x], g)
    return out.detach(), dict(zip(list(params) + ["x"], grads))


def moe_split(torch, moe, n):
    """``moe_ffn_ep``'s arithmetic for ``n`` expert ranks in one process:
    each rank's masked share, summed in rank order, times the gate."""
    def fn(params, x):
        _, gate, onehot = moe._route(params, x)
        k = params["w1"].shape[0] // n
        total = None
        for r in range(n):
            s = slice(r * k, (r + 1) * k)
            share = torch.einsum("etd,te->td", moe._expert_ffn(
                params["w1"][s], params["b1"][s], params["w2"][s],
                params["b2"][s], x), onehot[:, s])
            total = share if total is None else total + share
        return total * gate
    return fn


def moe_ep_times(torch, fn, params, x, g):
    """Median host ms of ``MOE_EP_TIMED`` synchronous forward + backward
    calls."""
    moe_ep_step(torch, fn, params, x, g)
    torch.cuda.synchronize()
    times = []
    for _ in range(MOE_EP_TIMED):
        t0 = time.perf_counter()
        moe_ep_step(torch, fn, params, x, g)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def moe_ep_rank(rank, port, out_path):
    """One of the two gloo ranks sharing cuda:0 (``python3 chip_smoke.py
    --moe-rank R PORT OUT``): ``moe_ffn_ep`` over a ("data", "expert")
    mesh of two at ``MOE_EP``'s shape on the rank's own tree (the router
    and its E/2 experts, ``moe.expert_slice`` copied: the whole tree is
    dropped), forward and backward, its collective counts, then its time
    and the all-reduce's alone.  Writes the output, the router and input
    gradients, this rank's expert gradients and the expert-weight bytes
    it held and the whole tree holds to ``out_path`` (npz)."""
    import torch
    from veles_tpu_torch import parallel
    from veles_tpu_torch.ops import moe
    began = time.monotonic()
    _, _, backend = parallel.initialize_multihost("127.0.0.1:%d" % port, 2,
                                                  rank)
    try:
        dev = parallel._JOINED["device"]
        mesh = parallel.make_mesh(model_parallel=2,
                                  axis_names=("data", "expert"))
        whole, x, g = moe_ep_inputs(torch, dev)
        params = {key: v.detach().clone().requires_grad_()
                  for key, v in moe.expert_slice(whole, mesh).items()}
        held, whole_bytes = (sum(
            tree[key].numel() * tree[key].element_size()
            for key in moe.EXPERT_KEYS) for tree in (params, whole))
        del whole

        def fn(p, xx):
            return moe.moe_ffn_ep(p, xx, mesh)

        parallel.reset_collective_counts()
        out, grads = moe_ep_step(torch, fn, params, x, g)
        counts = parallel.collective_counts()
        step_ms = moe_ep_times(torch, fn, params, x, g)
        group = mesh.group("expert")
        times = []
        for _ in range(MOE_EP_TIMED):
            t0 = time.perf_counter()
            parallel.ep_all_reduce(out, group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        k = MOE_EP[3] // 2
        lo = mesh.index("expert") * k
        check(params["w1"].shape[0] == k, "the rank holds %d experts, "
              "not %d" % (params["w1"].shape[0], k))
        numpy.savez(out_path, out=out.cpu().numpy(), lo=lo,
                    backend=backend, device=str(dev),
                    step_ms=step_ms,
                    all_reduce_ms=statistics.median(times),
                    rank_s=time.monotonic() - began,
                    expert_bytes=held, whole_expert_bytes=whole_bytes,
                    **{"count/" + k_: v for k_, v in counts.items()},
                    **{"grad/" + name: v.cpu().numpy()
                       for name, v in grads.items()})
    finally:
        parallel.shutdown()
    return 0


def moe_ep_phase(torch, card, device="cuda"):
    """Expert parallelism at the full-width block shape: NCCL at world 1
    in this process (``moe_ffn_ep`` bit-equal to ``moe_ffn``, values and
    gradients), then two gloo ranks sharing cuda:0 (this script with
    ``--moe-rank``) held against ``moe_ffn`` on the card by the
    reference's bars and bit for bit against the same split arithmetic
    done in one process."""
    import os
    import shutil
    import tempfile
    from veles_tpu_torch import parallel
    from veles_tpu_torch.ops import moe
    began = time.monotonic()
    checks, report = {}, {"card": card, "shape": dict(zip(
        ("tokens", "d_model", "d_ff", "experts"), MOE_EP))}

    def single(p, xx):
        return moe.moe_ffn(p, xx)

    # (a) NCCL at world 1: the sum over one rank is the identity
    _, _, backend = parallel.initialize_multihost(
        "127.0.0.1:%d" % free_port(), 1, 0)
    try:
        mesh = parallel.make_mesh(model_parallel=1,
                                  axis_names=("data", "expert"))
        params, x, g = moe_ep_inputs(torch, device)
        ref_out, ref_grads = moe_ep_step(torch, single, params, x, g)

        def ep(p, xx):
            return moe.moe_ffn_ep(p, xx, mesh)

        parallel.reset_collective_counts()
        out, grads = moe_ep_step(torch, ep, params, x, g)
        counts = parallel.collective_counts()
        checks["nccl_world_1_backend"] = backend == "nccl"
        checks["nccl_world_1_bit_equal"] = torch.equal(out, ref_out) and all(
            torch.equal(grads[k], ref_grads[k]) for k in grads)
        checks["nccl_world_1_counted"] = (
            counts["ep_all_reduce"] == counts["ep_input_grad_all_reduce"]
            == 1)
        report["nccl_world_1"] = {
            "backend": backend, "collectives": counts,
            "moe_ffn_ms": moe_ep_times(torch, single, params, x, g),
            "moe_ffn_ep_ms": moe_ep_times(torch, ep, params, x, g)}
    finally:
        parallel.shutdown()
    del out, grads
    split_out, split_grads = moe_ep_step(torch, moe_split(torch, moe, 2),
                                         params, x, g)

    # (b) two gloo ranks sharing cuda:0
    tmp = tempfile.mkdtemp(prefix="veles_moe_ep_")
    try:
        port = free_port()
        outs = [os.path.join(tmp, "rank%d.npz" % r) for r in range(2)]
        here = os.path.abspath(__file__)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(here))
        t0 = time.monotonic()
        procs = [subprocess.Popen(
            [sys.executable, here, "--moe-rank", str(r), str(port),
             outs[r]], env=env, cwd=os.path.dirname(here),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=300)
                errs.append((p.returncode, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.monotonic() - t0
        for code, err in errs:
            check(code == 0, "an expert-parallel rank failed:\n%s"
                  % err[-4000:])
        ranks = [dict(numpy.load(path)) for path in outs]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k = MOE_EP[3] // 2

    def gathered(name):
        full = numpy.zeros(params[name].shape, numpy.float32)
        for r in ranks:
            lo = int(r["lo"])
            full[lo:lo + k] = r["grad/" + name]
        return full

    got = {"out": ranks[0]["out"], "router": ranks[0]["grad/router"],
           "x": ranks[0]["grad/x"]}
    got.update({name: gathered(name) for name in ("w1", "b1", "w2", "b2")})
    want = {"out": ref_out}
    want.update(ref_grads)
    split = {"out": split_out}
    split.update(split_grads)
    errs = {}
    for name, a in got.items():
        b = want[name].cpu().numpy()
        rtol, atol = MOE_EP_VALUE_TOL if name == "out" else MOE_EP_GRAD_TOL
        errs[name] = float(numpy.max(numpy.abs(a - b)
                                     / (atol + rtol * numpy.abs(b))))
    checks["gloo_backend_on_one_card"] = all(
        str(r["backend"]) == "gloo" and str(r["device"]) == "cuda:0"
        for r in ranks)
    checks["gloo_ranks_bit_equal"] = all(
        numpy.array_equal(ranks[1][key], ranks[0][key])
        for key in ("out", "grad/router", "grad/x"))
    checks["gloo_within_reference_bars"] = max(errs.values()) <= 1.0
    checks["gloo_bit_equal_to_split"] = all(
        numpy.array_equal(a, split[name].cpu().numpy())
        for name, a in got.items())
    checks["gloo_counted"] = all(
        int(r["count/ep_all_reduce"]) == 1
        and int(r["count/ep_input_grad_all_reduce"]) == 1 for r in ranks)
    # each rank held its own E/2 experts, not the whole tree
    checks["gloo_ranks_hold_their_experts"] = all(
        2 * int(r["expert_bytes"]) == int(r["whole_expert_bytes"])
        for r in ranks)
    routed = (moe._route(params, x.detach())[2].sum(0)).tolist()
    report.update(
        gloo_two_ranks={
            "step_ms": [float(r["step_ms"]) for r in ranks],
            "all_reduce_ms": [float(r["all_reduce_ms"]) for r in ranks],
            "rank_s": [float(r["rank_s"]) for r in ranks],
            "ranks_s": ranks_s,
            "expert_bytes_per_rank": [int(r["expert_bytes"])
                                      for r in ranks],
            "whole_tree_expert_bytes": int(ranks[0]["whole_expert_bytes"]),
            "worst_over_bar": errs,
            "bit_equal_to_moe_ffn": all(
                numpy.array_equal(a, want[name].cpu().numpy())
                for name, a in got.items()),
            "bars": {"values": MOE_EP_VALUE_TOL,
                     "grads": MOE_EP_GRAD_TOL}},
        tokens_per_expert=routed, checks=checks,
        phase_s=time.monotonic() - began)
    print(json.dumps({"moe_ep": report}, default=str), flush=True)
    failed = [key for key, v in checks.items() if not v]
    check(not failed, "expert-parallel checks failed: %s" % failed)


# ------------------------------------------------------ pipeline and ring
#: GPipe at the LM's full width: LM_TRAIN's minibatch of 32 in 4
#: microbatches of 8; (b) runs 4 stages of 2 layers, one a gloo rank,
#: the 4 ranks sharing cuda:0 (NCCL refuses two ranks on one device)
PIPE_STAGES = 4
PIPE_TRAIN = dict(LM_TRAIN, trainer=dict(LM_TRAIN["trainer"],
                                         pipeline_microbatches=4))
#: docs/USAGE.md's MoE run (4 experts a block, 8 layers, 4 stages): 3
#: train steps and 1 validation minibatch
PIPE_MOE = dict(MOE_TRAIN,
                loader=dict(MOE_TRAIN["loader"], n_train=96, n_valid=32),
                trainer=dict(MOE_TRAIN["trainer"], pipeline_microbatches=4))
#: planted pipeline faults: the final all-reduce's backward sums the
#: cotangent over the stages, stage 0's input gradient is not shared,
#: the last stage writes microbatch t into slot t
PIPE_FAULTS = ("output_cotangent_summed", "input_grad_not_shared",
               "slot_t")
#: a fault is caught when the loss moves by more than this (relative) or
#: a gradient leaf by more than PIPE_FAULT_GRAD of its norm
PIPE_FAULT_LOSS = 1e-6
PIPE_FAULT_GRAD = 1e-3
#: timed steady steps of each pipelined run
PIPE_TIMED = 3
#: ring attention over the 4 ranks: (b, heads, s, head_dim), fp32,
#: s_local 2048
RING_SHAPE = (1, 8, 8192, 64)
#: case -> (window, sinks), every case causal; and its live key blocks
#: over the 4 ranks' 4 steps (causal: 1 + 2 + 3 + 4; window 1024 < 2048
#: keeps a rank's own block and the one before, sinks keep block 0)
RING_CASES = {"causal": (None, 0), "window1024_sinks4": (1024, 4)}
RING_LIVE = {"causal": 10, "window1024_sinks4": 9}
#: ring vs dense attention: the reference's bars (rtol, atol)
RING_TOL = (1e-4, 1e-5)
#: planted ring faults: the backward rotates forward, the early exit
#: drops the sink block
RING_FAULTS = ("backward_rotates_forward", "sink_block_dropped")


def replicated_digest(params):
    """crc32 over the bits of the replicated leaves (embedding,
    positions, final LN)."""
    import zlib
    crc = 0
    for t in (params["embed"], params["pos"], params["ln_f"]["g"],
              params["ln_f"]["b"]):
        crc = zlib.crc32(t.detach().cpu().numpy().tobytes(), crc)
    return crc


def leaf_digests(flat):
    """{name: crc32 of the leaf's bits} of a ``flat_params`` dict."""
    import zlib
    return {k: zlib.crc32(numpy.ascontiguousarray(v).tobytes())
            for k, v in flat.items()}


def pipe_run(torch, HK, cfg, stages, device="cuda", keep=()):
    """One seeded run of the char-LM sample at ``stages`` pipeline stages
    through its build + initialize + run under 'flash_pallas': train
    step losses, launches, set-up and run s, peak card bytes, the
    replicated leaves' digest after every update, the portable params
    after the updates in ``keep`` (0: at set-up), the final portable
    params' digests (gathered from the stages: every stage runs this
    alike) and the validation loss.
    Returns (workflow, that dict)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import char_lm
    cuda = device == "cuda"
    cfg = dict(cfg, trainer=dict(cfg["trainer"], pipeline_stages=stages))
    t0 = time.monotonic()
    wf = lm_build(prng, root, char_lm, cfg)
    wf.initialize(device=device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    trainer = wf.trainer
    inner, losses, digests, kept = trainer.run, [], [], {}
    if 0 in keep:
        kept[0] = flat_params(trainer._to_portable(trainer.params))

    def run_and_keep():
        train = trainer.is_train_minibatch()
        inner()
        if train:
            losses.append(float(trainer.metrics["loss_sum"]
                                / trainer.metrics["tokens"]))
            digests.append(replicated_digest(trainer.params))
            if trainer.time in keep:
                kept[trainer.time] = flat_params(
                    trainer._to_portable(trainer.params))

    trainer.run = run_and_keep
    HK.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    wf.run()
    if cuda:
        torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    trainer.run = inner
    launches = HK.launch_counts()
    final = leaf_digests(flat_params(trainer._to_portable(trainer.params)))
    return wf, {"launches": launches, "losses": losses,
                "final_digests": final,
                "setup_s": setup_s, "run_s": run_s,
                "peak_bytes": (torch.cuda.max_memory_allocated() if cuda
                               else None),
                "replicated_digests": digests, "kept": kept,
                "validation_loss": float(
                    wf.decision.epoch_metrics[0]["validation"]["loss"]),
                "train_steps": trainer.time}


def flash_want(cfg, stages):
    """The flash kernels' exact launches of one run of ``cfg`` at
    ``stages`` stages on each stage: its layers times the microbatches,
    a train step (7a-7c) and a validation minibatch (7a)."""
    ld, tr = cfg["loader"], cfg["trainer"]
    mb = ld["minibatch_size"]
    steps, valid = -(-ld["n_train"] // mb), -(-ld["n_valid"] // mb)
    per = tr["n_layers"] // stages * tr["pipeline_microbatches"]
    return {"flash_attention_fwd": per * (steps + valid),
            "flash_attention_bwd_dkv": per * steps,
            "flash_attention_bwd_dq": per * steps}


FLASH_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dkv",
               "flash_attention_bwd_dq")


def steady_pipe(torch, wf, device="cuda", n=PIPE_TIMED):
    """A pipelined trainer's steady train step on the run's first
    minibatch: host ms over ``n`` synchronous steps, tokens/s, and the
    profiler's busy share of this process's kernels over 2 steps."""
    trainer, ld = wf.trainer, wf.loader
    mb = ld.max_minibatch_size
    tokens = ld.original_data.devmem[:mb]
    mask = torch.ones(mb, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def step():
        trainer._train(trainer.params, trainer.opt_state, tokens, mask,
                       trainer.time)
        sync()

    step()
    t0 = time.monotonic()
    for _ in range(n):
        step()
    step_s = (time.monotonic() - t0) / n
    busy, per_kernel = profile_steps(torch, step, 2)
    return {"step_ms": step_s * 1e3,
            "tokens_per_s": mb * (ld.seq_len - 1) / step_s,
            "busy_share": busy,
            "card_us": sum(per_kernel.values()) if per_kernel else None}


@contextlib.contextmanager
def pipeline_fault(name):
    """Within the block, ``name`` of ``PIPE_FAULTS`` or ``RING_FAULTS``
    is planted in ``parallel.pipeline`` or ``parallel.ring``."""
    from veles_tpu_torch import parallel
    from veles_tpu_torch.parallel import pipeline, ring
    kept = {}

    def plant(module, attr, fn):
        kept[(module, attr)] = getattr(module, attr)
        setattr(module, attr, fn)

    if name == "output_cotangent_summed":
        def summed(grad, group):
            grad = grad.clone()
            parallel.stage_output_all_reduce(grad, group)
            return grad
        plant(pipeline, "_output_cotangent", summed)
    elif name == "input_grad_not_shared":
        plant(pipeline, "_share_input_grad", lambda dx, group: dx)
    elif name == "slot_t":
        plant(pipeline, "_out_slot", lambda t, n_stages: t)
    elif name == "backward_rotates_forward":
        rotate = ring._rotate
        plant(ring, "_rotate",
              lambda tensors, mesh, axis, shift: rotate(tensors, mesh, axis,
                                                        1))
    elif name == "sink_block_dropped":
        live = ring._live
        plant(ring, "_live", lambda src, s_local, q_first, q_last, window,
              sinks: live(src, s_local, q_first, q_last, window, 0))
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for (module, attr), fn in kept.items():
            setattr(module, attr, fn)


def pipe_faults(torch, wf):
    """Each ``PIPE_FAULTS`` fault against the sound pipeline on this
    stage: the train loss and every gradient leaf this stage holds, at
    the trainer's params on the run's first minibatch; per fault the
    loss's relative move and the worst leaf's ‖faulty − sound‖/‖sound‖,
    and the replicated leaves' gradient digest (the stages must agree)."""
    import zlib
    from veles_tpu_torch.ops.transformer import tree_leaves
    trainer, ld = wf.trainer, wf.loader
    mb = ld.max_minibatch_size
    tokens = ld.original_data.devmem[:mb]
    mask = torch.ones(mb, device=tokens.device)
    loss_fn = trainer._loss_fn(training=True)
    params = trainer.params
    leaves = tree_leaves(params)
    replicated = {id(t) for t in (params["embed"], params["pos"],
                                  params["ln_f"]["g"], params["ln_f"]["b"])}

    def grads():
        loss = loss_fn(trainer.params, tokens, mask)
        return float(loss), torch.autograd.grad(loss, leaves)

    sound_loss, sound = grads()
    out = {}
    for name in PIPE_FAULTS:
        with pipeline_fault(name):
            loss, got = grads()
        rel = [float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b).clamp_min(1e-30))
               for a, b in zip(got, sound)]
        crc = 0
        for leaf, g in zip(leaves, got):
            if id(leaf) in replicated:
                crc = zlib.crc32(g.cpu().numpy().tobytes(), crc)
        out[name] = {"loss_rel": abs(loss - sound_loss) / abs(sound_loss),
                     "grad_rel_worst": max(rel),
                     "replicated_grad_digest": crc}
    return out


def ring_inputs(torch, device, shape=RING_SHAPE):
    """Seeded q, k, v and the output's cotangent, (b, h, s, dh) fp32."""
    rng = numpy.random.RandomState(SEED)
    return [torch.tensor(rng.randn(*shape).astype(numpy.float32),
                         device=device) for _ in range(4)]


def ring_case(torch, ring, mesh, q, k, v, g, window, sinks):
    """The ring's output and dq, dk, dv for the cotangent ``g``, with
    this rank's attends."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = ring.ring_attention(q, k, v, mesh, causal=True, window=window,
                              sinks=sinks)
    grads = torch.autograd.grad(out, [q, k, v], g)
    return ([out.detach()] + list(grads),
            ring.ring_attention_local.counts["attends"])


def over_bar(got, want, tol=RING_TOL):
    """max |got − want| / (atol + rtol·|want|) over every tensor (≤ 1
    within the bars)."""
    rtol, atol = tol
    return max(float(((a - b).abs() / (atol + rtol * b.abs())).max())
               for a, b in zip(got, want))


def ring_phase_rank(torch, rank, device, shape, timed=PIPE_TIMED):
    """Ring attention on this rank of the joined run (mesh (1, n)): each
    ``RING_CASES`` case against dense ``attention`` (rank 0), its
    attends, a digest of its global results (the ranks must agree), its
    ms, and the faults."""
    import zlib
    from veles_tpu_torch.ops import attention as A
    from veles_tpu_torch.parallel import ring
    mesh = ring.make_seq_mesh()
    q, k, v, g = ring_inputs(torch, device, shape)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = {}
    for case, (window, sinks) in RING_CASES.items():
        got, attends = ring_case(torch, ring, mesh, q, k, v, g, window,
                                 sinks)
        crc = 0
        for t in got:
            crc = zlib.crc32(t.cpu().numpy().tobytes(), crc)
        times = []
        for _ in range(timed):
            sync()
            t0 = time.perf_counter()
            ring_case(torch, ring, mesh, q, k, v, g, window, sinks)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        rec = {"attends": attends, "digest": crc,
               "ring_ms": statistics.median(times)}
        faults = {}
        for name in RING_FAULTS:
            with pipeline_fault(name):
                faults[name] = ring_case(torch, ring, mesh, q, k, v, g,
                                         window, sinks)[0]
        if rank == 0:
            def dense(q, k, v, window=window, sinks=sinks):
                q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
                o = A.attention(q, k, v, causal=True, window=window,
                                sinks=sinks)
                return [o.detach()] + list(torch.autograd.grad(o, [q, k, v],
                                                               g))
            want = dense(q, k, v)
            times = []
            for _ in range(timed):
                sync()
                t0 = time.perf_counter()
                dense(q, k, v)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            rec.update(over_bar=over_bar(got, want),
                       over_bar_each=[over_bar([a], [b])
                                      for a, b in zip(got, want)],
                       dense_ms=statistics.median(times),
                       faults_over_bar={name: over_bar(f, want)
                                        for name, f in faults.items()})
            del want
        del faults, got
        out[case] = rec
    return out


def pipeline_rank(rank, port, spec_path, out_path):
    """One of the four gloo ranks sharing cuda:0 (``python3
    chip_smoke.py --pipeline-rank R PORT SPEC OUT``): (b) the dense and
    the MoE char-LM runs at 4 pipeline stages, the planted pipeline
    faults, the steady step, the host-staged hop and output sum timed
    alone; (c) ring attention.  ``SPEC`` (JSON) holds the device and
    the configs; writes its results to ``OUT`` (JSON)."""
    import torch
    from veles_tpu_torch import parallel
    from veles_tpu_torch.ops import attention as A
    from veles_tpu_torch.ops import functional as F
    from veles_tpu_torch.ops import hopper_kernels as HK
    with open(spec_path) as f:
        spec = json.load(f)
    device = spec["device"]
    torch.set_num_threads(1)     # four ranks share the host's cores
    began = time.monotonic()
    _, _, backend = parallel.initialize_multihost(
        "127.0.0.1:%d" % port, PIPE_STAGES, rank, device=device)
    report = {"backend": backend, "device": str(parallel._JOINED["device"])}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    try:
        F.set_matmul_precision("float32")
        A.set_attention_backend("flash_pallas")
        parallel.reset_collective_counts()
        wf, dense = pipe_run(torch, HK, spec["dense"], PIPE_STAGES, device)
        dense["collectives"] = parallel.collective_counts()
        dense["stage_layers"] = int(
            wf.trainer.params["blocks"]["ln1"]["g"].shape[0])
        dense["faults"] = pipe_faults(torch, wf)
        dense["steady"] = steady_pipe(torch, wf, device)
        report["dense"] = dense
        # the host-staged hop of one microbatch's activations, and the
        # output sum, timed alone
        mb = spec["dense"]["loader"]["minibatch_size"] // spec["dense"][
            "trainer"]["pipeline_microbatches"]
        seq = spec["dense"]["loader"]["seq_len"] - 1
        d = spec["dense"]["trainer"]["d_model"]
        act = torch.zeros(mb, seq, d, device=device)
        group = wf.trainer._pp_mesh.group("stage")
        hop, total = [], []
        for _ in range(PIPE_TIMED + 1):
            sync()
            t0 = time.perf_counter()
            parallel.p2p_exchange(
                [act] if rank < PIPE_STAGES - 1 else None, rank + 1,
                [act] if rank > 0 else None, rank - 1, group)
            sync()
            hop.append((time.perf_counter() - t0) * 1e3)
            outs = torch.zeros(PIPE_STAGES, mb, seq, d, device=device)
            sync()
            t0 = time.perf_counter()
            parallel.stage_output_all_reduce(outs, group)
            sync()
            total.append((time.perf_counter() - t0) * 1e3)
        report["hop_ms"] = statistics.median(hop[1:])
        report["output_all_reduce_ms"] = statistics.median(total[1:])
        report["hop_bytes"] = act.numel() * 4
        del wf, act, outs
        if device == "cuda":
            gc_cuda(torch)
        wf, report["moe"] = pipe_run(torch, HK, spec["moe"], PIPE_STAGES,
                                     device)
        report["moe"]["steady"] = steady_pipe(torch, wf, device)
        del wf
        if device == "cuda":
            gc_cuda(torch)
        report["ring"] = ring_phase_rank(torch, rank, device,
                                         tuple(spec["ring"]))
    finally:
        parallel.shutdown()
    for run in ("dense", "moe"):
        del report[run]["kept"]
    report["rank_s"] = time.monotonic() - began
    with open(out_path, "w") as f:
        json.dump(report, f)
    return 0


def pipeline_phase(torch, HK, card, dense_step_s, device="cuda",
                   dense_cfg=None, moe_cfg=None, ring_shape=RING_SHAPE):
    """GPipe and ring attention at the LM's full width: (a) in this
    process at one stage (no joined run), the dense char-LM run (exact
    flash launches, falling loss, the steady step)
    held against the sequential run within ``LM_*_SHARE``, and the MoE
    run; (b) four gloo ranks sharing the card (this script with
    ``--pipeline-rank``) at 4 stages, bit-equal to (a) and to each other
    after every update, dense and MoE, with the planted faults caught;
    (c) ring attention on the same ranks within ``RING_TOL`` of dense
    attention, exact skipped attends, the ring faults caught.  Returns
    the flash kernels' launches of (a)'s and (b)'s runs."""
    import os
    import shutil
    import tempfile
    from veles_tpu_torch.ops import attention as A
    dense_cfg, moe_cfg = dense_cfg or PIPE_TRAIN, moe_cfg or PIPE_MOE
    cuda = device == "cuda"
    began = time.monotonic()
    checks, report = {}, {"card": card}
    A.set_attention_backend("flash_pallas")
    try:
        wf, one = pipe_run(torch, HK, dense_cfg, 1, device, keep=(0, 1, 3))
        one["steady"] = steady_pipe(torch, wf, device)
        del wf
        if cuda:
            gc_cuda(torch)
        _, seq = pipe_run(torch, HK, dense_cfg, 0, device, keep=(0, 1, 3))
        if cuda:
            gc_cuda(torch)
        _, moe_one = pipe_run(torch, HK, moe_cfg, 1, device)
        if cuda:
            gc_cuda(torch)
    finally:
        A.set_attention_backend("xla")
    want = flash_want(dense_cfg, 1)
    checks["a_launches_exact"] = all(one["launches"][k] == want[k]
                                     for k in FLASH_NAMES)
    checks["a_moe_launches_exact"] = all(
        moe_one["launches"][k] == flash_want(moe_cfg, 1)[k]
        for k in FLASH_NAMES)
    losses = one["losses"]
    checks["a_loss_falls"] = bool(all(numpy.isfinite(losses)) and numpy.mean(
        losses[-3:]) < numpy.mean(losses[:3]))
    shares = lm_shares([one["kept"][k] for k in (0, 1, 3)],
                       [seq["kept"][k] for k in (0, 1, 3)])
    worst = [max(d.values()) for d in shares]
    top = [sorted(d.items(), key=lambda kv: -kv[1])[:3] for d in shares]
    checks["a_within_sequential_shares"] = (worst[0] <= LM_FIRST_SHARE
                                            and worst[1] <= LM_THIRD_SHARE)
    report["a"] = {
        "config": {"n_layers": dense_cfg["trainer"]["n_layers"],
                   "d_model": dense_cfg["trainer"]["d_model"],
                   "minibatch": dense_cfg["loader"]["minibatch_size"],
                   "microbatches": dense_cfg["trainer"][
                       "pipeline_microbatches"],
                   "seq": dense_cfg["loader"]["seq_len"] - 1, "stages": 1},
        "launches": {k: one["launches"][k] for k in FLASH_NAMES},
        "want": want, "losses": losses,
        "validation_loss": one["validation_loss"],
        "sequential_validation_loss": seq["validation_loss"],
        "sequential_losses": seq["losses"],
        "shares_worst_after_1_3": worst,
        "shares_top_tensors_after_1_3": top,
        "limits": [LM_FIRST_SHARE, LM_THIRD_SHARE],
        "steady": one["steady"],
        "sequential_step_ms_phase_7": dense_step_s * 1e3,
        "setup_s": one["setup_s"], "run_s": one["run_s"],
        "peak_bytes": one["peak_bytes"],
        "moe": {k: moe_one[k] for k in ("losses", "validation_loss",
                                        "run_s", "peak_bytes")}}
    del shares, seq

    # (b), (c): four gloo ranks sharing the card
    tmp = tempfile.mkdtemp(prefix="veles_pipeline_")
    try:
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump({"device": device, "dense": dense_cfg, "moe": moe_cfg,
                       "ring": list(ring_shape)}, f)
        port = free_port()
        outs = [os.path.join(tmp, "rank%d.json" % r)
                for r in range(PIPE_STAGES)]
        here = os.path.abspath(__file__)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(here))
        t0 = time.monotonic()
        procs = [subprocess.Popen(
            [sys.executable, here, "--pipeline-rank", str(r), str(port),
             spec, outs[r]], env=env, cwd=os.path.dirname(here),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(PIPE_STAGES)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=600)
                errs.append((p.returncode, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.monotonic() - t0
        for code, err in errs:
            check(code == 0, "a pipeline rank failed:\n%s" % err[-4000:])
        ranks = []
        for path in outs:
            with open(path) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b_want = flash_want(dense_cfg, PIPE_STAGES)
    m_want = flash_want(moe_cfg, PIPE_STAGES)
    checks["b_gloo_on_one_card"] = all(
        r["backend"] == "gloo" and (not cuda or r["device"] == "cuda:0")
        for r in ranks)
    for run, ref, w in (("dense", one, b_want), ("moe", moe_one, m_want)):
        checks["b_%s_launches_exact" % run] = all(
            r[run]["launches"][k] == w[k] for r in ranks for k in FLASH_NAMES)
        checks["b_%s_replicated_equal_every_step" % run] = all(
            r[run]["replicated_digests"] == ref["replicated_digests"]
            for r in ranks)
        checks["b_%s_losses_bit_equal_to_a" % run] = all(
            r[run]["losses"] == ref["losses"]
            and r[run]["validation_loss"] == ref["validation_loss"]
            for r in ranks)
    checks["b_dense_params_bit_equal_to_a"] = (
        ranks[0]["dense"]["final_digests"] == one["final_digests"])
    checks["b_moe_params_bit_equal_to_a"] = (
        ranks[0]["moe"]["final_digests"] == moe_one["final_digests"])
    faults = {}
    for name in PIPE_FAULTS:
        per = [r["dense"]["faults"][name] for r in ranks]
        moved = any(p["loss_rel"] > PIPE_FAULT_LOSS
                    or p["grad_rel_worst"] > PIPE_FAULT_GRAD for p in per)
        drift = len({p["replicated_grad_digest"] for p in per}) > 1
        faults[name] = {"loss_rel": [p["loss_rel"] for p in per],
                        "grad_rel_worst": [p["grad_rel_worst"] for p in per],
                        "replicas_disagree": drift}
        checks["b_fault_%s_caught" % name] = moved or drift
    ring = {}
    for case in RING_CASES:
        per = [r["ring"][case] for r in ranks]
        attends = sum(p["attends"] for p in per)
        ring[case] = {"attends": attends, "of": PIPE_STAGES ** 2,
                      "ring_ms": [p["ring_ms"] for p in per],
                      "dense_ms": per[0]["dense_ms"],
                      "over_bar": per[0]["over_bar"],
                      "over_bar_out_dq_dk_dv": per[0]["over_bar_each"],
                      "faults_over_bar": per[0]["faults_over_bar"]}
        checks["c_%s_within_bars" % case] = per[0]["over_bar"] <= 1.0
        checks["c_%s_skips_exact" % case] = attends == RING_LIVE[case]
        checks["c_%s_ranks_bit_equal" % case] = len(
            {p["digest"] for p in per}) == 1
    checks["c_fault_backward_rotates_forward_caught"] = (
        ring["causal"]["faults_over_bar"]["backward_rotates_forward"] > 1.0)
    checks["c_fault_sink_block_dropped_caught"] = (
        ring["window1024_sinks4"]["faults_over_bar"]["sink_block_dropped"]
        > 1.0)
    report["b"] = {
        "stages": PIPE_STAGES, "backend": ranks[0]["backend"],
        "launches_per_rank": {run: [{k: r[run]["launches"][k]
                                     for k in FLASH_NAMES} for r in ranks]
                              for run in ("dense", "moe")},
        "want": {"dense": b_want, "moe": m_want},
        "stage_layers": [r["dense"]["stage_layers"] for r in ranks],
        "losses": ranks[0]["dense"]["losses"],
        "moe_losses": ranks[0]["moe"]["losses"],
        "steady": [r["dense"]["steady"] for r in ranks],
        "moe_steady": [r["moe"]["steady"] for r in ranks],
        "peak_bytes": {run: [r[run]["peak_bytes"] for r in ranks]
                       for run in ("dense", "moe")},
        "run_s": {run: [r[run]["run_s"] for r in ranks]
                  for run in ("dense", "moe")},
        "collectives_dense_run": [r["dense"]["collectives"] for r in ranks],
        "hop_ms": [r["hop_ms"] for r in ranks],
        "hop_bytes": ranks[0]["hop_bytes"],
        "output_all_reduce_ms": [r["output_all_reduce_ms"] for r in ranks],
        "faults": faults, "fault_limits": [PIPE_FAULT_LOSS, PIPE_FAULT_GRAD],
        "rank_s": [r["rank_s"] for r in ranks], "ranks_s": ranks_s}
    report["c"] = {"shape": list(ring_shape), "cases": ring,
                   "bars": RING_TOL}
    report.update(checks=checks, phase_s=time.monotonic() - began)
    print(json.dumps({"pipeline": report}, default=str), flush=True)
    failed = [key for key, v in checks.items() if not v]
    check(not failed, "pipeline and ring checks failed: %s" % failed)
    launches = {k: one["launches"][k] + moe_one["launches"][k]
                + sum(r[run]["launches"][k] for r in ranks
                      for run in ("dense", "moe")) for k in FLASH_NAMES}
    return launches


# --------------------------------------------------------------- phase 14
#: (a) the rolling-cache decode: LM_CONFIG built with RoPE (no
#: positional table), batch 8, seeded prompts of 128 tokens, a ring of
#: 256 slots behind 4 pinned sinks; 384 new tokens fill the LM's max_len
#: 512, 768 go 1.5 times past it
ROLLING = {"batch": 8, "prompt": 128, "window": 256, "sinks": 4}
ROLLING_NEW = (384, 768)
#: the 768-token decode loop's peak card memory may exceed the 384
#: one's by at most this many bytes (its token buffer is 12 KB larger)
ROLLING_PEAK_SLACK = 1 << 20
#: planted faults: the slot taken as pos % (sinks + window), so the
#: sinks are evicted; q/k rotated at the slot instead of the position.
#: Both show from position sinks + window = 260 on, so their runs decode
#: ROLLING_FAULT_NEW tokens past the 128-token prompt (to position 319)
ROLLING_FAULTS = ("sinks_evicted", "rope_at_slot")
ROLLING_FAULT_NEW = 192
#: new tokens of the decode whose card busy share is profiled
ROLLING_PROFILED = 16
#: a planted fault must read at least this many times LOGIT_TOL
FAULT_FACTOR = 10.0
#: (b) the GA over MNIST-FC's widths (784 -> 100 tanh -> 10 softmax,
#: minibatch 100, 10,000 validation samples) with layer 0's learning
#: rate as Tune(0.03, 0.005, 0.1).  A fitness is the best validation
#: n_err, and an epoch scores the validation set before it trains.  The
#: synthetic set is separable: after a few dozen steps at any rate in
#: the range every individual scores 0 errors, so at 60,000 train
#: samples the GA would compare ties.  The GA therefore trains ONE
#: minibatch an epoch for 2 epochs: the fitness is the validation n_err
#: after one SGD step, which falls with the rate.  The ensemble, scored
#: on its trained weights by evaluate_combined, trains 1 epoch of the
#: full 60,000
GA = {"generations": 2, "population": 3, "workers": 3, "epochs": 2,
      "n_train": 100, "tune": (0.03, 0.005, 0.1)}
ENSEMBLE = {"size": 2, "workers": 2, "epochs": 1, "n_train": 60000}
#: MNIST-FC's bar for every ensemble member (phase 5's)
POP_MAX_ERR_PCT = 5.0
POP_FAULTS = ("worker_skips_set_leaf", "restore_skipped")
#: (c) one seeded MNIST-shaped stream pushed through the ZeroMQ loader
ZMQ = {"n": 1000, "minibatch": 100, "shape": (784,)}


@contextlib.contextmanager
def patched(owner, name, value):
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield real
    finally:
        setattr(owner, name, real)


def rolling_fault(T, name):
    """A context planting one of ``ROLLING_FAULTS`` in the decode loop."""
    if name == "sinks_evicted":
        def faulty(slot_pos, pos, window, sinks=0):
            slot = pos % (sinks + window)
            slot_pos[slot] = pos
            live = (slot_pos >= 0) & (slot_pos <= pos)
            in_window = slot_pos > pos - window
            if sinks:
                in_window |= slot_pos < sinks
            return slot, slot_pos, live & in_window
        return patched(T, "rolling_slot_update", faulty)
    real = T.mha_decode_step_rolling

    def faulty(params, x, k_cache, v_cache, slot, live, pos, n_heads):
        return real(params, x, k_cache, v_cache, slot, live, slot, n_heads)
    return patched(T, "mha_decode_step_rolling", faulty)


def rolling_run(torch, T, params, prompt, n_new, n_heads, device):
    """One ``generate_rolling`` through the entry point.  Returns (tokens,
    the loop's seconds from its first step's bookkeeping to the end,
    card bytes allocated at the loop's start, the loop's peak, every
    step's logits on the host).  The peak counter is reset at the
    loop's start; each step's logits are copied to pinned host memory
    (one small asynchronous copy a step; no card allocation grows with
    the steps)."""
    r = ROLLING
    mark = {}
    real_update = T.rolling_slot_update

    def probe(slot_pos, pos, window, sinks=0):
        if not mark:
            torch.cuda.synchronize()
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
                mark["base"] = torch.cuda.memory_allocated()
            mark["t0"] = time.perf_counter()
        return real_update(slot_pos, pos, window, sinks=sinks)

    host = torch.empty((n_new, prompt.shape[0], params["embed"].shape[0]),
                       pin_memory=device == "cuda")
    real_head = T.head_logits
    calls = []

    def head(p, h):
        out = real_head(p, h)
        host[len(calls)].copy_(out[:, -1], non_blocking=True)
        calls.append(1)
        return out

    with patched(T, "rolling_slot_update", probe), \
            patched(T, "head_logits", head):
        toks = T.generate_rolling(params, prompt, n_new, n_heads,
                                  r["window"], temperature=0,
                                  sinks=r["sinks"])
        torch.cuda.synchronize()
    loop_s = time.perf_counter() - mark["t0"]
    base = mark.get("base", 0)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    return toks, loop_s, base, peak, host


def rolling_logit_err(torch, T, params, toks, logits, s, n_heads):
    """Max abs gap between each decode step's logits and a teacher-
    forced plain forward (rope, the window and sinks) over the emitted
    sequence, at the positions that chose tokens s..end."""
    r = ROLLING
    with torch.no_grad():
        ref = T.transformer_forward(params, toks[:, :-1], n_heads,
                                    rope=True, window=r["window"],
                                    sinks=r["sinks"])[:, s - 1:]
    got = logits.to(ref.device).transpose(0, 1)
    return float((got - ref).abs().max())


def rolling_phase(torch, T, card, device="cuda", cfg=None):
    """(a) ``generate_rolling`` at the full LM width: tokens against
    ``generate`` while its cache lasts, every step's logits against a
    teacher-forced plain forward, flat peak memory, two planted faults,
    ms a step and tokens/s.  Returns the report."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import attention as A
    from veles_tpu_torch.ops import functional as F
    cfg = cfg or LM_CONFIG
    r = ROLLING
    F.set_matmul_precision("float32")
    A.set_attention_backend("xla")
    t0 = time.monotonic()
    host = T.init_transformer_params(
        prng.RandomGenerator("init", SEED), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg["n_layers"], rope=True)
    params = T.tree_map(lambda a: torch.as_tensor(a, device=device), host)
    rng = numpy.random.RandomState(SEED)
    prompt = torch.as_tensor(rng.randint(0, cfg["vocab"], (
        r["batch"], r["prompt"])).astype(numpy.int32), device=device)
    setup_s = time.monotonic() - t0
    s, heads = r["prompt"], cfg["n_heads"]
    runs = {}
    for n_new in ROLLING_NEW:
        toks, loop_s, base, peak, logits = rolling_run(
            torch, T, params, prompt, n_new, heads, device)
        check(toks.shape == (r["batch"], s + n_new)
              and int(toks.min()) >= 0 and int(toks.max()) < cfg["vocab"],
              "rolling: malformed output %r" % (tuple(toks.shape),))
        err = rolling_logit_err(torch, T, params, toks, logits, s, heads)
        steps = n_new - 1
        runs[n_new] = {"loop_s": loop_s,
                       "ms_per_step": loop_s / steps * 1e3,
                       "tokens_per_s": r["batch"] * steps / loop_s,
                       "loop_start_bytes": base, "loop_peak_bytes": peak,
                       "loop_peak_growth_bytes": peak - base,
                       "max_abs_logit_err": err}
        if n_new + s <= cfg["max_len"]:
            with torch.no_grad():
                full = T.generate(params, prompt, n_new, heads,
                                  temperature=0, max_len=cfg["max_len"],
                                  rope=True, window=r["window"],
                                  sinks=r["sinks"])
            runs[n_new]["tokens_equal_generate"] = int(
                (full[:, s:] == toks[:, s:]).sum())
            runs[n_new]["tokens"] = r["batch"] * n_new
        del toks, logits
    # the card's busy share over a short decode (the prompt's prefill
    # included), and its kernel time a call
    busy, per_kernel = profile_steps(torch, lambda: (T.generate_rolling(
        params, prompt, ROLLING_PROFILED, heads, r["window"], temperature=0,
        sinks=r["sinks"]), torch.cuda.synchronize()), 1)
    profiled = {"new_tokens": ROLLING_PROFILED, "busy_share": busy,
                "kernel_ms": sum(per_kernel.values()) / 1e3,
                "top_kernels_ms": {k: v / 1e3 for k, v in sorted(
                    per_kernel.items(), key=lambda kv: -kv[1])[:5]}}
    faults = {}
    for name in ROLLING_FAULTS:
        with rolling_fault(T, name):
            toks, _, _, _, logits = rolling_run(
                torch, T, params, prompt, ROLLING_FAULT_NEW, heads, device)
        faults[name] = rolling_logit_err(torch, T, params, toks, logits, s,
                                         heads)
    short, long_ = (runs[n] for n in ROLLING_NEW)
    report = {"phase": "rolling", "card": card,
              "config": dict(cfg, rope=True, **r), "setup_s": setup_s,
              "runs": {str(k): v for k, v in runs.items()},
              "peak_long_minus_short_bytes": (long_["loop_peak_bytes"]
                                            - short["loop_peak_bytes"]),
              "profiled": profiled, "logit_tol": LOGIT_TOL,
              "faults": faults,
              "phase_s": time.monotonic() - t0}
    print(json.dumps(report), flush=True)
    for n, run in runs.items():
        check(run["max_abs_logit_err"] <= LOGIT_TOL,
              "rolling n_new %d: logits %g from the plain forward > %g"
              % (n, run["max_abs_logit_err"], LOGIT_TOL))
    check(report["peak_long_minus_short_bytes"] <= ROLLING_PEAK_SLACK,
          "rolling: the loop's peak grew %d bytes with n_new"
          % report["peak_long_minus_short_bytes"])
    for name, err in faults.items():
        check(err >= FAULT_FACTOR * LOGIT_TOL,
              "rolling fault %s read %g < %g x the limit" % (
                  name, err, FAULT_FACTOR))
    return report


def population_phase(torch, HK, card, device="cuda", loader=None):
    """(b) the GA and the ensemble on MNIST-FC, sequential in this
    process and in worker processes sharing the card: equal winners,
    fitnesses, histories, summaries, weights and combined errors; the
    winner's direct run; kernel 1's launches in this process exact; two
    planted faults caught.  Returns this process's kernel-1 launches."""
    from veles_tpu_torch import (genetics, prng, samples, snapshotter,
                                 subproc)
    from veles_tpu_torch.config import Tune, root
    from veles_tpu_torch.ensemble import train_ensemble
    from veles_tpu_torch.samples import mnist
    loader = dict(loader or {})
    began = time.monotonic()
    mb = 100

    def configure(run, tune):
        prng.reset()
        prng.seed_all(SEED)
        root.__dict__.pop("mnist", None)
        mnist.default_config()
        root.mnist.loader.update(dict(loader, n_train=run["n_train"]))
        root.mnist.decision.max_epochs = run["epochs"]
        if tune:
            root.mnist.layers[0]["learning_rate"] = Tune(*GA["tune"])

    evals = []
    real_run = samples.run_sample

    def recording(module, seed=None, build_kwargs=None, device=None):
        t0 = time.monotonic()
        wf = real_run(module, seed=seed, build_kwargs=build_kwargs,
                      device=device)
        torch.cuda.synchronize()
        evals.append({"lr": float(root.mnist.layers[0]["learning_rate"]),
                      "s": time.monotonic() - t0,
                      "fitness": wf.decision.best_metric,
                      "train_steps": wf.fused_step.train_steps})
        return wf

    batches = []
    real_eval = genetics.evaluate_population

    def timed_batch(module_name, genes, individuals, *args, **kwargs):
        t0 = time.monotonic()
        fits = real_eval(module_name, genes, individuals, *args, **kwargs)
        batches.append({"lrs": [i[0] for i in individuals], "fitness": fits,
                        "s": time.monotonic() - t0})
        return fits

    configure(ENSEMBLE, False)
    t0 = time.monotonic()
    wf = mnist.build()
    wf.initialize(device=device)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    del wf

    HK.reset_launch_counts()
    with patched(samples, "run_sample", recording), \
            patched(genetics, "evaluate_population", timed_batch):
        configure(GA, True)
        t0 = time.monotonic()
        seq_fit, seq_genes, seq_pop = genetics.optimize_workflow(
            mnist, GA["generations"], GA["population"], seed=SEED,
            device=device)
        seq_s = time.monotonic() - t0
        ga_evals = list(evals)
        ga_launches = HK.launch_counts()["fused_sgd_update"]
        ga_steps = sum(e["train_steps"] for e in ga_evals)
        # the winner, left in the config tree, trained directly
        direct = samples.run_sample(mnist, seed=SEED, device=device)
        direct_fit = direct.decision.best_metric
        del direct
        configure(GA, True)
        t0 = time.monotonic()
        par_fit, par_genes, par_pop = genetics.optimize_workflow(
            mnist, GA["generations"], GA["population"], seed=SEED,
            workers=GA["workers"], device=device)
        par_s = time.monotonic() - t0
        ga_batches = list(batches)
        by_lr = {e["lr"]: e["fitness"] for e in ga_evals}
        eval_s = {e["lr"]: e["s"] for e in ga_evals}
        for b in ga_batches:
            # a worker's start (python, torch, the card's context) and
            # its spec's round trip: the batch beyond its longest run
            b["overhead_s"] = b["s"] - max(eval_s[lr] for lr in b["lrs"])
        batches_equal = all([by_lr[lr] for lr in b["lrs"]] == b["fitness"]
                            for b in ga_batches)
        # fault: the workers skip set_leaf (their specs carry no genes)
        configure(GA, True)
        genes = genetics.find_tunes()
        picks = [[lr] for lr in by_lr if lr != GA["tune"][0]][:2]
        real_workers = subproc.run_workers

        def skip_genes(module_name, specs, workers, env_overrides=None):
            return real_workers(module_name, [dict(s, genes={})
                                              for s in specs], workers,
                                env_overrides)

        with patched(subproc, "run_workers", skip_genes):
            skipped = genetics.evaluate_population(
                mnist.__name__, genes, picks, SEED, len(picks),
                device=device)
        fault_ga = skipped != [by_lr[p[0]] for p in picks]

        # the ensemble, sequential and in workers
        def ensemble(workers):
            configure(ENSEMBLE, False)
            t0 = time.monotonic()
            trainer, combined = train_ensemble(
                mnist, size=ENSEMBLE["size"], base_seed=SEED,
                workers=workers, device=device)
            return trainer, combined, time.monotonic() - t0

        seq_tr, seq_comb, ens_seq_s = ensemble(0)
        summaries = []

        def keep(module_name, specs, workers, env_overrides=None):
            summaries[:] = real_workers(module_name, specs, workers,
                                        env_overrides)
            return summaries

        with patched(subproc, "run_workers", keep):
            par_tr, par_comb, ens_par_s = ensemble(ENSEMBLE["workers"])
        # fault: the restore skipped.  What the workers send is then
        # never read, so their summaries are handed back without
        # training them again
        with patched(snapshotter, "restore", lambda wf, path: None), \
                patched(subproc, "run_workers", lambda *a, **k: summaries):
            bad_tr, bad_comb, _ = ensemble(ENSEMBLE["workers"])
    torch.cuda.synchronize()
    launches = HK.launch_counts()["fused_sgd_update"]
    steps = sum(e["train_steps"] for e in evals)

    def weights(trainer):
        return [[v.mem for f in wf.forwards for v in (f.weights, f.bias)]
                for _, wf, _ in trainer.members]

    def same(a, b):
        return all(numpy.array_equal(x, y) for wa, wb in zip(a, b)
                   for x, y in zip(wa, wb))

    seq_w = weights(seq_tr)
    ens_equal = (same(seq_w, weights(par_tr)) and seq_comb == par_comb
                 and [m[2] for m in seq_tr.members]
                 == [m[2] for m in par_tr.members])
    fault_ens = not (same(seq_w, weights(bad_tr)) and bad_comb == seq_comb)
    member_err = [100.0 * n / seq_comb["count"]
                  for n in seq_comb["members"]]
    report = {
        "phase": "population", "card": card,
        "config": {"layers": "784-100tanh-10softmax", "minibatch": mb,
                   "n_valid": loader.get("n_valid", 10000),
                   "ga": GA, "ensemble": ENSEMBLE, "loader": loader},
        "setup_s": setup_s,
        "ga": {"sequential_s": seq_s, "workers_s": par_s,
               "best_fitness": seq_fit, "best_genes": seq_genes,
               "history": seq_pop.history,
               "workers_equal": (par_fit, par_genes, par_pop.history)
               == (seq_fit, seq_genes, seq_pop.history),
               "worker_fitness_equal_sequential": batches_equal,
               "direct_run_fitness": direct_fit,
               "evaluations": ga_evals, "worker_batches": ga_batches,
               "launches": ga_launches, "train_steps": ga_steps},
        "ensemble": {"sequential_s": ens_seq_s, "workers_s": ens_par_s,
                     "combined": seq_comb, "member_err_pct": member_err,
                     "summaries": [m[2] for m in seq_tr.members],
                     "workers_equal": ens_equal},
        "faults": {"worker_skips_set_leaf": {"fitness": skipped,
                                             "caught": fault_ga},
                   "restore_skipped": {"combined": bad_comb,
                                       "caught": fault_ens}},
        "launches": launches, "train_steps": steps,
        "phase_s": time.monotonic() - began}
    print(json.dumps(report), flush=True)
    ga_runs = len(ga_evals)
    check(ga_launches == ga_steps == ga_runs * GA["epochs"]
          * -(-GA["n_train"] // mb) and ga_runs >= 3,
          "GA: %d fused SGD launches for %d train steps in %d runs"
          % (ga_launches, ga_steps, ga_runs))
    check(report["ga"]["workers_equal"],
          "GA: workers=%d gave %r, sequential %r" % (
              GA["workers"], (par_fit, par_genes), (seq_fit, seq_genes)))
    check(batches_equal, "GA: a worker's fitness differs from the "
          "sequential one: %r vs %r" % (ga_batches, by_lr))
    check(direct_fit == seq_fit, "GA: the winner's direct run scored %r, "
          "its fitness %r" % (direct_fit, seq_fit))
    check(ens_equal, "ensemble: workers=%d differs from sequential"
          % ENSEMBLE["workers"])
    check(max(member_err) < POP_MAX_ERR_PCT,
          "ensemble: member validation error %r >= %g%%"
          % (member_err, POP_MAX_ERR_PCT))
    check(launches == steps, "population: %d fused SGD launches for %d "
          "train steps" % (launches, steps))
    check(fault_ga and fault_ens, "population: a planted fault went "
          "unnoticed: %r" % report["faults"])
    return launches


def zmq_phase(torch, card, device="cuda"):
    """(c) one seeded stream through ``ZeroMQLoader`` to the card: every
    device minibatch (data, labels, mask) bit-equal to the host samples,
    the live sizes, then the end of the stream and ``complete``."""
    from veles_tpu_torch.zmq_loader import ZeroMQLoader, push_samples
    z = ZMQ
    rng = numpy.random.RandomState(SEED)
    data = rng.standard_normal((z["n"],) + z["shape"]).astype(numpy.float32)
    labels = rng.randint(0, 10, z["n"]).astype(numpy.int32)
    loader = ZeroMQLoader(None, sample_shape=z["shape"],
                          minibatch_size=z["minibatch"], timeout_ms=10000,
                          name="zmq")
    loader.initialize(device=device)
    # the producer pushes from its own thread, as a separate process
    # would: it blocks at the sockets' high-water marks until the loader
    # drains them
    producer = threading.Thread(target=push_samples, args=(
        loader.endpoint, [{"data": d, "label": int(l)}
                          for d, l in zip(data, labels)]))
    sizes, equal, at = [], True, 0
    t0 = time.monotonic()
    producer.start()
    try:
        while not bool(loader.complete) and len(sizes) <= z["n"]:
            loader.run()
            size = loader.minibatch_size
            sizes.append(size)
            got = [getattr(loader, n).devmem for n in (
                "minibatch_data", "minibatch_labels", "minibatch_mask")]
            equal &= all(t.device.type == torch.device(device).type
                         for t in got)
            want_x = numpy.zeros((z["minibatch"],) + z["shape"],
                                 numpy.float32)
            want_y = numpy.zeros(z["minibatch"], numpy.int32)
            want_m = numpy.zeros(z["minibatch"], numpy.float32)
            want_x[:size] = data[at:at + size]
            want_y[:size] = labels[at:at + size]
            want_m[:size] = 1.0
            for t, w in zip(got, (want_x, want_y, want_m)):
                equal &= numpy.array_equal(t.cpu().numpy(), w)
            at += size
    finally:
        producer.join(timeout=60)
        loader.stop()
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    check(not producer.is_alive(), "zmq: the producer did not finish")
    full = z["n"] // z["minibatch"]
    report = {"phase": "zmq", "card": card, "config": {
        "samples": z["n"], "shape": list(z["shape"]),
        "minibatch": z["minibatch"]}, "run_s": run_s,
        "ms_per_minibatch": run_s / len(sizes) * 1e3, "sizes": sizes,
        "bit_equal": bool(equal), "complete": bool(loader.complete)}
    print(json.dumps(report), flush=True)
    check(sizes == [z["minibatch"]] * full + [0] and bool(loader.complete),
          "zmq: minibatch sizes %r" % sizes)
    check(equal, "zmq: a device minibatch differs from the host samples")
    return report


# --------------------------------------------------------------- phase 15
#: the deploy phase's model: full-width AlexNet (``alexnet_layers()``,
#: crop 227, 1000 classes) on the seeded 256x256 synthetic set, minibatch
#: 128, 384 train / 128 validation for 1 epoch: 3 train minibatches, the
#: last gated by Decision, so 2 committed updates
DEPLOY_LOADER = {"n_train": 384, "n_valid": 128, "epochs": 1}
#: predict batches held against the workflow's eval forward
DEPLOY_BATCHES = (1, 7, 128)
#: the artifact on the card vs the eval forward: the program runs the
#: same ATen ops on the same card
DEPLOY_ATOL = 1e-6
#: the card vs the CPU (cuDNN and the CPU sum the convolutions in other
#: orders), a reply vs a direct predict (the batcher runs rows in other
#: batch shapes), the native runner vs predict (AOTInductor's generated
#: pointwise code): outputs are softmax probabilities, O(1e-3)
DEPLOY_CROSS_ATOL = 1e-5
#: REST: requests of one image each, from this many client threads;
#: the batched run's max_batch.  32 latencies give a median and a
#: maximum, no tail: a p99 of them would be the maximum by another name
DEPLOY_REQUESTS, DEPLOY_CLIENTS, DEPLOY_MAX_BATCH = 32, 8, 32
#: the native bundle's static batch
DEPLOY_NATIVE_BATCH = 8
#: the cut model's loader: only its sample shape is read
NATIVE_LOADER = {"minibatch_size": 8, "n_train": 8, "n_valid": 8,
                 "epochs": 1}
#: the CLI leg: MNIST-FC at configs[0]'s widths (784->100 tanh->10,
#: minibatch 100), the data cut to 6,000 / 1,000 for 2 epochs; rows
#: posted one a request to it and to ``serve_snapshot`` of its snapshot
DEPLOY_CLI = ["root.mnist.loader.n_train=6000",
              "root.mnist.loader.n_valid=1000",
              "root.mnist.decision.max_epochs=2"]
DEPLOY_CLI_ROWS = 16
#: planted faults, each of which a check of this phase must catch
DEPLOY_FAULTS = ("int8_scale_over_input_axis", "lrn_k_altered",
                 "batcher_rows_to_wrong_requests", "runner_op_skips_kernel")


def native_layers(layers):
    """The native leg's model: ``layers`` cut after their second pooling
    layer (AlexNet's first two conv blocks, both LRN layers), then their
    softmax head: fewer kernels for AOTInductor to generate and compile
    than the whole net has."""
    cut = [i for i, layer in enumerate(layers)
           if layer["type"] == "max_pooling"][1] + 1
    return layers[:cut] + layers[-1:]


def plain_int8(flat):
    """Per-output-channel symmetric int8 of every ``<layer>/w`` (the
    scale over each weight's last axis), written out here independently
    of ``export._quantize_int8``."""
    out = {}
    for key, arr in flat.items():
        if not (key.endswith("/w") and arr.ndim >= 2):
            out[key] = arr
            continue
        flat_w = arr.reshape(-1, arr.shape[-1])
        scale = numpy.maximum(numpy.abs(flat_w).max(axis=0) / 127.0,
                              1e-12).astype(numpy.float32)
        out[key] = numpy.clip(numpy.rint(arr / scale), -127,
                              127).astype(numpy.int8)
        out[key + ".scale"] = scale
    return out


def faulty_runner_source(path):
    """The runner's source with both of the LRN op's implementations
    returning x (no window sum, no kernel), written to ``path``."""
    from veles_tpu_torch import native
    text = native.RUNNER_SOURCE.read_text()
    for fn in ("lrn_forward_cpu", "lrn_forward_cuda"):
        head = text.index("std::tuple<at::Tensor, at::Tensor> %s(" % fn)
        body = text.index("{\n", head) + 2
        text = (text[:body] + "  return {x.clone(), at::ones_like(x)};\n"
                + text[body:])
    check(text.count("return {x.clone(), at::ones_like(x)};") == 2,
          "deploy: the runner fault was not planted")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return path


@contextlib.contextmanager
def deploy_fault(name, wf=None):
    """Within the block, ``name`` of ``DEPLOY_FAULTS`` is planted (the
    runner fault is a separate build: see ``faulty_runner_source``)."""
    from veles_tpu_torch import export
    from veles_tpu_torch.serving import batcher
    if name == "int8_scale_over_input_axis":
        owner, attr = export, "_quantize_int8"
        inner = export._quantize_int8

        def planted(flat):
            out = {}
            for key, arr in flat.items():
                if key.endswith("/w") and arr.ndim >= 2:
                    scale = numpy.maximum(numpy.abs(arr).max(
                        axis=-1, keepdims=True) / 127.0, 1e-12).astype(
                            numpy.float32)
                    out[key] = numpy.clip(numpy.rint(arr / scale), -127,
                                          127).astype(numpy.int8)
                    out[key + ".scale"] = scale
                else:
                    out[key] = arr
            return out
    elif name == "lrn_k_altered":
        norms = [f for f in wf.forwards if f.layer_type == "norm"]
        saved = [f.k for f in norms]
        for f in norms:
            f.k = 1.0
        try:
            yield
        finally:
            for f, k in zip(norms, saved):
                f.k = k
        return
    else:
        owner, attr = batcher.MicroBatcher, "_dispatch"
        inner = batcher.MicroBatcher._dispatch

        def planted(self, items):
            futures = [it.future for it in items]
            for it, fut in zip(items, futures[1:] + futures[:1]):
                it.future = fut
            return inner(self, items)
    setattr(owner, attr, planted)
    try:
        yield
    finally:
        setattr(owner, attr, inner)


def int8_exact(torch, export, runner, fp32_flat, q_path, rows, tmp, device):
    """The int8 artifact's exact check: its stored arrays equal
    ``plain_int8`` of the fp32 weights, each loaded tensor is scale x
    int8, and its outputs equal, bit for bit, those of an fp32 artifact
    exported from the dequantized weights.  Returns (ok, report)."""
    import io
    import tarfile
    want = plain_int8(fp32_flat)
    with tarfile.open(q_path, "r:gz") as tar:
        npz = numpy.load(io.BytesIO(tar.extractfile(export.WEIGHTS).read()))
        stored = {k: npz[k] for k in npz.files}
    stored_equal = sorted(stored) == sorted(want) and all(
        stored[k].dtype == want[k].dtype and stored[k].shape == want[k].shape
        and numpy.array_equal(stored[k], want[k]) for k in want)
    qm = export.load_model(q_path, device=device)
    deq = {}
    for key, arr in zip(qm.manifest["param_keys"], qm._params):
        deq[key] = arr
    deq_equal = all(numpy.array_equal(
        deq[k], stored[k + ".scale"] * stored[k].astype(numpy.float32))
        if stored[k].dtype == numpy.int8 else numpy.array_equal(
            deq[k], stored[k]) for k in deq)
    # an fp32 artifact from the dequantized weights
    saved = runner.state
    runner.state = [dict(e) for e in saved]
    for key, arr in deq.items():
        layer, pname = key.split("/", 1)
        runner.state[int(layer)][pname] = torch.from_numpy(arr).to(
            saved[int(layer)][pname].device)
    try:
        deq_path = export.export_model(runner.wf, os.path.join(
            tmp, "dequantized.veles"))
    finally:
        runner.state = saved
    q_out = qm.predict(rows)
    d_out = export.load_model(deq_path, device=device).predict(rows)
    outputs_equal = bool(numpy.array_equal(q_out, d_out))
    ok = stored_equal and deq_equal and outputs_equal
    return ok, {"stored_equal_plain_int8": bool(stored_equal),
                "dequantized_equal_scale_x_int8": bool(deq_equal),
                "outputs_bit_equal_dequantized_fp32": outputs_equal,
                "q_out": q_out}


def post_json(url, body, timeout=120):
    """POST raw bytes; returns (status, parsed JSON body)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def rest_load(api, bodies, clients):
    """``len(bodies)`` requests from ``clients`` threads started
    together; returns ({i: reply}, [latency s], wall s)."""
    url = "http://127.0.0.1:%d/predict" % api.port
    replies, latencies, lock = {}, [], threading.Lock()
    start = threading.Barrier(clients)

    def client(ci):
        start.wait()
        for i in range(ci, len(bodies), clients):
            t0 = time.monotonic()
            status, out = post_json(url, bodies[i])
            dt = time.monotonic() - t0
            with lock:
                replies[i] = (status, out)
                latencies.append(dt)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return replies, latencies, time.monotonic() - t0


def rest_leg(torch, HK, restful_api, path, rows, direct, n_lrn, device,
             max_batch, n_requests=DEPLOY_REQUESTS):
    """``serve_artifact`` direct (``max_batch`` 0) or batched: replies
    against a direct predict of each row, the LRN launches a forward, the
    413 and 400 errors.  Returns (report, rows wrong)."""
    api = restful_api.serve_artifact(
        path, port=0, max_batch=max_batch,
        device=None if device == "cuda" else device)
    try:
        distinct = [json.dumps({"input": r[None].tolist()}).encode()
                    for r in rows]
        bodies = [distinct[i % len(rows)] for i in range(n_requests)]
        HK.reset_launch_counts()
        replies, latencies, wall = rest_load(api, bodies, DEPLOY_CLIENTS)
        launches = HK.launch_counts()["lrn_forward"]
        snap = api.metrics.snapshot() if api.metrics is not None else None
        url = "http://127.0.0.1:%d/predict" % api.port
        too_big, _ = post_json(url, b" " * (api.max_body + 1))
        bad_shape, bad_body = post_json(url, json.dumps(
            {"input": [[0.0] * 5]}).encode())
    finally:
        api.stop()
    wrong, worst = 0, 0.0
    for i, (status, out) in sorted(replies.items()):
        want = direct[i % len(rows)]
        got = numpy.asarray(out.get("output", [[numpy.nan]]), numpy.float32)
        gap = (float(numpy.abs(got - want).max())
               if status == 200 and got.shape == want.shape else numpy.inf)
        worst = max(worst, gap)
        if (status != 200 or gap > DEPLOY_CROSS_ATOL
                or out.get("argmax") != want.argmax(1).tolist()):
            wrong += 1
    forwards = snap["dispatches"] if max_batch else n_requests
    lat = sorted(latencies)
    report = {"max_batch": max_batch, "requests": n_requests,
              "clients": DEPLOY_CLIENTS, "wall_s": wall,
              "requests_per_s": n_requests / wall,
              "p50_s": statistics.median(lat),
              "max_s": lat[-1],
              "replies_wrong": wrong, "max_abs_gap": worst,
              "forwards": forwards, "lrn_launches": launches,
              "status_413": too_big, "status_400": bad_shape,
              "error_400": bad_body.get("error")}
    if max_batch:
        report["mean_batch"] = snap["batch_size"]["mean"]
    report["ok"] = bool(
        wrong == 0 and len(replies) == n_requests and too_big == 413
        and bad_shape == 400 and launches == n_lrn * forwards
        and (not max_batch or report["mean_batch"] > 1))
    return report, wrong


def request_split(torch, model, row):
    """One request's time split on the host clock: JSON decode (and the
    list to array conversion), the forward on the card, JSON encode."""
    body = json.dumps({"input": row[None].tolist()}).encode()
    reps = 3
    t0 = time.monotonic()
    for _ in range(reps):
        x = numpy.asarray(json.loads(body)["input"], numpy.float32)
    decode = (time.monotonic() - t0) / reps
    model.predict(x)
    t0 = time.monotonic()
    for _ in range(reps):
        probs = model.predict(x)
    forward = (time.monotonic() - t0) / reps
    t0 = time.monotonic()
    for _ in range(reps):
        json.dumps({"output": probs.tolist(),
                    "argmax": probs.argmax(1).tolist()}).encode()
    encode = (time.monotonic() - t0) / reps
    return {"request_bytes": len(body), "json_decode_s": decode,
            "forward_s": forward, "json_encode_s": encode}


def build_runners(tmp):
    """Start the runner's build and the faulty runner's (g++ each) in
    the background; returns {name: future of (path, seconds)}."""
    from concurrent.futures import ThreadPoolExecutor
    from veles_tpu_torch import native

    def timed(source):
        t0 = time.monotonic()
        return native.build_runner(source), time.monotonic() - t0

    pool = ThreadPoolExecutor(max_workers=2)
    futures = {"sound": pool.submit(timed, native.RUNNER_SOURCE),
               "faulty": pool.submit(timed, faulty_runner_source(
                   os.path.join(tmp, "artifact_runner.cpp")))}
    pool.shutdown(wait=False)
    return futures


def cli_serve_leg(torch, device, tmp):
    """(d) ``python -m veles_tpu_torch ... --serve 0 --serve-batch 8`` in
    a subprocess; its replies to ``DEPLOY_CLI_ROWS`` rows (one a request)
    against ``serve_snapshot`` of its final snapshot on the same rows."""
    import signal
    from veles_tpu_torch import prng, restful_api
    from veles_tpu_torch.config import parse_override, root
    from veles_tpu_torch.samples import mnist
    snaps = os.path.join(tmp, "cli_snaps")
    argv = [sys.executable, "-m", "veles_tpu_torch",
            "veles_tpu_torch.samples.mnist", "--random-seed", str(SEED),
            "--no-stats", "--serve", "0", "--serve-batch", "8",
            "--snapshot-dir", snaps] + DEPLOY_CLI
    if device != "cuda":
        argv[4:4] = ["-d", device]
    log = os.path.join(tmp, "cli.log")
    t0 = time.monotonic()
    with open(log, "w", encoding="utf-8") as err:
        proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=err, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        line = proc.stdout.readline()
        serving_s = time.monotonic() - t0
        if not line.startswith("SERVING http://127.0.0.1:"):
            with open(log, encoding="utf-8") as f:
                tail = f.read()[-3000:]
            check(False, "deploy: the CLI printed %r, not its SERVING "
                  "line:\n%s" % (line, tail))
        url = line.split()[1]

        def build():
            prng.reset()
            root.__dict__.pop("mnist", None)
            mnist.default_config()
            for token in DEPLOY_CLI:
                parse_override(token)
            wf = mnist.build()
            wf.initialize(device=device)
            return wf

        api = restful_api.serve_snapshot(
            os.path.join(snaps, "mnist_current.pickle.gz"), port=0,
            build=build)
        try:
            data = api.workflow.loader.original_data.devmem
            rows = data[:DEPLOY_CLI_ROWS].cpu().numpy()
            equal = True
            for row in rows:
                body = json.dumps({"input": row[None].tolist()}).encode()
                a = post_json(url, body)
                b = post_json("http://127.0.0.1:%d/predict" % api.port, body)
                equal &= a[0] == b[0] == 200 and a[1]["output"] == \
                    b[1]["output"] and a[1]["argmax"] == b[1]["argmax"]
        finally:
            api.stop()
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return {"argv": argv[2:], "seconds_to_serving": serving_s,
            "rows": DEPLOY_CLI_ROWS, "bit_equal_to_serve_snapshot":
            bool(equal), "exit_code": proc.returncode}


def deploy_phase(torch, HK, card, device="cuda", layers=None, loader=None):
    """Phase 15: export, REST serving and the native runner of a trained
    full-width AlexNet, with the LRN forward kernel inside the exported
    program; the CLI's ``--serve``; four planted faults.  Returns the LRN
    forward launches of the deployment paths."""
    import shutil
    import tempfile
    from veles_tpu_torch import export, native, prng, restful_api
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import imagenet
    began = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="veles_deploy_")
    on = None if device == "cuda" else device
    try:
        runners = build_runners(tmp)
        # (a) train, export, load, predict
        layers = layers or imagenet.alexnet_layers()
        t0 = time.monotonic()
        wf = imagenet_build(prng, root, imagenet, layers,
                            **dict(DEPLOY_LOADER, **(loader or {})))
        wf.initialize(device=device)
        wf.run()
        torch.cuda.synchronize()
        train_s = time.monotonic() - t0
        runner = wf._fused_runner
        n_lrn = sum(1 for f in wf.forwards if f.layer_type == "norm")
        rows = wf.loader.original_data.devmem[:max(DEPLOY_BATCHES)].cpu() \
            .numpy()

        def eval_rows(x):
            return runner.eval_forward()(
                runner.state, torch.from_numpy(x).to(device)).cpu().numpy()

        sizes, seconds = {}, {}
        paths = {q: os.path.join(tmp, "alexnet_%s.veles" % (q or "fp32"))
                 for q in (None, "int8")}
        for q, p in paths.items():
            t0 = time.monotonic()
            export.export_model(wf, p, quantize=q)
            seconds[q or "fp32"] = time.monotonic() - t0
            sizes[q or "fp32"] = os.path.getsize(p)
        t0 = time.monotonic()
        model = export.load_model(paths[None], device=on)
        load_s = time.monotonic() - t0
        predicts, predict_ok = [], True
        for b in DEPLOY_BATCHES:
            x = rows[:b]
            want = eval_rows(x)
            HK.reset_launch_counts()
            t0 = time.monotonic()
            got = model.predict(x)
            dt = time.monotonic() - t0
            lrn = HK.launch_counts()["lrn_forward"]
            gap = float(numpy.abs(got - want).max())
            same_argmax = bool((got.argmax(1) == want.argmax(1)).all())
            predicts.append({"batch": b, "lrn_launches": lrn,
                             "max_abs_gap": gap, "argmax_equal": same_argmax,
                             "bit_equal": bool(numpy.array_equal(got, want)),
                             "predict_s": dt})
            predict_ok &= (lrn == n_lrn and gap <= DEPLOY_ATOL
                           and same_argmax and got.shape == want.shape)
        card_7 = model.predict(rows[:7])
        cpu_7 = export.load_model(paths[None], device="cpu").predict(
            rows[:7])
        cpu_gap = float(numpy.abs(cpu_7 - card_7).max())
        fp32_flat = {k: v.detach().cpu().numpy() for k, v in
                     export._flatten_state(
                         [{k: v for k, v in e.items() if k in ("w", "b")}
                          for e in runner.state]).items()}
        int8_ok, int8 = int8_exact(torch, export, runner, fp32_flat,
                                   paths["int8"], rows, tmp, on)
        agree = float((int8.pop("q_out").argmax(1) ==
                       model.predict(rows).argmax(1)).mean())
        # (b) REST, direct and batched
        direct = [model.predict(r[None]) for r in rows[:DEPLOY_CLIENTS]]
        rest = {}
        for mb in (0, DEPLOY_MAX_BATCH):
            rest["direct" if not mb else "batched"], _ = rest_leg(
                torch, HK, restful_api, paths[None], rows[:DEPLOY_CLIENTS],
                direct, n_lrn, device, mb)
        split = request_split(torch, model, rows[0])
        # (c) the native runner, on the trained model cut to its conv
        # blocks and softmax head (``native_layers``)
        t0 = time.monotonic()
        cut = imagenet_build(prng, root, imagenet, native_layers(layers),
                             **dict(NATIVE_LOADER, **(loader or {})))
        cut.initialize(device=device)
        cut_runner = cut._fused_runner
        # the conv blocks' trained weights; the head keeps its own (it
        # reads pool2's 43,264 features, not fc7's 4096)
        for mine, trained in zip(cut_runner.state[:-1], runner.state):
            for k in ("w", "b"):
                if k in mine:
                    mine[k].copy_(trained[k])
        cut_s = time.monotonic() - t0
        t0 = time.monotonic()
        bundle = export.export_native_bundle(
            cut, os.path.join(tmp, "bundle"), batch=DEPLOY_NATIVE_BATCH)
        aoti_s = time.monotonic() - t0
        runner_bin, runner_build_s = runners["sound"].result()
        x8 = rows[:DEPLOY_NATIVE_BATCH]
        want8 = cut_runner.eval_forward()(
            cut_runner.state, torch.from_numpy(x8).to(device)).cpu().numpy()
        t0 = time.monotonic()
        out8, native_lrn, _, stderr = native.run_artifact(
            bundle, x8, runner=runner_bin)
        native_s = time.monotonic() - t0
        mem = [line.split()[2:] for line in stderr.splitlines()
               if line.startswith("card bytes ")]
        native_gap = float(numpy.abs(out8 - want8).max())
        native_want = n_lrn if device == "cuda" else 0
        native_ok = (native_gap <= DEPLOY_CROSS_ATOL and native_lrn ==
                     native_want and (out8.argmax(1) ==
                                      want8.argmax(1)).all())
        # (d) the CLI's --serve
        cli = cli_serve_leg(torch, device, tmp)
        # (e) the planted faults
        caught = {}
        with deploy_fault("int8_scale_over_input_axis"):
            bad = os.path.join(tmp, "bad_int8.veles")
            export.export_model(wf, bad, quantize="int8")
        caught["int8_scale_over_input_axis"] = not int8_exact(
            torch, export, runner, fp32_flat, bad, rows[:8], tmp, on)[0]
        with deploy_fault("lrn_k_altered", wf):
            bad = export.export_model(wf, os.path.join(tmp, "bad_k.veles"))
        gap_k = float(numpy.abs(export.load_model(bad, device=on).predict(
            rows[:7]) - eval_rows(rows[:7])).max())
        caught["lrn_k_altered"] = gap_k > DEPLOY_ATOL
        with deploy_fault("batcher_rows_to_wrong_requests"):
            _, wrong = rest_leg(torch, HK, restful_api, paths[None],
                                rows[:DEPLOY_CLIENTS], direct, n_lrn,
                                device, DEPLOY_MAX_BATCH,
                                n_requests=2 * DEPLOY_CLIENTS)
        caught["batcher_rows_to_wrong_requests"] = wrong > 0
        faulty_bin, _ = runners["faulty"].result()
        f_out, f_lrn, _, _ = native.run_artifact(bundle, x8,
                                                 runner=faulty_bin)
        f_gap = float(numpy.abs(f_out - want8).max())
        caught["runner_op_skips_kernel"] = (f_gap > DEPLOY_CROSS_ATOL
                                            or f_lrn != native_want)
        deploy_launches = (sum(p["lrn_launches"] for p in predicts)
                           + rest["direct"]["lrn_launches"]
                           + rest["batched"]["lrn_launches"] + native_lrn)
        report = {
            "phase": "deploy", "card": card,
            "config": {"layers": "alexnet_layers()" if layers is None
                       else "given", "image_hw": list(wf.loader.image_hw),
                       "minibatch": wf.loader.max_minibatch_size,
                       "n_train": wf.loader.class_lengths[2],
                       "train_steps": wf.fused_step.train_steps,
                       "lrn_layers": n_lrn},
            "train_s": train_s,
            "export": {"bytes": sizes, "seconds": seconds,
                       "load_s": load_s, "predict": predicts,
                       "card_vs_cpu_max_abs_gap": cpu_gap,
                       "int8": dict(int8, argmax_agreement_with_fp32=agree)},
            "rest": dict(rest, one_request=split),
            "native": {"model": "cut after pool2, softmax head",
                       "weights": sum(v.numel() for e in cut_runner.state
                                      for k, v in e.items()
                                      if k in ("w", "b")),
                       "cut_setup_s": cut_s, "aoti_compile_s": aoti_s,
                       "runner_build_s": runner_build_s,
                       "run_s": native_s, "max_abs_gap": native_gap,
                       "lrn_launches": native_lrn,
                       "card_bytes_used_and_allocator_peak":
                       [int(v) for v in mem[0]] if mem else None,
                       "bundle_bytes": os.path.getsize(
                           os.path.join(bundle, "program.pt2"))},
            "cli": cli,
            "faults": {"caught": caught, "lrn_k_gap": gap_k,
                       "runner_gap": f_gap, "runner_lrn_launches": f_lrn},
            "deploy_launches": deploy_launches,
            "phase_s": time.monotonic() - began}
        print(json.dumps({"deploy": report}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(predict_ok, "deploy: the artifact's predict disagrees with the "
          "eval forward or launched the LRN kernel %r times: %r"
          % (n_lrn, predicts))
    check(cpu_gap <= DEPLOY_CROSS_ATOL, "deploy: the artifact on the CPU "
          "is %g from the card's" % cpu_gap)
    check(int8_ok, "deploy: the int8 artifact's exact check failed: %r"
          % int8)
    for name, leg in rest.items():
        check(leg["ok"], "deploy: REST %s failed: %r" % (name, leg))
    check(native_ok, "deploy: the native runner is %g from the cut model's "
          "eval forward with %d LRN launches" % (native_gap, native_lrn))
    check(cli["bit_equal_to_serve_snapshot"], "deploy: the CLI's replies "
          "differ from serve_snapshot's")
    for name in DEPLOY_FAULTS:
        check(caught[name], "deploy: the planted fault %r was not caught"
              % name)
    return deploy_launches


# --------------------------------------------------------------- phase 16
#: the observe phase's runs: MNIST-FC at configs[0]'s widths (the
#: sample's defaults: 784→100 tanh→10 softmax, minibatch 100, 60,000 /
#: 10,000 synthetic samples), 3 epochs in process; 2 in the CLI child
#: and in the streamed run (windows of 50 minibatches)
OBSERVE_EPOCHS = 3
OBSERVE_CLI_EPOCHS = 2
OBSERVE_WINDOW = 50
OBSERVE_FAULTS = ("weights_not_transposed", "confusion_transposed",
                  "reporter_epoch_behind", "events_drop_levelname")
#: the keys of one structured event (the reference's ``_event_dict``)
EVENT_KEYS = ["t", "level", "logger", "msg"]


def same_spec(a, b):
    """Deep equality of two plot specs: dicts in key order, lists, numpy
    arrays of the same dtype and shape, scalars of the same type."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same_spec(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_spec(x, y) for x, y in zip(a, b)))
    if isinstance(a, numpy.ndarray):
        return (isinstance(b, numpy.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and numpy.array_equal(a, b))
    return type(a) is type(b) and a == b


def numpy_only(spec):
    """True when every array in ``spec`` is a numpy array (lists of
    Python numbers allowed), so another process can unpickle it."""
    if isinstance(spec, dict):
        return all(numpy_only(v) for v in spec.values())
    if isinstance(spec, (list, tuple)):
        return all(numpy_only(v) for v in spec)
    return isinstance(spec, (numpy.ndarray, str, int, float, type(None)))


def weights_ok(spec, committed, limit=64):
    """``Weights2D``'s spec is the committed (n_in, n_out) weights,
    transposed and reshaped to 28x28, bit for bit."""
    want = committed.T[:limit].reshape(-1, 28, 28)
    got = spec["images"] if spec else None
    return (isinstance(got, numpy.ndarray) and got.shape == want.shape
            and got.dtype == want.dtype and numpy.array_equal(got, want))


def confusion_ok(matrix, metrics):
    """The plotted confusion matrix is one set's of one epoch
    (``metrics``: the decision's numbers for it), sums to its count and
    holds count - n_err on its trace."""
    return (isinstance(matrix, numpy.ndarray)
            and numpy.array_equal(matrix, metrics["confusion"])
            and int(matrix.sum()) == metrics["count"]
            and int(numpy.trace(matrix)) == metrics["count"]
            - metrics["n_err"])


def row_ok(row, summary, epochs):
    """A dashboard row holds the run's end: its epoch count, best metric
    and last metrics (``Launcher.result_summary``'s)."""
    return (row.get("epoch") == epochs and row.get("complete") is True
            and row.get("best") == summary["best_metric"]
            and row.get("metrics") == summary["last_epoch_metrics"])


def events_ok(lines, epochs):
    """Every line of an events file is one JSON object with the
    reference's keys; the decision logged each epoch at INFO."""
    try:
        events = [json.loads(x) for x in lines]
    except ValueError:
        return False
    decided = [e for e in events if e.get("logger", "").endswith(
        ".decision") and e.get("msg", "").startswith("epoch ")]
    return (bool(events) and all(list(e) == EVENT_KEYS for e in events)
            and [e["level"] for e in decided] == ["INFO"] * epochs
            and [int(e["msg"].split()[1]) for e in decided]
            == list(range(1, epochs + 1)))


def joined_collector(server, deadline_s=20.0):
    """A SUB socket on ``server``, joined: a probe spec is resent until
    one arrives (no fixed wait for the slow joiner); returns (socket,
    seconds to join)."""
    import pickle
    import zmq
    sock = zmq.Context.instance().socket(zmq.SUB)
    sock.connect(server.endpoint)
    sock.setsockopt(zmq.SUBSCRIBE, b"")
    begin = time.monotonic()
    while time.monotonic() - begin < deadline_s:
        server.send({"kind": "probe", "name": "probe"})
        if sock.poll(50, zmq.POLLIN):
            while sock.poll(200, zmq.POLLIN):
                pickle.loads(sock.recv())
            return sock, time.monotonic() - begin
    check(False, "observe: the graphics subscriber did not join")


def drain(sock):
    """Every spec the collector holds, up to the end of the stream."""
    import pickle
    import zmq
    got = []
    while sock.poll(2000, zmq.POLLIN):
        spec = pickle.loads(sock.recv())
        if spec is None:
            return got, True
        if spec.get("name") != "probe":
            got.append(spec)
    return got, False


def observe_build(device, epochs=OBSERVE_EPOCHS):
    """The seeded MNIST-FC workflow at the sample's defaults
    (``configs[0]``'s widths) for ``epochs`` epochs, built."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import mnist
    prng.reset()
    prng.seed_all(SEED)
    root.__dict__.pop("mnist", None)
    mnist.default_config()
    return mnist.build(fused=True, decision={"max_epochs": epochs,
                                             "fail_iterations": 50})


def observe_run(torch, HK, device, scan, observed, tmp):
    """One run of ``observe_build`` through the Launcher (graph loop, or
    the epoch scan at chunk 1), with or without the observers: the
    standard plotters into a graphics server with a subscriber, a
    dashboard with its reporter, and an events file.  Returns a dict of
    what the checks read."""
    from veles_tpu_torch import logger, web_status
    from veles_tpu_torch.graphics_server import GraphicsServer
    from veles_tpu_torch.launcher import Launcher
    wf = observe_build(device)
    out = {"wf": wf}
    if observed:
        server = wf.graphics_server = GraphicsServer("tcp://127.0.0.1:0")
        sock, out["join_s"] = joined_collector(server)
        out["plotters"] = wf.link_plotters(output_dir=tmp)
        out["status"] = web_status.attach_web_status(wf)
        out["reporter"] = [u for u in wf
                           if isinstance(u, web_status.StatusReporter)][0]
        out["events"] = os.path.join(tmp, "events_%d.jsonl" % scan)
        logger.setup_logging(events_file=out["events"])
        # the epoch-end work alone (a unit's run_time also holds the
        # minibatches its gate turns away)
        out["epoch_end_s"] = {}
        for unit, method in [(p, "redraw") for p in out["plotters"]] + [
                (out["reporter"], "report")]:
            out["epoch_end_s"][unit.name] = 0.0
            inner = getattr(unit, method)

            def timed(*args, _inner=inner, _name=unit.name):
                t = time.perf_counter()
                try:
                    return _inner(*args)
                finally:
                    out["epoch_end_s"][_name] += time.perf_counter() - t
            setattr(unit, method, timed)
    launcher = Launcher(wf, stats=False, epoch_scan=1 if scan else 0,
                        device=None if device == "cuda" else device)
    HK.reset_launch_counts()
    t0 = time.monotonic()
    try:
        launcher.boot()
        torch.cuda.synchronize()
    finally:
        out["run_s"] = time.monotonic() - t0
        out["launches"] = HK.launch_counts()["fused_sgd_update"]
        if observed:
            logger.setup_logging()
            server.close()
            out["received"], out["ended"] = drain(sock)
            sock.close(linger=0)
    out["launcher"] = launcher
    out["summary"] = launcher.result_summary()
    out["weights"] = [[e[k].cpu().numpy().copy() for k in ("w", "b")]
                      for e in wf._fused_runner.state if e]
    out["metrics"] = wf.decision.epoch_metrics
    return out


def cli_status_leg(device, tmp):
    """(b) ``python -m veles_tpu_torch veles_tpu_torch.samples.mnist
    --web-status-url ... --events-file ...`` in a subprocess, reporting
    into a dashboard of this process."""
    from veles_tpu_torch.web_status import WebStatus
    status = WebStatus().start()
    url = "http://127.0.0.1:%d" % status.port
    events = os.path.join(tmp, "cli_events.jsonl")
    result = os.path.join(tmp, "cli_result.json")
    argv = [sys.executable, "-m", "veles_tpu_torch",
            "veles_tpu_torch.samples.mnist", "--random-seed", str(SEED),
            "--no-stats", "--web-status-url", url, "--events-file", events,
            "--result-file", result,
            "root.mnist.decision.max_epochs=%d" % OBSERVE_CLI_EPOCHS]
    if device != "cuda":
        argv[4:4] = ["-d", device]
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    try:
        proc = subprocess.run(argv, cwd=repo, capture_output=True,
                              text=True, timeout=300,
                              env=dict(os.environ, PYTHONPATH=repo))
        child_s = time.monotonic() - t0
        check(proc.returncode == 0, "observe: the CLI child failed:\n%s"
              % proc.stderr[-3000:])
        with open(result, encoding="utf-8") as f:
            summary = json.load(f)
        row = status.snapshot().get("mnist", {})
        pages = {path: get_page(url + path) for path in (
            "/graph/mnist.dot", "/graph/mnist.svg", "/metrics",
            "/timeseries.json")}
        with open(events, encoding="utf-8") as f:
            lines = f.read().splitlines()
    finally:
        status.stop()
    metrics_text = pages["/metrics"][1]
    out = {
        "argv": argv[2:], "child_s": child_s,
        "row_equals_result": row_ok(row, summary, OBSERVE_CLI_EPOCHS),
        "row_epoch": row.get("epoch"), "row_best": row.get("best"),
        "result_best_metric": summary["best_metric"],
        "result_best_epoch": summary["best_epoch"],
        "dot_served": pages["/graph/mnist.dot"][0] == 200
        and pages["/graph/mnist.dot"][1].startswith("digraph mnist"),
        "svg_served": pages["/graph/mnist.svg"][0] == 200
        and pages["/graph/mnist.svg"][1].startswith("<svg"),
        "metrics_workflow_lines": [x for x in metrics_text.splitlines()
                                   if x.startswith("veles_workflow_")],
        "timeseries_code": pages["/timeseries.json"][0],
        "events_lines": len(lines),
        "events_ok": events_ok(lines, OBSERVE_CLI_EPOCHS)}
    check(out["row_equals_result"], "observe: the dashboard's row %r is "
          "not the child's result %r" % ({k: row.get(k) for k in (
              "epoch", "best", "complete")}, summary))
    check(out["dot_served"] and out["svg_served"],
          "observe: the graph was not served as .dot and .svg")
    check(len(out["metrics_workflow_lines"]) == 3,
          "observe: /metrics lacks the veles_workflow_* lines: %r"
          % metrics_text[-2000:])
    check(out["timeseries_code"] == 404, "observe: /timeseries.json "
          "answered %r without a store" % out["timeseries_code"])
    check(out["events_ok"], "observe: the events file does not parse "
          "with the reference's keys")
    return out


def get_page(url, timeout=30):
    """GET ``url``; returns (status, body text; "" on an error)."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""


def stream_status_leg(torch, HK, device):
    """A ``--stream-window`` run with a dashboard attached: the
    ``veles_stream_*`` gauges reach ``/metrics``, the dispatches one a
    graph replay (train steps plus validation minibatches an epoch)."""
    from veles_tpu_torch import web_status
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.loader.base import TRAIN, VALID
    wf = observe_build(device, epochs=OBSERVE_CLI_EPOCHS)
    status = web_status.attach_web_status(wf)
    HK.reset_launch_counts()
    try:
        Launcher(wf, stats=False, stream_window=OBSERVE_WINDOW,
                 device=None if device == "cuda" else device).boot()
        torch.cuda.synchronize()
        launches = HK.launch_counts()["fused_sgd_update"]
        text = get_page("http://127.0.0.1:%d/metrics" % status.port)[1]
    finally:
        status.stop()
    stats = wf._stream_stats
    steps = wf.loader.plan_arrays(TRAIN)[0].shape[0]
    valid = wf.loader.plan_arrays(VALID)[0].shape[0]
    want = OBSERVE_CLI_EPOCHS * (steps + valid)
    gauges = [x for x in text.splitlines() if x.startswith("veles_stream_")]
    label = '{workflow="mnist",process="0"}'
    out = {"window": OBSERVE_WINDOW, "dispatches": stats["dispatches"],
           "dispatches_want": want, "windows": stats["windows"],
           "gauges": gauges, "launches": launches,
           "train_steps": wf.fused_step.train_steps}
    check(stats["dispatches"] == want, "observe: %d stream dispatches, "
          "not %d" % (stats["dispatches"], want))
    check("veles_stream_dispatches_total%s %d" % (label, want) in gauges
          and len(gauges) == 4, "observe: /metrics stream gauges %r"
          % gauges)
    check(launches == wf.fused_step.train_steps, "observe: %d SGD "
          "launches in the streamed run for %d steps"
          % (launches, wf.fused_step.train_steps))
    return out


def observe_fault(name, run, tmp):
    """True when the planted fault ``name`` makes its check fail on the
    observed graph-loop ``run``."""
    from veles_tpu_torch import logger, web_status
    from veles_tpu_torch.nn_plotting_units import Weights2D
    from veles_tpu_torch.plotting_units import MatrixPlotter
    wf = run["wf"]
    committed = run["weights"][0][0]
    if name == "weights_not_transposed":
        class Faulty(Weights2D):
            def plot_spec(self):
                w = self.input.weights.to_numpy()[:self.limit]
                side = int(round(w.shape[1] ** 0.5))
                return {"kind": "image_grid",
                        "images": w.reshape(len(w), side, side)}
        unit = Faulty(wf, name="faulty_weights")
        unit.input = wf.forwards[0]
        return not weights_ok(unit.plot_spec(), committed)
    if name == "confusion_transposed":
        # on the run's least symmetric confusion matrix (the last
        # validation one can be diagonal: a transpose would not show)
        sets = [m[s] for m in wf.decision.epoch_metrics for s in m]
        target = max(sets, key=lambda v: int(numpy.abs(
            v["confusion"] - v["confusion"].T).sum()))

        class Faulty(MatrixPlotter):
            def plot_spec(self):
                spec = super().plot_spec()
                spec["matrix"] = spec["matrix"].T
                return spec
        unit = Faulty(wf, name="faulty_confusion")
        unit.input = type("Held", (), {
            "confusion_matrix": target["confusion"]})()
        return not confusion_ok(unit.plot_spec()["matrix"], target)
    if name == "reporter_epoch_behind":
        class Behind(web_status.StatusReporter):
            def report(self):
                super().report()
                row = self.status.snapshot()[self.workflow.name]
                self.status.update(self.workflow.name,
                                   epoch=row["epoch"] - 1)
        status = web_status.WebStatus()
        Behind(wf, status=status, name="faulty_reporter").report()
        return not row_ok(status.snapshot()["mnist"], run["summary"],
                          OBSERVE_EPOCHS)
    if name == "events_drop_levelname":
        path = os.path.join(tmp, "faulty_events.jsonl")
        real = logger._event_dict

        def dropped(record):
            event = real(record)
            event.pop("level")
            return event
        logger._event_dict = dropped
        try:
            logger.setup_logging(events_file=path)
            for e in range(1, OBSERVE_EPOCHS + 1):
                wf.decision.info("epoch %d — planted", e)
        finally:
            logger.setup_logging()
            logger._event_dict = real
        with open(path, encoding="utf-8") as f:
            return not events_ok(f.read().splitlines(), OBSERVE_EPOCHS)
    raise ValueError(name)


def observe_phase(torch, HK, card, device="cuda"):
    """Phase 16: the observability services on MNIST-FC at
    ``configs[0]``'s widths: (a) the standard plotters over ZeroMQ, the
    graph loop and the epoch scan, each run bit-equal to the same run
    unobserved; (b) the dashboard (a CLI child reporting into it, a
    streamed run's gauges); (c) publishing; (d) planted faults; (e) the
    plotters' and the reporter's host cost."""
    import shutil
    import tempfile
    from veles_tpu_torch.plotter import render_spec
    from veles_tpu_torch.publishing import Publisher
    t_phase = time.monotonic()
    try:
        import matplotlib  # noqa: F401
        mpl = None
    except ImportError as e:
        mpl = "matplotlib does not import: %s" % e
    tmp = tempfile.mkdtemp(prefix="observe_")
    try:
        runs = {}
        # the loop in turns (plain, observed, plain): the host clock's
        # spread beside the observers' cost
        for key in ((0, False), (0, True), (0, "again"), (1, False),
                    (1, True)):
            runs[key] = observe_run(torch, HK, device, key[0],
                                    key[1] is True, tmp)
            gc_cuda(torch)
        checks = {"bit_equal_plain_rerun": same_metrics(
            runs[0, False]["metrics"], runs[0, "again"]["metrics"])
            and all(numpy.array_equal(a, b) for x, y in zip(
                runs[0, False]["weights"], runs[0, "again"]["weights"])
                for a, b in zip(x, y))}
        for scan in (0, 1):
            plain, seen = runs[scan, False], runs[scan, True]
            checks["bit_equal_unobserved_%s" % ("scan" if scan else
                                                "loop")] = (
                same_metrics(plain["metrics"], seen["metrics"])
                and all(numpy.array_equal(a, b) for x, y in zip(
                    plain["weights"], seen["weights"])
                    for a, b in zip(x, y)))
        for run in runs.values():
            check(run["launches"] == run["wf"].fused_step.train_steps
                  == OBSERVE_EPOCHS * 600, "observe: %d SGD launches for "
                  "%d train steps" % (run["launches"],
                                      run["wf"].fused_step.train_steps))
        loop, scan_run = runs[0, True], runs[1, True]
        wf = loop["wf"]
        plotters = loop["plotters"]
        history = [s for p in plotters for s in p.specs]
        received = loop["received"]
        by_name = {p.name: [s for s in received if s["name"] == p.name]
                   for p in plotters}
        curve = plotters[0].specs[-1]
        want_series = {}
        for m in wf.decision.epoch_metrics:
            for set_name, values in m.items():
                want_series.setdefault(set_name, []).append(
                    values["err_pct"])
        weights_specs = plotters[2].specs
        checks.update({
            "received_equal_history": loop["ended"]
            and len(received) == len(history)
            and all(len(by_name[p.name]) == len(p.specs)
                    and all(same_spec(a, b) for a, b in zip(
                        by_name[p.name], p.specs)) for p in plotters),
            "numpy_only": all(numpy_only(s) for s in history),
            "curve_equals_epoch_metrics": same_spec(curve["series"],
                                                   want_series),
            "confusion_equals_decision": numpy.array_equal(
                plotters[1].specs[-1]["matrix"], wf.decision.confusion_matrix)
            and confusion_ok(plotters[1].specs[-1]["matrix"],
                             wf.decision.epoch_metrics[-1]["validation"]),
            "final_weights_committed": weights_ok(weights_specs[-1],
                                                  loop["weights"][0][0]),
            "scan_specs_none": all(not p.specs for p in scan_run[
                "plotters"]) and not scan_run["received"]
            and scan_run["ended"],
            "loop_row_is_result": row_ok(
                loop["status"].snapshot().get("mnist", {}),
                loop["summary"], OBSERVE_EPOCHS),
            "scan_row_is_result": row_ok(
                scan_run["status"].snapshot().get("mnist", {}),
                scan_run["summary"], OBSERVE_EPOCHS),
        })
        with open(loop["events"], encoding="utf-8") as f:
            checks["events_ok"] = events_ok(f.read().splitlines(),
                                            OBSERVE_EPOCHS)
        # no plot of the initial weights: each epoch's plot moved
        initial = observe_build(device, epochs=1)
        initial.initialize(device=device)
        w0 = initial.forwards[0].weights.to_numpy()
        checks["weights_plots_not_stale"] = not any(
            numpy.array_equal(s["images"], w0.T[:64].reshape(-1, 28, 28))
            for s in weights_specs)
        del initial
        for run in (loop, scan_run):
            run["status"].stop()
        # PNGs: every spec received, rendered here when matplotlib imports
        rendered = 0
        if mpl is None:
            for i, spec in enumerate(received):
                render_spec(spec, os.path.join(tmp, "%s_%04d.png"
                                               % (spec["name"], i)))
            rendered = sum(f.endswith(".png") for f in os.listdir(tmp))
        # (c) the report of the observed card run
        backends = ("markdown", "html", "json") + (("pdf",) if mpl is None
                                                   else ())
        t0 = time.monotonic()
        paths = Publisher(backends).publish(
            wf, os.path.join(tmp, "report"), launcher=loop["launcher"],
            plots=[os.path.join(tmp, f) for f in sorted(os.listdir(tmp))
                   if f.endswith(".png")])
        publish_s = time.monotonic() - t0
        with open(paths[2], encoding="utf-8") as f:
            facts = json.load(f)
        checks["report_epochs_equal"] = len(facts["epochs"]) == len(
            wf.decision.epoch_metrics) and all(
            row["%s_%s" % (s, k)] == m[s][k]
            for row, m in zip(facts["epochs"], wf.decision.epoch_metrics)
            for s in m for k in ("n_err", "count", "loss", "err_pct"))
        # (b) the dashboard: a CLI child reporting in, a streamed run
        gc_cuda(torch)
        cli_leg = cli_status_leg(device, tmp)
        gc_cuda(torch)
        stream = stream_status_leg(torch, HK, device)
        # (d) the planted faults
        faults = {name: observe_fault(name, loop, tmp)
                  for name in OBSERVE_FAULTS}
        # (e) host cost: the units' own seconds, and the whole runs
        epochs = OBSERVE_EPOCHS
        units = plotters + [loop["reporter"]]
        steps = wf.fused_step.train_steps
        cost = {
            "units_ms_per_epoch": {u.name: 1e3 * u.run_time / epochs
                                   for u in units},
            "units_ms_per_epoch_total": 1e3 * sum(
                u.run_time for u in units) / epochs,
            "unit_runs_per_epoch": {u.name: u.run_count / epochs
                                    for u in units},
            "epoch_end_ms_per_epoch": {
                k: 1e3 * v / epochs for k, v in loop["epoch_end_s"].items()},
            "epoch_end_ms_per_epoch_total": 1e3 * sum(
                loop["epoch_end_s"].values()) / epochs,
            "loop_s_plain": runs[0, False]["run_s"],
            "loop_s_observed": loop["run_s"],
            "loop_s_plain_again": runs[0, "again"]["run_s"],
            "loop_ms_per_train_step": {
                k: 1e3 * runs[0, key]["run_s"] / steps for k, key in (
                    ("plain", False), ("observed", True),
                    ("plain_again", "again"))},
            "scan_s_plain": runs[1, False]["run_s"],
            "scan_s_observed": scan_run["run_s"],
            "join_s": loop["join_s"]}
        launches = sum(r["launches"] for r in runs.values()) + \
            stream["launches"]
        report = {"phase": "observe", "card": card,
                  "config": {"layers": "784-100tanh-10softmax",
                             "minibatch": 100, "n_train": 60000,
                             "n_valid": 10000, "epochs": OBSERVE_EPOCHS},
                  "matplotlib": mpl or "imports",
                  "rendered": rendered,
                  "rendered_reason": mpl or "every received spec",
                  "specs": {p.name: len(p.specs) for p in plotters},
                  "scan_specs": {p.name: len(p.specs)
                                 for p in scan_run["plotters"]},
                  "received": len(received), "checks": checks,
                  "cli": cli_leg, "stream": stream,
                  "report": {"backends": list(backends),
                             "seconds": publish_s,
                             "files": [os.path.basename(p) for p in paths]},
                  "faults_caught": faults, "cost": cost,
                  "fused_sgd_launches": launches,
                  "phase_s": time.monotonic() - t_phase}
        print(json.dumps({"observe": report}, default=str), flush=True)
        bad = [k for k, v in checks.items() if not v]
        check(not bad, "observe: checks failed: %s" % bad)
        check(all(faults.values()), "observe: faults not caught: %s"
              % [k for k, v in faults.items() if not v])
        check(mpl is not None or rendered == len(received),
              "observe: %d PNGs for %d specs" % (rendered, len(received)))
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------- phase 17
#: the serving fast path at the full LM width (``LM_CONFIG``), page 32, 8
#: slots.  (a) 16 requests sharing a 256-token prefix (8 full pages) with
#: distinct suffixes of 1 to 64 tokens, served with a 64-chunk prefix
#: cache and without it; the first two suffixes agree on their first page
#: but for its last token (a full chunk the cache must tell apart)
FAST_SHARED, FAST_REQUESTS, FAST_SUFFIX, FAST_NEW = 256, 16, (1, 64), (16, 33)
FAST_PAGE, FAST_SLOTS, FAST_CACHE = 32, 8, 64
#: (b) speculative verify: the draft length, the requests verified (the
#: candidates with the most accepted drafts in a host replay of the plain
#: engine's greedy tokens) and the periodic prompts added to (a)'s as
#: candidates, with their new tokens
FAST_SPEC_K, FAST_SPEC_REQUESTS, FAST_PERIODIC, FAST_PERIODIC_NEW = 4, 8, 8, 48
#: planted faults, each of which a check of this phase must catch
FAST_FAULTS = ("trie_key_drops_last_token", "verify_accepts_unchecked",
               "cow_skips_copy")


def fast_requests(vocab, page=FAST_PAGE):
    """Phase 17 (a)'s seeded requests: [(prompt, n_new)]."""
    rng = numpy.random.RandomState(SEED + 17)
    shared = rng.randint(0, vocab, FAST_SHARED).astype(numpy.int32)
    lens = rng.randint(FAST_SUFFIX[0], FAST_SUFFIX[1] + 1, FAST_REQUESTS)
    lens[:2] = (page + 8, page + 18)
    suffixes = [rng.randint(0, vocab, n).astype(numpy.int32) for n in lens]
    suffixes[1][:page] = suffixes[0][:page]
    suffixes[1][page - 1] = (suffixes[0][page - 1] + 1) % vocab
    n_new = rng.randint(FAST_NEW[0], FAST_NEW[1], FAST_REQUESTS)
    return [(numpy.concatenate([shared, s]), int(k))
            for s, k in zip(suffixes, n_new)]


def periodic_requests(vocab):
    """Phase 17 (b)'s periodic candidate prompts: [(prompt, n_new)]."""
    rng = numpy.random.RandomState(SEED + 18)
    out = []
    for _ in range(FAST_PERIODIC):
        motif = rng.randint(0, vocab, rng.randint(4, 17))
        out.append((numpy.resize(motif, rng.randint(64, 161)).astype(
            numpy.int32), FAST_PERIODIC_NEW))
    return out


def expected_hit_chunks(reqs, page):
    """Prefix-cache hits of a run that computes each distinct full-chunk
    prefix once (no eviction): every other full chunk is a hit, at
    admission or late."""
    seen, full = set(), 0
    for prompt, _ in reqs:
        n_full = (len(prompt) - 1) // page
        full += n_full
        seen.update(tuple(int(t) for t in prompt[:(j + 1) * page])
                    for j in range(n_full))
    return full - len(seen)


def record_prefix_pages(engine, store):
    """On each finishing lane of ``engine``, keep a copy of every full
    prompt chunk's page (each block's K and V) under the prompt prefix
    through that chunk."""
    finish, page = engine._finish, engine.prefill_chunk

    def recording(slot):
        lane = engine._lanes[slot]
        prompt = lane.request.prompt
        for j in range((lane.request.true_len - 1) // page):
            key = tuple(int(t) for t in prompt[:(j + 1) * page])
            if key not in store:
                p = lane.pages[j]
                store[key] = [(kp[p].clone(), vp[p].clone())
                              for kp, vp in engine._kv_pools]
        finish(slot)
    engine._finish = recording


def trie_page_mismatches(torch, engine, store):
    """(trie entries, entries whose page is not bit-equal to the page
    the cache-off engine computed for the same prefix)."""
    n, bad, stack = 0, 0, [(engine._trie.root, ())]
    while stack:
        node, path = stack.pop()
        for key, child in node.children.items():
            full = path + key
            stack.append((child, full))
            n += 1
            want = store.get(full)
            if want is None or not all(
                    torch.equal(kp[child.rows], k)
                    and torch.equal(vp[child.rows], v)
                    for (kp, vp), (k, v) in zip(engine._kv_pools, want)):
                bad += 1
    return n, bad


def planted_cow(torch, engine):
    """Copy-on-write of a trie page that a stand-in lane shares, on the
    stopped engine (every free page filled with NaN first, so a copy not
    made cannot pass): True when the source stays bit-equal, the copy is
    bit-equal, and the lane's reference, pin and table entry moved to the
    copy."""
    from veles_tpu_torch.serving.kv_pool import KVPagePool
    from veles_tpu_torch.serving.lm_engine import _Request, _Slot
    pool = engine._pool
    p = next(iter(engine._trie.root.children.values())).rows
    free = list(pool._free)
    for kp, vp in engine._kv_pools:
        kp[free] = float("nan")
        vp[free] = float("nan")
    before = [(kp[p].clone(), vp[p].clone()) for kp, vp in engine._kv_pools]
    refs = pool.refs(p)
    pool.retain(p)
    pool.pin(p)
    lane = _Slot(_Request(numpy.zeros(1, numpy.int32), 1, 30.0, pages=1))
    lane.pages = [p]
    engine._page_tables[0, 0] = p
    copies = engine.metrics.counter("kv_cow_copies")
    engine._cow_guard(0, lane, 0, 1)
    q = lane.pages[0]
    ok = (q != p and engine._page_tables[0, 0] == q
          and pool.refs(p) == refs and not pool.pinned(p)
          and pool.refs(q) == 1 and pool.pinned(q)
          and engine.metrics.counter("kv_cow_copies") == copies + 1
          and all(torch.equal(kp[p], k) and torch.equal(vp[p], v)
                  and torch.equal(kp[q], k) and torch.equal(vp[q], v)
                  for (kp, vp), (k, v) in zip(engine._kv_pools, before)))
    pool.unpin(q)
    pool.release(q)
    engine._page_tables[0, :] = KVPagePool.SCRATCH
    return ok


def replay_drafts(S, prompt, out, k):
    """(draft tokens, accepted) that a speculative run meters on these
    greedy tokens, replayed on the host (drafts past the known tokens
    count as misses)."""
    i, drafted, accepted = 1, 0, 0
    while i < len(out):
        draft = S.propose_draft(numpy.concatenate([prompt, out[:i]]), k)
        a = 0
        if draft is not None:
            drafted += len(draft)
            while (a < len(draft) and i + a < len(out)
                   and draft[a] == out[i + a]):
                a += 1
            accepted += a
        i += a + 1
    return drafted, accepted


def fast_serve(torch, HK, S, cfg, host, reqs, device, tag, prepare=None,
               **knobs):
    """One engine over ``host`` answering ``reqs`` all at once (the
    launch counts set to 0 just before, read just after); ``prepare``
    sees the engine before it starts.  Returns (engine (stopped),
    outputs, TTFTs, launches, wall s)."""
    engine = S.LMEngine(host, cfg["n_heads"], cfg["max_len"],
                        slots=FAST_SLOTS, prefill_chunk=FAST_PAGE,
                        device=device, name="fast_" + tag, **knobs)
    if prepare is not None:
        prepare(engine)
    engine.start()
    try:
        HK.reset_launch_counts()
        t0 = time.monotonic()
        futures = [engine.submit(p, k) for p, k in reqs]
        outs = [f.result(timeout=300) for f in futures]
        wall = time.monotonic() - t0
        launches = HK.launch_counts()
    finally:
        engine.stop()
    check(engine.metrics.errors == 0, "%s: %d engine errors"
          % (tag, engine.metrics.errors))
    for out, (_, k) in zip(outs, reqs):
        check(out.shape == (k,) and out.min() >= 0
              and out.max() < cfg["vocab"], "%s: malformed output %r"
              % (tag, out))
    return engine, outs, [f.ttft_s for f in futures], launches, wall


def worst_shortfall(torch, T, engine, reqs, outs):
    """Phase 4's teacher-forced check over every emitted token: (worst
    logit shortfall below its row max, exact argmax matches)."""
    worst, exact = 0.0, 0
    with torch.inference_mode():
        for (prompt, _), out in zip(reqs, outs):
            short, n_exact = teacher_forced(
                torch, T, engine, numpy.concatenate([prompt, out]),
                len(prompt), out)
            worst, exact = max(worst, short), exact + n_exact
    return worst, exact


def fast_counters(engine):
    c = engine.metrics.snapshot()["counters"]
    return {k: c.get(k, 0) for k in (
        "prefix_hit_chunks", "prefix_hit_tokens", "kv_pages_referenced",
        "kv_cow_copies", "draft_tokens", "draft_accepted",
        "decode_dispatches", "prefill_dispatches", "prefill_tokens",
        "tokens_out")}


def pool_drained(engine):
    """Flush the stopped engine's trie; True when the pool then holds
    every page free and its books agree."""
    if engine._trie is not None:
        while engine._trie.evict_one():
            pass
    inv = engine.verify_pool_invariants()
    return inv["free_pages"] == engine._pool.num_pages


def step_ms(torch, fn, device, reps=20):
    """Host-clock ms of one call of ``fn`` (synchronous: it reads its
    picks back), after one warm call."""
    with torch.inference_mode():
        fn()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(reps):
            fn()
        return (time.monotonic() - t0) / reps * 1e3


def serve_fastpath(torch, HK, T, S, card, device="cuda", cfg=None,
                   keep=None):
    """Phase 17: the radix prefix cache with copy-on-write pages and the
    prompt-lookup speculative verify on the paged engine at the full LM
    width; three planted faults.  Returns kernels 5 and 6's launches on
    the phase's engine runs (the faults' runs not counted); ``keep`` (a
    dict) gets the periodic candidates and the plain engine's tokens for
    them (phase 18's speculative run is held against them)."""
    from veles_tpu_torch import prng
    cfg = cfg or LM_CONFIG
    began = time.monotonic()
    host = T.init_transformer_params(
        prng.RandomGenerator("init", SEED), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg["n_layers"], max_len=cfg["max_len"])
    n_layers = cfg["n_layers"]
    reqs = fast_requests(cfg["vocab"])
    candidates = periodic_requests(cfg["vocab"])
    total_prompt = sum(len(p) for p, _ in reqs)
    want_hits = expected_hit_chunks(reqs, FAST_PAGE)
    caught = {}

    # (a) the shared-prefix requests without the cache (its full prompt
    # pages kept as they finish), then with it
    store = {}
    off, off_outs, off_ttft, off_launches, off_wall = fast_serve(
        torch, HK, S, cfg, host, reqs, device, "off",
        prepare=lambda e: record_prefix_pages(e, store))
    on, on_outs, on_ttft, on_launches, on_wall = fast_serve(
        torch, HK, S, cfg, host, reqs, device, "on",
        prefix_cache=FAST_CACHE)
    c_on, c_off = fast_counters(on), fast_counters(off)
    check(c_on["prefix_hit_chunks"] == want_hits
          and want_hits >= (FAST_REQUESTS - 1) * FAST_SHARED // FAST_PAGE,
          "fastpath: %d prefix hits, want %d" % (c_on["prefix_hit_chunks"],
                                                 want_hits))
    check(c_on["prefix_hit_tokens"] == want_hits * FAST_PAGE
          and c_on["prefill_tokens"] == total_prompt
          - c_on["prefix_hit_tokens"]
          and c_off["prefill_tokens"] == total_prompt,
          "fastpath: prefill tokens %r" % c_on)
    check(on_launches["paged_flash_prefill"]
          == n_layers * c_on["prefill_dispatches"] > 0
          and on_launches["paged_flash_decode"]
          == n_layers * c_on["decode_dispatches"] > 0,
          "fastpath: launches %r for %r" % (on_launches, c_on))
    entries, mismatched = trie_page_mismatches(torch, on, store)
    check(entries == on._trie.size > 0 and mismatched == 0,
          "fastpath: %d of %d trie pages differ from the cache-off "
          "engine's" % (mismatched, entries))
    cow_ok = planted_cow(torch, on)
    check(cow_ok, "fastpath: the planted copy-on-write failed")
    with patched(on, "_page_copy_program", lambda src, dst: None):
        caught["cow_skips_copy"] = not planted_cow(torch, on)
    worst_off, exact_off = worst_shortfall(torch, T, off, reqs, off_outs)
    worst_on, exact_on = worst_shortfall(torch, T, on, reqs, on_outs)
    check(max(worst_off, worst_on) <= LOGIT_TOL,
          "fastpath: an emitted token's logit sits %g below its row max "
          "(tolerance %g)" % (max(worst_off, worst_on), LOGIT_TOL))
    same_tokens = sum(bool(numpy.array_equal(a, b))
                      for a, b in zip(on_outs, off_outs))
    trie_size = on._trie.size
    check(pool_drained(on) and pool_drained(off),
          "fastpath: the pool did not get every page back")
    # the trie keyed on a chunk's first C - 1 tokens
    bad = fast_serve(torch, HK, S, cfg, host, reqs, device, "bad_key",
                     prepare=lambda e: setattr(
                         e, "_chunk_key",
                         lambda toks: tuple(int(t) for t in toks[:-1])),
                     prefix_cache=FAST_CACHE)[0]
    caught["trie_key_drops_last_token"] = (
        fast_counters(bad)["prefix_hit_chunks"] != want_hits
        or trie_page_mismatches(torch, bad, store)[1] > 0)
    del store, bad
    if device == "cuda":
        gc_cuda(torch)

    # (b) speculative verify on the candidates whose greedy tokens (the
    # plain engine's) replay the most accepted drafts on the host
    _, plain, _, plain_launches, _ = fast_serve(
        torch, HK, S, cfg, host, candidates, device, "candidates")
    if keep is not None:
        keep["candidates"] = (candidates, plain)
    pool = reqs + candidates
    replays = [replay_drafts(S, p, out, FAST_SPEC_K)
               for (p, _), out in zip(pool, off_outs + plain)]
    by_accepted = sorted(range(len(pool)), key=lambda i: -replays[i][1])
    picked = [pool[i] for i in by_accepted[:FAST_SPEC_REQUESTS]]
    replayed = sum(replays[i][1] for i in by_accepted[:FAST_SPEC_REQUESTS])
    check(replayed > 0, "fastpath: no candidate prompt replays an "
          "accepted draft")
    # the fault's requests: the most rejected draft tokens
    by_rejected = sorted(range(len(pool)),
                         key=lambda i: replays[i][1] - replays[i][0])
    rejecting = [pool[i] for i in by_rejected[:FAST_SPEC_REQUESTS // 2]]
    widths = []

    def splits(b, h, kv, c, dh, m, real=HK.decode_splits):
        widths.append(c)
        return real(b, h, kv, c, dh, m)
    with patched(HK, "decode_splits", splits):
        spec, spec_outs, spec_ttft, spec_launches, spec_wall = fast_serve(
            torch, HK, S, cfg, host, picked, device, "spec",
            spec_k=FAST_SPEC_K)
    c_spec = fast_counters(spec)
    check(spec_launches["paged_flash_decode"]
          == n_layers * c_spec["decode_dispatches"] > 0
          and spec_launches["paged_flash_prefill"]
          == n_layers * c_spec["prefill_dispatches"],
          "fastpath: verify launches %r for %r" % (spec_launches, c_spec))
    # the serve's launches are the last (warmup's step launches c = 1)
    widths = widths[len(widths) - spec_launches["paged_flash_decode"]:]
    check(device != "cuda" or set(widths) == {FAST_SPEC_K + 1},
          "fastpath: decode launched at c %r" % sorted(set(widths)))
    check(c_spec["tokens_out"] > c_spec["decode_dispatches"]
          and c_spec["draft_accepted"] > 0,
          "fastpath: speculative run %r" % c_spec)
    worst_spec, exact_spec = worst_shortfall(torch, T, spec, picked,
                                             spec_outs)
    check(worst_spec <= LOGIT_TOL, "fastpath: a verified token's logit "
          "sits %g below its row max (tolerance %g)"
          % (worst_spec, LOGIT_TOL))
    check(pool_drained(spec), "fastpath: the speculative engine's pool "
          "did not get every page back")
    # the verify step at full width against the plain step: all lanes 16
    # pages deep on distinct pages
    w = spec._max_pages
    ptabs = (1 + numpy.arange(spec.slots * w, dtype=numpy.int32)
             ).reshape(spec.slots, w)
    pos = numpy.full(spec.slots, spec.max_len - 1 - FAST_SPEC_K,
                     numpy.int32)
    toks = numpy.zeros((spec.slots, FAST_SPEC_K + 1), numpy.int32)
    verify_ms = step_ms(torch, lambda: spec._verify_program(ptabs, toks,
                                                            pos), device)
    plain_ms = step_ms(torch, lambda: spec._step_program(
        ptabs, toks[:, 0], pos), device)

    # a verifier that accepts every draft unchecked
    def unchecked(engine):
        real = engine._verify_program

        def echo(ptabs, toks, pos):
            out = real(ptabs, toks, pos)
            out[:, :-1] = toks[:, 1:]
            return out
        engine._verify_program = echo
    bad, bad_outs = fast_serve(torch, HK, S, cfg, host, rejecting, device,
                               "bad_verify", prepare=unchecked,
                               spec_k=FAST_SPEC_K)[:2]
    worst_bad = worst_shortfall(torch, T, bad, rejecting, bad_outs)[0]
    caught["verify_accepts_unchecked"] = worst_bad > LOGIT_TOL
    del bad

    launches = {k: sum(run[k] for run in (off_launches, on_launches,
                                          plain_launches, spec_launches))
                for k in ("paged_flash_decode", "paged_flash_prefill")}
    report = {
        "phase": "serve_fastpath", "card": card, "config": dict(cfg),
        "slots": FAST_SLOTS, "page": FAST_PAGE,
        "prefix": {
            "requests": len(reqs), "shared_tokens": FAST_SHARED,
            "prompt_tokens": total_prompt,
            "served_from_cache_tokens": c_on["prefix_hit_tokens"],
            "prefilled_tokens": c_on["prefill_tokens"],
            "expected_hit_chunks": want_hits, "cache_chunks": FAST_CACHE,
            "counters_on": c_on, "counters_off": c_off,
            "ttft_p50_s_off": statistics.median(off_ttft),
            "ttft_p50_s_on": statistics.median(on_ttft),
            "ttft_max_s_off": max(off_ttft), "ttft_max_s_on": max(on_ttft),
            "wall_s_off": off_wall, "wall_s_on": on_wall,
            "trie_entries": trie_size,
            "trie_pages_bit_equal_to_cache_off": entries - mismatched,
            "planted_cow_ok": cow_ok,
            "requests_with_equal_tokens_on_off": same_tokens,
            "teacher_forced": {"worst_shortfall_off": worst_off,
                               "worst_shortfall_on": worst_on,
                               "exact_argmax_off": exact_off,
                               "exact_argmax_on": exact_on,
                               "tokens": sum(k for _, k in reqs),
                               "tolerance": LOGIT_TOL}},
        "spec": {
            "k": FAST_SPEC_K, "requests": len(picked),
            "candidates": len(reqs) + len(candidates),
            "replayed_accepted": replayed,
            "replayed_rejected_fault_requests": sum(
                replays[i][0] - replays[i][1]
                for i in by_rejected[:FAST_SPEC_REQUESTS // 2]),
            "counters": c_spec,
            "tokens_per_decode_dispatch":
            (c_spec["tokens_out"] - len(picked))
            / c_spec["decode_dispatches"],
            "decode_launch_c": sorted(set(widths)),
            "verify_step_ms_full_width": verify_ms,
            "plain_step_ms_full_width": plain_ms,
            "ttft_p50_s": statistics.median(spec_ttft),
            "wall_s": spec_wall,
            "teacher_forced": {"worst_shortfall": worst_spec,
                               "exact_argmax": exact_spec,
                               "tokens": sum(k for _, k in picked),
                               "tolerance": LOGIT_TOL}},
        "launches": launches,
        "faults": {"caught": caught, "unchecked_verify_shortfall": worst_bad},
        "phase_s": time.monotonic() - began}
    print(json.dumps({"serve_fastpath": report}), flush=True)
    for name in FAST_FAULTS:
        check(caught[name], "fastpath: the planted fault %r was not caught"
              % name)
    return launches


# --------------------------------------------------------------- phase 18
#: the fused K-step decode at the full LM width (``LM_CONFIG``), page 32,
#: 8 slots: (a) K = 8 on phase 4's 16 requests, with a 64-chunk prefix
#: cache (trie pages pinned while lanes freeze); (b) ``spec_k`` 4 at K = 4
#: on phase 17's periodic candidates; (c) the MoE engine at K = 4 on 4
#: of phase 4's requests
MEGA_K, MEGA_SPEC = 8, (4, 4)            # K; (spec_k, K)
MEGA_MOE_K, MEGA_MOE_REQUESTS, MEGA_FAULT_REQUESTS = 4, 4, 8
#: replays timed (host clock) and dispatches profiled
MEGA_TIMED, MEGA_PROFILED = 20, 3
#: planted faults, each of which a check of this phase must catch
MEGA_FAULTS = ("write_mask_ignored", "stale_page_table",
               "accepts_past_mismatch")


def guard_rows(torch, engine, changed):
    """On each lane of ``engine``: as its first token comes out, keep a
    copy of its pinned trie pages and of its pages from the prompt's
    last one on; as it finishes, add to ``changed`` the trie pages and
    the pages whose rows past its last fed position moved.  A finished
    lane freezes inside a megastep, and its writes must go to the
    scratch page."""
    first, finish = engine._emit_first, engine._finish
    page, kept = engine.prefill_chunk, {}

    def pages(idx):
        idx = torch.as_tensor(idx, device=engine.device).long()
        return [(kp[idx].clone(), vp[idx].clone())
                for kp, vp in engine._kv_pools]

    def on_first(slot, lane, tok):
        j0 = lane.request.true_len // page
        trie = [node.rows for node in lane.pinned]
        kept[id(lane)] = (j0, trie, pages(lane.pages[j0:]), pages(trie))
        first(slot, lane, tok)

    def on_finish(slot):
        lane = engine._lanes[slot]
        j0, trie, tail, shared = kept.pop(id(lane))
        req = lane.request
        # rows at and past the first position never fed
        n = len(lane.pages) - j0
        unfed = ((j0 * page + torch.arange(n * page, device=engine.device))
                 .view(n, 1, page, 1) >= req.true_len + req.n_new - 1)
        for (kb, vb), (ka, va) in zip(tail, pages(lane.pages[j0:])):
            changed["rows"] += int(not (
                torch.equal(torch.where(unfed, kb, 0),
                            torch.where(unfed, ka, 0))
                and torch.equal(torch.where(unfed, vb, 0),
                                torch.where(unfed, va, 0))))
        for (kb, vb), (ka, va) in zip(shared, pages(trie)):
            changed["trie"] += int(not (torch.equal(kb, ka)
                                        and torch.equal(vb, va)))
        finish(slot)
    engine._emit_first, engine._finish = on_first, on_finish


def ignore_write_mask(L):
    """A planted fault, for the engines started within: the write mask
    dropped from every paged step (captured so on the card), so frozen
    lanes write through their own tables."""
    real = L.paged_chunk_apply
    return patched(L, "paged_chunk_apply",
                   lambda *args, write_mask=None, **kw: real(*args, **kw))


def stale_page_table(engine):
    """A planted fault: after the first dispatch the staged page table is
    never refreshed, so a refilled slot replays its old table."""
    run = engine._megastep_program

    def once(w):
        out = run(w)
        engine._ms_host = dict(engine._ms_host,
                               ptab=engine._ms_host["ptab"].copy())
        engine._megastep_program = run
        return out
    engine._megastep_program = once


def accepts_past_mismatch(engine):
    """A planted fault: the verify accepts one draft token past the
    first mismatch."""
    real = engine._accepted
    engine._accepted = lambda draft, out: (real(draft, out) + 1).clamp(
        max=engine.spec_k)


def megastep_books(engine, reqs, outs, launches, n_layers, plain):
    """Phase 18's checks of one run that hold on any device: the books
    (one decode dispatch a megastep, every token but each request's
    first from a megastep, plain runs' lane-iterations closed) and
    kernel 5's and 6's launches.  Returns the counters."""
    c = engine.metrics.snapshot()["counters"]
    c = {k: c.get(k, 0) for k in (
        "megastep_dispatches", "megastep_tokens", "megastep_lane_iterations",
        "megastep_wasted_iterations", "decode_dispatches",
        "prefill_dispatches", "draft_tokens", "draft_accepted",
        "tokens_out", "prefix_hit_tokens")}
    tokens = sum(len(o) for o in outs)
    check(c["megastep_dispatches"] == c["decode_dispatches"] > 0
          and c["tokens_out"] == tokens
          and c["megastep_tokens"] == tokens - len(reqs)
          and (not plain or c["megastep_tokens"]
               + c["megastep_wasted_iterations"]
               == c["megastep_lane_iterations"]),
          "megastep: books %r" % c)
    check(launches["paged_flash_decode"]
          == n_layers * engine.megastep * c["megastep_dispatches"]
          and launches["paged_flash_prefill"]
          == n_layers * c["prefill_dispatches"],
          "megastep: launches %r for %r" % (launches, c))
    return c


def differing_tokens(outs, want):
    """Tokens that differ from the per-tick engine's (from the first
    divergence of a request on; the teacher-forced check of both runs
    puts both tokens at the divergence within ``LOGIT_TOL`` of the row
    max, so a divergence is a near-tie)."""
    n = 0
    for a, b in zip(outs, want):
        diff = numpy.flatnonzero(a != b)
        n += len(a) - int(diff[0]) if len(diff) else 0
    return n


def megastep_times(torch, engine, reps=MEGA_TIMED):
    """The widest table's fused dispatch against the per-tick step of
    the same engine, with all 8 lanes 16 pages deep on distinct pages
    and active for all K iterations: host-clock ms of each (the fused
    one with its upload and read-back), ms a token of a lane, and each
    one's card busy share under the profiler."""
    K, S, w = engine.megastep, engine.slots, engine._max_pages
    ptabs = (1 + numpy.arange(S * w, dtype=numpy.int32)).reshape(S, w)
    stage = engine._ms_host
    stage["ptab"][:] = ptabs
    stage["last"][:] = 0
    stage["pos"][:] = engine.max_len - K       # K writes fit
    stage["left"][:] = K
    zeros = numpy.zeros(S, numpy.int32)
    deep = numpy.full(S, engine.max_len - 1, numpy.int32)

    def mega():
        engine._ms_in.copy_(engine._ms_stage, non_blocking=True)
        engine._ms_out.copy_(engine._megastep_program(w), non_blocking=True)
        torch.cuda.current_stream().synchronize()

    def tick():
        engine._step_program(ptabs, zeros, deep)
    mega_ms = step_ms(torch, mega, "cuda", reps)
    tick_ms = step_ms(torch, tick, "cuda", reps)
    with torch.inference_mode():
        busy_mega, kernels = profile_steps(torch, mega, MEGA_PROFILED)
        busy_tick, _ = profile_steps(torch, tick, MEGA_PROFILED)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return {"megastep_ms": mega_ms, "megastep_token_ms": mega_ms / K,
            "tick_step_ms": tick_ms, "token_ms_ratio": mega_ms / K / tick_ms,
            "megastep_busy_share": busy_mega, "tick_busy_share": busy_tick,
            "megastep_card_ms": sum(kernels.values()) / 1e3,
            "megastep_top_kernels_us": dict(top), "K": K, "width": w}


def serve_megastep(torch, HK, T, S, card, tick, fastpath, device="cuda",
                   cfg=None):
    """Phase 18: the fused K-step decode (one captured graph a ladder
    width) at the full LM width, held against phase 4's per-tick tokens
    (``tick``) and phase 17's plain tokens for its candidates
    (``fastpath``); three planted faults; timing.  Returns kernels 5 and 6's launches on the phase's runs (the
    faults' runs not counted)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.serving import lm_engine
    cfg = cfg or LM_CONFIG
    began = time.monotonic()
    n_layers = cfg["n_layers"]
    host = T.init_transformer_params(
        prng.RandomGenerator("init", SEED), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=n_layers, max_len=cfg["max_len"])
    reqs, tick_outs = tick["requests"], tick["outs"]
    caught, report = {}, {"phase": "serve_megastep", "card": card,
                          "config": dict(cfg), "slots": FAST_SLOTS,
                          "page": FAST_PAGE}

    # (a) K = 8 (with the prefix cache) on phase 4's requests
    changed = {"rows": 0, "trie": 0}
    eng, outs, ttft, launches_a, wall = fast_serve(
        torch, HK, S, cfg, host, reqs, device, "mega",
        prepare=lambda e: guard_rows(torch, e, changed), megastep=MEGA_K,
        prefix_cache=FAST_CACHE)
    c_a = megastep_books(eng, reqs, outs, launches_a, n_layers, plain=True)
    worst_a, exact_a = worst_shortfall(torch, T, eng, reqs, outs)
    check(worst_a <= LOGIT_TOL, "megastep: an emitted token's logit sits "
          "%g below its row max (tolerance %g)" % (worst_a, LOGIT_TOL))
    check(changed == {"rows": 0, "trie": 0}, "megastep: a frozen lane "
          "wrote past its last position or into a trie page: %r" % changed)
    check(pool_drained(eng), "megastep: the pool did not get every page "
          "back")
    tokens = sum(len(o) for o in outs)
    report["plain"] = {
        "K": MEGA_K, "requests": len(reqs), "tokens": tokens,
        "counters": c_a, "wall_s": wall, "tokens_per_s": tokens / wall,
        "tick_tokens_per_s_phase_4": tick["tokens_per_s"],
        "dispatch_ms_mean": eng.metrics.decode_step.sum
        / eng.metrics.decode_step.total * 1e3,
        "tokens_per_lane_iteration": c_a["megastep_tokens"]
        / max(1, c_a["megastep_lane_iterations"]
              - c_a["megastep_wasted_iterations"]),
        "ttft_p50_s": statistics.median(ttft),
        "differing_tokens_vs_tick": differing_tokens(outs, tick_outs),
        "capture_s": eng.megastep_capture_s,
        "launches_a_replay": eng.megastep_launches,
        "teacher_forced": {"worst_shortfall": worst_a, "exact_argmax":
                           exact_a, "tokens": tokens,
                           "tolerance": LOGIT_TOL}}
    report["times"] = megastep_times(torch, eng)
    del eng
    gc_cuda(torch)

    # the write mask dropped: frozen lanes write through their tables
    moved = {"rows": 0, "trie": 0}
    with ignore_write_mask(lm_engine):
        fast_serve(torch, HK, S, cfg, host, reqs[:MEGA_FAULT_REQUESTS],
                   device, "mega_mask",
                   prepare=lambda e: guard_rows(torch, e, moved),
                   megastep=MEGA_K, prefix_cache=FAST_CACHE)
    caught["write_mask_ignored"] = moved["rows"] + moved["trie"] > 0
    # a stale page table replayed after slots are refilled
    refills = reqs[:FAST_SLOTS + 2]
    bad, bad_outs = fast_serve(torch, HK, S, cfg, host, refills, device,
                               "mega_stale", prepare=stale_page_table,
                               megastep=MEGA_K)[:2]
    worst_stale = worst_shortfall(torch, T, bad, refills, bad_outs)[0]
    caught["stale_page_table"] = worst_stale > LOGIT_TOL
    del bad
    gc_cuda(torch)

    # (b) spec_k 4 at K = 4 on phase 17's periodic candidates
    k, K = MEGA_SPEC
    cands, plain_outs = fastpath["candidates"]
    eng, outs, _, launches_b, wall = fast_serve(
        torch, HK, S, cfg, host, cands, device, "mega_spec", megastep=K,
        spec_k=k)
    c_b = megastep_books(eng, cands, outs, launches_b, n_layers,
                         plain=False)
    live = c_b["megastep_lane_iterations"] - c_b["megastep_wasted_iterations"]
    worst_b, exact_b = worst_shortfall(torch, T, eng, cands, outs)
    check(worst_b <= LOGIT_TOL and c_b["draft_accepted"] > 0
          and c_b["megastep_tokens"] > live,
          "megastep: speculative run %r, worst shortfall %g"
          % (c_b, worst_b))
    check(pool_drained(eng), "megastep: the speculative engine's pool did "
          "not get every page back")
    tokens = sum(len(o) for o in outs)
    report["spec"] = {
        "k": k, "K": K, "requests": len(cands), "tokens": tokens,
        "counters": c_b, "wall_s": wall, "tokens_per_s": tokens / wall,
        "tokens_per_lane_iteration": c_b["megastep_tokens"] / live,
        "differing_tokens_vs_tick": differing_tokens(outs, plain_outs),
        "teacher_forced": {"worst_shortfall": worst_b, "exact_argmax":
                           exact_b, "tokens": tokens,
                           "tolerance": LOGIT_TOL}}
    del eng
    # the verify accepting one draft token past the first mismatch
    few = reqs[:MEGA_FAULT_REQUESTS]
    bad, bad_outs = fast_serve(torch, HK, S, cfg, host, few, device,
                               "mega_accept", prepare=accepts_past_mismatch,
                               megastep=K, spec_k=k)[:2]
    worst_accept = worst_shortfall(torch, T, bad, few, bad_outs)[0]
    caught["accepts_past_mismatch"] = worst_accept > LOGIT_TOL
    del bad
    gc_cuda(torch)

    # (c) the MoE engine at K = 4: MoE routing inside the captured graph
    moe_host = T.init_transformer_params(
        prng.RandomGenerator("init", SEED), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=n_layers, max_len=cfg["max_len"],
        n_experts=MOE["n_experts"])
    few = reqs[:MEGA_MOE_REQUESTS]
    eng, outs, _, launches_c, wall = fast_serve(
        torch, HK, S, cfg, moe_host, few, device, "mega_moe",
        megastep=MEGA_MOE_K)
    c_c = megastep_books(eng, few, outs, launches_c, n_layers, plain=True)
    worst_c, exact_c = worst_shortfall(torch, T, eng, few, outs)
    check(worst_c <= LOGIT_TOL, "megastep: a MoE token's logit sits %g "
          "below its row max (tolerance %g)" % (worst_c, LOGIT_TOL))
    check(pool_drained(eng), "megastep: the MoE engine's pool did not get "
          "every page back")
    report["moe"] = {"K": MEGA_MOE_K, "n_experts": MOE["n_experts"],
                     "requests": len(few), "counters": c_c, "wall_s": wall,
                     "teacher_forced": {"worst_shortfall": worst_c,
                                        "exact_argmax": exact_c,
                                        "tolerance": LOGIT_TOL}}
    del eng, moe_host
    gc_cuda(torch)

    launches = {n: sum(run[n] for run in (launches_a, launches_b,
                                          launches_c))
                for n in ("paged_flash_decode", "paged_flash_prefill")}
    report.update(launches=launches,
                  faults={"caught": caught, "moved": moved,
                          "stale_shortfall": worst_stale,
                          "accept_shortfall": worst_accept},
                  phase_s=time.monotonic() - began)
    print(json.dumps({"serve_megastep": report}), flush=True)
    for name in MEGA_FAULTS:
        check(caught[name], "megastep: the planted fault %r was not caught"
              % name)
    return launches


# --------------------------------------------------------------- phase 19
#: the while megastep at the full LM width (``LM_CONFIG``), page 32, 8
#: slots: (a) the alias ``megastep="while"`` (K = 16) with a standby ring
#: of 2 on phase 4's 16 requests (and without the ring, for tokens/s);
#: (b) ``spec_k`` 4 at K = 4 with a ring of 2 on phase 17's periodic
#: candidates, each sent twice; (c) one lane with n_new 6 at K = 16
#: against the scan at the same K
WHILE_RING, WHILE_SPEC, WHILE_LONE = 2, (4, 4), 6
#: realised iterations of the timed dispatches at the widest table
WHILE_TIMED_ITERS = (1, 4, 8, 16)
#: planted faults, each of which a check of this phase must catch
WHILE_FAULTS = ("arm_ignores_count", "predicate_ignores_ring",
                "predicate_never_updated")


def while_output(engine):
    """The host copy of the last while dispatch's packed output (the
    pinned read-back buffer on the card, the program's own on the
    CPU)."""
    if engine.device.type == "cuda":
        return engine._ms_out.numpy()
    return engine._wl["out"].numpy()


def record_while(engine, log):
    """Record every while dispatch of ``engine`` into ``log``: its
    realised iterations, its published ring entries (``count``) and its
    ``assign``; and count the standby prompt chunks run
    (``log["standby_chunks"]``)."""
    count_launches, chunk = (engine._count_while_launches,
                             engine._advance_standby_chunk)
    S, K, k, R = (engine.slots, engine.megastep, engine.spec_k,
                  engine.refill_ring)
    at = 2 * S + K * S * (k + 1) + (K * S if k else 0)
    log.setdefault("dispatches", [])
    log.setdefault("standby_chunks", 0)

    def counted(w, iters):
        res = while_output(engine)
        published = int(engine._ms_host["count"][0]) if R else 0
        log["dispatches"].append((int(iters), published,
                                  res[at + 1:at + 1 + R].tolist()))
        count_launches(w, iters)

    def standby(entry):
        log["standby_chunks"] += 1
        chunk(entry)
    engine._count_while_launches = counted
    engine._advance_standby_chunk = standby


def while_contract(cap, log):
    """The while program's contract (iteration cap ``cap``) over every
    recorded dispatch:
    ``assign`` names a distinct slot or -1 for a published entry and -1
    past ``count``, and the program stops before the cap only once every
    published entry is armed.  Returns the dispatches that broke it."""
    bad = []
    for iters, published, assign in log["dispatches"]:
        armed = [s for s in assign[:published] if s >= 0]
        if (any(s != -1 for s in assign[published:])
                or len(set(armed)) != len(armed)
                or (iters < cap and len(armed) < published)):
            bad.append((iters, published, assign))
    return bad


def whilestep_books(engine, reqs, outs, launches, n_layers, log, plain):
    """Phase 19's checks of one run that hold on any device: the books
    (one decode dispatch a while dispatch, every token but each request's
    first from one, plain runs' lane-iterations closed), the program's
    contract, and kernels 5's and 6's launches: 8 of kernel 5 a REALISED
    iteration, 8 of kernel 6 a prompt chunk (the standby ring's
    included).  Returns the counters."""
    c = engine.metrics.snapshot()["counters"]
    c = {k: c.get(k, 0) for k in (
        "megastep_dispatches", "megastep_tokens", "megastep_lane_iterations",
        "megastep_wasted_iterations", "megastep_refills",
        "decode_dispatches", "prefill_dispatches", "draft_tokens",
        "draft_accepted", "tokens_out")}
    tokens = sum(len(o) for o in outs)
    iters = sum(d[0] for d in log["dispatches"])
    check(c["megastep_dispatches"] == c["decode_dispatches"]
          == len(log["dispatches"]) > 0
          and c["tokens_out"] == tokens
          and c["megastep_tokens"] == tokens - len(reqs)
          and (not plain or c["megastep_tokens"]
               + c["megastep_wasted_iterations"]
               == c["megastep_lane_iterations"]),
          "whilestep: books %r" % c)
    broken = while_contract(engine.megastep, log)
    check(not broken, "whilestep: dispatches broke the program's contract: "
          "%r" % broken[:4])
    check(launches["paged_flash_decode"] == n_layers * iters
          and launches["paged_flash_prefill"]
          == n_layers * c["prefill_dispatches"],
          "whilestep: launches %r for %d realised iterations and %r"
          % (launches, iters, c))
    return dict(c, realised_iterations=iters,
                standby_chunks=log["standby_chunks"])


def arm_ignores_count(engine):
    """A planted fault: the in-program arm takes entries past ``count``
    (the zero padding rows) — it reads a full ring as published."""
    real = engine._while_arm
    full = engine._ms_dev["count"].clone().fill_(engine.refill_ring)

    def arm(ptabs, w):
        count = engine._ms_dev["count"]
        engine._ms_dev["count"] = full
        try:
            real(ptabs, w)
        finally:
            engine._ms_dev["count"] = count
    engine._while_arm = arm


def predicate_ignores_ring(engine):
    """A planted fault: the loop's predicate reads only the lanes, so the
    program stops once they drain with a published entry unarmed."""
    st = engine._wl

    def live():
        st["flag"].copy_((st["left"] > 0).any().view(1))
    engine._while_live = live


def predicate_never_updated(engine):
    """A planted fault: the predicate is set before the first iteration
    and never again, so every iteration to the cap runs (the frozen ones
    as the identity)."""
    real_pre, real_live = engine._while_pre, engine._while_live

    def pre(w):
        engine._while_live = real_live
        try:
            real_pre(w)
        finally:
            engine._while_live = lambda: None
    engine._while_pre = pre
    engine._while_live = lambda: None


def while_ring_case(torch, HK, S, cfg, host, device, cases, slots,
                    fault=None):
    """``slots`` slots, a ring of 2, K = 16, ``cases`` queued before the
    loop's first turn (the engine's condition held across its start), so
    a request past the slots waits ready in the ring while they decode.
    ``fault`` sees the engine before it starts.  Returns the dispatch
    log."""
    engine = S.LMEngine(host, cfg["n_heads"], cfg["max_len"], slots=slots,
                        prefill_chunk=FAST_PAGE, device=device,
                        name="while_ring_case", megastep=16,
                        megastep_mode="while", refill_ring=WHILE_RING)
    log = {}
    record_while(engine, log)
    if fault is not None:
        fault(engine)
    with engine._cond:
        engine.start()
        futures = [engine.submit(p, n) for p, n in cases]
    try:
        for f in futures:
            f.result(timeout=300)
    finally:
        engine.stop()
    return log


def while_times(torch, engine, scan, reps=MEGA_TIMED):
    """The widest table's while dispatch with all 8 lanes 16 pages deep
    on distinct pages and n iterations of work (``WHILE_TIMED_ITERS``,
    and 0: every node skipped), against the scan's dispatch at the same
    K with all K iterations of work: host-clock ms of one synchronous
    dispatch with its upload and read-back, and card ms of the program
    alone (CUDA events around ``reps`` back-to-back launches), each also
    a realised iteration."""
    S, w, K = engine.slots, engine._max_pages, engine.megastep
    out = {"K": K, "width": w}
    for eng in (engine, scan):
        stage = eng._ms_host
        stage["ptab"][:] = (1 + numpy.arange(S * w, dtype=numpy.int32)
                            ).reshape(S, w)
        stage["last"][:] = 0
        stage["pos"][:] = eng.max_len - K       # K writes fit

    def dispatch(eng):
        eng._ms_in.copy_(eng._ms_stage, non_blocking=True)
        eng._ms_out.copy_(eng._megastep_program(w), non_blocking=True)
        torch.cuda.current_stream().synchronize()

    def card_ms(eng):
        eng._ms_in.copy_(eng._ms_stage)
        eng._megastep_program(w)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            eng._megastep_program(w)
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    for eng, name, n in ([(engine, "while", n) for n in WHILE_TIMED_ITERS]
                         + [(scan, "scan", K), (engine, "while", 0)]):
        eng._ms_host["left"][:] = n
        ms = step_ms(torch, lambda: dispatch(eng), "cuda", reps)
        if name == "while":
            got = int(eng._ms_out[2 * S + K * S])
            check(got == n, "whilestep: a timed dispatch ran %d iterations, "
                  "not %d" % (got, n))
        with torch.inference_mode():
            card = card_ms(eng)
        tag = "%s_%d" % (name, n)
        out[tag] = {"host_ms": ms, "card_ms": card}
        if n:
            out[tag].update(host_ms_per_iteration=ms / n,
                            card_ms_per_iteration=card / n)
    return out


def serve_whilestep(torch, HK, T, S, card, tick, fastpath, device="cuda",
                    cfg=None, timed=True):
    """Phase 19: the while megastep (K conditional graph nodes a ladder
    width) and the standby refill ring at the full LM width, held
    against phase 4's per-tick tokens (``tick``) and phase 17's plain
    tokens for its candidates (``fastpath``); three planted faults;
    timing at the widest table against the scan.  Returns kernels 5 and
    6's launches on the phase's runs (the faults' runs not counted)."""
    from veles_tpu_torch import prng
    cfg = cfg or LM_CONFIG
    began = time.monotonic()
    n_layers = cfg["n_layers"]
    host = T.init_transformer_params(
        prng.RandomGenerator("init", SEED), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=n_layers, max_len=cfg["max_len"])
    reqs, tick_outs = tick["requests"], tick["outs"]
    caught, report = {}, {"phase": "serve_whilestep", "card": card,
                          "config": dict(cfg), "slots": FAST_SLOTS,
                          "page": FAST_PAGE}
    runs = []

    def run(tag, cases, plain, **knobs):
        log = {}
        eng, outs, _, launches, wall = fast_serve(
            torch, HK, S, cfg, host, cases, device, tag,
            prepare=lambda e: record_while(e, log), **knobs)
        c = whilestep_books(eng, cases, outs, launches, n_layers, log,
                            plain)
        worst, exact = worst_shortfall(torch, T, eng, cases, outs)
        check(worst <= LOGIT_TOL, "whilestep %s: an emitted token's logit "
              "sits %g below its row max (tolerance %g)"
              % (tag, worst, LOGIT_TOL))
        check(pool_drained(eng), "whilestep %s: the pool did not get "
              "every page back" % tag)
        runs.append(launches)
        tokens = sum(len(o) for o in outs)
        rec = {"requests": len(cases), "tokens": tokens, "counters": c,
               "wall_s": wall, "tokens_per_s": tokens / wall,
               "iters_per_dispatch": [d[0] for d in log["dispatches"]],
               "capture_s": eng.megastep_capture_s,
               "launches_an_iteration": eng.megastep_launches,
               "teacher_forced": {"worst_shortfall": worst,
                                  "exact_argmax": exact, "tokens": tokens,
                                  "tolerance": LOGIT_TOL}}
        return eng, outs, rec

    # (a) the alias (K = 16) with a ring of 2 on phase 4's requests, and
    # without the ring
    eng, outs, rec = run("while_ring", reqs, True, megastep="while",
                         refill_ring=WHILE_RING)
    check(eng.megastep == 16 and rec["counters"]["megastep_refills"] > 0
          and rec["counters"]["standby_chunks"] > 0,
          "whilestep: the ring armed nothing in phase 4's requests: %r"
          % rec["counters"])
    rec["differing_tokens_vs_tick"] = differing_tokens(outs, tick_outs)
    rec["tick_tokens_per_s_phase_4"] = tick["tokens_per_s"]
    rec["ring_peak"] = eng.metrics.snapshot()["gauges"].get(
        "standby_ring_peak", 0)
    report["ring"] = rec
    del eng
    eng, outs, rec = run("while", reqs, True, megastep="while")
    rec["differing_tokens_vs_tick"] = differing_tokens(outs, tick_outs)
    report["no_ring"] = rec
    del eng
    gc_cuda(torch)

    # (b) spec_k 4 at K = 4 with a ring of 2 on phase 17's candidates,
    # each sent twice: 16 requests on 8 slots, so the ring fills
    k, K = WHILE_SPEC
    cands, plain_outs = fastpath["candidates"]
    cands, plain_outs = cands * 2, plain_outs * 2
    eng, outs, rec = run("while_spec", cands, False, megastep=K,
                         megastep_mode="while", refill_ring=WHILE_RING,
                         spec_k=k)
    c_b = rec["counters"]
    live = c_b["megastep_lane_iterations"] - c_b["megastep_wasted_iterations"]
    check(c_b["draft_accepted"] > 0 and c_b["megastep_tokens"] > live
          and c_b["megastep_refills"] > 0,
          "whilestep: speculative run %r" % c_b)
    rec.update(k=k, K=K, tokens_per_lane_iteration=c_b["megastep_tokens"]
               / live, differing_tokens_vs_tick=differing_tokens(
                   outs, plain_outs))
    report["spec"] = rec
    del eng
    gc_cuda(torch)

    # (c) one lane, n_new 6, K = 16: the while program against the scan
    lone = [(reqs[0][0], WHILE_LONE)]
    eng, outs, rec = run("while_lone", lone, True, megastep=16,
                         megastep_mode="while")
    c_c = rec["counters"]
    check(rec["iters_per_dispatch"] == [WHILE_LONE - 1]
          and c_c["megastep_wasted_iterations"] == 0
          and c_c["megastep_lane_iterations"] == WHILE_LONE - 1,
          "whilestep: the lone lane's dispatch %r, books %r"
          % (rec["iters_per_dispatch"], c_c))
    scan, scan_outs, _, scan_launches, _ = fast_serve(
        torch, HK, S, cfg, host, lone, device, "scan_lone", megastep=16)
    c_s = scan.metrics.snapshot()["counters"]
    check(c_s["megastep_lane_iterations"] == 16
          and c_s["megastep_wasted_iterations"] == 16 - (WHILE_LONE - 1)
          and scan_launches["paged_flash_decode"] == 16 * n_layers
          and numpy.array_equal(scan_outs[0], outs[0]),
          "whilestep: the scan twin %r, launches %r" % (c_s, scan_launches))
    rec["scan_twin"] = {k_: c_s.get(k_, 0) for k_ in (
        "megastep_lane_iterations", "megastep_wasted_iterations")}
    rec["scan_twin"]["paged_flash_decode"] = scan_launches[
        "paged_flash_decode"]
    report["lone"] = rec
    if timed:
        report["times"] = while_times(torch, eng, scan)
    del eng, scan
    gc_cuda(torch)

    # the planted faults, on one-chunk prompts: (1) two slots, a short
    # lane, a long one and a third request in the ring — once the ring
    # is empty a slot that drains or is free sits beside the live lane,
    # and the faulty arm takes a padding row; (2) one slot, a lane and a
    # request in the ring — the faulty predicate ends the program when
    # the lane drains, the entry unarmed
    short = [int(t) for t in reqs[0][0][:20]]
    pair = [(short, WHILE_LONE), (short[::-1], WHILE_LONE)]
    arm_log = while_ring_case(torch, HK, S, cfg, host, device,
                        pair + [([int(t) for t in reqs[1][0][:20]], 30)],
                        2, arm_ignores_count)
    caught["arm_ignores_count"] = bool(while_contract(16, arm_log))
    ring_log = while_ring_case(torch, HK, S, cfg, host, device, pair, 1,
                         predicate_ignores_ring)
    caught["predicate_ignores_ring"] = bool(while_contract(16, ring_log))
    good_log = while_ring_case(torch, HK, S, cfg, host, device, pair, 1)
    check(not while_contract(16, good_log)
          and good_log["dispatches"][0] == (2 * (WHILE_LONE - 1), 1,
                                            [0, -1]),
          "whilestep: the ring pair without a fault %r"
          % good_log["dispatches"])
    stuck = {}
    fast_serve(torch, HK, S, cfg, host, lone, device, "while_stuck",
               prepare=lambda e: (record_while(e, stuck),
                                  predicate_never_updated(e)),
               megastep=16, megastep_mode="while")
    stuck_iters = [d[0] for d in stuck["dispatches"]]
    caught["predicate_never_updated"] = stuck_iters != [WHILE_LONE - 1]
    gc_cuda(torch)

    launches = {n: sum(r[n] for r in runs)
                for n in ("paged_flash_decode", "paged_flash_prefill")}
    report.update(launches=launches,
                  faults={"caught": caught,
                          "arm_dispatches": arm_log["dispatches"],
                          "ring_dispatches": ring_log["dispatches"],
                          "good_pair_dispatches": good_log["dispatches"],
                          "stuck_iters": stuck_iters},
                  phase_s=time.monotonic() - began)
    print(json.dumps({"serve_whilestep": report}), flush=True)
    for name in WHILE_FAULTS:
        check(caught[name], "whilestep: the planted fault %r was not "
              "caught" % name)
    return launches


# ---------------------------------------------------------------- sampling
#: phase 20's sampling knobs (the engine's; generate and the HTTP bodies
#: take the same temperature and top_k)
SAMPLE_KW = {"temperature": 0.8, "top_k": 40, "sample_seed": 123}
#: (a)'s decode paths on phase 4's requests
SAMPLE_MODES = {"tick": {}, "scan": {"megastep": 8},
                "while": {"megastep": 16, "megastep_mode": "while",
                          "refill_ring": 2},
                "spec": {"megastep": 4, "spec_k": 4}}
#: the draw kernel alone: a decode step's rows and a verify's (8 x (4 + 1))
SAMPLE_DRAW_ROWS = (8, 40)
#: (c) generate: batch, prompt length, new tokens
SAMPLE_GENERATE = (8, 64, 64)
#: (d) serve_lm: the direct path's largest tier, and the sampled
#: requests' n_new cap (tier 8: 16 eager decode loops share the host)
SAMPLE_MAX_NEW, SAMPLE_DIRECT_NEW = 64, 8
#: the draw: 2 fold-ins a row beside each element's hash
SAMPLE_ROW_OPS = 2 * DROPOUT_OPS


def sampled_shortfall(torch, T, HK, engine, reqs, outs):
    """Phase 20's teacher-forced check of a sampling engine: each emitted
    token's perturbed score — its plain-pass logit after the top-k mask,
    over the temperature, plus the plain draw's gumbel at (its request's
    admission id, its position) — against its row's best.  Returns
    (worst shortfall, tokens equal to the plain draw's)."""
    worst, exact = 0.0, 0
    with torch.inference_mode():
        for rid, ((prompt, _), out) in enumerate(zip(reqs, outs), 1):
            n, s = len(out), len(prompt)
            logits = teacher_logits(torch, T, engine,
                                    numpy.concatenate([prompt, out]), s, n)
            dev = logits.device
            scores = HK.sample_scores_ref(
                logits.contiguous(), engine.temperature, engine._sample_key,
                engine.top_k,
                torch.full((n,), rid, dtype=torch.int32, device=dev),
                torch.arange(s, s + n, dtype=torch.int32, device=dev))
            tok = torch.as_tensor(out, device=dev).long()
            picked = scores.gather(1, tok[:, None])[:, 0]
            worst = max(worst, (scores.max(dim=1).values - picked)
                        .max().item())
            exact += int((scores.argmax(dim=1) == tok).sum().item())
    return worst, exact


def sampling_books(engine, mode, reqs, outs, launches, n_layers, log):
    """(a)'s books of one run: phase 4's, 18's or 19's checks of kernels
    5 and 6 by mode, and the draw's launches — one a prompt chunk and
    one a decode dispatch (a fused one: one an iteration, realised in
    the while mode).  Returns the counters."""
    c = engine.metrics.snapshot()["counters"]
    chunks = c.get("prefill_dispatches", 0)
    if mode == "tick":
        steps = c.get("decode_dispatches", 0)
        check(launches["paged_flash_decode"] == n_layers * steps > 0
              and launches["paged_flash_prefill"] == n_layers * chunks > 0
              and c.get("tokens_out") == sum(len(o) for o in outs),
              "sampling tick: launches %r for %r" % (launches, c))
        draws = steps + chunks
    elif "megastep_mode" in SAMPLE_MODES[mode]:
        c = whilestep_books(engine, reqs, outs, launches, n_layers, log,
                            True)
        draws = c["realised_iterations"] + chunks
    else:
        c = megastep_books(engine, reqs, outs, launches, n_layers,
                           not engine.spec_k)
        draws = engine.megastep * c["megastep_dispatches"] + chunks
    check(launches["sample_token"] == draws,
          "sampling %s: %d draws launched, %d expected (%r)"
          % (mode, launches["sample_token"], draws, c))
    return dict(c, draws=draws)


def draw_case(torch, HK, prng, rows, vocab, seed=0, timed=True):
    """The draw kernel alone in the engine's mode (base key, seeds and
    positions a row, top_k 40) against its plain version on the same
    card inputs: equal tokens (a difference only at a plain-version
    near tie within 1e-5), a bit-equal second launch, and its time (the
    wrapper's call: ``torch.topk``'s cutoffs and the draw; and the
    draw's launch alone, ``draw_kernel_ms``) beside the plain version's
    and its bound: the larger of the bytes
    (logits, top-k cutoffs, seeds and positions read, tokens written)
    over HBM and the integer operations (each element's threefry hash
    and the row's two fold-ins, as dropout's row reckons them)."""
    dev = torch.device("cuda")
    gen = card_draws(torch, numpy.random.RandomState(seed))
    lg = torch.randn(rows, vocab, device=dev, generator=gen) * 3
    seeds = torch.randint(1, 1000, (rows,), device=dev, generator=gen,
                          dtype=torch.int32)
    pos = torch.randint(0, 512, (rows,), device=dev, generator=gen,
                        dtype=torch.int32)
    base = prng.RandomGenerator("lm-sample", SAMPLE_KW["sample_seed"]
                                ).base_key()
    t, k = SAMPLE_KW["temperature"], SAMPLE_KW["top_k"]
    got = HK.sample_token(lg, t, base, k, seeds, pos)
    again = HK.sample_token(lg, t, base, k, seeds, pos)
    scores = HK.sample_scores_ref(lg, t, base, k, seeds, pos)
    ref = scores.argmax(dim=1).to(torch.int32)
    torch.cuda.synchronize()
    top2 = scores.topk(2, dim=1).values
    differ = got != ref
    ties = int((differ & ((top2[:, 0] - top2[:, 1]) <= 1e-5)).sum().item())
    check(int(differ.sum().item()) == ties and torch.equal(got, again),
          "draw %dx%d: %d tokens differ from the plain version (%d near "
          "ties), repeat equal %s" % (rows, vocab, int(differ.sum().item()),
                                      ties, torch.equal(got, again)))
    n = rows * vocab
    out = {"kernel": "sample_token", "case": "rows%d" % rows,
           "shape": [rows, vocab], "top_k": k, "unequal": ties,
           "max_abs_err": float((got - ref).abs().max().item()),
           "repeat_bit_equal": True}
    if not timed:
        return out
    lgs = [lg] + [lg.clone() for _ in range(COPIES - 1)]
    n_bytes = 4 * n + 4 * rows * 4
    int_ops = DROPOUT_OPS * n + SAMPLE_ROW_OPS * rows
    tops = [torch.topk(x, k, dim=1).values for x in lgs]
    out.update(
        kernel_ms=time_ms([lambda x=x: HK.sample_token(x, t, base, k, seeds,
                                                       pos) for x in lgs],
                          torch),
        draw_kernel_ms=time_ms([lambda x=x, top=top: HK._sample_launch(
            x, t, base, top, seeds, pos) for x, top in zip(lgs, tops)],
            torch),
        plain_ms=time_ms([lambda x=x: HK.sample_token_ref(
            x, t, base, k, seeds, pos) for x in lgs], torch, calls=3,
            reps=5),
        library_ms=None, bytes=n_bytes, int_ops=int_ops)
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = int_ops / INT32_OP_S * 1e3
    out["bound_ms"], out["bound_by"] = ((t_bytes, "bytes") if t_bytes >= t_ops
                                        else (t_ops, "operations"))
    return out


def sampled_while_ms(torch, engine, reps=MEGA_TIMED):
    """Host-clock and card ms of one while launch at the widest table
    with all 8 lanes 16 pages deep and 16 iterations of work (a sampling
    engine's lanes under seeds 1..8)."""
    S, w, K = engine.slots, engine._max_pages, engine.megastep
    stage = engine._ms_host
    stage["ptab"][:] = (1 + numpy.arange(S * w, dtype=numpy.int32)
                        ).reshape(S, w)
    stage["last"][:] = 0
    stage["pos"][:] = engine.max_len - K
    stage["left"][:] = K
    if "seeds" in stage:
        stage["seeds"][:] = numpy.arange(1, S + 1)
    if "count" in stage:
        stage["count"][:] = 0

    def dispatch():
        engine._ms_in.copy_(engine._ms_stage, non_blocking=True)
        engine._ms_out.copy_(engine._megastep_program(w), non_blocking=True)
        torch.cuda.current_stream().synchronize()
    host = step_ms(torch, dispatch, "cuda", reps)
    check(int(engine._ms_out[2 * S + K * S]) == K,
          "sampling: a timed while launch ran %d iterations, not %d"
          % (int(engine._ms_out[2 * S + K * S]), K))
    with torch.inference_mode():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            engine._megastep_program(w)
        ev[1].record()
        torch.cuda.synchronize()
    return {"host_ms": host, "card_ms": ev[0].elapsed_time(ev[1]) / reps,
            "iterations": K}


def generate_sampling(torch, HK, T, prng, params, cfg, device):
    """(c): ``generate`` sampling at ``SAMPLE_GENERATE``: one draw launch
    a token, every token's perturbed score under generate's split chain
    (one key for the batch's draw, flat counters) within LOGIT_TOL / T
    of its row's best in a plain full forward over the output."""
    b, s, n_new = SAMPLE_GENERATE
    t, k = SAMPLE_KW["temperature"], SAMPLE_KW["top_k"]
    prompt = torch.as_tensor(numpy.random.RandomState(SEED + 20).randint(
        0, cfg["vocab"], (b, s)).astype(numpy.int32), device=device)
    HK.reset_launch_counts()
    t0 = time.monotonic()
    out = T.generate(params, prompt, n_new, cfg["n_heads"],
                     rng=prng.PRNGKey(SEED), temperature=t, top_k=k)
    out_host = out.cpu().numpy()
    wall = time.monotonic() - t0
    draws = HK.launch_counts()["sample_token"]
    check(device != "cuda" or draws == n_new,
          "generate: %d draws for %d tokens" % (draws, n_new))
    worst, exact = 0.0, 0
    with torch.inference_mode():
        logits = T.transformer_forward(params, out[:, :-1].long(),
                                       cfg["n_heads"])
        key = prng.PRNGKey(SEED)
        for i in range(n_new):
            key, sub = prng.split(key)
            scores = HK.sample_scores_ref(
                logits[:, s - 1 + i].contiguous(), t, sub, k)
            tok = out[:, s + i].long()
            picked = scores.gather(1, tok[:, None])[:, 0]
            worst = max(worst, (scores.max(dim=1).values - picked)
                        .max().item())
            exact += int((scores.argmax(dim=1) == tok).sum().item())
    check(worst <= LOGIT_TOL / t, "generate: a sampled token's perturbed "
          "score sits %g below its row's best (tolerance %g)"
          % (worst, LOGIT_TOL / t))
    check(out_host.shape == (b, s + n_new) and out_host.min() >= 0
          and out_host.max() < cfg["vocab"], "generate: malformed output")
    return {"batch": b, "prompt": s, "new_tokens": n_new, "draws": draws,
            "wall_s": wall, "tokens_per_s": b * n_new / wall,
            "worst_shortfall": worst, "exact_draws": exact,
            "tokens": b * n_new, "tolerance": LOGIT_TOL / t}


def direct_reference(T, trainer, params, prompt, n_new, seed, cache_len):
    """What ``serve_lm``'s direct path answers for one sampled request:
    its tier and power-of-two bucket, ``trainer_sample_tokens`` in
    process, cut back to the prompt and ``n_new`` tokens."""
    tiers = sorted({x for x in (8, 32, 128, SAMPLE_MAX_NEW)
                    if x <= SAMPLE_MAX_NEW})
    s = len(prompt)
    run = next((x for x in tiers if x >= n_new), tiers[-1])
    bucket = 16
    while bucket < s:
        bucket *= 2
    bucket = min(bucket, cache_len - run)
    padded = numpy.pad(numpy.asarray(prompt, numpy.int32)[None],
                       ((0, 0), (0, max(bucket - s, 0))))
    out = T.trainer_sample_tokens(
        trainer, padded, n_new=run, temperature=SAMPLE_KW["temperature"],
        seed=seed, params=params, max_len=cache_len,
        top_k=SAMPLE_KW["top_k"], true_len=s)
    return numpy.concatenate([out[0, :s], out[0, padded.shape[1]:
                                              padded.shape[1] + n_new]])


def serve_lm_http(torch, HK, T, params, cfg, reqs, device):
    """(d): ``serve_lm`` on the card over HTTP: the greedy requests
    through its engine (8 slots, page 32) against ``generate``'s tokens,
    the seeded sampled ones through the direct path against
    ``trainer_sample_tokens`` in process, each set posted from 16 client
    threads at once: requests/s, p50 latency, launches."""
    from types import SimpleNamespace
    from veles_tpu_torch import restful_api
    trainer = SimpleNamespace(params=params, n_heads=cfg["n_heads"],
                              max_len=cfg["max_len"],
                              _to_portable=lambda tree: tree)
    api = restful_api.serve_lm(SimpleNamespace(trainer=trainer), port=0,
                               slots=FAST_SLOTS, prefill_chunk=FAST_PAGE,
                               max_new=SAMPLE_MAX_NEW)
    out = {}
    try:
        greedy = [json.dumps({"input": [p.tolist()], "n_new": k}).encode()
                  for p, k in reqs]
        sampled = [json.dumps({"input": [p.tolist()],
                               "n_new": min(k, SAMPLE_DIRECT_NEW),
                               "temperature": SAMPLE_KW["temperature"],
                               "top_k": SAMPLE_KW["top_k"],
                               "seed": i}).encode()
                   for i, (p, k) in enumerate(reqs)]
        for name, bodies in (("greedy_engine", greedy),
                             ("sampled_direct", sampled)):
            HK.reset_launch_counts()
            replies, lat, wall = rest_load(api, bodies, len(bodies))
            launches = HK.launch_counts()
            check(all(replies[i][0] == 200 for i in range(len(bodies))),
                  "serve_lm %s: %r" % (name, [replies[i][0] for i in
                                              range(len(bodies))]))
            lat.sort()
            out[name] = {"requests": len(bodies), "wall_s": wall,
                         "requests_per_s": len(bodies) / wall,
                         "p50_s": statistics.median(lat), "max_s": lat[-1],
                         "launches": {n: launches[n] for n in (
                             "paged_flash_decode", "paged_flash_prefill",
                             "sample_token")}}
            out[name]["replies"] = [numpy.asarray(replies[i][1]["tokens"][0])
                                    for i in range(len(bodies))]
        engine = api.lm_engine
        c = engine.metrics.snapshot()["counters"]
        g = out["greedy_engine"]
        check(g["launches"]["paged_flash_decode"]
              == cfg["n_layers"] * c["decode_dispatches"] > 0
              and g["launches"]["sample_token"] == 0
              and out["sampled_direct"]["launches"]["paged_flash_decode"]
              == 0, "serve_lm: launches %r / %r for %r"
              % (g["launches"], out["sampled_direct"]["launches"], c))
    finally:
        api.stop()
    # the greedy replies against generate, one request at a time; a reply
    # that differs is held to the teacher-forced pass (a near tie)
    differing, worst = 0, 0.0
    with torch.inference_mode():
        for (p, k), reply in zip(reqs, out["greedy_engine"].pop("replies")):
            want = T.generate(params, torch.as_tensor(p[None], device=device),
                              k, cfg["n_heads"], temperature=0.0,
                              max_len=cfg["max_len"]).cpu().numpy()[0]
            check(len(reply) == len(want) and (reply[:len(p)] == p).all(),
                  "serve_lm: a greedy reply is malformed")
            n = differing_tokens([reply[len(p):]], [want[len(p):]])
            if n:
                differing += n
                short, _ = teacher_forced(torch, T, engine, reply, len(p),
                                          reply[len(p):])
                worst = max(worst, short)
    check(worst <= LOGIT_TOL, "serve_lm: a greedy token's logit sits %g "
          "below its row max (tolerance %g)" % (worst, LOGIT_TOL))
    out["greedy_engine"].update(differing_tokens_vs_generate=differing,
                                worst_shortfall=worst)
    # the sampled replies against trainer_sample_tokens in process
    unequal = 0
    for i, ((p, k), reply) in enumerate(
            zip(reqs, out["sampled_direct"].pop("replies"))):
        want = direct_reference(T, trainer, params, p,
                                min(k, SAMPLE_DIRECT_NEW), i,
                                cfg["max_len"])
        unequal += int(len(reply) != len(want)
                       or not numpy.array_equal(reply, want))
    check(unequal == 0, "serve_lm: %d sampled replies differ from "
          "trainer_sample_tokens in process" % unequal)
    out["sampled_direct"]["unequal_to_in_process"] = unequal
    return out


def serve_sampling(torch, HK, T, S, card, tick, device="cuda", cfg=None,
                   timed=True):
    """Phase 20: seeded sampling (``SAMPLE_KW``) at the full LM width, 8
    slots, page 32: (a) the engine on phase 4's requests (``tick``) in
    ``SAMPLE_MODES``, (b) timings (a sampled while launch and per-tick
    step against greedy ones of the same run, the draw kernel alone),
    (c) ``generate`` sampling, (d) ``serve_lm`` over HTTP.  Returns
    kernels 5 and 6's launches on (a)'s and (d)'s runs, and the draw's
    line."""
    from veles_tpu_torch import prng
    cfg = cfg or LM_CONFIG
    began = time.monotonic()
    n_layers = cfg["n_layers"]
    host = T.init_transformer_params(
        prng.RandomGenerator("init", SEED), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=n_layers, max_len=cfg["max_len"])
    reqs = tick["requests"]
    tol = LOGIT_TOL / SAMPLE_KW["temperature"]
    report = {"phase": "serve_sampling", "card": card, "config": dict(cfg),
              "slots": FAST_SLOTS, "page": FAST_PAGE, "knobs": SAMPLE_KW}
    runs, outs_by, kept, legs = [], {}, {}, {}
    draws = 0
    mark = [began]

    def leg(name):
        now = time.monotonic()
        legs[name], mark[0] = now - mark[0], now
    # (a) each decode path on phase 4's requests
    for mode, knobs in SAMPLE_MODES.items():
        log = {}
        prepare = None
        if "megastep_mode" in knobs:
            def prepare(e, log=log):
                record_while(e, log)
        eng, outs, ttft, launches, wall = fast_serve(
            torch, HK, S, cfg, host, reqs, device, "sample_" + mode,
            prepare=prepare, **dict(SAMPLE_KW, **knobs))
        c = sampling_books(eng, mode, reqs, outs, launches, n_layers, log)
        worst, exact = sampled_shortfall(torch, T, HK, eng, reqs, outs)
        check(worst <= tol, "sampling %s: a token's perturbed score sits %g "
              "below its row's best (tolerance %g)" % (mode, worst, tol))
        check(pool_drained(eng), "sampling %s: the pool did not get every "
              "page back" % mode)
        runs.append(launches)
        draws += launches["sample_token"]
        outs_by[mode] = outs
        tokens = sum(len(o) for o in outs)
        report[mode] = {
            "knobs": knobs, "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "ttft_p50_s": statistics.median(ttft), "counters": c,
            "differing_tokens_vs_tick": differing_tokens(
                outs, outs_by["tick"]),
            "teacher_forced": {"worst_shortfall": worst,
                               "exact_draws": exact, "tokens": tokens,
                               "tolerance": tol}}
        if mode in ("tick", "while"):
            kept[mode] = eng
        else:
            del eng
        gc_cuda(torch)
        leg(mode)
    report["tick"]["tokens_per_s_greedy_phase_4"] = tick["tokens_per_s"]
    # (b) timings: the sampled while launch and per-tick step against a
    # greedy engine of the same run; the draw kernel alone
    drawn = [draw_case(torch, HK, prng, rows, cfg["vocab"], seed=rows,
                       timed=timed) for rows in SAMPLE_DRAW_ROWS]
    if timed:
        greedy = S.LMEngine(host, cfg["n_heads"], cfg["max_len"],
                            slots=FAST_SLOTS, prefill_chunk=FAST_PAGE,
                            device=device, name="sample_greedy",
                            **SAMPLE_MODES["while"])
        greedy.start()
        greedy.stop()
        w = greedy._max_pages
        ptabs = (1 + numpy.arange(FAST_SLOTS * w, dtype=numpy.int32)
                 ).reshape(FAST_SLOTS, w)
        zeros = numpy.zeros(FAST_SLOTS, numpy.int32)
        deep = numpy.full(FAST_SLOTS, cfg["max_len"] - 1, numpy.int32)
        seeds = numpy.arange(1, FAST_SLOTS + 1, dtype=numpy.int32)
        times = {
            "while_sampled": sampled_while_ms(torch, kept["while"]),
            "while_greedy": sampled_while_ms(torch, greedy),
            "tick_sampled_ms": step_ms(torch, lambda: kept[
                "tick"]._step_program(ptabs, zeros, deep, seeds), device),
            "tick_greedy_ms": step_ms(torch, lambda: greedy._step_program(
                ptabs, zeros, deep), device)}
        times["while_card_ratio"] = (times["while_sampled"]["card_ms"]
                                     / times["while_greedy"]["card_ms"])
        times["tick_ratio"] = (times["tick_sampled_ms"]
                               / times["tick_greedy_ms"])
        report["times"] = times
        del greedy
    kept.clear()
    gc_cuda(torch)
    leg("times")
    # (c) generate, (d) serve_lm over HTTP
    params = T.params_from_jax(host, device)
    report["generate"] = generate_sampling(torch, HK, T, prng, params, cfg,
                                           device)
    draws += report["generate"]["draws"]
    leg("generate")
    http = serve_lm_http(torch, HK, T, params, cfg, reqs, device)
    leg("serve_lm")
    report["serve_lm"] = http
    for name in ("greedy_engine", "sampled_direct"):
        runs.append(http[name]["launches"])
        draws += http[name]["launches"]["sample_token"]
    launches = {n: sum(r[n] for r in runs)
                for n in ("paged_flash_decode", "paged_flash_prefill")}
    report.update(launches=launches, draw_launches=draws,
                  draw_cases=drawn, leg_s=legs,
                  phase_s=time.monotonic() - began)
    print(json.dumps({"serve_sampling": report}), flush=True)
    return launches, {"launches": draws, "cases": drawn}


# ---------------------------------------------------------------- phase 21
#: crash-safe serving and hot weight swap at the full LM width, 8 slots,
#: page 32, a prefix cache of ``OPS_CACHE`` chunks.  (a) the swap on each
#: decode path of ``OPS_MODES``, phase 4's 16 requests twice: weights A
#: (phase 4's) to B (a second seeded draw) finish-on-old, then back to A
#: with ``drain=True``, each swap asked for once every slot is busy
OPS_MODES = {"tick": {}, "scan": {"megastep": 8},
             "while": {"megastep": 16, "megastep_mode": "while",
                       "refill_ring": 2}}
OPS_CACHE = 128
OPS_SEED_B = SEED + 1
#: the weights each stamped version serves
OPS_VERSION_WEIGHTS = {0: "A", 1: "B", 2: "A"}
#: the planted faults' and the unarmed-plan runs' traffic: phase 4's
#: first 8 prompts, 16 new tokens each
OPS_SHORT = (8, 16)
#: (b) a freeze at this loop turn of the per-tick verify run, held this
#: long before it is released; (c) the crash: a freeze at this turn
OPS_FREEZE_TURN, OPS_FREEZE_S, OPS_CRASH_TURN = 20, 0.2, 6
OPS_FAULTS = ("pointer_swap", "trie_kept")


def serve_ops(torch, HK, T, S, card, tick, device="cuda", cfg=None):
    """Phase 21: hot weight swap, fault plans and checkpoint/restore at
    the full LM width (see the module docstring), every result held by
    the teacher-forced check on the weights of its stamped version and
    counted against phase 4's tokens (``tick``) or a fresh engine's on
    B.  Returns kernels 5 and 6's launches on the phase's runs (the
    planted faults' runs and the crashed engine's not counted)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.serving import FaultPlan, InjectedFault
    from veles_tpu_torch.serving import lm_engine as LE
    cfg = cfg or LM_CONFIG
    began = time.monotonic()

    def draw(seed):
        return T.init_transformer_params(
            prng.RandomGenerator("init", seed), cfg["vocab"],
            d_model=cfg["d_model"], n_heads=cfg["n_heads"],
            n_layers=cfg["n_layers"], max_len=cfg["max_len"])
    hosts = {"A": draw(SEED), "B": draw(OPS_SEED_B)}
    weights = {k: T.params_from_jax(h, device) for k, h in hosts.items()}
    reqs, a_outs = tick["requests"], tick["outs"]
    short = [(p, OPS_SHORT[1]) for p, _ in reqs[:OPS_SHORT[0]]]
    report = {"phase": "serve_ops", "card": card, "config": dict(cfg),
              "slots": FAST_SLOTS, "page": FAST_PAGE,
              "prefix_cache": OPS_CACHE}
    runs, caught, legs, mark = [], {}, {}, [began]

    def leg(name):
        now = time.monotonic()
        legs[name], mark[0] = now - mark[0], now

    def engine(tag, host, plan=None, **knobs):
        return S.LMEngine(host, cfg["n_heads"], cfg["max_len"],
                          slots=FAST_SLOTS, prefill_chunk=FAST_PAGE,
                          prefix_cache=OPS_CACHE, device=device,
                          name="ops_" + tag, faults=plan, **knobs)

    def held(eng, cases):
        """Start ``eng`` with ``cases`` queued before its loop's first
        turn (the schedule fixed by the loop, not the clock), the launch
        counts set to 0 after its warmup; returns the futures."""
        with eng._cond:
            eng.start()
            HK.reset_launch_counts()
            return [eng.submit(p, k) for p, k in cases]

    def worst(eng, cases, outs, names):
        """The teacher-forced check of every result on the weights named
        in ``names``: the worst shortfall."""
        out = 0.0
        with torch.inference_mode():
            for (prompt, _), toks, name in zip(cases, outs, names):
                short_, _ = teacher_forced(
                    torch, T, eng, numpy.concatenate([prompt, toks]),
                    len(prompt), toks, params=weights[name])
                out = max(out, short_)
        return out

    def outcomes(futures):
        """(tokens or None, the exception) of each future."""
        out = []
        for f in futures:
            try:
                out.append((f.result(timeout=300), None))
            except Exception as e:   # noqa: BLE001 — read by the checks
                out.append((None, e))
        return out

    def watch(eng, failed):
        """Record in ``failed`` every request a planted fault fails as a
        participant: a lane torn down or a ring entry failed with
        ``InjectedFault``."""
        teardown, fail_standby = eng._teardown_slot, eng._fail_standby

        def on_teardown(slot, lane, exc=None):
            if isinstance(exc, InjectedFault):
                failed.append(lane.request.future)
            teardown(slot, lane, exc)

        def on_fail_standby(entry, exc):
            if isinstance(exc, InjectedFault):
                failed.append(entry.lane.request.future)
            fail_standby(entry, exc)
        eng._teardown_slot, eng._fail_standby = on_teardown, on_fail_standby

    def until(cond, what, timeout=120.0):
        deadline = time.monotonic() + timeout
        while not cond():
            check(time.monotonic() < deadline, "serve_ops: timed out "
                  "waiting for %s" % what)
            time.sleep(0.001)

    # a fresh per-tick engine on B: the tokens B-stamped results must give
    eng, b_outs, _, launches, _ = fast_serve(torch, HK, S, cfg, hosts["B"],
                                             reqs, device, "ops_fresh_b")
    runs.append(launches)
    check(worst(eng, reqs, b_outs, "B" * len(reqs)) <= LOGIT_TOL,
          "serve_ops: the fresh engine on B failed the teacher check")
    del eng
    leg("fresh_b")

    # (a) the swap on each path: A -> B finish-on-old, B -> A drained
    applies = []

    def swap_batch(eng, to, version, drain):
        futures = [eng.submit(p, k) for p, k in reqs]
        until(lambda: eng.metrics.gauge("slots_busy") >= FAST_SLOTS,
              "every slot busy")
        t0 = time.monotonic()
        check(eng.swap_weights(hosts[to], version=version, drain=drain)
              == version, "serve_ops: swap_weights returned another "
              "version")
        wait_s = time.monotonic() - t0
        outs = [f.result(timeout=300) for f in futures]
        return outs, [f.version for f in futures], wait_s

    for mode, knobs in OPS_MODES.items():
        eng = engine(mode, hosts["A"], **knobs)

        def recorded(eng=eng, flush=eng._flush_prefix_cache, mode=mode):
            before = eng._trie.size
            flush()
            applies.append({"mode": mode, "chunks_before": before,
                            "chunks_after": eng._trie.size,
                            "gauge": eng.metrics.gauge(
                                "prefix_cache_chunks")})
        eng._flush_prefix_cache = recorded
        eng.start()
        try:
            HK.reset_launch_counts()
            t0 = time.monotonic()
            outs1, vers1, wait1 = swap_batch(eng, "B", 1, False)
            quiesce1 = eng.metrics.gauge("swap_quiesce_s")
            requeued1 = eng.metrics.counter("requests_requeued_for_swap")
            outs2, vers2, wait2 = swap_batch(eng, "A", 2, True)
            wall = time.monotonic() - t0
            launches = HK.launch_counts()
        finally:
            eng.stop()
        runs.append(launches)
        outs, vers = outs1 + outs2, vers1 + vers2
        names = [OPS_VERSION_WEIGHTS[v] for v in vers]
        short_ = worst(eng, reqs * 2, outs, names)
        check(short_ <= LOGIT_TOL, "serve_ops %s: a token's logit sits %g "
              "below its row max on its stamped version's weights "
              "(tolerance %g)" % (mode, short_, LOGIT_TOL))
        on_b = [(o, w) for o, w, v in zip(outs, b_outs * 2, vers) if v == 1]
        on_a = [(o, w) for o, w, v in zip(outs, a_outs * 2, vers) if v != 1]
        differ_b = differing_tokens(*zip(*on_b)) if on_b else 0
        differ_a = differing_tokens(*zip(*on_a)) if on_a else 0
        c = eng.metrics.snapshot()["counters"]
        requeued2 = c["requests_requeued_for_swap"] - requeued1
        check(set(vers1) == {0, 1} and set(vers2) <= {1, 2} and 2 in vers2,
              "serve_ops %s: stamps %r then %r" % (mode, vers1, vers2))
        check(differ_a == 0 and differ_b == 0, "serve_ops %s: %d tokens "
              "differ from phase 4's on A, %d from the fresh engine's on B"
              % (mode, differ_a, differ_b))
        check(eng.metrics.errors == 0 and c["weight_swaps"] == 2
              and requeued2 > 0, "serve_ops %s: errors %d, "
              "swaps %d, requeued at the drain %d" % (
                  mode, eng.metrics.errors, c["weight_swaps"], requeued2))
        check(launches["paged_flash_decode"] > 0
              and launches["paged_flash_prefill"] > 0,
              "serve_ops %s: the kernels did not run: %r" % (mode, launches))
        check(pool_drained(eng), "serve_ops %s: the pool did not get every "
              "page back" % mode)
        tokens = sum(len(o) for o in outs)
        report[mode] = {
            "knobs": knobs, "requests": len(outs), "tokens": tokens,
            # prefill_tokens beyond these are prompts prefilled again
            "prompt_tokens": sum(len(p) for p, _ in reqs * 2),
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "stamps": [vers1, vers2],
            "swap_wait_s": [wait1, wait2],
            "swap_quiesce_s": [quiesce1,
                               eng.metrics.gauge("swap_quiesce_s")],
            "requeued": [requeued1, requeued2],
            "differing_tokens": {"on_A_vs_phase_4": differ_a,
                                 "on_B_vs_fresh_B": differ_b},
            "counters": {k: c.get(k, 0) for k in (
                "prefix_hit_chunks", "prefill_dispatches", "prefill_tokens",
                "decode_dispatches", "megastep_refills", "tokens_out")},
            "launches": launches,
            "teacher_forced": {"worst_shortfall": short_,
                               "tolerance": LOGIT_TOL}}
        del eng
        gc_cuda(torch)
        leg("swap_" + mode)
    check(len(applies) == 2 * len(OPS_MODES)
          and all(a["chunks_before"] > 0 and a["chunks_after"] == 0
                  and a["gauge"] == 0 for a in applies),
          "serve_ops: the prefix cache at the applies %r" % applies)
    report["applies"] = applies

    # the swap's two halves on a quiet engine: staging on the caller's
    # thread (host clock), the in-place copy (card time) against its
    # bytes' bound
    eng = engine("apply", hosts["A"])
    t0 = time.monotonic()
    staged = eng._stage_params(hosts["B"])
    stage_ms = (time.monotonic() - t0) * 1e3
    n_bytes = 2 * sum(t.numel() * t.element_size()
                      for t in T.tree_leaves(staged))
    with torch.inference_mode():
        apply_ms = time_ms([lambda: eng._load_params(staged)], torch,
                           calls=5, reps=5)
    report["apply"] = {"stage_ms_host": stage_ms, "apply_ms_card": apply_ms,
                       "leaves": len(T.tree_leaves(staged)),
                       "bytes": n_bytes, "bound_ms": bound(n_bytes, 0)[0]}
    del eng, staged
    leg("apply_times")

    # the planted faults: (1) a swap that reassigns params — the captured
    # scan graphs keep decoding on A; (2) a swap that keeps the trie — the
    # same prompts hit A's cached chunks after the apply
    b_short = [b[:k] for b, (_, k) in zip(b_outs, short)]
    eng = engine("pointer_swap", hosts["A"], megastep=8)
    eng._load_params = lambda staged, eng=eng: setattr(eng, "params",
                                                       staged)
    eng.start()
    try:
        eng.swap_weights(hosts["B"])
        outs = [f.result(timeout=300)
                for f in [eng.submit(p, k) for p, k in short]]
    finally:
        eng.stop()
    caught["pointer_swap"] = differing_tokens(outs, b_short)
    del eng
    eng = engine("trie_kept", hosts["A"])
    eng._flush_prefix_cache = lambda: None
    eng.start()
    try:
        [f.result(timeout=300) for f in [eng.submit(p, k) for p, k in short]]
        cached = eng._trie.size
        eng.swap_weights(hosts["B"])
        outs = [f.result(timeout=300)
                for f in [eng.submit(p, k) for p, k in short]]
    finally:
        eng.stop()
    caught["trie_kept"] = differing_tokens(outs, b_short) if cached else 0
    del eng
    gc_cuda(torch)
    leg("planted")

    # (b) fault plans: per tick with spec_k 4 (a verify, a prompt chunk,
    # a freeze released, a copy-on-write made due at the freeze), then
    # the copy-on-write site on a direct call; while K = 16 with a ring
    # of 2 (a step)
    def faulted(tag, plan, at_freeze=None, **knobs):
        """The engine on A under ``plan``, phase 4's requests held;
        ``at_freeze`` (given a plan with a tick freeze) sees the frozen
        engine and returns what to undo once every future resolved."""
        failed = []
        eng = engine(tag, hosts["A"], plan, **knobs)
        watch(eng, failed)
        futures = held(eng, reqs)
        frozen_tokens = undo = None
        if at_freeze is not None:
            until(lambda: plan.calls("engine.tick") >= OPS_FREEZE_TURN,
                  "the freeze")
            before = eng.metrics.counter("tokens_out")
            time.sleep(OPS_FREEZE_S)
            frozen_tokens = eng.metrics.counter("tokens_out") - before
            undo = at_freeze(eng)
            plan.release()
        got = outcomes(futures)
        if undo is not None:
            undo()
        launches = HK.launch_counts()
        runs.append(launches)
        bad = [f for f, (_, e) in zip(futures, got) if e is not None]
        check(all(isinstance(e, InjectedFault) for _, e in got if e)
              and set(map(id, bad)) == set(map(id, failed)) and bad,
              "serve_ops %s: failed %d requests, %d participants of the "
              "faults" % (tag, len(bad), len(failed)))
        ok = [(c, t) for c, (t, e) in zip(reqs, got) if e is None]
        short_ = worst(eng, [c for c, _ in ok], [t for _, t in ok],
                       "A" * len(ok))
        differ = differing_tokens([t for _, t in ok],
                                  [a for a, (_, e) in zip(a_outs, got)
                                   if e is None])
        check(short_ <= LOGIT_TOL and differ == 0, "serve_ops %s: the "
              "survivors' shortfall %g, %d tokens differ from phase 4's"
              % (tag, short_, differ))
        inv = eng.verify_pool_invariants()
        trie = eng._trie.size
        check(inv["pinned_pages"] == 0 and inv["used_pages"] == trie,
              "serve_ops %s: the pool after the faults %r" % (tag, inv))
        rec = {"failed": len(bad), "participants": len(failed),
               "fired": plan.fired(), "frozen_tokens_out": frozen_tokens,
               "launches": launches, "errors": eng.metrics.errors,
               "survivors_shortfall": short_}
        return eng, rec

    shared_lane = []

    def share_write_page(eng):
        """A second reference (a sibling's) to a page that one busy lane
        writes next — a decoding lane's write position, else a
        prefilling lane's tail chunk (never served from the cache): that
        write must copy the page first, and the armed ``engine.cow``
        fails the lane (and it alone) there.  Returns the reference's
        release."""
        P = eng.prefill_chunk
        busy = [(s_, ln) for s_, ln in enumerate(eng._lanes)
                if ln is not None]
        check(busy, "serve_ops: no lane busy at the freeze")
        slot, lane = min(busy, key=lambda b: bool(b[1].pending))
        at = lane.pending[-1][1] if lane.pending else int(eng._pos[slot])
        page = lane.pages[at // P]
        check(not eng._pool.shared(page), "serve_ops: the write page of "
              "slot %d is shared before the plant" % slot)
        eng._pool.retain(page)
        shared_lane.extend([lane.request.future,
                            "tail chunk" if lane.pending else "decode"])
        return lambda: eng._pool.release(page)

    plan = FaultPlan().arm("engine.verify", calls=[3]) \
        .arm("engine.chunk", calls=[5]) \
        .arm("engine.cow", calls=[1]) \
        .arm("engine.tick", kind="freeze", calls=[OPS_FREEZE_TURN],
             duration_s=120.0)
    eng, rec = faulted("faults_tick", plan, at_freeze=share_write_page,
                       spec_k=FAST_SPEC_K)
    try:
        check(rec["frozen_tokens_out"] == 0 and rec["fired"] == {
            "engine.verify": 1, "engine.chunk": 1, "engine.cow": 1,
            "engine.tick": 1} and plan.calls("engine.cow") == 1
            and eng.metrics.counter("kv_cow_copies") == 0,
            "serve_ops: the per-tick plan %r" % rec)
        check(isinstance(shared_lane[0].exception(timeout=0),
                         InjectedFault)
              and "engine.cow" in str(shared_lane[0].exception()),
              "serve_ops: the lane whose write page was shared did not "
              "fail at engine.cow")
        # disarmed: the next 16 requests pass the check
        plan.disarm()
        HK.reset_launch_counts()
        outs = [f.result(timeout=300)
                for f in [eng.submit(p, k) for p, k in reqs]]
        runs.append(HK.launch_counts())
    finally:
        plan.release()
        eng.stop()
    after = worst(eng, reqs, outs, "A" * len(reqs))
    check(after <= LOGIT_TOL and differing_tokens(outs, a_outs) == 0,
          "serve_ops: the requests after the faults: shortfall %g" % after)
    check(pool_drained(eng), "serve_ops: the pool after the faults did "
          "not get every page back")
    # copy-on-write, the unit check: a shared page and one direct write
    # on the stopped engine, the site armed once
    plan.arm("engine.cow", times=1)
    pool = eng._pool
    (page,) = pool.alloc(1)
    pool.retain(page)
    pool.pin(page)
    lane = LE._Slot(LE._Request(numpy.asarray([1, 2, 3], numpy.int32), 4,
                                30.0, pages=1))
    lane.pages = [page]
    eng._page_tables[0, 0] = page
    free = pool.free_pages
    try:
        eng._cow_guard(0, lane, 0, 1)
        cow_fired = False
    except InjectedFault:
        cow_fired = True
    check(cow_fired and pool.free_pages == free and pool.refs(page) == 2
          and lane.pages == [page], "serve_ops: the copy-on-write fault "
          "kept a page or moved the lane")
    with torch.inference_mode():
        eng._cow_guard(0, lane, 0, 1)
        copy = lane.pages[0]
        check(copy != page and eng.metrics.counter("kv_cow_copies") == 1
              and all(torch.equal(k[copy], k[page])
                      and torch.equal(v[copy], v[page])
                      for k, v in eng._kv_pools),
              "serve_ops: the copy after the copy-on-write fault")
    rec.update(after_shortfall=after, cow_served_write=shared_lane[1],
               cow_fault_returned_page=cow_fired)
    report["faults_tick"] = rec
    del eng
    gc_cuda(torch)
    eng, rec = faulted("faults_while", FaultPlan().arm("engine.step",
                                                       calls=[3]),
                       **OPS_MODES["while"])
    eng.stop()
    check(pool_drained(eng), "serve_ops: the while run's pool after its "
          "fault")
    report["faults_while"] = rec
    del eng
    gc_cuda(torch)
    # a plan with no rule launches the kernels as no plan does
    unarmed = []
    for tag, plan in (("no_plan", None), ("unarmed", FaultPlan())):
        eng = engine(tag, hosts["A"], plan)
        futures = held(eng, short)
        outs = [f.result(timeout=300) for f in futures]
        unarmed.append((HK.launch_counts(), outs))
        eng.stop()
        del eng
    runs.append(unarmed[1][0])
    keys = ("paged_flash_decode", "paged_flash_prefill")
    check([unarmed[0][0][k] for k in keys] == [unarmed[1][0][k]
                                                for k in keys]
          and differing_tokens(unarmed[1][1], unarmed[0][1]) == 0,
          "serve_ops: an unarmed plan changed the launches %r"
          % [u[0] for u in unarmed])
    report["unarmed"] = {"no_plan": unarmed[0][0], "unarmed": unarmed[1][0]}
    gc_cuda(torch)
    leg("faults")

    # (c) crash and restore: freeze mid-traffic, checkpoint, release,
    # stop; restore into a fresh engine
    plan = FaultPlan().arm("engine.tick", kind="freeze",
                           calls=[OPS_CRASH_TURN], duration_s=120.0)
    crashed = engine("crashed", hosts["A"], plan)
    held(crashed, reqs)
    try:
        until(lambda: plan.calls("engine.tick") >= OPS_CRASH_TURN,
              "the crash")
        state = json.loads(json.dumps(crashed.checkpoint()))
    finally:
        plan.release()
        crashed.stop()
    del crashed
    check(len(state["requests"]) == len(reqs), "serve_ops: the checkpoint "
          "journaled %d of %d requests" % (len(state["requests"]),
                                           len(reqs)))
    fresh = engine("restored", hosts["A"]).start()
    try:
        HK.reset_launch_counts()
        restored = fresh.restore(state)
        outs = [restored[e["rid"]].result(timeout=300)
                for e in state["requests"]]
        launches = HK.launch_counts()
    finally:
        fresh.stop()
    runs.append(launches)
    order = {tuple(p): i for i, (p, _) in enumerate(reqs)}
    want = [a_outs[order[tuple(e["prompt"])]] for e in state["requests"]]
    differ = differing_tokens(outs, want)
    short_ = worst(fresh, [(numpy.asarray(e["prompt"], numpy.int32),
                            e["n_new"]) for e in state["requests"]], outs,
                   "A" * len(outs))
    check(differ == 0 and short_ <= LOGIT_TOL
          and fresh.metrics.counter("engine_restores") == 1
          and fresh.metrics.counter("requests_restored") == len(reqs),
          "serve_ops: the restore: %d tokens differ from the uncrashed "
          "run, shortfall %g" % (differ, short_))
    check(pool_drained(fresh), "serve_ops: the restored engine's pool")
    report["restore"] = {
        "journaled": len(state["requests"]),
        "slot_frontiers": state["slot_frontiers"],
        "pool_used_at_crash": state["pool"]["num_pages"]
        - len(state["pool"]["free"]),
        "prefix_cache_chunks_at_crash": state["prefix_cache_chunks"],
        "differing_tokens_vs_uncrashed": differ, "shortfall": short_,
        "launches": launches}
    del fresh
    gc_cuda(torch)
    leg("restore")

    launches = {n: sum(r[n] for r in runs)
                for n in ("paged_flash_decode", "paged_flash_prefill")}
    report.update(launches=launches, faults_caught=caught, leg_s=legs,
                  phase_s=time.monotonic() - began)
    print(json.dumps({"serve_ops": report}, default=str), flush=True)
    for name in OPS_FAULTS:
        check(caught[name], "serve_ops: the planted fault %r was not "
              "caught" % name)
    return launches


# ---------------------------------------------------------------- phase 22
#: the decode paths phase 22 traces, each one engine (8 slots, page 32)
TRACE_PATHS = {"tick": {}, "spec_k4": {"spec_k": FAST_SPEC_K},
                 "scan_k8": {"megastep": 8},
                 "while_k16": {"megastep": 16, "megastep_mode": "while",
                               "refill_ring": 2}}
#: the tracer settings each path serves phase 4's 16 requests under
#: (None: untraced); the sampled tracer's coin is seeded.  Every path
#: runs untraced and ``all``.  The sampled mode runs per tick, at
#: ``spec_k`` 4 and at scan K = 8: the verify and megastep spans open
#: and fence only when a sampled request takes part, so the per-tick
#: run does not stand for them.  ``errors`` runs per tick only ((c)
#: runs it again under faults); the while path shares the scan path's
#: sampled span logic
TRACE_MODES = (None, "all", "sample:0.25", "errors")
TRACE_PATH_MODES = {"tick": TRACE_MODES,
                    "spec_k4": (None, "all", "sample:0.25"),
                    "scan_k8": (None, "all", "sample:0.25"),
                    "while_k16": (None, "all")}
#: (b) a spin of at least 5 ms queued behind each watched dispatch, its
#: event behind the spin: a span that closed at enqueue finds it pending
TRACE_SPIN_CYCLES = int(2.5e9 * 0.005)
#: (d) the telemetry store's interval, and the sample_once calls timed
TRACE_TELEMETRY_S, TRACE_SAMPLES_TIMED = 0.05, 20
#: (b), (c) and the planted faults serve phase 4's first 8 prompts, 16
#: new tokens each
TRACE_SHORT = (8, 16)
TRACE_FAULTS = ("chunk_span_unfenced", "k_spans_a_replay",
                  "tracer_call_in_captured_body")


class _TracerProxy:
    """A span tracer seen through a planted fault: ``add_many`` of one
    span name is replaced, every other call reaches the real tracer."""

    def __init__(self, real, name, add_many):
        self._real, self._name, self._add_many = real, name, add_many

    def __getattr__(self, attr):
        return getattr(self._real, attr)

    def add_many(self, ctxs, name, *args, **kw):
        if name == self._name:
            return self._add_many(ctxs, name, *args, **kw)
        return self._real.add_many(ctxs, name, *args, **kw)


def ledger_dispatches(rows, prefix):
    """Dispatches of the ledger ``rows`` whose op starts with
    ``prefix``."""
    return sum(r["dispatches"] for r in rows if r["op"].startswith(prefix))


def settled(tracer, timeout=60.0):
    """Wait until every traced request has been finished (a future's
    done callback finishes its trace on the engine's thread, after the
    client's wait returned)."""
    deadline = time.monotonic() + timeout
    while tracer.stats()["live"]:
        check(time.monotonic() < deadline, "a traced request never "
              "finished its trace")
        time.sleep(0.001)


def strict_json(body):
    """Parse ``body`` as strict JSON (NaN and Infinity refused)."""
    def refuse(const):
        raise ValueError("non-strict JSON constant %s" % const)
    return json.loads(body, parse_constant=refuse)


def http_get(url, timeout=60):
    """GET ``url``; returns (status, body bytes, content type)."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read(), r.headers.get("Content-Type", "")


def serve_observe(torch, HK, T, S, card, tick, device="cuda", cfg=None,
                  keep=None):
    """Phase 22: request tracing and live telemetry at the full LM width
    (see the module docstring).  Returns kernels 5 and 6's launches on
    the phase's runs (the planted faults' runs not counted); ``keep`` (a
    dict) gets each path's untraced run (tokens, launches, dispatches;
    phase 23 holds its guarded runs against them)."""
    from types import SimpleNamespace
    from veles_tpu_torch import prng, restful_api
    from veles_tpu_torch.serving import (FaultPlan, InjectedFault,
                                         SpanTracer, verify_integrity)
    cfg = cfg or LM_CONFIG
    began = time.monotonic()
    host = T.init_transformer_params(
        prng.RandomGenerator("init", SEED), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg["n_layers"], max_len=cfg["max_len"])
    reqs = tick["requests"]
    short = [(p, TRACE_SHORT[1]) for p, _ in reqs[:TRACE_SHORT[0]]]
    kernels = ("paged_flash_decode", "paged_flash_prefill")
    report = {"phase": "serve_observe", "card": card, "config": dict(cfg),
              "slots": FAST_SLOTS, "page": FAST_PAGE}
    runs, caught, legs, mark = [], {}, {}, [began]

    def leg(name):
        now = time.monotonic()
        legs[name], mark[0] = now - mark[0], now

    def engine(tag, tracer=None, **knobs):
        return S.LMEngine(host, cfg["n_heads"], cfg["max_len"],
                          slots=FAST_SLOTS, prefill_chunk=FAST_PAGE,
                          device=device, name="observe_" + tag,
                          tracer=tracer, **knobs)

    def served(eng, cases):
        """``cases`` queued on the started, idle ``eng`` before its loop's
        next turn (the schedule fixed by the loop, not the clock), the
        launch counts set to 0 just before; returns (outputs, launches,
        wall s, decode and prefill dispatches)."""
        m = eng.metrics
        before = (m.counter("decode_dispatches"),
                  m.counter("prefill_dispatches"))
        with eng._cond:
            HK.reset_launch_counts()
            t0 = time.monotonic()
            futures = [eng.submit(p, k) for p, k in cases]
        outs = [f.result(timeout=300) for f in futures]
        wall = time.monotonic() - t0
        launches = HK.launch_counts()
        return outs, {n: launches[n] for n in kernels}, wall, (
            m.counter("decode_dispatches") - before[0],
            m.counter("prefill_dispatches") - before[1])

    # (a) traced equals untraced: a fresh engine a path and mode (its
    # free slots and round robin as the untraced run's, so the schedule
    # is the same)
    paths = {}
    for path, knobs in TRACE_PATHS.items():
        rows = {}
        for mode in TRACE_PATH_MODES[path]:
            tracer = (None if mode is None else
                      SpanTracer.from_spec(mode, last=64, seed=SEED))
            eng = engine(path, tracer, **knobs).start()
            try:
                outs, launches, wall, (steps, chunks) = served(eng, reqs)
                runs.append(launches)
                tokens = sum(len(o) for o in outs)
                row = {"tokens_per_s": tokens / wall, "wall_s": wall,
                       "launches": launches, "decode_dispatches": steps,
                       "prefill_dispatches": chunks, "outs": outs}
                if tracer is not None:
                    settled(tracer)
                    recs = tracer.requests()
                    integ = verify_integrity(recs)
                    stats = tracer.stats()
                    ledger = tracer.live_ledger()
                    row.update(
                        stats=stats, spans=integ["spans"],
                        ledger_decode=ledger_dispatches(ledger, "decode."),
                        ledger_prefill=ledger_dispatches(ledger,
                                                         "prefill."),
                        megastep_spans=sum(
                            1 for r in recs for s in r["spans"]
                            if s["name"] == "decode.megastep"))
                rows[str(mode)] = row
            finally:
                eng.stop()
            del eng
        gc_cuda(torch)
        base = rows["None"]
        base_outs = base["outs"]
        if keep is not None:
            keep[path] = {"outs": base_outs, "launches": base["launches"],
                          "decode_dispatches": base["decode_dispatches"],
                          "prefill_dispatches": base["prefill_dispatches"]}
        for mode, row in rows.items():
            differ = differing_tokens(row.pop("outs"), base_outs)
            row["differing_tokens_vs_untraced"] = differ
            check(differ == 0, "serve_observe %s %s: %d tokens differ from "
                  "the untraced run" % (path, mode, differ))
            check(row["launches"] == base["launches"], "serve_observe %s "
                  "%s: launches %r, untraced %r" % (
                      path, mode, row["launches"], base["launches"]))
            check(row["decode_dispatches"] == base["decode_dispatches"],
                  "serve_observe %s %s: the schedule moved" % (path, mode))
            if mode in ("all", "errors"):
                # every request traced: one ledger dispatch a step or a
                # graph replay, one a prompt chunk
                check(row["ledger_decode"] == row["decode_dispatches"]
                      and row["ledger_prefill"]
                      == row["prefill_dispatches"],
                      "serve_observe %s %s: ledger %d / %d dispatches for "
                      "%d steps / %d chunks" % (
                          path, mode, row["ledger_decode"],
                          row["ledger_prefill"], row["decode_dispatches"],
                          row["prefill_dispatches"]))
                check(row["stats"]["retained"]
                      == (len(reqs) if mode == "all" else 0),
                      "serve_observe %s %s: %r" % (path, mode,
                                                   row["stats"]))
            if mode == "sample:0.25":
                st = row["stats"]
                check(st["started"] == len(reqs) and 0 < st["retained"]
                      == len(reqs) - st["sampled_out"]
                      and row["ledger_decode"] <= row["decode_dispatches"],
                      "serve_observe %s sampled: %r" % (path, row))
            if mode != "None":
                row["tokens_per_s_vs_untraced"] = (row["tokens_per_s"]
                                                   / base["tokens_per_s"])
        paths[path] = rows
        leg("traced_" + path)
    report["traced"] = paths

    # (b) fencing: behind every watched chunk and swap apply a spin and
    # a CUDA event; each span's close must find the event complete
    # (planted: the fence removed)
    def watched(tag, planted):
        tracer = SpanTracer(mode="all", last=64)
        eng = engine(tag, tracer)
        if planted:
            eng._tfence = lambda traced=True: None
        closes = []
        chunk, load = eng._chunk_program, eng._load_params
        add, event_of = tracer.add, tracer.event

        def spun(fn):
            def run(*args):
                out = fn(*args)
                torch.cuda._sleep(TRACE_SPIN_CYCLES)
                ev = torch.cuda.Event()
                ev.record()
                closes.append([ev, None])
                return out
            return run

        def closing(ctx, name, *args, **kw):
            if name == "prefill.chunk":
                closes[-1][1] = ("prefill.chunk", closes[-1][0].query())
            return add(ctx, name, *args, **kw)

        def closing_event(name, *args, **kw):
            if name == "swap.apply":
                closes[-1][1] = ("swap.apply", closes[-1][0].query())
            return event_of(name, *args, **kw)
        eng.start()
        eng._chunk_program, eng._load_params = spun(chunk), spun(load)
        tracer.add, tracer.event = closing, closing_event
        try:
            outs, launches, _, _ = served(eng, short)
            eng.swap_weights(host)
        finally:
            eng.stop()
        marks = [c[1] for c in closes if c[1] is not None]
        late = sum(1 for _, done in marks if not done)
        verify_integrity(tracer.requests())
        return outs, launches, marks, late

    outs, launches, marks, late = watched("fenced", False)
    runs.append(launches)
    check(late == 0 and any(n == "swap.apply" for n, _ in marks)
          and sum(n == "prefill.chunk" for n, _ in marks) > len(short),
          "serve_observe: %d of %d fenced spans closed before their "
          "dispatch's event" % (late, len(marks)))
    _, _, marks_p, late_p = watched("unfenced", True)
    caught["chunk_span_unfenced"] = late_p
    report["fencing"] = {
        "spans_watched": len(marks), "closed_before_event": late,
        "swap_apply_watched": sum(n == "swap.apply" for n, _ in marks),
        "planted_closed_before_event": late_p,
        "spin_cycles": TRACE_SPIN_CYCLES}
    gc_cuda(torch)
    leg("fencing")

    # (c) errors mode: faults at a prompt chunk and a decode step; the
    # ring retains exactly the failed requests
    plan = FaultPlan().arm("engine.chunk", calls=[5]) \
        .arm("engine.step", calls=[3])
    tracer = SpanTracer(mode="errors", last=64)
    eng = engine("errors", tracer, faults=plan).start()
    try:
        with eng._cond:
            HK.reset_launch_counts()
            futures = [eng.submit(p, k) for p, k in short]
        failed = set()
        for f in futures:
            try:
                f.result(timeout=300)
            except InjectedFault:
                failed.add(f.request.trace.rid)
        runs.append({n: HK.launch_counts()[n] for n in kernels})
    finally:
        eng.stop()
    recs = tracer.requests()
    verify_integrity(recs)
    kept = {r["rid"] for r in recs}
    check(failed and kept == failed and all(
        "InjectedFault" in r["error"] for r in recs)
        and len(tracer.dumps()) == len(failed),
        "serve_observe: the errors ring kept %r for the failed %r"
        % (sorted(kept), sorted(failed)))
    report["errors_mode"] = {"failed": len(failed), "retained": len(kept),
                             "fired": plan.fired(),
                             "stats": tracer.stats()}
    del eng
    gc_cuda(torch)
    leg("errors_mode")

    # the planted faults on the captured scan: K spans a replay, and the
    # span's call moved inside the captured body (it runs at capture only)
    def scan_run(tag, plant):
        real = SpanTracer(mode="all", last=64)
        eng = engine(tag, real, megastep=8)
        plant(eng, real)
        eng.start()
        try:
            _, _, _, (steps, _) = served(eng, short)
        finally:
            eng.stop()
        return ledger_dispatches(real.live_ledger(), "decode."), steps

    def k_spans(eng, real):
        def k_times(ctxs, name, *args, **kw):
            for _ in range(eng.megastep):
                did = real.add_many(ctxs, name, *args, **kw)
            return did
        eng._tracer = _TracerProxy(real, "decode.megastep", k_times)

    def in_body(eng, real):
        eng._tracer = _TracerProxy(real, "decode.megastep",
                                   lambda *args, **kw: None)
        body = eng._megastep_body

        def traced_body(w):
            ctxs = [ln.request.trace for ln in eng._lanes if ln is not None]
            t = time.monotonic()
            real.add_many(ctxs, "decode.megastep", "decode", t, t,
                          attrs={"bucket": w, "backend": eng._backend})
            return body(w)
        eng._megastep_body = traced_body
    for name, plant in (("k_spans_a_replay", k_spans),
                        ("tracer_call_in_captured_body", in_body)):
        ledger, steps = scan_run(name, plant)
        caught[name] = ledger != steps
        report.setdefault("planted", {})[name] = {
            "ledger_decode": ledger, "decode_dispatches": steps}
        gc_cuda(torch)
    leg("planted")

    # (d) serve_lm over HTTP, traced, with telemetry and the stock SLOs
    trainer = SimpleNamespace(params=T.params_from_jax(host, device),
                              n_heads=cfg["n_heads"], max_len=cfg["max_len"],
                              _to_portable=lambda tree: tree)
    api = restful_api.serve_lm(
        SimpleNamespace(trainer=trainer), port=0, slots=FAST_SLOTS,
        prefill_chunk=FAST_PAGE, megastep=8, max_new=SAMPLE_MAX_NEW,
        trace="all", telemetry=TRACE_TELEMETRY_S, slo=True)
    base = "http://127.0.0.1:%d" % api.port
    try:
        eng, store = api.lm_engine, api.telemetry
        bodies = [json.dumps({"input": [p.tolist()], "n_new": k}).encode()
                  for p, k in reqs]
        HK.reset_launch_counts()
        replies, lat, wall = rest_load(api, bodies, len(bodies))
        launches = HK.launch_counts()
        runs.append({n: launches[n] for n in kernels})
        check(all(replies[i][0] == 200 for i in range(len(bodies))),
              "serve_observe http: %r" % [replies[i][0]
                                          for i in range(len(bodies))])
        # two more ticks, so the window closes after the traffic
        samples = store.samples
        deadline = time.monotonic() + 10
        while store.samples < samples + 2:
            check(time.monotonic() < deadline, "serve_observe: the "
                  "telemetry store stopped sampling")
            time.sleep(TRACE_TELEMETRY_S / 2)
        got = {}
        for path in ("/trace.json?last=16", "/ledger.json",
                     "/timeseries.json?window=600", "/slo.json",
                     "/metrics.json", "/status"):
            code, body, ctype = http_get(base + path)
            check(code == 200, "serve_observe: GET %s %d" % (path, code))
            got[path.split("?")[0]] = (body if ctype.startswith(
                "text/plain") else strict_json(body), len(body))
        reserved = torch.cuda.memory_reserved() if device == "cuda" \
            else None
        sample_ms = []
        for _ in range(TRACE_SAMPLES_TIMED):
            t0 = time.perf_counter()
            store.sample_once()
            sample_ms.append((time.perf_counter() - t0) * 1e3)
        recs = api.tracer.requests()
        verify_integrity(recs)
    finally:
        api.stop()
    gauges = got["/metrics.json"][0]["gauges"]
    graphs = len(eng._megastep_programs) if device == "cuda" else 0
    check(gauges["compile_programs"] == graphs
          == len(eng._width_ladder) * (device == "cuda"),
          "serve_observe: compile_programs %r for %d captured graphs"
          % (gauges["compile_programs"], graphs))
    if device == "cuda":
        check(0 < gauges["device_mem_bytes"] <= reserved,
              "serve_observe: device_mem_bytes %r, reserved %r"
              % (gauges.get("device_mem_bytes"), reserved))
    # the probe's tokens/s, integrated over the window, against the
    # tokens the store's counter saw (host clock)
    series = got["/timeseries.json"][0]["series"]
    key = [k for k in store.sources()][0]
    rate = series["%s.gauge.tokens_per_s" % key]["series"]
    count = series["%s.counter.tokens_out" % key]["series"]
    # (a counter first appears at its first increment: absent is 0)
    by_t = {round(t, 6): v for t, v in count}
    integral = sum(v * (t - t_prev) for (t_prev, _), (t, v)
                   in zip(rate, rate[1:]))
    counted = (by_t.get(round(rate[-1][0], 6), 0)
               - by_t.get(round(rate[0][0], 6), 0))
    check(counted > 0 and abs(integral - counted) <= 0.1 * counted,
          "serve_observe: tokens_per_s integrates to %g tokens over the "
          "window, the counter saw %d" % (integral, counted))
    led = got["/ledger.json"][0]
    c = eng.metrics.snapshot()["counters"]
    check(ledger_dispatches(led["rows"], "decode.")
          == c["decode_dispatches"] > 0, "serve_observe http: ledger %r, "
          "decode dispatches %d" % (led["rows"], c["decode_dispatches"]))
    roots = {r["spans"][0]["name"] for r in recs}
    status = got["/status"][0].decode()
    slo = got["/slo.json"][0]
    check(roots == {"http.request"} and len(recs) == len(bodies)
          and all(s in status for s in ("[telemetry", "[slo",
                                        "[cost ledger"))
          and slo["objectives"] and slo["evaluations"] > 0,
          "serve_observe http: roots %r, status %r" % (roots, status))
    lat.sort()
    report["http"] = {
        "requests": len(bodies), "wall_s": wall,
        "requests_per_s": len(bodies) / wall,
        "p50_s": statistics.median(lat), "max_s": lat[-1],
        "launches": runs[-1],
        "trace_json_bytes_16_requests": got["/trace.json"][1],
        "trace_events": len(got["/trace.json"][0]["traceEvents"]),
        "ledger_rows": led["rows"], "compile_programs": graphs,
        "device_mem_bytes": gauges.get("device_mem_bytes"),
        "memory_reserved": reserved,
        "tokens_per_s_integrated": integral, "tokens_counted": counted,
        "mfu_live_max": max((v for _, v in series.get(
            "%s.gauge.mfu_live" % key, {}).get("series", [])),
            default=None),
        "mfu_peak": {k: v for k, v in gauges.items()
                     if k.startswith("mfu_peak_flops")},
        "slo_worst": slo["worst_state_name"],
        "samples": store.samples,
        "sample_once_ms_median": statistics.median(sample_ms),
        "sample_once_ms_max": max(sample_ms)}
    del eng, store, api
    gc_cuda(torch)
    leg("http")

    launches = {n: sum(r[n] for r in runs) for n in kernels}
    report.update(launches=launches, faults_caught=caught, leg_s=legs,
                  phase_s=time.monotonic() - began)
    print(json.dumps({"serve_observe": report}, default=str), flush=True)
    for name in TRACE_FAULTS:
        check(caught[name], "serve_observe: the planted fault %r was not "
              "caught" % name)
    return launches


# ---------------------------------------------------------------- guarded
#: phase 23's armed runs: phase 22's four decode paths (its untraced runs
#: the reference), then per tick sampled (against an unarmed run here)
#: and traced at ``sample:1.0`` (against phase 22's), and a swap under
#: the scan's captured graphs (against an unarmed run of the same script)
GUARD_SWAP_PATH = "scan_k8"
GUARD_FAULTS = ("cond_held_across_step", "implicit_read_in_decode",
                "guard_exit_keeps_mode")
#: the unarmed shims' cost: with-block round trips timed on the host clock
GUARD_SHIM_PAIRS = 200000
#: the reference's bound on the unarmed shims, a share of a decode step
#: (``tools/chaos_bench.py``'s ``fault_free_overhead``)
GUARD_SHIM_SHARE = 0.02


def sync_probe(torch, device):
    """Which host/card operations ``set_sync_debug_mode("error")``
    refuses on this card: {operation: whether it raised}.  A refusal must
    be the mode's (its message names a synchronizing operation)."""
    a = numpy.arange(4096, dtype=numpy.int32)
    pinned = torch.zeros(4096, dtype=torch.int32).pin_memory()
    d = torch.zeros(4096, dtype=torch.int32, device=device)
    event = torch.cuda.Event()
    ops = {
        "blocking_upload": lambda: torch.as_tensor(a, device=device),
        "pageable_non_blocking_upload": lambda: torch.from_numpy(a).to(
            device, non_blocking=True),
        "pinned_non_blocking_upload": lambda: pinned.to(
            device, non_blocking=True),
        "pinned_non_blocking_read": lambda: pinned.copy_(
            d, non_blocking=True),
        "blocking_read": lambda: d.cpu(),
        "item": lambda: d[0].item(),
        "stream_synchronize": lambda: torch.cuda.current_stream(
            device).synchronize(),
        "device_synchronize": torch.cuda.synchronize,
        "event_synchronize": lambda: (event.record(), event.synchronize()),
        "card_to_card_copy": lambda: d.clone(),
    }
    raised = {}
    for name, fn in ops.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            raised[name] = False
        except RuntimeError as e:
            check("synchroniz" in str(e), "sync probe %s raised something "
                  "else: %s" % (name, e))
            raised[name] = True
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return raised


def pair_us(lock, n=GUARD_SHIM_PAIRS):
    """µs a ``with lock: pass`` round trip, host clock."""
    t0 = time.perf_counter()
    for _ in range(n):
        with lock:
            pass
    return (time.perf_counter() - t0) / n * 1e6


def serve_guarded(torch, HK, T, S, card, tick, observed, device="cuda",
                  cfg=None):
    """Phase 23: the lock-order witness and the transfer guard armed on
    every decode path at the full LM width (see the module docstring).
    Returns kernels 5 and 6's launches on the armed runs (the unarmed
    references' and the planted faults' runs not counted)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.serving import (SpanTracer, lockcheck, verify_integrity,
                                         xfer)
    cfg = cfg or LM_CONFIG
    began = time.monotonic()
    on_card = device == "cuda"
    host = T.init_transformer_params(
        prng.RandomGenerator("init", SEED), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg["n_layers"], max_len=cfg["max_len"])
    reqs = tick["requests"]
    short = [(p, TRACE_SHORT[1]) for p, _ in reqs[:TRACE_SHORT[0]]]
    kernels = ("paged_flash_decode", "paged_flash_prefill")
    report = {"phase": "serve_guarded", "card": card, "config": dict(cfg),
              "slots": FAST_SLOTS, "page": FAST_PAGE}
    runs, rows, caught, legs, mark = [], {}, {}, {}, [began]
    edges, totals = {}, {"acquisitions": 0, "dispatch_checks": 0}

    def leg(name):
        now = time.monotonic()
        legs[name], mark[0] = now - mark[0], now

    def mode():
        """The card's sync debug mode (0 on the CPU, which has none)."""
        return torch.cuda.get_sync_debug_mode() if on_card else 0

    def engine(tag, params=host, **knobs):
        return S.LMEngine(params, cfg["n_heads"], cfg["max_len"],
                          slots=FAST_SLOTS, prefill_chunk=FAST_PAGE,
                          device=device, name="guarded_" + tag, **knobs)

    def served(eng, cases):
        """``cases`` queued on the started, idle ``eng`` before its
        loop's next turn, the launch counts set to 0 just before; returns
        (outputs, launches, decode and prefill dispatches)."""
        m = eng.metrics
        before = (m.counter("decode_dispatches"),
                  m.counter("prefill_dispatches"))
        with eng._cond:
            HK.reset_launch_counts()
            futures = [eng.submit(p, k) for p, k in cases]
        outs = [f.result(timeout=300) for f in futures]
        launches = HK.launch_counts()
        return outs, {n: launches[n] for n in kernels}, (
            m.counter("decode_dispatches") - before[0],
            m.counter("prefill_dispatches") - before[1])

    @contextlib.contextmanager
    def armed(name):
        """Both witnesses armed; yields the lock-order witness."""
        witness = lockcheck.arm(lockcheck.LockOrderWitness(name=name))
        xfer.arm("disallow")
        try:
            yield witness
        finally:
            xfer.disarm()
            lockcheck.disarm()

    def swapped(eng):
        """Phase 4's first 8 prompts on A, the swap to B while the engine
        idles (its graphs keep serving, reading B by address), then the
        16 requests on B."""
        first = served(eng, short)[0]
        check(eng.swap_weights(swap_to, version=1) == 1,
              "serve_guarded: the swap was refused")
        outs, launches, steps = served(eng, reqs)
        return outs, launches, steps, first

    def all16(eng):
        return served(eng, reqs)

    def run(tag, knobs, script):
        eng = engine(tag, **knobs).start()
        try:
            return script(eng)
        finally:
            eng.stop()
            del eng

    def guarded(tag, knobs, want, script=all16):
        """One armed run of ``script`` held against ``want`` (an unarmed
        run's outputs, launches and dispatches)."""
        with armed(tag) as witness:
            got = run(tag, knobs, script)
        after = mode()
        rep = witness.report()
        differ = differing_tokens(got[0], want["outs"])
        row = {"differing_tokens": differ, "launches": got[1],
               "decode_dispatches": got[2][0],
               "prefill_dispatches": got[2][1],
               "acquisitions": rep["acquisitions"],
               "dispatch_checks": rep["dispatch_checks"],
               "violations": len(rep["violations"]), "mode_after": after}
        rows[tag] = row
        runs.append(got[1])
        totals["acquisitions"] += rep["acquisitions"]
        totals["dispatch_checks"] += rep["dispatch_checks"]
        for a, bs in rep["edges"].items():
            edges.setdefault(a, set()).update(bs)
        check(not rep["violations"], "serve_guarded %s: %d lock-order "
              "violations:\n%s" % (tag, len(rep["violations"]),
                                   "\n\n".join(rep["violations"])))
        check(differ == 0, "serve_guarded %s: %d tokens differ from the "
              "unarmed run" % (tag, differ))
        check(got[1] == want["launches"], "serve_guarded %s: launches %r, "
              "unarmed %r" % (tag, got[1], want["launches"]))
        check(got[2] == (want["decode_dispatches"],
                         want["prefill_dispatches"]),
              "serve_guarded %s: the schedule moved" % tag)
        check(after == 0, "serve_guarded %s: sync debug mode %d after "
              "stop()" % (tag, after))
        check(rep["dispatch_checks"] > 0, "serve_guarded %s: no dispatch "
              "was checked" % tag)
        return got

    def unarmed(tag, knobs):
        outs, launches, steps = run(tag, knobs, all16)
        return {"outs": outs, "launches": launches,
                "decode_dispatches": steps[0],
                "prefill_dispatches": steps[1]}

    # (a) what the mode refuses on this card
    if on_card:
        report["sync_probe"] = probe = sync_probe(torch, device)
        for name in ("blocking_upload", "item", "blocking_read",
                     "stream_synchronize"):
            check(probe[name], "sync probe: %s passed the error mode" % name)
        for name in ("pageable_non_blocking_upload",
                     "pinned_non_blocking_upload", "card_to_card_copy"):
            check(not probe[name], "sync probe: %s raised" % name)
    leg("probe")

    # (b) every decode path armed against phase 22's untraced run, then
    # sampled, traced and swapped
    for path, knobs in TRACE_PATHS.items():
        guarded(path, knobs, observed[path])
        gc_cuda(torch)
        leg(path)
    guarded("sampled", SAMPLE_KW, unarmed("sampled_unarmed", SAMPLE_KW))
    leg("sampled")
    tracer = SpanTracer.from_spec("sample:1.0", last=64, seed=SEED)
    guarded("traced", {"tracer": tracer}, observed["tick"])
    settled(tracer)
    integ = verify_integrity(tracer.requests())
    rows["traced"].update(spans=integ["spans"], stats=tracer.stats())
    check(integ["requests"] == len(reqs), "serve_guarded traced: %r"
          % integ)
    del tracer
    leg("traced")
    swap_to = T.init_transformer_params(
        prng.RandomGenerator("init", SEED + 1), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg["n_layers"], max_len=cfg["max_len"])
    knobs = TRACE_PATHS[GUARD_SWAP_PATH]
    base = run("swap_unarmed", knobs, swapped)
    got = guarded("swap", knobs, {
        "outs": base[0], "launches": base[1],
        "decode_dispatches": base[2][0], "prefill_dispatches": base[2][1]},
        swapped)
    check(differing_tokens(got[3], base[3]) == 0, "serve_guarded swap: "
          "the tokens before the swap differ from the unarmed run")
    check(differing_tokens(got[0], observed[GUARD_SWAP_PATH]["outs"]) > 0,
          "serve_guarded swap: weights B served weights A's tokens")
    del swap_to
    gc_cuda(torch)
    leg("swap")

    # (c) the planted faults, each on a per-tick engine serving phase
    # 4's first prompts
    with armed("cond_held_across_step") as witness:
        eng = engine("cond_held")
        step = eng._step_plain

        def held(active, eng=eng, step=step):
            with eng._cond:
                return step(active)
        eng._step_plain = held
        eng.start()
        try:
            served(eng, short[:2])
        finally:
            eng.stop()
    caught["cond_held_across_step"] = any(
        "'lm_engine._cond' held across device dispatch 'engine.step'" in v
        for v in witness.violations)
    with armed("implicit_read_in_decode") as witness:
        eng = engine("implicit_read").start()
        pick, left = eng._pick, [1]

        def poisoned(logits, seeds, pos, pick=pick, left=left):
            if left[0]:
                left[0] -= 1
                logits.max().item()
            return pick(logits, seeds, pos)
        eng._pick = poisoned
        error = None
        try:
            try:
                eng.submit(*short[0]).result(timeout=300)
            except RuntimeError as e:
                error = str(e)
            nxt = eng.submit(*short[1]).result(timeout=300)
        finally:
            eng.stop()
    after = mode()
    caught["implicit_read_in_decode"] = bool(
        error and "synchroniz" in error and len(nxt) == short[1][1]
        and after == 0)
    report["implicit_read_error"] = error
    leave = xfer._leave_guard

    def kept_mode():
        with xfer._state:
            xfer._guards -= 1
    xfer._leave_guard = kept_mode
    try:
        with armed("guard_exit_keeps_mode"):
            eng = engine("kept_mode").start()
            try:
                for p, k in short[:2]:
                    try:
                        eng.submit(p, k).result(timeout=300)
                    except RuntimeError:
                        pass
            finally:
                eng.stop()
        after = mode()
    finally:
        xfer._leave_guard = leave
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
        xfer._guards, xfer._boundaries, xfer._applied = 0, 0, None
    caught["guard_exit_keeps_mode"] = after != 0
    gc_cuda(torch)
    leg("faults")

    # (d) the unarmed shims' cost on the host clock, against the decode
    # step alone (phase 4's, full width), charged the acquisitions the
    # armed per-tick run made a decode dispatch
    check(lockcheck.armed() is None and not xfer.armed(),
          "serve_guarded: a witness is still armed")
    import threading as _threading
    empty = pair_us(contextlib.nullcontext())
    shim = {"tracked_condition_us": pair_us(lockcheck.make_condition(
                "chip_smoke.cond")),
            "condition_us": pair_us(_threading.Condition()),
            "tracked_lock_us": pair_us(lockcheck.make_lock("chip_smoke.lock")),
            "lock_us": pair_us(_threading.Lock()),
            "unarmed_guard_us": pair_us(xfer.guard(device)) - empty,
            "unarmed_boundary_us": pair_us(xfer.boundary()) - empty}
    delta = max(0.0, shim["tracked_condition_us"] - shim["condition_us"],
                shim["tracked_lock_us"] - shim["lock_us"])
    per_step = rows["tick"]["acquisitions"] / rows["tick"][
        "decode_dispatches"]
    step_us = tick["step_ms"] * 1e3
    shim.update(acquisitions_per_decode_dispatch=per_step,
                decode_step_ms=tick["step_ms"],
                step_share=(per_step * delta + max(
                    0.0, shim["unarmed_guard_us"])
                    + 2 * max(0.0, shim["unarmed_boundary_us"])) / step_us)
    check(shim["step_share"] < GUARD_SHIM_SHARE, "serve_guarded: the "
          "unarmed shims cost %.4f of a decode step" % shim["step_share"])
    leg("shim_cost")

    launches = {n: sum(r[n] for r in runs) for n in kernels}
    report.update(runs=rows, edges={a: sorted(bs) for a, bs in
                                    sorted(edges.items())},
                  witness_totals=totals, shim=shim, launches=launches,
                  faults_caught=caught, leg_s=legs,
                  phase_s=time.monotonic() - began)
    print(json.dumps({"serve_guarded": report}, default=str), flush=True)
    for name in GUARD_FAULTS:
        check(caught[name], "serve_guarded: the planted fault %r was not "
              "caught" % name)
    return launches


# ------------------------------------------------------------------- fleet
#: phase 24: two engine replicas on the one card behind the router
FLEET_REPLICAS = 2
FLEET_PATHS = {"tick": {}, "scan_k8": {"megastep": 8}}
FLEET_POLICIES = ("metrics", "round_robin")
#: the paths whose requests also run one at a time (the placements'
#: alternation); every path runs them as one burst
FLEET_SEQUENTIAL_PATHS = ("scan_k8",)
#: the reference's bound on a burst's split over an idle fleet
#: (``tests/test_serving.py::TestRouter::test_idle_fleet_spreads_evenly``)
FLEET_BURST_SPREAD = 2
#: (b) the drain: replica 0's decode dispatch slowed by this much
FLEET_LATENCY_S = 0.05
#: (c) the refusing replicas' Retry-After seconds
FLEET_RETRY_AFTERS = (0.7, 0.3, 0.5)
#: (c) the seeded stub fleets ``_order`` is held on
FLEET_ORDER_FLEETS = 200
#: (e) placements timed through a stub fleet whose futures are settled
FLEET_PLACEMENTS_TIMED = 20000
FLEET_FAULTS = ("order_keeps_drained", "short_result_delivered",
                "retry_after_last")
#: the planted short-result delivery's drain serves phase 4's first 8
FLEET_PLANTED_REQUESTS = 8


def router_mutant(S, name, old, new):
    """A copy of ``S.Router``'s method ``name`` with ``old`` replaced by
    ``new`` in its source: a planted fault."""
    import inspect
    import textwrap
    from veles_tpu_torch.serving import router as router_mod
    src = textwrap.dedent(inspect.getsource(getattr(S.Router, name)))
    check(src.count(old) == 1, "router_mutant: %r not in %s" % (old, name))
    scope = {}
    exec(compile(src.replace(old, new), "<planted %s>" % name, "exec"),
         vars(router_mod), scope)
    return scope[name]


def stub_replica(S, i, gauges=(), steps=(), ttfts=(), submit=None):
    """A replica the router can place on without an engine: its metrics
    set from ``gauges``/``steps``/``ttfts`` and ``submit`` its admission."""
    from types import SimpleNamespace
    m = S.ServingMetrics("fleet_stub", labels={"replica": str(i)})
    for k, v in gauges:
        m.set_gauge(k, v)
    for s in steps:
        m.record_decode_step(s)
    for s in ttfts:
        m.record_ttft(s)
    return SimpleNamespace(metrics=m, spec_k=0, max_len=512,
                           weights_version=0, submit=submit,
                           _cancel=lambda req: None)


def plain_order(router):
    """The placement order, computed apart from ``Router._order``: the
    live replicas by (score, requests routed, index), or round robin from
    the counter's next value."""
    live = [i for i, ok in enumerate(router._live) if ok]
    if router.policy == "round_robin":
        start = router._rr + 1
        return [live[(start + j) % len(live)] for j in range(len(live))]
    return sorted(live, key=lambda i: (router._score(i), router._routed[i],
                                       i))


def order_mismatches(S, seed=SEED):
    """Seeded stub fleets (2-4 replicas, gauges and EWMAs drawn from few
    values so ties occur, about a quarter drained, both policies): the
    fleets whose ``_order`` differs from :func:`plain_order`."""
    rng = numpy.random.RandomState(seed)
    bad = 0
    for k in range(FLEET_ORDER_FLEETS):
        n = int(rng.randint(2, 5))
        stubs = []
        for i in range(n):
            total = int(rng.choice([0, 128]))
            gauges = [("queue_depth", int(rng.randint(0, 3))),
                      ("slots_busy", int(rng.randint(0, 3)))]
            if total:
                gauges += [("kv_pages_total", total),
                           ("kv_pages_free", int(rng.randint(0, total + 1)))]
            stubs.append(stub_replica(
                S, i, gauges, rng.choice([0.004, 0.008], rng.randint(0, 3)),
                rng.choice([0.05, 0.1], rng.randint(0, 2))))
        router = S.Router(stubs, policy=FLEET_POLICIES[k % 2])
        router._live = [bool(x) for x in rng.rand(n) < 0.75]
        router._routed = [int(x) for x in rng.randint(0, 3, n)]
        router._rr = int(rng.randint(0, 7))
        if not any(router._live):
            try:
                router._order()
                bad += 1
            except S.NoLiveReplicas:
                pass
            continue
        want = plain_order(router)
        bad += int(router._order() != want)
    return bad


def all_refuse(S):
    """Every replica refusing with its own Retry-After: (the raised
    exception's type name, its retry_after)."""
    def refusing(ra):
        def submit(prompt, n_new):
            raise S.Overloaded(retry_after=ra)
        return submit
    router = S.Router([stub_replica(S, i, submit=refusing(ra))
                       for i, ra in enumerate(FLEET_RETRY_AFTERS)],
                      policy="round_robin")
    try:
        router.submit(numpy.arange(3, dtype=numpy.int32), 4)
    except S.Overloaded as e:
        return type(e).__name__, e.retry_after
    return None, None


def placement_us(S, n=FLEET_PLACEMENTS_TIMED, **knobs):
    """Host µs of one placement through the router (``submit``:
    ``_order``, ``_place``, the completion callback, ``_deliver``) on a
    two-replica stub fleet whose futures come back settled, less the
    stub's own submit; host clock.  ``knobs`` arm the router (a hedge
    loop runs while it is timed)."""
    from concurrent.futures import Future
    from types import SimpleNamespace
    out = numpy.zeros(8, numpy.int32)

    def submit(prompt, n_new):
        f = Future()
        f.request = SimpleNamespace(tspan=None)
        f.set_result(out)
        return f
    stubs = [stub_replica(S, i, submit=submit) for i in range(2)]
    prompt = numpy.arange(8, dtype=numpy.int32)
    with fleet_router(S, stubs, **knobs) as router:
        t0 = time.perf_counter()
        for _ in range(n):
            submit(prompt, 8)
        own = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n):
            router.submit(prompt, 8)
        return max(0.0, time.perf_counter() - t0 - own) / n * 1e6


def serve_fleet(torch, HK, T, S, card, tick, device="cuda", cfg=None):
    """Phase 24: two engine replicas on the card behind the router (see
    the module docstring).  Returns kernels 5 and 6's launches on the
    fleet runs of (a) and (b) (the planted faults' runs not counted);
    ``tick`` gets the router's host µs a placement (phase 25 times the
    armed router against it)."""
    from veles_tpu_torch import prng
    cfg = cfg or LM_CONFIG
    began = time.monotonic()
    host = T.init_transformer_params(
        prng.RandomGenerator("init", SEED), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg["n_layers"], max_len=cfg["max_len"])
    reqs, want = tick["requests"], tick["outs"]
    kernels = ("paged_flash_decode", "paged_flash_prefill")
    n_layers = cfg["n_layers"]
    report = {"phase": "serve_fleet", "card": card, "config": dict(cfg),
              "replicas": FLEET_REPLICAS, "slots": FAST_SLOTS,
              "page": FAST_PAGE}
    runs, caught, legs, mark = [], {}, {}, [began]
    teacher = {"rows": 0, "worst": 0.0}

    def leg(name):
        now = time.monotonic()
        legs[name], mark[0] = now - mark[0], now

    def fleet(tag, knobs=None, plans=()):
        return [S.LMEngine(host, cfg["n_heads"], cfg["max_len"],
                           slots=FAST_SLOTS, prefill_chunk=FAST_PAGE,
                           device=device, name="fleet_%s_r%d" % (tag, i),
                           metrics=S.ServingMetrics(
                               "fleet_" + tag, labels={"replica": str(i)}),
                           faults=plans[i] if i < len(plans) else None,
                           **(knobs or {}))
                for i in range(FLEET_REPLICAS)]

    def held(tag, cases, outs):
        """Rows that differ from phase 4's one engine, held to the
        teacher-forced plain pass (a row equal to phase 4's was held in
        phase 4); returns the differing tokens."""
        diff = 0
        with torch.inference_mode():
            for (prompt, k), out, base in zip(cases, outs, want):
                check(out.shape == (k,) and out.min() >= 0
                      and out.max() < cfg["vocab"], "serve_fleet %s: "
                      "malformed output %r" % (tag, out))
                n = differing_tokens([out], [base])
                if n:
                    diff += n
                    short, _ = teacher_forced(
                        torch, T, engine0[0], numpy.concatenate(
                            [prompt, out]), len(prompt), out)
                    teacher["rows"] += 1
                    teacher["worst"] = max(teacher["worst"], short)
                    check(short <= LOGIT_TOL, "serve_fleet %s: an emitted "
                          "token's logit sits %g below its row max" % (
                              tag, short))
        return diff

    def served(tag, router, sequential, k_scan):
        """Phase 4's requests through ``router`` one at a time or as one
        burst, the launch counts set to 0 just before; checks the launch
        formula over the replicas' dispatch deltas and returns the
        run's record."""
        engines = router.replicas
        before = [(e.metrics.counter("decode_dispatches"),
                   e.metrics.counter("prefill_dispatches")) for e in engines]
        routed0 = router.routed_counts()
        HK.reset_launch_counts()
        t0 = time.monotonic()
        if sequential:
            futures = []
            for p, k in reqs:
                futures.append(router.submit(p, k))
                futures[-1].result(timeout=300)
        else:
            futures = [router.submit(p, k) for p, k in reqs]
        outs = [f.result(timeout=300) for f in futures]
        wall = time.monotonic() - t0
        launches = HK.launch_counts()
        launches = {n: launches[n] for n in kernels}
        steps = [e.metrics.counter("decode_dispatches") - b[0]
                 for e, b in zip(engines, before)]
        chunks = [e.metrics.counter("prefill_dispatches") - b[1]
                  for e, b in zip(engines, before)]
        split = [a - b for a, b in zip(router.routed_counts(), routed0)]
        check(launches["paged_flash_decode"]
              == n_layers * k_scan * sum(steps) > 0
              and launches["paged_flash_prefill"]
              == n_layers * sum(chunks) > 0,
              "serve_fleet %s: launches %r for decode dispatches %r and "
              "chunks %r" % (tag, launches, steps, chunks))
        runs.append(launches)
        tokens = sum(len(o) for o in outs)
        return outs, {"wall_s": wall, "tokens_per_s": tokens / wall,
                      "split": split,
                      "stamps": [f.job.replica for f in futures],
                      "decode_dispatches": steps, "prefill_dispatches": chunks,
                      "launches": launches,
                      "differing_tokens": held(tag, reqs, outs)}

    def quiet(router):
        deadline = time.monotonic() + 60
        while any(e.metrics.gauge("slots_busy", 0)
                  or e.metrics.gauge("queue_depth", 0)
                  for e in router.replicas):
            check(time.monotonic() < deadline, "serve_fleet: the fleet "
                  "never went idle")
            time.sleep(0.001)

    # (a) phase 4's requests, sequential then as one burst, each policy
    # (a router of its own over the path's started replicas), per tick
    # and at scan K = 8
    engine0 = [None]
    report["runs"] = {}
    for path, knobs in FLEET_PATHS.items():
        k_scan = knobs.get("megastep", 1)
        engines = fleet(path, knobs)
        engine0[0] = engines[0]
        for e in engines:
            e.start()
        for policy in FLEET_POLICIES:
            tag = "%s_%s" % (path, policy)
            router = S.Router(engines, policy=policy)
            seq = None
            try:
                if path in FLEET_SEQUENTIAL_PATHS:
                    _, seq = served(tag + "_sequential", router, True,
                                    k_scan)
                    quiet(router)
                _, burst = served(tag + "_burst", router, False, k_scan)
                quiet(router)
            except BaseException:
                router.stop()
                raise
            # sequential: every score 0 at each placement — the
            # fewest-routed tiebreak alternates from replica 0 (metrics),
            # the counter from replica 1 (round robin)
            first = 0 if policy == "metrics" else 1
            check(seq is None or seq["stamps"] == [
                (first + i) % 2 for i in range(len(reqs))],
                "serve_fleet %s: sequential placements %r" % (
                    tag, seq and seq["stamps"]))
            spread = max(burst["split"]) - min(burst["split"])
            bound = FLEET_BURST_SPREAD if policy == "metrics" else 0
            check(spread <= bound, "serve_fleet %s: a burst split %r" % (
                tag, burst["split"]))
            report["runs"][tag] = {"sequential": seq, "burst": burst,
                                   "tokens_per_s_vs_phase4":
                                   burst["tokens_per_s"]
                                   / tick["tokens_per_s"]}
            leg(tag)
        router.stop()
        errors = sum(e.metrics.errors for e in engines)
        check(errors == 0 and all(pool_drained(e) for e in engines),
              "serve_fleet %s: %d engine errors, or a pool not full again"
              % (path, errors))
        del router, engines
        gc_cuda(torch)

    def drain_run(tag, cases, count=True):
        """(b): ``cases`` as one burst on a per-tick fleet whose replica
        0 is slowed; replica 0 (the burst's first placement) is
        unregistered once it has made two decode dispatches.  Returns
        (outputs, withdrawn, router snapshot, a later placement's
        replica)."""
        plan = S.FaultPlan().arm("engine.step", kind="latency",
                                 latency_s=FLEET_LATENCY_S)
        router = S.Router(fleet(tag, plans=[plan])).start()
        engine0[0] = router.replicas[0]
        try:
            HK.reset_launch_counts()
            futures = [router.submit(p, k) for p, k in cases]
            check(futures[0].job.replica == 0, "serve_fleet %s: the first "
                  "placement went to replica %r" % (
                      tag, futures[0].job.replica))
            deadline = time.monotonic() + 60
            while plan.calls("engine.step") < 2:
                check(time.monotonic() < deadline, "serve_fleet %s: "
                      "replica 0 never decoded" % tag)
                time.sleep(0.001)
            moved = router.unregister(0, reason="serve_fleet drain")
            outs = [f.result(timeout=300) for f in futures]
            later = router.submit(*reqs[0])
            later.result(timeout=300)
            launches = HK.launch_counts()
        finally:
            router.stop()
        if count:
            runs.append({n: launches[n] for n in kernels})
        return outs, moved, router.metrics.snapshot(), later.job.replica

    # (b) the drain, exactly once and whole
    outs, moved, snap, later = drain_run("drain", reqs)
    c = snap["counters"]
    report["drain"] = {
        "withdrawn": moved, "requeued": c.get("requeued_requests", 0),
        "responses": snap["responses"], "later_replica": later,
        "replicas_live": snap["gauges"]["replicas_live"],
        "differing_tokens": held("drain", reqs, outs)}
    check(moved >= 1 and c.get("requeued_requests", 0) >= moved
          and snap["responses"] == len(reqs) + 1 and snap["errors"] == 0
          and snap["gauges"]["replicas_live"] == 1 and later == 1,
          "serve_fleet drain: %r" % report["drain"])
    gc_cuda(torch)
    leg("drain")

    # (c) every replica refusing, then none live
    name, ra = all_refuse(S)
    router = S.Router([stub_replica(S, i) for i in range(FLEET_REPLICAS)])
    for i in range(FLEET_REPLICAS):
        router.unregister(i, reason="serve_fleet none live")
    try:
        router.submit(numpy.arange(3, dtype=numpy.int32), 4)
        none_live = None
    except S.Overloaded as e:
        none_live = (type(e).__name__, e.retry_after, str(e))
    report["refusals"] = {"all_refuse": [name, ra],
                          "none_live": none_live,
                          "order_mismatches": order_mismatches(S)}
    check(name == "Overloaded" and ra == min(FLEET_RETRY_AFTERS)
          and none_live is not None and none_live[0] == "NoLiveReplicas"
          and none_live[1] > 0
          and report["refusals"]["order_mismatches"] == 0,
          "serve_fleet refusals: %r" % report["refusals"])
    leg("refusals")

    # (d) the planted faults
    with patched(S.Router, "_order", router_mutant(
            S, "_order", "live = [i for i, ok in enumerate(self._live) "
            "if ok]", "live = list(range(len(self._live)))")):
        caught["order_keeps_drained"] = order_mismatches(S) > 0
    with patched(S.Router, "_on_attempt_done", router_mutant(
            S, "_on_attempt_done", "if requeue and len(result) < job.n_new:",
            "if False:")):
        outs, _, _, _ = drain_run("planted", reqs[:FLEET_PLANTED_REQUESTS],
                                  count=False)
    caught["short_result_delivered"] = any(
        len(o) < k for o, (_, k) in zip(outs, reqs))
    with patched(S.Router, "_place", router_mutant(
            S, "_place", "else min(min_retry, ra)", "else ra")):
        caught["retry_after_last"] = all_refuse(S)[1] != min(
            FLEET_RETRY_AFTERS)
    gc_cuda(torch)
    leg("faults")

    # (e) the router's host cost a placement against phase 4's decode
    # step
    us = tick["placement_us"] = placement_us(S)
    report["placement"] = {"host_us": us, "decode_step_ms": tick["step_ms"],
                           "step_share": us / (tick["step_ms"] * 1e3)}
    launches = {n: sum(r[n] for r in runs) for n in kernels}
    report.update(launches=launches, teacher_forced={
        "rows_checked": teacher["rows"], "worst_shortfall": teacher["worst"],
        "tolerance": LOGIT_TOL}, phase4_tokens_per_s=tick["tokens_per_s"],
        faults_caught=caught, leg_s=legs,
        phase_s=time.monotonic() - began)
    print(json.dumps({"serve_fleet": report}, default=str), flush=True)
    for name in FLEET_FAULTS:
        check(caught[name], "serve_fleet: the planted fault %r was not "
              "caught" % name)
    return launches


# -------------------------------------------------------------- resilience
#: phase 25: the router's resilience layer over two replicas on the card,
#: one fleet a decode path reused across the legs
RES_PATHS = {"tick": {}, "scan_k8": {"megastep": 8}}
RES_RETRIES = 2
#: (b) replica 0's decode dispatch slowed by this much; the fixed hedge
#: threshold; the paths whose burst also runs unhedged (the latency
#: hedging saves)
RES_LATENCY_S, RES_HEDGE_AFTER_S = 0.02, 0.25
RES_UNHEDGED_PATHS = ("tick",)
#: (c) the health checker: consecutive failures to open, the staleness
#: window (above one K = 8 replay), the first cooldown and its cap, the
#: drain timeout of a wedged lane
RES_FAIL_THRESHOLD, RES_STALL_S = 2, 1.0
RES_COOLDOWN_S, RES_COOLDOWN_CAP_S = 0.2, 1.6
RES_DRAIN_TIMEOUT_S = 0.5
RES_FAULTS = ("retry_ignores_exclude", "loser_overwrites_stamps",
              "half_open_no_doubling", "probe_resets_page_streak")


@contextlib.contextmanager
def fleet_router(S, engines, **knobs):
    """A router over engines that already run: its own threads (the
    hedge loop) started and stopped, the engines left running for the
    next leg (``Router.start`` / ``stop`` would start or stop them
    too)."""
    router = S.Router(engines, **knobs)
    router.replicas = []
    router.start()
    router.replicas = engines
    try:
        yield router
    finally:
        router.replicas = []
        router.stop()
        router.replicas = engines


class _PendingReplica:
    """A stub replica whose futures the script resolves by hand."""

    def __init__(self, S, i):
        self.metrics = S.ServingMetrics("res_stub", labels={"replica": str(i)})
        self.spec_k, self.max_len, self.weights_version = 0, 512, 0
        self.futures, self.cancelled = [], 0
        self.outcome = "ok"

    def submit(self, prompt, n_new):
        from concurrent.futures import Future
        from types import SimpleNamespace
        f = Future()
        f.request = SimpleNamespace(tspan=None)
        f.version = len(self.futures)
        self.futures.append(f)
        if self.outcome == "error":
            f.set_exception(RuntimeError("probe failed"))
        elif self.outcome == "ok_now":
            f.set_result(numpy.zeros(n_new, numpy.int32))
        return f

    def _cancel(self, req):
        self.cancelled += 1


class _HeldTimer:
    """``threading.Timer`` stand-in that keeps its call for the script."""

    made = []

    def __init__(self, delay, func, args=()):
        self.delay, self.func, self.args, self.daemon = delay, func, args, 0
        _HeldTimer.made.append(self)

    def start(self):
        pass

    def cancel(self):
        pass

    def is_alive(self):
        return False


def retry_target(S):
    """Replica 0 first in placement order (replica 1 routed more); its
    attempt faults and the retry, run from the held timer, goes where
    ``exclude`` sends it: (attempts per replica, the serving replica)."""
    _HeldTimer.made = []
    engines = [_PendingReplica(S, i) for i in range(2)]
    with patched(threading, "Timer", _HeldTimer):
        router = S.Router(engines, retries=1)
        router._routed = [0, 5]
        fut = router.submit(numpy.arange(3, dtype=numpy.int32), 2)
        engines[0].futures[0].set_exception(S.InjectedFault("step"))
        [timer] = _HeldTimer.made
        timer.func(*timer.args)
    placed = [len(e.futures) for e in engines]
    for e in engines:
        for f in e.futures:
            if not f.done():
                f.set_result(numpy.zeros(2, numpy.int32))
    return placed, fut.job.replica


def hedge_race(S):
    """A primary on replica 0 and a hedge on replica 1: the hedge
    delivers, and the primary reaches ``_deliver`` in the same window
    (both passed the done check).  (replica stamp, result, hedge_wins,
    losers cancelled per replica)."""
    engines = [_PendingReplica(S, i) for i in range(2)]
    router = S.Router(engines)
    fut = router.submit(numpy.arange(3, dtype=numpy.int32), 2)
    job = fut.job
    router._place(job, exclude={0}, hedge=True)
    [primary] = [a for a in job.live if not a.is_hedge]
    engines[1].futures[0].set_result(numpy.ones(2, numpy.int32))
    router._deliver(job, primary, numpy.zeros(2, numpy.int32))
    return (job.replica, fut.result().tolist(),
            router.metrics.counter("hedge_wins"),
            [e.cancelled for e in engines])


def half_open_cooldowns(S, checker_cls):
    """Replica 0 opened by ``RES_FAIL_THRESHOLD`` page signals at t = 0,
    then every half-open probe failing, one step at each re-open time:
    the cooldowns after each failed probe."""
    engines = [_PendingReplica(S, i) for i in range(2)]
    for e in engines:
        e.outcome = "ok_now"
    router = S.Router(engines)
    checker = checker_cls(router, fail_threshold=RES_FAIL_THRESHOLD,
                          cooldown_s=1.0, cooldown_cap_s=4.0)
    for _ in range(RES_FAIL_THRESHOLD):
        checker.note_slo_page(0, reason="script", now=0.0)
    engines[0].outcome = "error"
    out, now = [], 0.0
    for _ in range(4):
        now = checker._reopen_at[0]
        checker.step(now=now)
        out.append(checker._cooldown[0])
    return out


def page_streak(S, checker_cls):
    """The reference's page-streak script on a stub fleet whose probes
    succeed: True when page, probe scan, page opens the circuit."""
    engines = [_PendingReplica(S, i) for i in range(2)]
    for e in engines:
        e.outcome = "ok_now"
    router = S.Router(engines)
    checker = checker_cls(router, fail_threshold=2, cooldown_s=600.0)
    checker.note_slo_page(0, reason="burning")
    checker.step()
    checker.note_slo_page(0, reason="still burning")
    return checker.states()[0] == checker.OPEN


def resilience_planted(S):
    """Each planted fault of phase 25 (e): the honest router or checker
    passes the check the mutant fails.  Returns {fault: caught}."""
    from veles_tpu_torch.serving import router as router_mod
    plain = {"retry_ignores_exclude": lambda: retry_target(S) == ([1, 1], 1),
             "loser_overwrites_stamps": lambda: hedge_race(S)
             == (1, [1, 1], 1, [1, 0]),
             "half_open_no_doubling": lambda: half_open_cooldowns(
                 S, S.HealthChecker) == [2.0, 4.0, 4.0, 4.0],
             "probe_resets_page_streak": lambda: page_streak(
                 S, S.HealthChecker)}
    for name, ok in plain.items():
        check(ok(), "serve_resilience: the honest %s check failed" % name)
    caught = {}
    with patched(S.Router, "_place", router_mutant(
            S, "_place", "    if exclude:\n", "    if False:\n")):
        caught["retry_ignores_exclude"] = not plain[
            "retry_ignores_exclude"]()
    with patched(S.Router, "_deliver", router_mutant(
            S, "_deliver", "if job.delivered or job.future.done():",
            "if job.future.cancelled():")):
        caught["loser_overwrites_stamps"] = not plain[
            "loser_overwrites_stamps"]()

    def checker_mutant(name, old, new):
        import inspect
        import textwrap
        src = textwrap.dedent(inspect.getsource(
            getattr(S.HealthChecker, name)))
        check(src.count(old) == 1, "checker mutant: %r not in %s"
              % (old, name))
        scope = {}
        exec(compile(src.replace(old, new), "<planted %s>" % name, "exec"),
             vars(router_mod), scope)
        return type("Planted", (S.HealthChecker,), {name: scope[name]})
    caught["half_open_no_doubling"] = half_open_cooldowns(S, checker_mutant(
        "_half_open_probe", "2 * self._cooldown[i]", "self._cooldown[i]")) \
        != [2.0, 4.0, 4.0, 4.0]
    caught["probe_resets_page_streak"] = not page_streak(S, checker_mutant(
        "step", "self._fails[i] = 0\n", "self._fails[i] = 0\n"
        "                self._slo_fails[i] = 0\n"))
    return caught


def serve_resilience(torch, HK, T, S, card, tick, device="cuda", cfg=None):
    """Phase 25: the router's resilience layer over two replicas on the
    card (see the module docstring).  Returns kernels 5 and 6's launches
    on its runs."""
    from types import SimpleNamespace
    from veles_tpu_torch import prng, restful_api
    from veles_tpu_torch.serving import verify_integrity
    cfg = cfg or LM_CONFIG
    began = time.monotonic()
    host = T.init_transformer_params(
        prng.RandomGenerator("init", SEED), cfg["vocab"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_layers=cfg["n_layers"], max_len=cfg["max_len"])
    reqs, want = tick["requests"], tick["outs"]
    kernels = ("paged_flash_decode", "paged_flash_prefill")
    n_layers = cfg["n_layers"]
    report = {"phase": "serve_resilience", "card": card, "config": dict(cfg),
              "replicas": 2, "slots": FAST_SLOTS, "page": FAST_PAGE,
              "paths": {}}
    runs, legs, mark = [], {}, [began]
    teacher = {"rows": 0, "worst": 0.0}
    engine0 = [None]

    def leg(name):
        now = time.monotonic()
        legs[name], mark[0] = now - mark[0], now

    def held(tag, cases, outs):
        """Every output whole; rows that differ from phase 4's one
        engine held to the teacher-forced plain pass; returns the
        differing tokens."""
        diff = 0
        with torch.inference_mode():
            for (prompt, k), out, base in zip(cases, outs, want):
                check(out.shape == (k,) and out.min() >= 0
                      and out.max() < cfg["vocab"], "serve_resilience %s: "
                      "malformed output %r" % (tag, out))
                n = differing_tokens([out], [base])
                if n:
                    diff += n
                    short, _ = teacher_forced(
                        torch, T, engine0[0], numpy.concatenate(
                            [prompt, out]), len(prompt), out)
                    teacher["rows"] += 1
                    teacher["worst"] = max(teacher["worst"], short)
                    check(short <= LOGIT_TOL, "serve_resilience %s: an "
                          "emitted token's logit sits %g below its row max"
                          % (tag, short))
        return diff

    def quiet(engines, router=None):
        deadline = time.monotonic() + 120
        while (router is not None and router._jobs) or any(
                e.metrics.gauge("slots_busy", 0)
                or e.metrics.gauge("queue_depth", 0) for e in engines):
            check(time.monotonic() < deadline, "serve_resilience: the "
                  "fleet never went quiet")
            time.sleep(0.002)

    def books(engines):
        return [(e.metrics.counter("decode_dispatches"),
                 e.metrics.counter("prefill_dispatches")) for e in engines]

    def launched(tag, engines, before, k_scan):
        """Kernels 5 and 6 since the reset: n_layers x (K x) the
        replicas' summed decode dispatches and prompt chunks, the hedge
        losers', the retries' and the probes' included."""
        counts = HK.launch_counts()
        counts = {n: counts[n] for n in kernels}
        after = books(engines)
        steps = sum(a[0] - b[0] for a, b in zip(after, before))
        chunks = sum(a[1] - b[1] for a, b in zip(after, before))
        check(counts["paged_flash_decode"] == n_layers * k_scan * steps > 0
              and counts["paged_flash_prefill"] == n_layers * chunks > 0,
              "serve_resilience %s: launches %r for %d decode dispatches "
              "and %d chunks" % (tag, counts, steps, chunks))
        runs.append(counts)
        return counts

    def wait_for(cond, what, timeout=60):
        deadline = time.monotonic() + timeout
        while not cond():
            check(time.monotonic() < deadline, "serve_resilience: " + what)
            time.sleep(0.002)

    def burst(router, cases):
        """``cases`` as one burst; (outputs, futures, seconds from
        submit to result each)."""
        done = {}
        futures = []
        for p, k in cases:
            f = router.submit(p, k)
            f.add_done_callback(lambda f, t0=f.job.t0: done.setdefault(
                id(f), time.monotonic() - t0))
            futures.append(f)
        outs = [f.result(timeout=300) for f in futures]
        return outs, futures, [done[id(f)] for f in futures]

    for path, knobs in RES_PATHS.items():
        k_scan = knobs.get("megastep", 1)
        engines = [S.LMEngine(host, cfg["n_heads"], cfg["max_len"],
                              slots=FAST_SLOTS, prefill_chunk=FAST_PAGE,
                              device=device, name="res_%s_r%d" % (path, i),
                              metrics=S.ServingMetrics(
                                  "res_" + path, labels={"replica": str(i)}),
                              **knobs)
                   for i in range(2)]
        engine0[0] = engines[0]
        for e in engines:
            e.start()
        rec = report["paths"][path] = {}
        try:
            # (a) retries: every step of replica 0 faults
            engines[0]._faults = S.FaultPlan().arm("engine.step")
            with fleet_router(S, engines, retries=RES_RETRIES,
                              retry_backoff_s=0.01) as router:
                before = books(engines)
                HK.reset_launch_counts()
                outs, futures, _ = burst(router, reqs)
                quiet(engines, router)
                served = [f.job.replica for f in futures]
                retried = router.metrics.counter("requests_retried")
                rec["retry"] = {
                    "retried": retried, "served_by": served,
                    "responses": router.metrics.responses,
                    "launches": launched(path + " retry", engines, before,
                                         k_scan),
                    "differing_tokens": held(path + " retry", reqs, outs)}
                check(served == [1] * len(reqs) and retried >= 1
                      and router.metrics.responses == len(reqs)
                      and all(f.job.retries <= 1 for f in futures),
                      "serve_resilience %s retry: %r" % (path, rec["retry"]))
                # both replicas faulting: the budget runs out
                engines[1]._faults = S.FaultPlan().arm("engine.step")
                f = router.submit(*reqs[0])
                try:
                    f.result(timeout=300)
                    spent = None
                except S.InjectedFault as e:
                    spent = type(e).__name__
                quiet(engines, router)
                rec["retry"]["budget_spent"] = {
                    "raised": spent, "retries": f.job.retries,
                    "retried": router.metrics.counter("requests_retried")
                    - retried}
                check(spent == "InjectedFault" and f.job.retries
                      == RES_RETRIES == rec["retry"]["budget_spent"][
                          "retried"], "serve_resilience %s: a spent retry "
                      "budget: %r" % (path, rec["retry"]["budget_spent"]))
            engines[1]._faults = None
            leg(path + "_retry")

            # (b) hedges: replica 0's decode dispatch slowed; then the
            # same traffic unhedged, for the latency
            engines[0]._faults = S.FaultPlan().arm(
                "engine.step", kind="latency", latency_s=RES_LATENCY_S)
            with fleet_router(S, engines,
                              hedge_after_s=RES_HEDGE_AFTER_S) as router:
                settled_att, delivered = [], []
                done_cb, deliver = router._on_attempt_done, router._deliver
                router._on_attempt_done = lambda att, f: (
                    settled_att.append(att), done_cb(att, f))
                router._deliver = lambda job, att, result: (
                    delivered.append(att), deliver(job, att, result))
                before = books(engines)
                HK.reset_launch_counts()
                outs, futures, lat = burst(router, reqs)
                quiet(engines, router)
                m = router.metrics
                primary = {id(a.job): a.replica for a in settled_att
                           if not a.is_hedge}
                slow = [s for f, s in zip(futures, lat)
                        if primary.get(id(f.job)) == 0]
                losers = [a for a in settled_att if a not in delivered]
                with contextlib.ExitStack() as stack:
                    for e in engines:
                        stack.enter_context(e._cond)
                    for e in engines:
                        e.verify_pool_invariants()
                rec["hedge"] = {
                    "hedged": m.counter("requests_hedged"),
                    "hedge_wins": m.counter("hedge_wins"),
                    "responses": m.responses, "losers": len(losers),
                    "losers_cancelled": sum(
                        bool(a.engine_future.request.cancelled)
                        for a in losers),
                    "delivered_once": sorted(id(a.job) for a in delivered)
                    == sorted(id(f.job) for f in futures),
                    "slow_requests": len(slow),
                    "slow_p50_s": statistics.median(slow) if slow else None,
                    "slow_max_s": max(slow) if slow else None,
                    "launches": launched(path + " hedge", engines, before,
                                         k_scan),
                    "differing_tokens": held(path + " hedge", reqs, outs)}
                h = rec["hedge"]
                check(h["hedged"] >= 1 and h["hedge_wins"] >= 1
                      and h["responses"] == len(reqs) and h["delivered_once"]
                      and h["losers"] >= 1
                      and h["losers_cancelled"] == h["losers"],
                      "serve_resilience %s hedge: %r" % (path, h))
            if path in RES_UNHEDGED_PATHS:
                with fleet_router(S, engines) as router:
                    before = books(engines)
                    HK.reset_launch_counts()
                    outs, futures, lat = burst(router, reqs)
                    quiet(engines, router)
                    slow = [s for f, s in zip(futures, lat)
                            if f.job.replica == 0]
                    rec["unhedged"] = {
                        "slow_requests": len(slow),
                        "slow_p50_s": statistics.median(slow),
                        "slow_max_s": max(slow),
                        "launches": launched(path + " unhedged", engines,
                                             before, k_scan),
                        "differing_tokens": held(path + " unhedged", reqs,
                                                 outs)}
            engines[0]._faults = None
            leg(path + "_hedge")

            # (c) the circuit: replica 0 frozen mid-decode, the checker
            # stepped by hand; then the SLO monitor's hook
            plan = S.FaultPlan()
            engines[0]._faults = plan
            with fleet_router(S, engines,
                              drain_timeout_s=RES_DRAIN_TIMEOUT_S) as router:
                checker = S.HealthChecker(
                    router, interval_s=0.05, probe_timeout_s=30.0,
                    fail_threshold=RES_FAIL_THRESHOLD,
                    cooldown_s=RES_COOLDOWN_S,
                    cooldown_cap_s=RES_COOLDOWN_CAP_S, stall_s=RES_STALL_S)
                checker.warm_probes()
                before = books(engines)
                HK.reset_launch_counts()
                futures = [router.submit(p, k) for p, k in reqs]
                d0 = before[0][0]
                wait_for(lambda: engines[0].metrics.counter(
                    "decode_dispatches") > d0, "replica 0 never decoded")
                plan.arm("engine.tick", kind="freeze", times=1,
                         duration_s=120.0, after=plan.calls("engine.tick"))
                wait_for(lambda: plan.fired("engine.tick") == 1,
                         "no freeze")
                t_frozen = time.monotonic()
                deadline = t_frozen + 60
                while router._live[0]:
                    check(time.monotonic() < deadline, "serve_resilience "
                          "%s: replica 0 never quarantined" % path)
                    checker.step()
                    time.sleep(0.05)
                opened_s = time.monotonic() - t_frozen
                state_open = checker.states()[0]
                outs = [f.result(timeout=300) for f in futures]
                m = router.metrics
                rec["circuit"] = {
                    "quarantined_after_s": opened_s,
                    "state": state_open,
                    "circuit_open_total": m.counter("circuit_open_total"),
                    "withdrawn_forced": m.counter(
                        "drain_forced_replacements"),
                    "requeued": m.counter("requeued_requests"),
                    "responses": m.responses,
                    "differing_tokens": held(path + " circuit", reqs, outs)}
                # the frozen replica's lanes could not be withdrawn: the
                # drain timeout force re-placed them, and the zombies'
                # late results are ignored (each request answered once)
                check(state_open == S.HealthChecker.OPEN
                      and m.counter("circuit_open_total") == 1
                      and m.counter("drain_forced_replacements") >= 1
                      and m.responses == len(reqs),
                      "serve_resilience %s circuit: %r" % (
                          path, rec["circuit"]))
                plan.release()
                quiet(engines, router)
                time.sleep(RES_COOLDOWN_S)
                t0 = time.monotonic()
                while not router._live[0]:
                    check(time.monotonic() < t0 + 60, "serve_resilience "
                          "%s: the half-open probe never re-admitted "
                          "replica 0" % path)
                    checker.step()
                    time.sleep(0.05)
                rec["circuit"]["readmitted_after_s"] = time.monotonic() - t0
                with router._lock:
                    router._routed[1] += 100   # replica 0 first
                f = router.submit(*reqs[0])
                again = f.result(timeout=300)
                rec["circuit"]["serves_again"] = f.job.replica
                rec["circuit"]["again_differing_tokens"] = held(
                    path + " again", reqs[:1], [again])
                check(f.job.replica == 0 and checker.states()[0]
                      == S.HealthChecker.HEALTHY, "serve_resilience %s: "
                      "the recovered replica did not serve" % path)
                # the SLO monitor's hook opens the same circuit
                for _ in range(RES_FAIL_THRESHOLD):
                    checker.note_slo_page(0, reason="serve_resilience")
                rec["circuit"]["slo"] = {
                    "state": checker.states()[0], "live": router._live[0],
                    "circuit_open_total": m.counter("circuit_open_total"),
                    "slo_page_signals": m.counter("slo_page_signals")}
                check(checker.states()[0] == S.HealthChecker.OPEN
                      and not router._live[0]
                      and m.counter("circuit_open_total") == 2
                      and m.counter("slo_page_signals")
                      == RES_FAIL_THRESHOLD, "serve_resilience %s slo: %r"
                      % (path, rec["circuit"]["slo"]))
                time.sleep(RES_COOLDOWN_S)
                t0 = time.monotonic()
                while not router._live[0]:
                    check(time.monotonic() < t0 + 60, "serve_resilience "
                          "%s: no re-admission after the pages" % path)
                    checker.step()
                    time.sleep(0.05)
                quiet(engines, router)
                rec["circuit"]["launches"] = launched(
                    path + " circuit", engines, before, k_scan)
                rec["circuit"]["probes"] = m.counter("health_probes")
            engines[0]._faults = None
            plan.release()
            leg(path + "_circuit")
        finally:
            for e in engines:
                if e._faults is not None:
                    e._faults.release()
                e.stop()
        errors_ok = all(pool_drained(e) for e in engines)
        check(errors_ok, "serve_resilience %s: a pool not full again" % path)
        del engines
        gc_cuda(torch)

    # (d) serve_lm with the whole layer armed over HTTP, one injected
    # chunk fault (one plan shared by both replicas) retried
    trainer = SimpleNamespace(params=T.params_from_jax(host, device),
                              n_heads=cfg["n_heads"], max_len=cfg["max_len"],
                              _to_portable=lambda tree: tree)
    plan = S.FaultPlan()
    api = restful_api.serve_lm(
        SimpleNamespace(trainer=trainer), port=0, slots=FAST_SLOTS,
        prefill_chunk=FAST_PAGE, max_new=SAMPLE_MAX_NEW, replicas=2,
        health=True, health_interval_s=60.0, retries=RES_RETRIES, hedge=-1,
        slo=True, trace="all", fault_plan=plan)
    base = "http://127.0.0.1:%d" % api.port
    try:
        router = api.lm_engine
        engines = router.replicas
        engine0[0] = engines[0]
        checker = api.health_checker
        check(isinstance(router, S.Router) and checker is not None
              and api.slo.checker is checker and router.retries
              == RES_RETRIES and router.hedge_after_s < 0,
              "serve_resilience http: the layer is not armed")
        wait_for(lambda: checker._warmed, "the warm-up probes never ran")
        # the burst's first prompt chunk faults, on whichever replica
        plan.arm("engine.chunk", times=1, after=plan.calls("engine.chunk"))
        bodies = [json.dumps({"input": [p.tolist()], "n_new": k}).encode()
                  for p, k in reqs]
        before = books(engines)
        HK.reset_launch_counts()
        replies, lat, wall = rest_load(api, bodies, len(bodies))
        quiet(engines, router)
        launches = launched("http", engines, before, 1)
        got = {}
        for path in ("/metrics", "/metrics.json", "/slo.json",
                     "/trace.json?last=32"):
            code, body, ctype = http_get(base + path)
            check(code == 200, "serve_resilience: GET %s %d" % (path, code))
            got[path.split("?")[0]] = (body.decode() if ctype.startswith(
                "text/plain") else strict_json(body), len(body))
        m = router.metrics
        counters = {k: m.counter(k) for k in (
            "requests_retried", "requests_hedged", "hedge_wins",
            "circuit_open_total", "slo_page_signals",
            "health_probe_warmups")}
    finally:
        api.stop()
    check(api.health_checker is None and checker._thread is None,
          "serve_resilience http: the checker was not stopped")
    settled(api.tracer)
    recs = api.tracer.requests()
    integ = verify_integrity(recs)
    outs = [numpy.asarray(replies[i][1]["tokens"][0][len(p):], numpy.int32)
            for i, (p, _) in enumerate(reqs)]
    text = got["/metrics"][0].splitlines()
    families = [line for line in text if line.startswith("# TYPE ")]
    types = [line for line in families if "replica_health_state" in line]
    rows = [line for line in text
            if line.startswith("veles_serving_replica_health_state{")]
    token_rows = [line for line in text if line.startswith(
        'veles_serving_tokens_out_total{engine="lm",replica=')]
    attempts = sum(1 for r in recs for s in r["spans"]
                   if s["name"] == "attempt")
    slo = got["/slo.json"][0]
    report["http"] = {
        "requests": len(bodies), "wall_s": wall,
        "p50_s": statistics.median(lat), "max_s": max(lat),
        "codes": sorted({replies[i][0] for i in range(len(bodies))}),
        "counters": counters, "launches": launches,
        "trace_requests": integ["requests"],
        "health_rows": rows, "attempt_spans": attempts,
        "metrics_families": len(families),
        "slo_evaluations": slo["evaluations"],
        "slo_worst_state": slo["worst_state_name"],
        "fault_fired": plan.fired("engine.chunk"),
        "differing_tokens": held("http", reqs, outs)}
    check(report["http"]["codes"] == [200] and plan.fired("engine.chunk") == 1
          and counters["requests_retried"] == 1
          and counters["health_probe_warmups"] == 1 and len(types) == 1
          and len(families) == len(set(families)) and len(rows) == 2
          and len(token_rows) == 2 and integ["requests"] >= len(reqs)
          and attempts >= len(reqs) + counters["requests_retried"]
          and len(got["/metrics.json"][0]["replicas"]) == 2
          and len(got["/trace.json"][0]["traceEvents"]) > 0
          and "objectives" in slo,
          "serve_resilience http: %r" % report["http"])
    gc_cuda(torch)
    leg("http")

    # (e) the planted faults, host-only on stub fleets
    caught = resilience_planted(S)
    leg("faults")

    # (f) the router's host µs a placement armed but idle, against phase
    # 24's unarmed figure in this run
    report["placement"] = {"unarmed_us": tick["placement_us"],
                           "armed_idle_us": placement_us(
                               S, retries=RES_RETRIES, hedge_after_s=60.0),
                           "decode_step_ms": tick["step_ms"]}
    leg("placement")
    launches = {n: sum(r[n] for r in runs) for n in kernels}
    report.update(launches=launches, teacher_forced={
        "rows_checked": teacher["rows"], "worst_shortfall": teacher["worst"],
        "tolerance": LOGIT_TOL}, faults_caught=caught, leg_s=legs,
        phase_s=time.monotonic() - began)
    print(json.dumps({"serve_resilience": report}, default=str), flush=True)
    for name in RES_FAULTS:
        check(caught[name], "serve_resilience: the planted fault %r was not "
              "caught" % name)
    return launches


# ------------------------------------------------------------------ beside
def beside_phases(out_path):
    """Phases 15 and 16 in a process of their own (``python3
    chip_smoke.py --beside OUT``), which ``main`` starts before phase 11
    and joins after phase 13: both are host work (an AOTInductor
    compile, REST serving, CLI children, the observers) beside phases
    whose gloo ranks leave the host's cores idle.  Writes their launch
    counts and seconds to ``OUT`` (JSON)."""
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import hopper_kernels as HK
    began = time.monotonic()
    smi = nvidia_smi()
    memo_draws(prng)
    out = {"deploy_launches": deploy_phase(torch, HK, smi),
           "deploy_s": time.monotonic() - began}
    gc_cuda(torch)
    t0 = time.monotonic()
    out["observe_launches"] = observe_phase(torch, HK, smi)
    out["observe_s"] = time.monotonic() - t0
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(out, f)
    return 0


class Beside:
    """``beside_phases`` in a child process.  Its output goes to files
    and is relayed to this process's when it is joined; it is killed if
    this process exits first."""

    def __init__(self):
        import atexit
        import tempfile
        self.stopped = False
        self.tmp = tempfile.mkdtemp(prefix="veles_beside_")
        self.out = os.path.join(self.tmp, "out.json")
        here = os.path.abspath(__file__)
        self.logs = [open(os.path.join(self.tmp, name), "w+",
                          encoding="utf-8") for name in ("stdout", "stderr")]
        self.proc = subprocess.Popen(
            [sys.executable, here, "--beside", self.out],
            cwd=os.path.dirname(here),
            env=dict(os.environ, PYTHONPATH=os.path.dirname(here)),
            stdout=self.logs[0], stderr=self.logs[1],
            start_new_session=True)
        atexit.register(self.kill)

    def kill(self):
        """Stop the child and every process it started (its session),
        once."""
        import signal
        if self.stopped:
            return
        self.stopped = True
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()

    def join(self, timeout=900):
        """Wait for the child, relay its output, and return its
        report."""
        import shutil
        try:
            code = self.proc.wait(timeout=timeout)
        finally:
            self.kill()
        for log, stream in zip(self.logs, (sys.stdout, sys.stderr)):
            log.seek(0)
            stream.write(log.read())
            stream.flush()
            log.close()
        try:
            check(code == 0, "phases 15 and 16 failed (exit %s; their "
                  "output above)" % code)
            with open(self.out, encoding="utf-8") as f:
                return json.load(f)
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)


def main():
    started = time.monotonic()
    laps, mark = {}, [started]

    def lap(name):
        """The seconds since the previous lap, kept under ``name``."""
        now = time.monotonic()
        laps[name] = now - mark[0]
        mark[0] = now

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
             "flash_attention", "graph_while")
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
    memo_draws(prng)
    lap("start_and_build")

    # 3. kernels against their plain versions, at the serving shapes
    cases = [decode_case(torch, HK, A),
             decode_case(torch, HK, A, kv=2, seed=1),
             decode_case(torch, HK, A, c=4, seed=2),
             decode_case(torch, HK, A, window=100, sinks=4, seed=3),
             prefill_case(torch, HK, A, 0),
             prefill_case(torch, HK, A, 15),
             # the speculative verify's geometry: k + 1 = 5 query rows
             decode_case(torch, HK, A, c=FAST_SPEC_K + 1, seed=16)]
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
    lap("kernels_paged")
    sgd = sgd_cases(torch, HK)
    lap("kernels_sgd")
    lrn = [c for i, (name, shape) in enumerate(LRN_SHAPES.items())
           for c in lrn_case(torch, HK, name, shape, seed=i)]
    lrn_checks = lrn_edge_cases(torch, HK)
    lap("kernels_lrn")
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
    lap("kernels_dropout_bernoulli")
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
    lap("kernels_flash")
    dev_entries = device_entry_cases(torch, HK, prng)
    for case in (cases + checks + sgd + lrn + lrn_checks + drop + drop_checks
                 + draws + flash + flash_checks + dev_entries):
        print(json.dumps(dict(case, card=smi)), flush=True)
    lap("kernels_device_entries")

    # 4. serve through the engine
    tick = {}
    launches = serve(torch, HK, T, S, smi, keep=tick)
    lap("serve")

    # 5. train MNIST-FC through the sample's entry point
    launches["fused_sgd_update"] = train(torch, HK, smi)["fused_sgd_update"]
    lap("train")

    # 6. train full-width AlexNet through the ImageNet sample, on the
    # synthetic set, then from a record file (and the LMDB leg)
    alex, synthetic = alexnet(torch, HK, smi)
    for k in ("lrn_forward", "lrn_backward", "dropout"):
        launches[k] = alex[k]
    launches["fused_sgd_update"] += alex["fused_sgd_update"]
    lap("alexnet")
    rec = records(torch, HK, smi, synthetic=synthetic)
    for k in ("lrn_forward", "lrn_backward", "dropout", "fused_sgd_update"):
        launches[k] += rec[k]
    lap("records")
    launches["fused_sgd_update"] += wine_phase(torch, HK, smi)[
        "fused_sgd_update"]
    lap("wine")

    # 7. train the full-width LM through the char-LM sample
    lm, lm_steady = lm_train(torch, HK, smi)
    for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
              "flash_attention_bwd_dq"):
        launches[k] = lm[k]
    lap("lm_train")

    # 8. the conv zoo through the samples' own train
    from veles_tpu_torch.ops import functional as F
    deconv_check(torch, F, smi)
    stochastic_pool_check(torch, HK, F, smi)
    for sample in ZOO:
        launches["fused_sgd_update"] += zoo(torch, HK, smi, sample)[
            "fused_sgd_update"]
    lap("zoo")

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
    lap("non_sgd_and_streams")

    # 10. the run harness through the CLI: the graph loop, the epoch
    # scan (captured steps) and the streaming scan
    kept = {}
    harnessed = harness(torch, HK, smi, keep=kept)
    for k, v in harnessed.items():
        launches[k] = launches.get(k, 0) + v
    lap("harness")

    # 15 and 16 in a second process, beside 11-13 (``beside_phases``)
    beside = Beside()

    # 11. data- and tensor-parallel AlexNet: NCCL at world 1 through the
    # CLI, then two gloo ranks sharing the card
    shared = parallel_phase(torch, HK, smi, kept)
    del kept
    for k, v in shared.items():
        launches[k] = launches.get(k, 0) + v
    lap("parallel")

    # 12. mixture of experts at the full LM width, trained and served,
    # then expert parallelism; the earlier phases' runs go first
    from veles_tpu_torch import __main__ as cli
    cli.main.workflow = cli.main.launcher = None
    gc_cuda(torch)
    moe_lm = moe_train(torch, HK, smi,
                       lm_steady["flash_pallas"]["step_s"])
    gc_cuda(torch)
    moe_served = serve(torch, HK, T, S, smi, n_experts=MOE["n_experts"],
                       n_requests=MOE_SERVE_REQUESTS)
    moe_launches = {k: moe_lm[k] for k in (
        "flash_attention_fwd", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq")}
    moe_launches.update({k: moe_served[k] for k in (
        "paged_flash_decode", "paged_flash_prefill")})
    for k, v in moe_launches.items():
        launches[k] += v
    gc_cuda(torch)
    moe_ep_phase(torch, smi)
    lap("moe")

    # 13. GPipe at one stage in this process and at four on gloo ranks
    # sharing the card, then ring attention on those ranks
    gc_cuda(torch)
    pipe_launches = pipeline_phase(torch, HK, smi,
                                   lm_steady["flash_pallas"]["step_s"])
    for k, v in pipe_launches.items():
        launches[k] += v
    gc_cuda(torch)
    lap("pipeline")

    # 15 and 16 joined: their launches, and their seconds beside 11-13
    aside = beside.join()
    deploy_launches = aside["deploy_launches"]
    observe_launches = aside["observe_launches"]
    launches["fused_sgd_update"] += observe_launches
    lap("beside_wait")

    # 14. the rolling-cache decode at the full LM width, the GA and the
    # ensemble on MNIST-FC in this process and in workers sharing the
    # card, and the ZeroMQ loader
    t0 = time.monotonic()
    rolling_phase(torch, T, smi)
    gc_cuda(torch)
    pop_launches = population_phase(torch, HK, smi)
    launches["fused_sgd_update"] += pop_launches
    gc_cuda(torch)
    zmq_phase(torch, smi)
    print(json.dumps({"phase14_s": time.monotonic() - t0, "card": smi}),
          flush=True)
    lap("rolling_population_zmq")

    # 17. the serving fast path: the radix prefix cache with
    # copy-on-write pages, and the speculative verify at c = k + 1
    fastpath = {}
    fast_launches = serve_fastpath(torch, HK, T, S, smi, keep=fastpath)
    for k, v in fast_launches.items():
        launches[k] += v
    gc_cuda(torch)
    lap("serve_fastpath")

    # 18. the fused K-step decode: one captured graph a ladder width,
    # plain, speculative and MoE, then timed in a fresh process too
    mega_launches = serve_megastep(torch, HK, T, S, smi, tick, fastpath)
    for k, v in mega_launches.items():
        launches[k] += v
    gc_cuda(torch)
    lap("serve_megastep")

    # 19. the while megastep: K conditional graph nodes a ladder width,
    # the standby refill ring armed in the program, plain and speculative
    while_launches = serve_whilestep(torch, HK, T, S, smi, tick, fastpath)
    del fastpath
    for k, v in while_launches.items():
        launches[k] += v
    gc_cuda(torch)
    lap("serve_whilestep")

    # 20. seeded sampling: every decode path of the engine with the draw
    # kernel, generate, and serve_lm over HTTP
    sample_launches, drawn = serve_sampling(torch, HK, T, S, smi, tick)
    for k, v in sample_launches.items():
        launches[k] += v
    gc_cuda(torch)
    lap("serve_sampling")

    # 21. operations: hot weight swap on every decode path, fault plans
    # at every engine site, checkpoint and restore
    ops_launches = serve_ops(torch, HK, T, S, smi, tick)
    for k, v in ops_launches.items():
        launches[k] += v
    gc_cuda(torch)
    lap("serve_ops")

    # 22. request tracing and live telemetry: every decode path traced
    # against itself untraced, the fences, the errors ring, serve_lm
    # traced over HTTP with the telemetry store and the SLO monitor
    observed = {}
    observe_serve_launches = serve_observe(torch, HK, T, S, smi, tick,
                                           keep=observed)
    for k, v in observe_serve_launches.items():
        launches[k] += v
    gc_cuda(torch)
    lap("serve_observe")

    # 23. the lock-order witness and the transfer guard armed on every
    # decode path, sampled, traced and across a swap under the captured
    # graphs, three planted faults, the unarmed shims' cost
    guarded_launches = serve_guarded(torch, HK, T, S, smi, tick, observed)
    del observed
    for k, v in guarded_launches.items():
        launches[k] += v
    gc_cuda(torch)
    lap("serve_guarded")

    # 24. the serving fleet: two replicas on the card behind the router,
    # both policies on two decode paths, the drains, the refusals,
    # serve_lm over HTTP, three planted faults
    fleet_launches = serve_fleet(torch, HK, T, S, smi, tick)
    for k, v in fleet_launches.items():
        launches[k] += v
    gc_cuda(torch)
    lap("serve_fleet")

    # 25. the fleet's resilience layer: retries, hedges, the health
    # circuit (by hand and fed by the SLO hook), serve_lm over HTTP with
    # all of it armed, four planted faults
    resilience_launches = serve_resilience(torch, HK, T, S, smi, tick)
    del tick
    for k, v in resilience_launches.items():
        launches[k] += v
    gc_cuda(torch)
    lap("serve_resilience")

    # 26. the kernels line and the result
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
    # kernels 1 and 4: their device-operand entries (what the captured
    # steps launch, counted by replay in the harness phase)
    entries = {c["kernel"]: c for c in dev_entries
               if c["case"] in ("alexnet_step", "dropout6")}
    for row in kernels:
        entry = entries.get(row["name"])
        if entry is not None:
            row.update(device_operand_ms=entry["device_operand_ms"],
                       device_operand_by_value_ms=entry["by_value_ms"],
                       device_operand_bound_ms=entry["bound_ms"],
                       device_operand_launches=harnessed.get(row["name"],
                                                             0))
    # kernel 4's element-offset entry (a data-parallel rank's rows),
    # checked against the global launch's rows
    offset = [c for c in dev_entries if c.get("entry") == "offset"][0]
    for row in kernels:
        if row["name"] == "dropout":
            row.update(offset_entry_ms=offset["offset_ms"],
                       offset_entry_by_value_ms=offset["by_value_ms"],
                       offset_entry_bound_ms=offset["bound_ms"],
                       offset_entry_bit_equal=offset[
                           "bit_equal_to_global_rows"])
    # the MoE runs' and the pipelined runs' shares of the launches
    for row in kernels:
        if row["name"] in moe_launches:
            row["moe_launches"] = moe_launches[row["name"]]
        if row["name"] in pipe_launches:
            row["pipeline_launches"] = pipe_launches[row["name"]]
        if row["name"] in fast_launches:
            row["fastpath_launches"] = fast_launches[row["name"]]
        if row["name"] in mega_launches:
            row["megastep_launches"] = mega_launches[row["name"]]
        if row["name"] in while_launches:
            row["whilestep_launches"] = while_launches[row["name"]]
        if row["name"] in sample_launches:
            row["sampling_launches"] = sample_launches[row["name"]]
        if row["name"] in ops_launches:
            row["ops_launches"] = ops_launches[row["name"]]
        if row["name"] in observe_serve_launches:
            row["observe_serve_launches"] = observe_serve_launches[
                row["name"]]
        if row["name"] in guarded_launches:
            row["guarded_launches"] = guarded_launches[row["name"]]
        if row["name"] in fleet_launches:
            row["fleet_launches"] = fleet_launches[row["name"]]
        if row["name"] in resilience_launches:
            row["resilience_launches"] = resilience_launches[row["name"]]
        if row["name"] == "fused_sgd_update":
            row["population_launches"] = pop_launches
            row["observe_launches"] = observe_launches
        if row["name"] == "lrn_forward":
            row["deploy_launches"] = deploy_launches
    # beside the calls that are one or two short launches, the floor
    for row in kernels:
        if row["name"] in ("fused_sgd_update", "paged_flash_decode",
                           "paged_flash_prefill"):
            row["empty_launch_ms"] = floor_ms
    # the token draw is no TPU kernel's port either: a line of its own,
    # beside the Bernoulli draw's, with a kernels row's keys (its main
    # case: a decode step's 8 rows)
    main_draw = drawn["cases"][0]
    print(json.dumps({"sample_token": {
        "name": "sample_token", "route": "cuda", "source": SOURCES["dropout"],
        "replaces": None, "launches": drawn["launches"],
        "max_abs_err": main_draw["max_abs_err"],
        "ms": main_draw["kernel_ms"], "plain_ms": main_draw["plain_ms"],
        "bound_ms": main_draw["bound_ms"], "bound_by": main_draw["bound_by"],
        "library_ms": None,
        "cases": [{k: c[k] for k in (
            "case", "shape", "top_k", "unequal", "max_abs_err", "kernel_ms",
            "draw_kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
            for c in drawn["cases"]],
        "empty_launch_ms": floor_ms, "card": smi}}), flush=True)
    print(json.dumps({"phase_seconds": laps,
                      "beside_seconds": {k: aside[k] for k in (
                          "deploy_s", "observe_s")}, "card": smi}),
          flush=True)
    print("chip smoke: %.1f s" % (time.monotonic() - started), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--moe-rank"]:
        sys.exit(moe_ep_rank(int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4]))
    if sys.argv[1:2] == ["--beside"]:
        sys.exit(beside_phases(sys.argv[2]))
    if sys.argv[1:2] == ["--pipeline-rank"]:
        sys.exit(pipeline_rank(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4], sys.argv[5]))
    sys.exit(main())
