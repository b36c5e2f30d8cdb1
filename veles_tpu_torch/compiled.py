"""Fused execution of the accelerated segment of a StandardWorkflow.

Port of ``veles_tpu/compiled.py``.  The whole steady-state inner cycle
(forwards → evaluator → backwards → updates) runs as ONE
``train_step(state, batch) -> (state, metrics)`` call per minibatch
(plus an ``eval_step``), composed from the SAME ``forward_fn`` /
``backward_fn`` / ``update_fn`` / ``loss_fn`` the units run one by one
in unit mode, so fused and unit mode are numerically identical by
construction.  The unit graph stays intact — the accelerated units are
gate-skipped and a ``FusedStep`` node runs in their place — so Decision
gating keeps working unchanged.  All the momentum updates of a step are
one launch of the fused SGD kernel.

Skip-edge layers (``residual``, ``residual_proj``; ``HAS_SKIP_EDGE``)
take the whole activation list in the forward, and the backward walk
stashes the error they return for their source and adds it when it
reaches that layer (``veles_tpu/compiled.py:81-93, 111-143``).

**Step operands.**  Everything that varies from one train step to the
next besides the minibatch — the live batch size (and its fp32
``inv_batch``), each layer's learning rates at the global step (lr
policies), the step itself (adam), each stochastic layer's key and a
random crop's draws from it — is made by ONE host function,
:meth:`FusedRunner.host_operands`.  The graph loop hands its values to
the kernels directly (:class:`HostOperands`: by value); the epoch scan
stacks a chunk's worth into device tables (:class:`StepTables`) that a
captured step reads at row ``t`` through a device step counter
(:class:`DeviceOperands`), so both drivers feed the kernels the same
numbers by construction.  Keys: the graph loop draws one
``prng.get("dropout").key()`` a train minibatch; a stochastic layer
takes ``fold_in(rng, i)`` (with ``grad_accum`` > 1, microbatch j takes
``fold_in(rng, j)`` first, as the reference does).

**The captured step** (:class:`ScanProgram`, driven by
``veles_tpu_torch/epoch_driver.py``) is the reference's epoch scan
(``veles_tpu/compiled.py:250-505``) on the card: one
``torch.cuda.CUDAGraph`` holds one train step — the minibatch gather
from the device-resident data by the plan row, forward, loss, backward,
the one fused-SGD launch and the metrics into device tables — writing
out of place into the other of two static state buffers (ping-pong), and
the driver replays it once a minibatch.  A second graph holds one eval
step.  On the CPU the same step functions run eagerly; on the card a
capture that fails raises (no eager fallback).

**Under a ShardedTrainer** (``veles_tpu_torch/parallel``; the
reference's ``wf._sharded_trainer`` hooks, ``veles_tpu/compiled.py:
555-625``) the runner's ``shard`` is the trainer: the gradient and
metric sums of a step are all-reduced over the data group between the
gradients and the update (one flat bucket), split layers gather their
outputs and reduce their input gradients, each stochastic layer draws
its data rank's rows of the global draws, and FusedStep / FusedCommit /
``stop`` go through the trainer's state.  A captured step holds the
collectives (NCCL); under gloo on the card the scan raises.

The updated state of a graph-loop train minibatch is held PENDING;
``FusedCommit`` adopts it only after Decision lets the backward pass run
(a minibatch gated by ``decision.complete`` is computed and dropped, as
in the reference).
"""

from __future__ import annotations

import time

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.ops import functional as F
from veles_tpu_torch.units import Unit

_F32 = numpy.float32
#: a step's operand row: [batch, inv_batch, step, lr_w0, lr_b0, ...]
_BATCH, _INV_BATCH, _STEP, _LRS = 0, 1, 2, 3


class HostOperands:
    """One train step's operands as host values (the graph loop's):
    ``batch_size`` and ``step`` ints, per-layer (lr_w, lr_b), and per
    microbatch the per-layer host keys (None where a layer takes none)."""

    operands = None

    def __init__(self, batch_size, step, lrs, keys):
        self.batch_size = int(batch_size)
        self.step = int(step)
        self.lrs = lrs
        self.keys = keys

    def sgd_args(self, i):
        return self.batch_size, self.lrs[i]

    def adaptive_args(self, i):
        return self.batch_size, self.lrs[i], self.step

    def layer_rngs(self, micro):
        return self.keys[micro]

    def row(self):
        """The step's fp32 operand row (see ``_LRS``)."""
        batch = _F32(max(self.batch_size, 1))
        out = [batch, _F32(1.0) / batch, _F32(self.step)]
        for lr in self.lrs:
            if lr is not None:          # the layers with params, in order
                out.extend((_F32(lr[0]), _F32(lr[1])))
        return numpy.asarray(out, numpy.float32)


class DeviceOperands:
    """One train step's operands as views of its rows in the device
    tables (a captured step's): the operand row, the keys row and the
    crop rows.  ``layout`` maps a layer to its slots."""

    def __init__(self, layout, row, keys, crops):
        self.operands = row
        self._layout = layout
        self._keys = keys
        self._crops = crops

    def sgd_args(self, i):
        at = _LRS + 2 * self._layout.lr_slot[i]
        return _INV_BATCH, (at, at + 1)

    def adaptive_args(self, i):
        at = _LRS + 2 * self._layout.lr_slot[i]
        row = self.operands
        return row[_BATCH], (row[at], row[at + 1]), row[_STEP]

    def layer_rngs(self, micro):
        out = [None] * self._layout.n_layers
        for i, slot in self._layout.key_slot.items():
            out[i] = self._keys[micro * self._layout.n_keys + slot]
        for i, slot in self._layout.crop_slot.items():
            rows, cols = self._crops[slot]
            out[i] = F.CropDraws((rows[micro], cols[micro]))
        return out


class OperandLayout:
    """Where each layer's operands sit in a step's tables: lr slots for
    the layers with params, key slots for the stochastic layers that
    take a key, crop slots for those that take draws (``step_operand``
    returning arrays)."""

    def __init__(self, runner):
        fwds = runner.forwards
        self.n_layers = len(fwds)
        self.lr_slot = {i: n for n, i in enumerate(
            i for i, f in enumerate(fwds) if f.has_params)}
        self.key_slot, self.crop_slot = {}, {}
        for i, f in enumerate(fwds):
            if getattr(f, "STOCHASTIC", False):
                if getattr(f, "DRAWS_OPERAND", False):
                    self.crop_slot[i] = len(self.crop_slot)
                else:
                    self.key_slot[i] = len(self.key_slot)
        self.n_keys = len(self.key_slot)
        self.width = _LRS + 2 * len(self.lr_slot)


class FusedRunner:
    """Owns the fused step functions and the per-layer device state."""

    def __init__(self, wf, grad_accum=1):
        self.wf = wf
        self.forwards = list(wf.forwards)
        self.evaluator = wf.evaluator
        self.gds = list(wf.gds)
        #: microbatches per optimizer step (> 1: gradient accumulation —
        #: the minibatch splits, gradient sums add, ONE update applies
        #: with the full live batch size)
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1:
            raise ValueError("grad_accum must be >= 1")
        self.state = self._pull_state()
        self._has_stochastic = any(getattr(f, "STOCHASTIC", False)
                                   for f in self.forwards)
        from veles_tpu_torch.ops.evaluator import EvaluatorMSE
        self._is_mse = isinstance(self.evaluator, EvaluatorMSE)
        self.layout = OperandLayout(self)
        #: the last graph-loop train step's arguments (step timing)
        self._last_train_args = None
        #: the epoch scan's captured steps (set by the driver)
        self.scan = None
        #: the ShardedTrainer this runner runs under (None: one
        #: process): its collectives between the gradients and the
        #: update, around split layers, and on the metrics
        self.shard = None

    # ----------------------------------------------------------------- state
    def _pull_state(self):
        """Per-layer optimizer state from the unit Vectors (weightless
        layers contribute an empty entry)."""
        return [gd.state_entry() if fwd.has_params else {}
                for fwd, gd in zip(self.forwards, self.gds)]

    def sync_to_units(self):
        """Write the fused state back into the unit Vectors."""
        for entry, fwd, gd in zip(self.state, self.forwards, self.gds):
            if fwd.has_params:
                gd.absorb_entry(entry)

    # ------------------------------------------------------------- operands
    def _stochastic_keys(self, rng):
        """Per-layer host keys of one (micro)batch key: ``fold_in(rng,
        i)`` for each stochastic layer, None elsewhere."""
        return [prng.fold_in(rng, i)
                if rng is not None and getattr(f, "STOCHASTIC", False)
                else None for i, f in enumerate(self.forwards)]

    def _layer_rngs(self, ops, micro):
        """Microbatch ``micro``'s per-layer keys of ``ops`` (a data
        rank's rows of the global draws under a ShardedTrainer)."""
        rngs = ops.layer_rngs(micro)
        return rngs if self.shard is None else self.shard.layer_rngs(rngs)

    def host_operands(self, batch_size, step, rng=None):
        """Every step-varying input of one train step, as host values:
        the live batch size, each layer's learning rates at ``step``
        (its lr policies), the step, and each stochastic layer's key
        per microbatch (``rng`` the step's key, or None)."""
        lrs = [self.gds[i]._live_lrs(step) if f.has_params else None
               for i, f in enumerate(self.forwards)]
        if self.grad_accum == 1:
            keys = [self._stochastic_keys(rng)]
        else:
            keys = [self._stochastic_keys(
                None if rng is None else prng.fold_in(rng, j))
                for j in range(self.grad_accum)]
        return HostOperands(batch_size, step, lrs, keys)

    # ----------------------------------------------------------------- steps
    def _forward_chain(self, state, x, rng=None, train=False,
                       layer_rngs=None):
        """(acts, saved): the chain's input and every layer's output,
        and every layer's residuals for its backward (None where it
        keeps none) — the reference's ``jax.vjp`` residuals, passed
        explicitly.  ``layer_rngs`` (one per layer) wins over ``rng``,
        which stands for ``fold_in(rng, i)`` per stochastic layer."""
        if layer_rngs is None:
            layer_rngs = self._stochastic_keys(rng)
        split = {} if self.shard is None else self.shard.split
        acts, saved = [x], []
        for i, (fwd, entry) in enumerate(zip(self.forwards, state)):
            if getattr(fwd, "HAS_SKIP_EDGE", False):
                # skip-edge layers (residual / residual_proj) see the
                # whole activation list and keep no residuals
                y, res = fwd.chain_forward(i, acts, entry, layer_rngs[i],
                                           train), None
            elif i in split:
                y, res = self.shard.tp_forward(i, fwd, acts[-1], entry,
                                               layer_rngs[i], train)
            else:
                y, res = fwd.apply_fused(acts[-1], entry, layer_rngs[i],
                                         train)
            acts.append(y)
            saved.append(res)
        return acts, saved

    def _loss(self, y, y_ref, mask):
        """y_ref: labels (classification) or the regression/AE target."""
        if self._is_mse:
            return self.evaluator.loss_fn(y, y_ref.reshape(y.shape), mask)
        return self.evaluator.loss_fn(y, y_ref, mask)

    def _eval_step(self, state, x, y_ref, mask):
        acts, _ = self._forward_chain(state, x, rng=None, train=False)
        _, metrics = self._loss(acts[-1], y_ref, mask)
        if self.shard is not None:
            metrics = self.shard.reduce_metrics(metrics)
        return metrics

    def _grads_and_metrics(self, state, x, y_ref, mask, rng=None,
                           layer_rngs=None):
        """Forward + loss + backward without updates: per-layer grad sums
        (None for weightless layers) and the metric sums."""
        if layer_rngs is None:
            layer_rngs = self._stochastic_keys(rng)
        acts, saved = self._forward_chain(state, x, train=True,
                                          layer_rngs=layer_rngs)
        err, metrics = self._loss(acts[-1], y_ref, mask)
        split = {} if self.shard is None else self.shard.split
        all_grads = [None] * len(self.forwards)
        # a skip edge makes acts[src] the input of two consumers, so its
        # error has two parts: the main chain's and the stashed skip
        # error, added when the walk reaches src
        pending = {}
        for i in range(len(self.forwards) - 1, -1, -1):
            if err is not None and (i + 1) in pending:
                err = err + pending.pop(i + 1)
            if err is None:
                # the first parameterized gd skipped err_input; everything
                # below it is weightless — nothing to do
                break
            fwd = self.forwards[i]
            if getattr(fwd, "HAS_SKIP_EDGE", False):
                err, src, d_src, all_grads[i] = fwd.chain_backward(
                    i, acts, state[i], err, layer_rngs[i])
                pending[src] = (pending[src] + d_src if src in pending
                                else d_src)
                continue
            if i in split:
                err_in, grads = self.shard.tp_backward(
                    i, self.gds[i], acts[i], acts[i + 1], err, state[i],
                    layer_rngs[i], saved[i])
            else:
                err_in, grads = self.gds[i].backward_fused(
                    acts[i], acts[i + 1], err, state[i], layer_rngs[i],
                    saved[i])
            all_grads[i] = grads
            err = err_in
        return all_grads, metrics

    def _accumulated(self, state, x, y_ref, mask, ops):
        """Gradient accumulation (``veles_tpu/compiled.py:159-208``): the
        minibatch splits into ``grad_accum`` microbatches of contiguous
        rows, gradient sums add, ``*_max`` metrics combine by maximum
        and the rest add; microbatch j's stochastic layers take their
        keys from ``fold_in(rng, j)``."""
        k = self.grad_accum
        if x.shape[0] % k:
            raise ValueError("minibatch %d not divisible by grad_accum %d"
                             % (x.shape[0], k))

        def split(a):
            return a.reshape((k, a.shape[0] // k) + tuple(a.shape[1:]))

        xs, ys, ms = split(x), split(y_ref), split(mask)
        total_g = total_m = None
        for j in range(k):
            g, m = self._grads_and_metrics(
                state, xs[j], ys[j], ms[j],
                layer_rngs=self._layer_rngs(ops, j))
            if total_g is None:
                total_g, total_m = g, dict(m)
                continue
            total_g = [None if a is None else
                       tuple(None if u is None else u + v
                             for u, v in zip(a, b))
                       for a, b in zip(total_g, g)]
            for key, value in m.items():
                total_m[key] = (torch.maximum(total_m[key], value)
                                if key.endswith("_max")
                                else total_m[key] + value)
        return total_g, total_m

    def _apply_updates(self, state, all_grads, ops, out=None):
        """Every momentum-solver layer's tensors in ONE fused-SGD call
        (one kernel launch on the card); the adaptive solvers per layer.
        ``out`` (a state of the same layout) receives the new state."""
        new_state = list(state)
        joint, items = [], []
        for i, grads in enumerate(all_grads):
            if grads is None:
                continue
            gd = self.gds[i]
            batch, lrs = ops.sgd_args(i)
            mine = gd.sgd_items_fused(state[i], grads, batch, lrs)
            if mine is None:
                new_state[i] = gd.update_fused(state[i], grads,
                                               *ops.adaptive_args(i))
            else:
                joint.append((i, len(items), len(mine)))
                items.extend(mine)
        if items:
            dst = None
            if out is not None:
                dst = ([], [])
                for i, _, n in joint:
                    for p_key, v_key in (("w", "vw"), ("b", "vb"))[:n]:
                        dst[0].append(out[i][p_key])
                        dst[1].append(out[i][v_key])
            results = F.sgd_update_multi(items, ops.operands, dst)
            for i, first, n in joint:
                new_state[i] = self.gds[i].sgd_finish_fused(
                    state[i], results[first:first + n])
        if out is None:
            return new_state
        for new, dst in zip(new_state, out):
            for key, tensor in dst.items():
                if new[key] is not tensor:
                    tensor.copy_(new[key])
        return out

    def _step(self, state, x, y_ref, mask, ops, out=None):
        """(new state, metrics) of one train step with the operands
        ``ops`` (:class:`HostOperands` or :class:`DeviceOperands`);
        ``state`` is left untouched.  Under a ShardedTrainer the
        gradient and metric sums are reduced over the data group between
        the gradients and the update."""
        if self.grad_accum == 1:
            all_grads, metrics = self._grads_and_metrics(
                state, x, y_ref, mask, layer_rngs=self._layer_rngs(ops, 0))
        else:
            all_grads, metrics = self._accumulated(state, x, y_ref, mask,
                                                   ops)
        if self.shard is not None:
            all_grads, metrics = self.shard.reduce(all_grads, metrics)
        return self._apply_updates(state, all_grads, ops, out), metrics

    def _train_step(self, state, x, y_ref, mask, batch_size, rng=None,
                    step=0):
        """(new state, metrics); ``batch_size`` and ``step`` are Python
        ints, ``rng`` the step's host key (or None), the rest device
        tensors.  ``state`` is left untouched."""
        return self._step(state, x, y_ref, mask,
                          self.host_operands(batch_size, step, rng))

    # ---------------------------------------------------------- step timing
    def measure_device_step_time(self, iters=10):
        """Steady-state device time of one fused train step in seconds
        (``veles_tpu/compiled.py:210``), or None before any train step.
        After an epoch scan on the card: CUDA events around ``iters``
        replays of the captured step, which reads one state buffer and
        writes the other (scratch once the run is over), so the weights
        never move.  After the graph loop: the last step re-run ``iters``
        times (CUDA events on the card, the host clock on the CPU), its
        results dropped."""
        if self.scan is not None and self.scan.captured:
            return self.scan.time_train_replays(iters)
        args = self._last_train_args
        if args is None:
            return None
        x = args[0]
        if x.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            self._step(self.state, *args)
            start.record()
            for _ in range(iters):
                self._step(self.state, *args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
        begin = time.perf_counter()
        for _ in range(iters):
            self._step(self.state, *args)
        return (time.perf_counter() - begin) / iters

    def eval_forward(self):
        """The eval-mode forward ``(state, x) -> last activation`` under
        ``torch.no_grad()``, built once and shared by every caller (the
        reference's jitted ``eval_forward``): ensemble members of one
        topology all run through member 0's, each with its own state."""
        fn = getattr(self, "_eval_forward_fn", None)
        if fn is None:
            def fn(state, x):
                with torch.no_grad():
                    acts, _ = self._forward_chain(state, x, rng=None,
                                                  train=False)
                return acts[-1]
            self._eval_forward_fn = fn
        return fn

    # ------------------------------------------------------------ graph hook
    def install(self):
        """Rewire the graph: gate-skip the accelerated units; FusedStep
        runs the step right after the loader, FusedCommit adopts the
        pending update AFTER Decision has gated it."""
        wf = self.wf
        always = Bool(True)
        for unit in self.forwards + [self.evaluator] + self.gds:
            unit.gate_skip = always
        fused = FusedStep(wf, self, name="fused_step")
        first_fwd = self.forwards[0]
        first_fwd.unlink_from(wf.loader)
        fused.link_from(wf.loader)
        first_fwd.link_from(fused)
        commit = FusedCommit(wf, self, name="fused_commit")
        commit.link_from(wf.decision)
        commit.gate_skip = wf.decision.gd_skip | wf.decision.complete
        wf.fused_step = fused
        wf.fused_commit = commit
        return fused


class FusedStep(Unit):
    """Executes one fused train/eval step per minibatch.

    For train minibatches the updated state is held PENDING; FusedCommit
    adopts it only if Decision lets the backward pass run.  An
    evaluation-only workflow (``wf.eval_only``) takes the eval step for
    every minibatch.  The unit Vectors are synced back at the run's end
    (``stop``).
    """

    snapshot_attrs = ("train_steps",)

    def __init__(self, workflow, runner, **kwargs):
        super().__init__(workflow, **kwargs)
        self.runner = runner
        self.pending_state = None
        #: train minibatches dispatched (committed or gated) — the
        #: global step of the lr policies and adam
        self.train_steps = 0
        self._initialized = True

    def run(self):
        runner = self.runner
        loader = runner.wf.loader
        # attached by the launcher under --distributed: minibatches (this
        # rank's rows) go through the trainer, the same pending/commit
        # order
        trainer = getattr(runner.wf, "_sharded_trainer", None)
        x = loader.minibatch_data.devmem
        mask = loader.minibatch_mask.devmem
        if runner._is_mse:
            y_ref = runner.evaluator.target.devmem
        else:
            y_ref = loader.minibatch_labels.devmem
        if (loader.minibatch_class == TRAIN
                and not getattr(runner.wf, "eval_only", False)):
            rng = (prng.get("dropout").key() if runner._has_stochastic
                   else None)
            if trainer is not None:
                self.pending_state, metrics = trainer.train_step_pending(
                    x, y_ref, mask, loader.minibatch_size, rng,
                    self.train_steps)
            else:
                ops = runner.host_operands(loader.minibatch_size,
                                           self.train_steps, rng)
                self.pending_state, metrics = runner._step(
                    runner.state, x, y_ref, mask, ops)
                runner._last_train_args = (x, y_ref, mask, ops)
            self.train_steps += 1
        else:
            self.pending_state = None
            if trainer is not None:
                metrics = trainer.eval_step(x, y_ref, mask)
            else:
                metrics = runner._eval_step(runner.state, x, y_ref, mask)
        # decision reads these through its link_attrs alias on the evaluator
        runner.evaluator.metrics = metrics

    def stop(self):
        trainer = getattr(self.runner.wf, "_sharded_trainer", None)
        if trainer is not None:
            trainer.sync_to_runner()
        else:
            self.runner.sync_to_units()


class FusedCommit(Unit):
    """Adopts the pending update; gated like the GD units."""

    def __init__(self, workflow, runner, **kwargs):
        super().__init__(workflow, **kwargs)
        self.runner = runner
        self._initialized = True

    def run(self):
        fused = self.runner.wf.fused_step
        if fused.pending_state is not None:
            trainer = getattr(self.runner.wf, "_sharded_trainer", None)
            if trainer is not None:
                trainer.state = fused.pending_state
            else:
                self.runner.state = fused.pending_state
            fused.pending_state = None


# ------------------------------------------------------------ the scan step
def _launch_counts():
    """{counted function: its count}: the kernel wrappers' launches and
    the collectives of a sharded step."""
    from veles_tpu_torch import parallel
    from veles_tpu_torch.ops import hopper_kernels as HK
    return {fn: fn.launches for fn in HK._WRAPPERS + parallel.COUNTED}


class StepTables:
    """Static device tables of ``rows`` steps of one kind (train or one
    eval set) and what the steps record: the plan's (idx, mask) rows,
    for train the operand rows, keys and crop draws, the device step
    counter ``t``, float metrics one row a step (summed later exactly as
    the Decision sums the graph loop's, so the sums are bit-equal) and
    integer metrics added into one total a group of ``group`` steps (an
    epoch)."""

    def __init__(self, runner, device, rows, mb, group, groups, train,
                 micro_batch=None):
        self.device = device
        self.rows, self.group, self.groups = rows, group, groups
        layout = runner.layout
        self.idx = torch.zeros((rows, mb), dtype=torch.int64, device=device)
        self.mask = torch.zeros((rows, mb), dtype=torch.float32,
                                device=device)
        self.t = torch.zeros(1, dtype=torch.int64, device=device)
        self.float_rows, self.int_totals = {}, {}
        self.scal = self.keys = None
        self.crops = []
        if not train:
            return
        k = runner.grad_accum
        self.scal = torch.zeros((rows, layout.width), dtype=torch.float32,
                                device=device)
        if layout.n_keys:
            self.keys = torch.zeros((rows, k * layout.n_keys, 2),
                                    dtype=torch.int32, device=device)
        for i in sorted(layout.crop_slot, key=layout.crop_slot.get):
            oh, ow = runner.forwards[i].crop
            self.crops.append(tuple(
                torch.zeros((rows, k, micro_batch, n), dtype=torch.int64,
                            device=device) for n in (oh, ow)))

    def load(self, idx, mask, operands=None):
        """Copy a plan's (idx, mask) rows — and for train the host
        operand tables (:meth:`ScanProgram.operand_tables`) — into the
        first rows of the static tables."""
        n = len(idx)
        self.idx[:n].copy_(torch.as_tensor(numpy.asarray(idx, numpy.int64)))
        self.mask[:n].copy_(torch.as_tensor(
            numpy.asarray(mask, numpy.float32)))
        if operands is None:
            return
        scal, keys, crops = operands
        self.scal[:n].copy_(torch.as_tensor(scal))
        if self.keys is not None:
            self.keys[:n].copy_(torch.as_tensor(keys))
        for (rows, cols), host in zip(self.crops, crops):
            oh = rows.shape[-1]
            rows[:n].copy_(torch.as_tensor(host[..., :oh]))
            cols[:n].copy_(torch.as_tensor(host[..., oh:]))

    def at(self, table):
        """Row ``t`` of a table (a gather by the device counter)."""
        return table.index_select(0, self.t)[0]

    def record(self, metrics):
        """Metrics of step ``t``: float ones into their row, integer
        ones added into group ``t // group``."""
        group = None
        for key, value in metrics.items():
            if value.dtype.is_floating_point:
                rows = self.float_rows.get(key)
                if rows is None:
                    rows = self.float_rows[key] = torch.zeros(
                        (self.rows,) + tuple(value.shape),
                        dtype=value.dtype, device=self.device)
                rows.index_copy_(0, self.t, value.unsqueeze(0))
            else:
                totals = self.int_totals.get(key)
                if totals is None:
                    totals = self.int_totals[key] = torch.zeros(
                        (self.groups,) + tuple(value.shape),
                        dtype=value.dtype, device=self.device)
                if group is None:
                    group = torch.div(self.t, self.group,
                                      rounding_mode="floor")
                totals.index_add_(0, group, value.unsqueeze(0))

    def reset(self):
        """Counter to 0, integer totals to 0 (float rows are
        overwritten)."""
        self.t.zero_()
        for totals in self.int_totals.values():
            totals.zero_()

    def group_totals(self, g):
        """Group ``g``'s metric sums as host values, the way Decision
        reads the graph loop's (one transfer): floats summed from their
        fresh copy of the group's rows."""
        keys = list(self.float_rows) + list(self.int_totals)
        sums = [self.float_rows[k][g * self.group:(g + 1) * self.group]
                .clone().sum(dim=0) for k in self.float_rows]
        sums += [self.int_totals[k][g] for k in self.int_totals]
        flat = torch.cat([t.reshape(-1).double() for t in sums]).cpu()
        host, at = {}, 0
        for key, total in zip(keys, sums):
            part = flat[at:at + total.numel()].numpy()
            at += total.numel()
            if total.dim() == 0:
                host[key] = float(part[0])
            else:
                from veles_tpu_torch.memory import numpy_dtype
                host[key] = part.reshape(tuple(total.shape)).astype(
                    numpy_dtype(total.dtype))
        return host


class ScanProgram:
    """The epoch scan's steps over one data source: two static state
    buffers (ping-pong), static train tables and one eval table per set,
    and the captured train step (one graph per direction of the state)
    and eval step (one per state buffer and set).  ``data`` may be one
    tensor or several (the streaming windows): each gets graphs of its
    own.  ``replay_train``/``replay_eval`` run one step; on the CPU
    they call the step functions eagerly.

    A captured step counts no launch: each graph's launches per replay
    are read off the wrappers' counts at capture (its warm-up and its
    capture are then taken off again), and every replay adds them, so
    the kernels' counts stay exact."""

    def __init__(self, runner, device, datas, labels, train_rows, mb,
                 group, groups, eval_rows=None, state=None):
        self.runner = runner
        self.device = device
        self.datas = list(datas)
        self.labels = list(labels)
        self.cuda = device.type == "cuda"
        if self.cuda and runner.shard is not None and \
                runner.shard.mesh.backend != "nccl":
            raise ValueError(
                "the epoch scan on the card needs the nccl backend: a "
                "%s collective stages through the host and cannot be "
                "captured in a CUDA graph (run the graph loop, or give "
                "every rank a card of its own)"
                % runner.shard.mesh.backend)
        micro = mb // runner.grad_accum
        self.train = StepTables(runner, device, train_rows, mb, group,
                                groups, True, micro)
        self.evals = {cls: StepTables(runner, device, rows * groups, mb,
                                      rows, groups, False)
                      for cls, rows in (eval_rows or {}).items()}
        if state is None:
            state = runner.state
        self.buffers = [[{k: v.detach().clone() for k, v in e.items()}
                         for e in state] for _ in range(2)]
        self.cur = 0
        self.kept = None
        self._graphs = {}
        self.captured = False
        #: seconds spent warming up and capturing graphs
        self.capture_s = 0.0
        #: replays a graph, and launches a replay, by graph key
        self.replays, self.graph_launches = {}, {}

    # ------------------------------------------------------------ state
    @property
    def state(self):
        return self.buffers[self.cur]

    @property
    def previous(self):
        """The other buffer: the state before the last train step."""
        return self.buffers[1 - self.cur]

    def set_state(self, state):
        for dst, src in zip(self.buffers[self.cur], state):
            for k, v in dst.items():
                v.copy_(src[k])

    def keep(self):
        """Copy the current state aside (a chunk's input)."""
        if self.kept is None:
            self.kept = [{k: v.clone() for k, v in e.items()}
                         for e in self.state]
        else:
            for dst, src in zip(self.kept, self.state):
                for k, v in dst.items():
                    v.copy_(src[k])

    def restore_kept(self):
        self.set_state(self.kept)

    # --------------------------------------------------------- operands
    def operand_tables(self, ops_list):
        """Host tables of a list of :class:`HostOperands`: (scal (n,
        width) fp32, keys (n, micro * n_keys, 2) int32 or None, crop
        draws per crop layer (n, micro, b, oh + ow) int64)."""
        runner = self.runner
        layout = runner.layout
        scal = numpy.stack([ops.row() for ops in ops_list])
        keys = None
        if layout.n_keys:
            keys = numpy.zeros((len(ops_list), runner.grad_accum
                                * layout.n_keys, 2), numpy.uint32)
        crops = [[] for _ in layout.crop_slot]
        micro = self.train.idx.shape[1] // runner.grad_accum
        for n, ops in enumerate(ops_list):
            for j, layer_keys in enumerate(ops.keys):
                for i, slot in layout.key_slot.items():
                    keys[n, j * layout.n_keys + slot] = layer_keys[i]
            for i, slot in layout.crop_slot.items():
                fwd = runner.forwards[i]
                # a data rank's draws: its rows of the global batch's
                parts = 1 if runner.shard is None else \
                    runner.shard.data_parts
                rank = 0 if parts == 1 else runner.shard.mesh.data_index
                shape = (micro * parts,) + tuple(fwd.input.shape[1:])
                crops[slot].append(numpy.stack([
                    fwd.step_operand(layer_keys[i], shape)[
                        rank * micro:(rank + 1) * micro]
                    for layer_keys in ops.keys]))
        if keys is not None:
            keys = keys.view(numpy.int32)
        return scal, keys, [numpy.stack(c) for c in crops]

    # ------------------------------------------------------------ steps
    def _train_fn(self, data_at, src, dst):
        runner, tab = self.runner, self.train
        data, labels = self.datas[data_at], self.labels[data_at]
        bufs = self.buffers

        def step():
            idx = tab.at(tab.idx)
            x = data.index_select(0, idx)
            y = x if labels is None else labels.index_select(0, idx)
            crops = [(tab.at(rows), tab.at(cols))
                     for rows, cols in tab.crops]
            ops = DeviceOperands(runner.layout, tab.at(tab.scal),
                                 None if tab.keys is None
                                 else tab.at(tab.keys), crops)
            _, metrics = runner._step(bufs[src], x, y, tab.at(tab.mask),
                                      ops, out=bufs[dst])
            tab.record(metrics)
            tab.t.add_(1)
        return step

    def _eval_fn(self, data_at, cls, src):
        runner, tab = self.runner, self.evals[cls]
        data, labels = self.datas[data_at], self.labels[data_at]
        bufs = self.buffers

        def step():
            idx = tab.at(tab.idx)
            x = data.index_select(0, idx)
            y = x if labels is None else labels.index_select(0, idx)
            tab.record(runner._eval_step(bufs[src], x, y, tab.at(tab.mask)))
            tab.t.add_(1)
        return step

    def _graph(self, key, fn, tables):
        """The replay of ``fn``: eager on the CPU; on the card a CUDA
        graph captured at first use (warmed up first on a side stream,
        its warm-up's counter and totals reset after)."""
        graph = self._graphs.get(key)
        if graph is not None:
            return graph
        if not self.cuda:
            self._graphs[key] = fn
            return fn
        import gc
        began = time.perf_counter()
        counts = _launch_counts()
        # the warm-up runs the step the first replay runs next: it writes
        # what that replay writes (the destination buffer, the float row
        # t); the counter and the integer totals are put back
        t_saved = tables.t.clone()
        totals_saved = {k: v.clone() for k, v in tables.int_totals.items()}
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        # no garbage collection inside the capture: freeing an earlier
        # run's graph there would end the capture; other threads (the
        # streaming stager) may go on using the card
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                fn()
        finally:
            gc.enable()
        after = _launch_counts()
        per_replay = {f: after[f] - before[f] for f in after}
        for f, n in counts.items():
            f.launches = n
        tables.t.copy_(t_saved)
        for key_, totals in tables.int_totals.items():
            saved = totals_saved.get(key_)
            if saved is None:
                totals.zero_()
            else:
                totals.copy_(saved)
        torch.cuda.current_stream(self.device).synchronize()

        def replay():
            graph.replay()
            for f, n in per_replay.items():
                if n:
                    f.launches += n
        self.graph_launches[key] = {f.__name__: n
                                    for f, n in per_replay.items() if n}
        self._graphs[key] = replay
        self._graphs[key + ("graph",)] = graph
        self.captured = True
        self.capture_s += time.perf_counter() - began
        return replay

    def replay_train(self, data_at=0):
        """One train step: state buffer ``cur`` → the other one."""
        src = self.cur
        key = ("train", data_at, src)
        self._graph(key, self._train_fn(data_at, src, 1 - src),
                    self.train)()
        self.replays[key] = self.replays.get(key, 0) + 1
        self.cur = 1 - src

    def replay_eval(self, cls, data_at=0):
        """One eval step of set ``cls`` on the current state."""
        key = ("eval", data_at, self.cur, cls)
        self._graph(key, self._eval_fn(data_at, cls, self.cur),
                    self.evals[cls])()
        self.replays[key] = self.replays.get(key, 0) + 1

    def time_train_replays(self, iters):
        """Seconds a replay of the current state's train graph, by CUDA
        events: it reads buffer ``cur`` and writes the other, so the
        current state does not move; the counter is restored after."""
        key = ("train", 0, self.cur)
        graph = self._graphs.get(key + ("graph",))
        if graph is None:
            return None
        saved = self.train.t.clone()
        self.train.t.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            graph.replay()
            self.train.t.zero_()
        end.record()
        end.synchronize()
        self.train.t.copy_(saved)
        return start.elapsed_time(end) / 1e3 / iters


# ---------------------------------------------------------- weights across
def state_from_jax(state, device=None):
    """The reference's ``FusedRunner.state`` — a list of per-layer dicts
    (``w``/``vw``/``b``/``vb``[/``aw``/``ab``]) of arrays, numpy or
    anything ``numpy.asarray`` reads — as this runner's state: the same
    list of dicts of fp32 tensors on ``device`` (None = the CUDA card,
    raising without one).  A weightless layer's entry (pooling,
    residual, depooling, an activation) stays empty; ``residual_proj``'s
    is ``w``/``vw`` alone (bias-free), a deconv's ``w``/``vw``/``b``/
    ``vb`` with HWIO weights, as a conv's."""
    device = resolve_device(device)
    return [{key: torch.tensor(numpy.asarray(value), device=device)
             for key, value in entry.items()} for entry in state]


def load_fused_state(wf, state):
    """Load a per-layer state (as :func:`state_from_jax` returns) into a
    built, initialized workflow: the unit Vectors take it, and a fused
    runner steps from it next.  Each entry must hold the keys and shapes
    of its layer's own state (empty for a weightless layer); anything
    else raises ValueError before a Vector is touched."""
    if len(state) != len(wf.forwards):
        raise ValueError("%d state entries for %d layers"
                         % (len(state), len(wf.forwards)))
    for i, (entry, fwd, gd) in enumerate(zip(state, wf.forwards, wf.gds)):
        own = gd.state_entry() if fwd.has_params else {}
        want = {k: tuple(v.shape) for k, v in own.items()}
        got = {k: tuple(v.shape) for k, v in entry.items()}
        if got != want:
            raise ValueError("layer %d (%s): state %r, the layer's %r"
                             % (i, fwd.name, got, want))
    for entry, fwd, gd in zip(state, wf.forwards, wf.gds):
        if fwd.has_params:
            gd.absorb_entry(entry)
    runner = getattr(wf, "_fused_runner", None)
    if runner is not None:
        runner.state = runner._pull_state()


def trainer_state_from_jax(state, device=None):
    """A reference non-SGD trainer's ``snapshot_attrs`` — the SOM's
    ``weights`` and ``time``, the RBM's ``weights``, ``vbias``,
    ``hbias`` and ``time`` — as numpy arrays (or anything
    ``numpy.asarray`` reads) and an int: the same dict with fp32
    tensors on ``device`` (None = the CUDA card, raising without one)
    and ``time`` an int."""
    device = resolve_device(device)
    return {key: int(value) if key == "time"
            else torch.tensor(numpy.asarray(value), device=device)
            for key, value in state.items()}


def load_trainer_state(unit, state):
    """Load a trainer state (as :func:`trainer_state_from_jax` returns)
    into a built, initialized trainer unit: every name of the unit's
    ``snapshot_attrs`` must be present, each Vector's shape must match,
    and nothing else may be; anything else raises ValueError before a
    Vector is touched."""
    want = set(unit.snapshot_attrs)
    if set(state) != want:
        raise ValueError("%s: state keys %s, the unit's %s"
                         % (unit.name, sorted(state), sorted(want)))
    for key in sorted(want - {"time"}):
        have = tuple(getattr(unit, key).shape)
        got = tuple(state[key].shape)
        if got != have:
            raise ValueError("%s: %s has shape %s, the unit's %s"
                             % (unit.name, key, got, have))
    for key in want - {"time"}:
        getattr(unit, key).assign_device(state[key])
    if "time" in want:
        unit.time = int(state["time"])
