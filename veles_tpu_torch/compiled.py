"""Fused execution of the accelerated segment of a StandardWorkflow.

Port of ``veles_tpu/compiled.py:25-158`` and ``:506-624``.  The whole
steady-state inner cycle (forwards → evaluator → backwards → updates)
runs as ONE ``train_step(state, batch) -> (state, metrics)`` call per
minibatch (plus an ``eval_step``), composed from the SAME ``forward_fn``
/ ``backward_fn`` / ``update_fn`` / ``loss_fn`` the units run one by one
in unit mode, so fused and unit mode are numerically identical by
construction.  The unit graph stays intact — the accelerated units are
gate-skipped and a ``FusedStep`` node runs in their place — so Decision
gating keeps working unchanged.  PyTorch runs the step eagerly; all the
momentum updates of a step are one launch of the fused SGD kernel (each
tensor's arithmetic is the same as in unit mode, where a unit updates
its weights and bias in one launch).

Skip-edge layers (``residual``, ``residual_proj``; ``HAS_SKIP_EDGE``)
take the whole activation list in the forward, and the backward walk
stashes the error they return for their source and adds it when it
reaches that layer (``veles_tpu/compiled.py:81-93, 111-143``).

Stochastic layers (dropout, random crop) get their keys as the reference
threads them: one ``prng.get("dropout").key()`` per train minibatch when
a forward is ``STOCHASTIC``, folded with the layer index per layer
(``fold_in(rng, i)``, a host hash); eval steps take no key.

The updated state of a train minibatch is held PENDING; ``FusedCommit``
adopts it only after Decision lets the backward pass run (a minibatch
gated by ``decision.complete`` is computed and dropped, as in the
reference).  Not ported yet, and raising: ``grad_accum > 1`` (ROADMAP
Queue 2a, item 2), the epoch-scan functions and the device step timing
(item 3).
"""

from __future__ import annotations

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.ops import functional as F
from veles_tpu_torch.units import Unit


def _not_ported(what, item):
    raise NotImplementedError("%s is not ported yet: ROADMAP Queue 2a, "
                              "item %d" % (what, item))


class FusedRunner:
    """Owns the fused step functions and the per-layer device state."""

    def __init__(self, wf, grad_accum=1):
        if int(grad_accum) != 1:
            _not_ported("gradient accumulation (grad_accum > 1)", 2)
        self.wf = wf
        self.forwards = list(wf.forwards)
        self.evaluator = wf.evaluator
        self.gds = list(wf.gds)
        self.state = self._pull_state()
        self._has_stochastic = any(getattr(f, "STOCHASTIC", False)
                                   for f in self.forwards)
        from veles_tpu_torch.ops.evaluator import EvaluatorMSE
        self._is_mse = isinstance(self.evaluator, EvaluatorMSE)

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

    # ----------------------------------------------------------------- steps
    @staticmethod
    def _layer_rng(rng, i):
        return None if rng is None else prng.fold_in(rng, i)

    def _forward_chain(self, state, x, rng=None, train=False):
        """(acts, saved): the chain's input and every layer's output,
        and every layer's residuals for its backward (None where it
        keeps none) — the reference's ``jax.vjp`` residuals, passed
        explicitly."""
        acts, saved = [x], []
        for i, (fwd, entry) in enumerate(zip(self.forwards, state)):
            if getattr(fwd, "HAS_SKIP_EDGE", False):
                # skip-edge layers (residual / residual_proj) see the
                # whole activation list and keep no residuals
                y, res = fwd.chain_forward(i, acts, entry,
                                           self._layer_rng(rng, i),
                                           train), None
            else:
                y, res = fwd.apply_fused(acts[-1], entry,
                                         self._layer_rng(rng, i), train)
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
        return metrics

    def _grads_and_metrics(self, state, x, y_ref, mask, rng=None):
        """Forward + loss + backward without updates: per-layer grad sums
        (None for weightless layers) and the metric sums."""
        acts, saved = self._forward_chain(state, x, rng=rng, train=True)
        err, metrics = self._loss(acts[-1], y_ref, mask)
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
                    i, acts, state[i], err, self._layer_rng(rng, i))
                pending[src] = (pending[src] + d_src if src in pending
                                else d_src)
                continue
            err_in, grads = self.gds[i].backward_fused(
                acts[i], acts[i + 1], err, state[i],
                self._layer_rng(rng, i), saved[i])
            all_grads[i] = grads
            err = err_in
        return all_grads, metrics

    def _apply_updates(self, state, all_grads, batch_size, step):
        """Every momentum-solver layer's tensors in ONE fused-SGD call
        (one kernel launch on the card); the adaptive solvers per layer."""
        new_state = list(state)
        joint, items = [], []
        for i, grads in enumerate(all_grads):
            if grads is None:
                continue
            gd = self.gds[i]
            mine = gd.sgd_items_fused(state[i], grads, batch_size)
            if mine is None:
                new_state[i] = gd.update_fused(state[i], grads, batch_size,
                                               step)
            else:
                joint.append((i, len(items), len(mine)))
                items.extend(mine)
        if items:
            results = F.sgd_update_multi(items)
            for i, first, n in joint:
                new_state[i] = self.gds[i].sgd_finish_fused(
                    state[i], results[first:first + n])
        return new_state

    def _train_step(self, state, x, y_ref, mask, batch_size, rng=None,
                    step=0):
        """(new state, metrics); ``batch_size`` and ``step`` are Python
        ints, ``rng`` a host key (or None), the rest device tensors.
        ``state`` is left untouched."""
        all_grads, metrics = self._grads_and_metrics(state, x, y_ref, mask,
                                                     rng)
        return self._apply_updates(state, all_grads, batch_size,
                                   step), metrics

    # -------------------------------------------------- not ported (raise)
    def measure_device_step_time(self, iters=10):
        _not_ported("measure_device_step_time", 3)

    def epoch_chunk_fn(self, k):
        _not_ported("the epoch-scan (epoch_chunk_fn)", 3)

    def epoch_chunk_eval_fn(self, k, eval_first=False, donate=True):
        _not_ported("the epoch-scan (epoch_chunk_eval_fn)", 3)

    def window_scan_fn(self):
        _not_ported("the streaming epoch-scan (window_scan_fn)", 3)

    def epoch_fns(self):
        _not_ported("the epoch-scan (epoch_fns)", 3)

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
    adopts it only if Decision lets the backward pass run.  The unit
    Vectors are synced back at the run's end (``stop``).
    """

    snapshot_attrs = ("train_steps",)

    def __init__(self, workflow, runner, **kwargs):
        super().__init__(workflow, **kwargs)
        self.runner = runner
        self.pending_state = None
        #: train minibatches dispatched (committed or gated)
        self.train_steps = 0
        self._initialized = True

    def run(self):
        runner = self.runner
        loader = runner.wf.loader
        x = loader.minibatch_data.devmem
        mask = loader.minibatch_mask.devmem
        if runner._is_mse:
            y_ref = runner.evaluator.target.devmem
        else:
            y_ref = loader.minibatch_labels.devmem
        if loader.minibatch_class == TRAIN:
            rng = (prng.get("dropout").key() if runner._has_stochastic
                   else None)
            self.pending_state, metrics = runner._train_step(
                runner.state, x, y_ref, mask, int(loader.minibatch_size),
                rng, self.train_steps)
            self.train_steps += 1
        else:
            self.pending_state = None
            metrics = runner._eval_step(runner.state, x, y_ref, mask)
        # decision reads these through its link_attrs alias on the evaluator
        runner.evaluator.metrics = metrics

    def stop(self):
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
            self.runner.state = fused.pending_state
            fused.pending_state = None


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
