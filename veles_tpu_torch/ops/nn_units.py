"""NN unit base classes: forward ops, gradient ops, their pairing.

Port of ``veles_tpu/ops/nn_units.py`` (ref: veles/znicz/nn_units.py::
ForwardBase/GradientDescentBase/MatchingObject [H]).  A forward unit
owns its weights/bias (device-resident Vectors); its paired gradient
unit consumes ``err_output`` from the next unit in the backward chain,
produces ``err_input`` for the previous one, and applies the per-unit
update rule (learning rate, momentum, L1/L2 decay, clipping, solver).

Initial weights draw from the host ``init`` stream in the order the
units initialize, exactly as the reference's do, so the same seed gives
bit-equal weights in both packages.  Weightless units (pooling, LRN,
dropout, augmentation) derive from ``TransformUnit``; their one generic
gradient unit, ``TransformGD``, calls the forward unit's explicit
``backward`` where the reference takes ``jax.vjp`` of the transform.
Learning-rate policies (``lr_policy``, ``bias_lr_policy``) are host
functions of the global step (:mod:`veles_tpu_torch.ops.lr_adjust`).
"""

from __future__ import annotations

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.accel import AcceleratedUnit
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.workflow import Workflow, DeferredInitError
from veles_tpu_torch.ops import functional as F

#: maps config layer-type strings to forward unit classes
LAYER_TYPES = {}

#: maps forward classes to their gradient classes
_FORWARD_TO_GD = {}


def register_layer_type(name):
    def deco(cls):
        LAYER_TYPES[name] = cls
        cls.layer_type = name
        return cls
    return deco


def register_gd_for(forward_cls):
    def deco(cls):
        _FORWARD_TO_GD[forward_cls] = cls
        cls.forward_class = forward_cls
        return cls
    return deco


def gd_class_for(forward_unit_or_cls):
    cls = (forward_unit_or_cls if isinstance(forward_unit_or_cls, type)
           else type(forward_unit_or_cls))
    for klass in cls.__mro__:
        gd = _FORWARD_TO_GD.get(klass)
        if gd is not None:
            return gd
    raise KeyError("no gradient unit registered for %s" % cls.__name__)


class NNWorkflow(Workflow):
    """Workflow with the conventional NN roles attached: loader,
    forwards, evaluator, decision, gds."""

    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow, name=name, **kwargs)
        self.loader = None
        self.forwards = []
        self.evaluator = None
        self.decision = None
        self.gds = []
        self.repeater = None


class ForwardBase(AcceleratedUnit):
    """Base for weight-owning forward units.

    Subclasses set ``ACTIVATION``.  Weight init follows the reference's
    options (``weights_filling`` uniform/gaussian with
    ``weights_stddev``, default Glorot-uniform bound).
    """

    ACTIVATION = "linear"
    snapshot_attrs = ("weights", "bias")

    def __init__(self, workflow, output_sample_shape=None,
                 weights_filling="uniform", weights_stddev=None,
                 include_bias=True, **kwargs):
        super().__init__(workflow, **kwargs)
        if isinstance(output_sample_shape, int):
            output_sample_shape = (output_sample_shape,)
        self.output_sample_shape = output_sample_shape
        self.weights_filling = weights_filling
        self.weights_stddev = weights_stddev
        self.include_bias = include_bias
        self.weights = Vector()
        self.bias = Vector()
        self.output = Vector()
        # self.input is link_attrs'd from the previous unit's output (or
        # the loader's minibatch_data).

    # -- shape / param init --------------------------------------------------
    @property
    def n_input(self):
        n = 1
        for d in self.input.shape[1:]:
            n *= d
        return n

    @property
    def n_output(self):
        n = 1
        for d in self.output_sample_shape:
            n *= d
        return n

    def _init_weights(self, shape, fan_in, fan_out):
        stream = prng.get("init")
        w = numpy.zeros(shape, dtype=self.dtype)
        if self.weights_stddev is not None:
            s = self.weights_stddev
        else:
            s = numpy.sqrt(6.0 / (fan_in + fan_out))
        if self.weights_filling == "uniform":
            stream.fill(w, -s, s)
        elif self.weights_filling == "gaussian":
            stream.fill_normal(w, 0.0, s)
        else:
            raise ValueError("unknown weights_filling %r"
                             % self.weights_filling)
        return w

    def initialize(self, device=None, **kwargs):
        if not hasattr(self, "input") or self.input.is_empty:
            raise DeferredInitError(self.name)
        if self.weights.is_empty:
            self.weights.reset(self._init_weights(
                (self.n_input, self.n_output), self.n_input, self.n_output))
            if self.include_bias:
                self.bias.reset(numpy.zeros(self.n_output, self.dtype))
        batch = self.input.shape[0]
        self.output.reset(numpy.zeros(
            (batch,) + tuple(self.output_sample_shape), self.dtype))
        self._fwd = self.jit("fwd", self.forward_fn)
        super().initialize(device=device, **kwargs)

    # -- compute -------------------------------------------------------------
    has_params = True
    STOCHASTIC = False
    #: unit mode's residuals for the paired GD (see ``apply_fused``)
    saved = None

    def forward_fn(self, x, weights, bias):
        """The pure forward function (composed by the fused step)."""
        y = F.dense_forward(x, weights, bias if self.include_bias else None,
                            self.ACTIVATION)
        return y.reshape((x.shape[0],) + tuple(self.output_sample_shape))

    def apply_fused(self, x, entry, rng=None, train=False):
        """Uniform fused-chain hook: entry is this layer's param dict.
        Returns (y, the residuals the paired GD's ``backward_fused``
        takes as ``saved`` — None here)."""
        return self.forward_fn(x, entry.get("w"), entry.get("b")), None

    def run(self):
        self.output.assign_device(self._fwd(
            self.input.devmem, self.weights.devmem,
            self.bias.devmem if self.include_bias else None))


class TransformUnit(AcceleratedUnit):
    """Weightless forward unit: output = transform(input).

    Subclasses define ``transform(x, rng, train) -> (y, saved)`` — the
    output and what their ``backward(x, y, err, saved, rng)`` needs from
    the forward (None when nothing) — and ``output_shape`` when it is not
    the input's.  ``STOCHASTIC`` units get a fresh key per training
    minibatch: the fused step's per-layer ``fold_in``, or in unit mode
    ``prng.get("dropout").key()`` drawn by ``run`` and replayed by the
    GD from ``_last_rng``.  The fused chain passes each layer's
    ``saved`` from its forward to its GD; in unit mode the last forward's
    stays on the unit for its GD, which runs before the next forward.
    """

    has_params = False
    STOCHASTIC = False

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.output = Vector()
        self.saved = None
        self._last_rng = None

    def transform(self, x, rng=None, train=False):
        raise NotImplementedError

    def backward(self, x, y, err, saved, rng=None):
        raise NotImplementedError

    def output_shape(self, input_shape):
        """The output's shape for ``input_shape``, from arithmetic."""
        return tuple(input_shape)

    def initialize(self, device=None, **kwargs):
        if not hasattr(self, "input") or self.input.is_empty:
            raise DeferredInitError(self.name)
        out_shape = self.output_shape(self.input.shape)
        self.output.reset(numpy.zeros(out_shape, self.dtype))
        self.output_sample_shape = out_shape[1:]
        super().initialize(device=device, **kwargs)

    def apply_fused(self, x, entry, rng=None, train=False):
        return self.transform(x, rng, train)

    def _in_training_minibatch(self):
        """Unit-mode train/eval detection (the loader's minibatch class)."""
        from veles_tpu_torch.loader.base import TRAIN
        loader = getattr(self.workflow, "loader", None)
        return loader is None or loader.minibatch_class == TRAIN

    def run(self):
        train = self._in_training_minibatch()
        self._last_rng = None
        if self.STOCHASTIC and train:
            self._last_rng = prng.get("dropout").key()
        y, self.saved = self.transform(self.input.devmem, self._last_rng,
                                       train)
        self.output.assign_device(y)


class TransformGD(AcceleratedUnit):
    """Backward for a TransformUnit: err_input = the forward unit's
    explicit ``backward`` of err_output (the reference's
    ``jax.vjp(transform)``)."""

    has_params = False

    def __init__(self, workflow, forward=None, need_err_input=True,
                 **kwargs):
        super().__init__(workflow, **kwargs)
        self.forward = forward
        self.need_err_input = need_err_input
        self.err_input = Vector()
        if forward is not None:
            self.link_attrs(forward, "input", "output")

    def initialize(self, device=None, **kwargs):
        if self.forward is None or not self.forward.is_initialized:
            raise DeferredInitError(self.name)
        super().initialize(device=device, **kwargs)

    def backward_fused(self, x, y, err_output, entry, rng=None, saved=None):
        if not self.need_err_input:
            return None, None
        return self.forward.backward(x, y, err_output.reshape(y.shape),
                                     saved, rng), None

    def run(self):
        if not self.need_err_input:
            return  # nothing downstream consumes err_input
        fwd = self.forward
        self.err_input.assign_device(self.backward_fused(
            self.input.devmem, self.output.devmem, self.err_output.devmem,
            None, fwd._last_rng, fwd.saved)[0])


class GradientDescentBase(AcceleratedUnit):
    """Base for gradient/update units.

    Consumes ``err_output`` (dL/d output of the paired forward unit),
    produces ``err_input`` (the previous GD unit's err_output via
    link_attrs) and replaces the paired forward's weights with updated
    ones.  Hyperparameters are per-unit (ref: veles/znicz/gd.py [H]).
    """

    snapshot_attrs = ("velocity_weights", "velocity_bias", "time",
                      "accum_weights", "accum_bias", "solver")

    def __init__(self, workflow, forward=None, learning_rate=0.01,
                 learning_rate_bias=None, momentum=None, weight_decay=0.0,
                 weight_decay_bias=0.0, l1_vs_l2=0.0, gradient_clip=None,
                 need_err_input=True, lr_policy=None, bias_lr_policy=None,
                 weights_mask=None, solver="momentum", solver_rho=0.95,
                 solver_epsilon=1e-6, **kwargs):
        super().__init__(workflow, **kwargs)
        self.forward = forward
        self.learning_rate = learning_rate
        self.learning_rate_bias = (learning_rate if learning_rate_bias is None
                                   else learning_rate_bias)
        self.set_lr_policy(lr_policy, bias_lr_policy)
        #: optional 0/1 sparse-connectivity mask multiplied into the weights
        #: after every update (ref: veles/znicz/weights_zerofilling.py [M])
        self.weights_mask = weights_mask
        #: None = unset: plain SGD under "momentum", beta1 = 0.9 under adam
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.weight_decay_bias = weight_decay_bias
        self.l1_vs_l2 = l1_vs_l2
        self.gradient_clip = gradient_clip
        if solver not in ("momentum", "adagrad", "adadelta", "adam"):
            raise ValueError("unknown solver %r" % (solver,))
        self.solver = solver
        self.solver_rho = solver_rho
        self.solver_epsilon = solver_epsilon
        if solver in ("adagrad", "adadelta") and momentum:
            self.warning("momentum=%g is inert under solver=%r",
                         momentum, solver)
        #: first trainable layer skips computing err_input
        self.need_err_input = need_err_input
        self.err_input = Vector()
        self.velocity_weights = Vector()
        self.velocity_bias = Vector()
        #: grad² accumulators (adaptive solvers only; empty under momentum)
        self.accum_weights = Vector()
        self.accum_bias = Vector()
        self._mask_t = None
        if forward is not None:
            self.link_attrs(forward, "weights", "bias", "input", "output")
        #: update counter in unit mode (the adam bias correction's step)
        self.time = 0

    def set_lr_policy(self, lr_policy, bias_lr_policy=None):
        """Attach lr(t) decay policies (see
        :mod:`veles_tpu_torch.ops.lr_adjust`); the bias takes the weight
        policy unless it has its own."""
        from veles_tpu_torch.ops.lr_adjust import make_policy
        self.lr_policy = lr_policy
        self.bias_lr_policy = bias_lr_policy
        self._lr_fn = make_policy(lr_policy)
        self._lr_bias_fn = (make_policy(bias_lr_policy)
                            if bias_lr_policy is not None else self._lr_fn)

    def _live_lrs(self, step):
        """(lr_weights, lr_bias) at global train step ``step``: the
        configured constants, or the policies' fp32 values.  Weight and
        bias policies are independent (either may be unset)."""
        if self._lr_fn is None and self._lr_bias_fn is None:
            return self.learning_rate, self.learning_rate_bias
        lr_w = (self._lr_fn(self.learning_rate, int(step))
                if self._lr_fn is not None else self.learning_rate)
        lr_b = (self._lr_bias_fn(self.learning_rate_bias, int(step))
                if self._lr_bias_fn is not None else self.learning_rate_bias)
        return lr_w, lr_b

    def initialize(self, device=None, **kwargs):
        fwd = self.forward
        if fwd is None or fwd.weights.is_empty:
            raise DeferredInitError(self.name)
        if self.velocity_weights.is_empty:
            self.velocity_weights.reset(
                numpy.zeros(fwd.weights.shape, self.dtype))
            if fwd.include_bias:
                self.velocity_bias.reset(
                    numpy.zeros(fwd.bias.shape, self.dtype))
        if self.solver != "momentum" and self.accum_weights.is_empty:
            self.accum_weights.reset(
                numpy.zeros(fwd.weights.shape, self.dtype))
            if fwd.include_bias:
                self.accum_bias.reset(
                    numpy.zeros(fwd.bias.shape, self.dtype))
        self._bwd = self.jit("bwd", self.backward_fn)
        self._upd = self.jit("upd", self.update_fn)
        super().initialize(device=device, **kwargs)

    # -- pure functions ------------------------------------------------------
    def backward_fn(self, x, y, err_output, weights, bias=None, saved=None):
        """(err_input, grad_weights, grad_bias) — pure, composed when
        fused; ``saved`` is the forward's residuals (unused here)."""
        return F.dense_backward(
            x, y.reshape(y.shape[0], -1),
            err_output.reshape(err_output.shape[0], -1), weights,
            self.forward.ACTIVATION, self.forward.include_bias,
            self.need_err_input)

    has_params = True

    def backward_fused(self, x, y, err_output, entry, rng=None, saved=None):
        """(err_input, grads) for the fused chain."""
        err_in, grad_w, grad_b = self.backward_fn(
            x, y, err_output, entry["w"], entry.get("b"), saved)
        return err_in, (grad_w, grad_b)

    def update_fused(self, entry, grads, batch_size, lrs, step=0):
        """The fused chain's update of one layer under an adaptive
        solver: ``batch_size``, ``lrs`` (lr_w, lr_b) and ``step`` as
        numbers or fp32 0-dim tensors (a step's operands)."""
        grad_w, grad_b = grads
        return self.entry_from(self._adaptive(
            entry["w"], entry.get("b"), entry["vw"], entry.get("vb"),
            grad_w, grad_b, batch_size, lrs, step,
            entry.get("aw"), entry.get("ab")))

    def sgd_items_fused(self, entry, grads, batch_size, lrs):
        """:meth:`sgd_items` of a fused state entry and its grads."""
        grad_w, grad_b = grads
        return self.sgd_items(entry["w"], entry.get("b"), entry["vw"],
                              entry.get("vb"), grad_w, grad_b, batch_size,
                              lrs)

    def sgd_finish_fused(self, entry, results):
        """The new fused state entry from this unit's results of a joint
        momentum update (:meth:`sgd_finish`)."""
        return self.entry_from(self.sgd_finish(results, entry.get("aw"),
                                               entry.get("ab")))

    @staticmethod
    def entry_from(new):
        """A fused state entry from :meth:`update_fn`'s six results."""
        new_w, new_b, new_vw, new_vb, new_aw, new_ab = new
        new_entry = {"w": new_w, "vw": new_vw}
        if new_b is not None:
            new_entry["b"] = new_b
            new_entry["vb"] = new_vb
        if new_aw is not None:
            new_entry["aw"] = new_aw
            if new_ab is not None:
                new_entry["ab"] = new_ab
        return new_entry

    #: optimizer-state slots meaningful only under the solver that made them
    _SOLVER_SLOTS = ("velocity_weights", "velocity_bias",
                     "accum_weights", "accum_bias")

    def load_state_dict(self, d):
        """Params load whatever the snapshot's solver; optimizer slots
        only when it matches the configured one."""
        d = dict(d)
        snap_solver = d.pop("solver", "momentum")
        if snap_solver != self.solver:
            d = {k: v for k, v in d.items() if k not in self._SOLVER_SLOTS}
        super().load_state_dict(d)

    def state_entry(self):
        """Per-layer device-state dict for the fused step (keys ending in
        "w" carry weight-shaped tensors, "b" bias-shaped ones)."""
        fwd = self.forward
        entry = {"w": fwd.weights.devmem,
                 "vw": self.velocity_weights.devmem}
        if fwd.include_bias:
            entry["b"] = fwd.bias.devmem
            entry["vb"] = self.velocity_bias.devmem
        if not self.accum_weights.is_empty:
            entry["aw"] = self.accum_weights.devmem
            if fwd.include_bias:
                entry["ab"] = self.accum_bias.devmem
        return entry

    def absorb_entry(self, entry):
        """Write a fused state entry back into the unit Vectors."""
        fwd = self.forward
        fwd.weights.assign_device(entry["w"])
        self.velocity_weights.assign_device(entry["vw"])
        if fwd.include_bias:
            fwd.bias.assign_device(entry["b"])
            self.velocity_bias.assign_device(entry["vb"])
        if "aw" in entry:
            self.accum_weights.assign_device(entry["aw"])
            if fwd.include_bias:
                self.accum_bias.assign_device(entry["ab"])

    def sgd_items(self, weights, bias, vel_w, vel_b, grad_w, grad_b,
                  batch_size, lrs):
        """The momentum solver's updates as (param, velocity, grad,
        scalars) entries for :func:`F.sgd_update_multi` — the weights',
        then the bias's (its own learning rate and weight decay) — or
        None under another solver.  ``batch_size`` and ``lrs`` (lr_w,
        lr_b) fill the first two scalars as given: numbers, or the
        offsets of inv_batch and the rates in a step's operand row."""
        if self.solver != "momentum":
            return None
        momentum = 0.0 if self.momentum is None else self.momentum
        lr_w, lr_b = lrs
        items = [(weights, vel_w, grad_w,
                  (batch_size, lr_w, momentum,
                   self.weight_decay, self.l1_vs_l2, self.gradient_clip))]
        if grad_b is not None:
            items.append((bias, vel_b, grad_b,
                          (batch_size, lr_b, momentum,
                           self.weight_decay_bias, self.l1_vs_l2,
                           self.gradient_clip)))
        return items

    def _masked(self, new_w):
        """``new_w`` times ``weights_mask`` as it is at this update (a
        ZeroFiller sets it after this unit initializes; the reference
        reads it when its step is traced), or ``new_w`` without one."""
        if self.weights_mask is None:
            return new_w
        if self._mask_t is None or self._mask_t[0] is not self.weights_mask:
            self._mask_t = (self.weights_mask, torch.as_tensor(
                numpy.asarray(self.weights_mask, self.dtype)).to(
                    new_w.device))
        return new_w * self._mask_t[1]

    def sgd_finish(self, results, acc_w=None, acc_b=None):
        """:meth:`update_fn`'s six results from the (param, velocity)
        pairs of :meth:`sgd_items`' entries (the weights mask applied)."""
        (new_w, new_vw), *rest = results
        new_w = self._masked(new_w)
        if not rest:
            return new_w, None, new_vw, None, acc_w, None
        (new_b, new_vb), = rest
        return new_w, new_b, new_vw, new_vb, acc_w, acc_b

    def update_fn(self, weights, bias, vel_w, vel_b, grad_w, grad_b,
                  batch_size, step=0, acc_w=None, acc_b=None):
        """New (w, b, vw, vb, aw, ab); ``batch_size`` and ``step`` are
        Python ints, the learning rates this unit's at ``step``.  Under
        the momentum solver the weights and the bias take one joint
        update (one kernel launch on the card)."""
        lrs = self._live_lrs(step)
        items = self.sgd_items(weights, bias, vel_w, vel_b, grad_w, grad_b,
                               batch_size, lrs)
        if items is not None:
            return self.sgd_finish(F.sgd_update_multi(items), acc_w, acc_b)
        return self._adaptive(weights, bias, vel_w, vel_b, grad_w, grad_b,
                              batch_size, lrs, step, acc_w, acc_b)

    def _adaptive(self, weights, bias, vel_w, vel_b, grad_w, grad_b,
                  batch_size, lrs, step, acc_w, acc_b):
        """An adaptive solver's six results (see :meth:`update_fn`)."""
        lr_w, lr_b = lrs
        new_w, new_vw, new_aw = F.adaptive_update(
            weights, vel_w, acc_w, grad_w, batch_size, lr_w,
            self.momentum, self.weight_decay, self.l1_vs_l2,
            self.gradient_clip, self.solver, self.solver_rho,
            self.solver_epsilon, step)
        new_w = self._masked(new_w)
        if grad_b is None:
            return new_w, None, new_vw, None, new_aw, None
        new_b, new_vb, new_ab = F.adaptive_update(
            bias, vel_b, acc_b, grad_b, batch_size, lr_b,
            self.momentum, self.weight_decay_bias, self.l1_vs_l2,
            self.gradient_clip, self.solver, self.solver_rho,
            self.solver_epsilon, step)
        return new_w, new_b, new_vw, new_vb, new_aw, new_ab

    def run(self):
        fwd = self.forward
        err_in, grad_w, grad_b = self._bwd(
            self.input.devmem, self.output.devmem, self.err_output.devmem,
            self.weights.devmem,
            fwd.bias.devmem if fwd.include_bias else None, fwd.saved)
        if self.need_err_input:
            self.err_input.assign_device(err_in)
        adaptive = not self.accum_weights.is_empty
        new_w, new_b, new_vw, new_vb, new_aw, new_ab = self._upd(
            self.weights.devmem,
            fwd.bias.devmem if fwd.include_bias else None,
            self.velocity_weights.devmem,
            self.velocity_bias.devmem if fwd.include_bias else None,
            grad_w, grad_b, int(self.batch_size), self.time,
            self.accum_weights.devmem if adaptive else None,
            self.accum_bias.devmem
            if adaptive and fwd.include_bias else None)
        self.time += 1
        fwd.weights.assign_device(new_w)
        self.velocity_weights.assign_device(new_vw)
        if fwd.include_bias:
            fwd.bias.assign_device(new_b)
            self.velocity_bias.assign_device(new_vb)
        if new_aw is not None:
            self.accum_weights.assign_device(new_aw)
            if new_ab is not None:
                self.accum_bias.assign_device(new_ab)
