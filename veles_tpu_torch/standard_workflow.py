"""StandardWorkflow — the config→graph compiler.

Port of ``veles_tpu/standard_workflow.py`` (ref: veles/znicz/
standard_workflow.py::StandardWorkflow [H]): builds the full training
graph (loader → forwards → evaluator → decision → gds → repeater cycle)
from a declarative ``layers`` list like::

    [{"type": "all2all_tanh", "->": {"output_sample_shape": 100},
                              "<-": {"learning_rate": 0.03}},
     {"type": "softmax",      "->": {"output_sample_shape": 10},
                              "<-": {"learning_rate": 0.03}}]

Flat keys are also accepted (merged into "->"/"<-" by ownership).

Execution: the classic unit graph runs under the host scheduler (unit mode).
When ``fused=True`` (default) the accelerated segment (forwards + evaluator +
gds) runs as one train/eval step call per minibatch
(``veles_tpu_torch.compiled``) instead of the individual unit runs — same
numerics (identical pure functions).  Skip-edge layers (``residual``,
``residual_proj``) need the fused engine: a ``fused=False`` build with
one raises ValueError.  The Snapshotter and the plotters are
not ported yet and raise (ROADMAP Queue 2a, items 4 and 5).
"""

from __future__ import annotations

import inspect

from veles_tpu_torch.config import get
from veles_tpu_torch.workflow import Repeater
# importing the ops package registers every layer type
from veles_tpu_torch.ops.nn_units import (NNWorkflow, LAYER_TYPES,
                                          gd_class_for)
from veles_tpu_torch.ops.evaluator import EvaluatorSoftmax, EvaluatorMSE
from veles_tpu_torch.ops.decision import DecisionGD, DecisionMSE

# keys that are never user-routable (wired by the builder itself)
_RESERVED = {"self", "workflow", "forward", "need_err_input", "name"}


def _accepted_keys(cls):
    """Config keys a unit class accepts, from its __init__ chain."""
    keys = set()
    for klass in cls.__mro__:
        if klass is object:
            break
        init = klass.__dict__.get("__init__")
        if init is None:
            continue
        for pname, param in inspect.signature(init).parameters.items():
            if pname in _RESERVED or param.kind in (
                    param.VAR_KEYWORD, param.VAR_POSITIONAL):
                continue
            keys.add(pname)
    return keys


def parse_layer(layer):
    """Split one layer config dict into (type, fwd_kwargs, gd_kwargs).

    Flat keys are routed by introspecting which unit class accepts them
    (forward wins ties); explicit "->"/"<-" sub-dicts bypass routing — the
    reference's layer config shape (ref: veles/znicz/standard_workflow.py
    [H]).
    """
    layer = dict(layer)
    kind = layer.pop("type")
    cls = LAYER_TYPES.get(kind)
    if cls is None:
        raise ValueError("unknown layer type %r (known: %s)" %
                         (kind, ", ".join(sorted(LAYER_TYPES))))
    fwd = dict(layer.pop("->", {}))
    gd = dict(layer.pop("<-", {}))
    fwd_keys = _accepted_keys(cls)
    gd_keys = _accepted_keys(gd_class_for(cls))
    for key, value in layer.items():
        if key in fwd_keys:
            fwd[key] = get(value, value)
        elif key in gd_keys:
            gd[key] = get(value, value)
        else:
            raise ValueError(
                "layer type %r does not accept config key %r "
                "(forward keys: %s; gd keys: %s)" %
                (kind, key, ", ".join(sorted(fwd_keys)),
                 ", ".join(sorted(gd_keys - fwd_keys))))
    return kind, cls, fwd, gd


class StandardWorkflowBase(NNWorkflow):
    """Builds the standard supervised-training graph from config."""

    def __init__(self, workflow=None, name=None, loader_factory=None,
                 loader_config=None, layers=(), decision_config=None,
                 snapshotter_config=None, loss_function="softmax", fused=True,
                 grad_accum=1, **kwargs):
        super().__init__(workflow, name=name, **kwargs)
        self.layers_config = list(layers)
        self.loss_function = loss_function
        self.fused = fused
        #: microbatches per optimizer step (fused mode; see FusedRunner)
        self.grad_accum = grad_accum
        if grad_accum != 1 and not fused:
            # never drop an explicit setting silently
            self.warning("grad_accum=%s is inert in unit (non-fused) "
                         "mode — the per-unit path dispatches whole "
                         "minibatches", grad_accum)
        skip_kinds = sorted({layer.get("type") for layer in self.layers_config
                             if layer.get("type") in ("residual",
                                                      "residual_proj")})
        if not fused and skip_kinds:
            raise ValueError(
                "layer type(s) %s need the fused engine (a skip edge "
                "cannot ride the per-unit err chain) — build with "
                "fused=True" % ", ".join("'%s'" % k for k in skip_kinds))
        self.snapshotter = None
        self._build(loader_factory, dict(loader_config or {}),
                    dict(decision_config or {}), snapshotter_config)

    # ------------------------------------------------------------------ build
    def _build(self, loader_factory, loader_config, decision_config,
               snapshotter_config):
        if loader_factory is None:
            raise ValueError("loader_factory is required")
        self.repeater = Repeater(self, name="repeater")
        self.repeater.link_from(self.start_point)

        self.loader = loader_factory(self, name="loader", **loader_config)
        self.loader.link_from(self.repeater)

        self.link_forwards()
        self.link_evaluator()
        self.link_decision(decision_config)
        self.link_gds()
        if snapshotter_config is not None:
            self.link_snapshotter(dict(snapshotter_config))
        self.link_end_point()

    def link_forwards(self):
        prev = None
        for layer in self.layers_config:
            kind, cls, fwd_kwargs, _ = parse_layer(layer)
            unit = cls(self, **fwd_kwargs)
            if prev is None:
                unit.link_from(self.loader)
                unit.link_attrs(self.loader, ("input", "minibatch_data"))
            else:
                unit.link_from(prev)
                unit.link_attrs(prev, ("input", "output"))
            if getattr(unit, "IS_RESIDUAL_PROJ", False):
                # the projection's weights take their shape from the SKIP
                # source: acts[src], the output of layer src - 1, or the
                # loader's data for src 0
                src = len(self.forwards) - unit.skip
                if src < 0:
                    raise ValueError(
                        "residual_proj at layer %d skips %d back — "
                        "before the chain input"
                        % (len(self.forwards), unit.skip))
                if src == 0:
                    unit.link_attrs(self.loader,
                                    ("skip_input", "minibatch_data"))
                else:
                    unit.link_attrs(self.forwards[src - 1],
                                    ("skip_input", "output"))
            self.forwards.append(unit)
            prev = unit

    def link_evaluator(self):
        last = self.forwards[-1]
        if self.loss_function == "softmax":
            ev = EvaluatorSoftmax(self, name="evaluator")
            ev.link_attrs(self.loader, ("labels", "minibatch_labels"),
                          ("mask", "minibatch_mask"))
        elif self.loss_function == "mse":
            ev = EvaluatorMSE(self, name="evaluator")
            ev.link_attrs(self.loader, ("target", "minibatch_data"),
                          ("mask", "minibatch_mask"))
        else:
            raise ValueError("unknown loss_function %r" % self.loss_function)
        ev.link_from(last)
        ev.link_attrs(last, "output")
        self.evaluator = ev

    def link_decision(self, decision_config):
        cls = DecisionGD if self.loss_function == "softmax" else DecisionMSE
        dec = cls(self, name="decision", **decision_config)
        dec.link_from(self.evaluator)
        dec.link_attrs(self.loader, "minibatch_class", "minibatch_size",
                       "last_minibatch", "class_lengths", "epoch_number")
        dec.link_attrs(self.evaluator, "metrics")
        self.decision = dec

    def link_gds(self):
        """Backward chain in reverse layer order, closing the cycle."""
        prev_gd = None
        # err_input is only needed by gds BELOW; everything at or before the
        # first parameterized layer can skip that GEMM/conv (the reference's
        # need_err_input flag, extended past leading weightless layers like
        # augmentation/normalization)
        first_param = next(
            (i for i, f in enumerate(self.forwards) if f.has_params),
            len(self.forwards))
        for fwd in reversed(self.forwards):
            idx = self.forwards.index(fwd)
            _, _, _, gd_kwargs = parse_layer(self.layers_config[idx])
            gd_cls = gd_class_for(fwd)
            gd = gd_cls(self, forward=fwd,
                        need_err_input=idx > first_param,
                        **gd_kwargs)
            if prev_gd is None:
                gd.link_from(self.decision)
                gd.link_attrs(self.evaluator, "err_output")
            else:
                gd.link_from(prev_gd)
                gd.link_attrs(prev_gd, ("err_output", "err_input"))
            gd.link_attrs(self.loader, ("batch_size", "minibatch_size"))
            gd.gate_skip = self.decision.gd_skip | self.decision.complete
            self.gds.insert(0, gd)
            prev_gd = gd
        self.repeater.link_from(prev_gd if prev_gd is not None
                                else self.decision)

    def link_snapshotter(self, config):
        raise NotImplementedError(
            "the Snapshotter is not ported yet: ROADMAP Queue 2a, item 4")

    def link_plotters(self, output_dir="plots", weights_2d=True):
        raise NotImplementedError(
            "the plotters are not ported yet: ROADMAP Queue 2a, item 5")

    def link_end_point(self):
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete

    # ------------------------------------------------------------------ fused
    def initialize(self, device=None, **kwargs):
        from veles_tpu_torch.ops import functional as F
        if F.get_matmul_precision() == "float32":
            F.pin_fp32_matmul()          # the parity mode: TF32 off
        super().initialize(device=device, **kwargs)
        if self.fused:
            runner = getattr(self, "_fused_runner", None)
            if runner is None:
                from veles_tpu_torch.compiled import FusedRunner
                self._fused_runner = FusedRunner(
                    self, grad_accum=self.grad_accum)
                self._fused_runner.install()
            else:
                # re-initialize (e.g. initialize() then Launcher.boot):
                # a second install() would add a DUPLICATE FusedStep
                # whose stale runner re-dispatches every minibatch with
                # frozen weights and clobbers the metrics — keep the
                # installed graph and just refresh the device state
                # from the (possibly re-initialized) unit Vectors
                runner.state = runner._pull_state()
        return self

    def snapshot_state(self):
        # during a fused run the unit Vectors lag the device state; sync
        # before collecting so snapshots always see the live weights
        runner = getattr(self, "_fused_runner", None)
        if runner is not None:
            runner.sync_to_units()
        return super().snapshot_state()

    def load_snapshot_state(self, state):
        super().load_snapshot_state(state)
        # restored weights live in the unit Vectors; refresh the fused
        # runner's device state so the next step trains from them
        runner = getattr(self, "_fused_runner", None)
        if runner is not None:
            runner.state = runner._pull_state()
        # fine-tune semantics: a snapshot taken at completion restores
        # complete=True, but the CURRENT config may allow more epochs
        # (--snapshot with a raised max_epochs, ref resume ergonomics) —
        # re-evaluate the stopping condition against the current limits
        dec = self.decision
        if dec is not None and bool(dec.complete):
            if not dec.reevaluate_complete(int(self.loader.epoch_number)):
                dec.complete.set(False)


class StandardWorkflow(StandardWorkflowBase):
    """The user-facing standard workflow (reference class name parity)."""
