"""Unit — the dataflow-graph node every framework component derives from.

Port of ``veles_tpu/units.py`` (jax-free there too).  One addition: a
unit's ``initialize(device=...)`` binds every :class:`Vector` it owns to
that device, so a Vector uploads to the device of the unit that owns it
(there is no process-wide default device).

Ref: veles/units.py::Unit/TrivialUnit/UnitRegistry [H] (SURVEY §2.1).
Behavioral contract honored here:

- **control links**: ``b.link_from(a)`` means "b becomes runnable after a
  fires".  A unit with several incoming links waits for ALL of them (AND
  semantics, marks reset after opening) — except ``Repeater`` which ORs
  (that's what closes the training cycle).
- **gates**: ``gate_block`` (don't run, don't propagate) and ``gate_skip``
  (don't run, do propagate) are mutable ``Bool`` expressions evaluated at
  fire time.
- **data links**: ``b.link_attrs(a, "x", ("my_y", "their_y"))`` aliases
  attributes — reads/writes on ``b.x`` hit ``a.x``.
- **lifecycle**: ``initialize(**kwargs)`` once before the run (device
  resources, shape inference), ``run()`` per firing, ``stop()`` on teardown.
"""

from __future__ import annotations

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.mutable import Bool, LinkableAttribute


class UnitRegistry(type):
    """Metaclass keeping a registry of all Unit classes.

    Ref: veles/units.py::UnitRegistry [H] — the reference uses it for CLI
    listing and workflow deserialization; we use it for snapshot restore and
    the web-status inventory.  Keyed by qualified ``module.ClassName`` (bare
    names collide across modules); classes setting ``hide_from_registry``
    are excluded.
    """

    units = {}

    def __init__(cls, name, bases, namespace):
        super().__init__(name, bases, namespace)
        if not namespace.get("hide_from_registry", False):
            UnitRegistry.units["%s.%s" % (cls.__module__, name)] = cls


class IUnit:
    """Documented interface every unit satisfies (ref: veles/units.py::IUnit)."""

    def initialize(self, **kwargs):
        raise NotImplementedError

    def run(self):
        raise NotImplementedError


class Unit(Logger, metaclass=UnitRegistry):
    hide_from_registry = False

    def __init__(self, workflow, name=None, **kwargs):
        self.name = name or type(self).__name__
        self._links_from = {}   # Unit -> fired flag (AND-joined)
        self._links_to = []     # ordered successors
        self.gate_block = Bool(False)
        self.gate_skip = Bool(False)
        self._linked_attrs_ = {}
        self.workflow = None
        self._initialized = False
        self.run_count = 0
        self.run_time = 0.0     # cumulative seconds in run() (SURVEY §5.1)
        if workflow is not None:
            workflow.add_ref(self)

    # ------------------------------------------------------------------ graph
    @property
    def links_from(self):
        return self._links_from

    @property
    def links_to(self):
        return self._links_to

    def link_from(self, *units):
        """Add control edges: self runs after each of ``units`` fires."""
        for unit in units:
            if unit is self:
                raise ValueError("%s cannot link from itself" % self.name)
            if unit not in self._links_from:
                self._links_from[unit] = False
                unit._links_to.append(self)
        return self

    def unlink_from(self, *units):
        for unit in units:
            if unit in self._links_from:
                del self._links_from[unit]
                unit._links_to.remove(self)
        return self

    def unlink_all(self):
        for unit in list(self._links_from):
            self.unlink_from(unit)
        for unit in list(self._links_to):
            unit.unlink_from(self)
        return self

    def open_gate(self, src):
        """Mark the incoming edge from ``src`` fired; True when ready to run.

        AND semantics with reset-on-open, mirroring the reference's
        ``Unit.open_gate`` [H].
        """
        if src is not None and src in self._links_from:
            self._links_from[src] = True
        if not all(self._links_from.values()):
            return False
        for unit in self._links_from:
            self._links_from[unit] = False
        return True

    # ------------------------------------------------------------- data links
    def link_attrs(self, other, *attrs, two_way=True):
        """Alias attributes of ``other`` onto self.

        Each entry is either a name (same on both sides) or a
        ``(my_name, other_name)`` pair — identical ergonomics to the
        reference (ref: veles/units.py::Unit.link_attrs [H]).
        """
        for attr in attrs:
            if isinstance(attr, tuple):
                mine, theirs = attr
            else:
                mine = theirs = attr
            # Drop any locally shadowing value so the alias takes effect.
            self.__dict__.pop(mine, None)
            self._linked_attrs_[mine] = LinkableAttribute(
                other, theirs, two_way=two_way)
        return self

    def unlink_attrs(self, *names):
        for name in names:
            self._linked_attrs_.pop(name, None)
        return self

    def __getattribute__(self, name):
        # Linked attributes win over everything (including class-level
        # defaults, which plain __getattr__ fallback would let shadow the
        # alias).  Names starting with "_" can never be linked, keeping the
        # common internal lookups on the fast path.
        if not name.startswith("_"):
            linked = object.__getattribute__(self, "__dict__").get(
                "_linked_attrs_")
            if linked:
                entry = linked.get(name)
                if entry is not None:
                    return entry.get()
        return object.__getattribute__(self, name)

    def __getattr__(self, name):
        raise AttributeError("%s has no attribute %r" %
                             (type(self).__name__, name))

    def __setattr__(self, name, value):
        linked = self.__dict__.get("_linked_attrs_", {}).get(name)
        if linked is not None:
            if linked.two_way:
                linked.set(value)
                return
            # one-way link: writing locally severs the alias
            del self._linked_attrs_[name]
        object.__setattr__(self, name, value)

    # -------------------------------------------------------------- lifecycle
    @property
    def is_initialized(self):
        return self._initialized

    def initialize(self, device=None, **kwargs):
        """Prepare to run (allocate, infer shapes).  Idempotent per init
        pass.  Binds the Vectors this unit owns (not the ones it links
        from another unit) to ``device``."""
        if device is not None:
            from veles_tpu_torch.memory import Vector
            for value in list(self.__dict__.values()):
                if isinstance(value, Vector):
                    value.device = device
        self._initialized = True

    def run(self):
        pass

    def stop(self):
        pass

    def is_train_minibatch(self):
        """True when the CURRENT minibatch should train: the linked
        ``minibatch_class`` says TRAIN and the workflow is not in
        evaluation-only mode (``wf.eval_only``).  The one gate every
        updating unit consults, so a scoring pass never moves
        parameters."""
        from veles_tpu_torch.loader.base import TRAIN
        if getattr(self.workflow, "eval_only", False):
            return False
        return getattr(self, "minibatch_class", TRAIN) == TRAIN

    # --------------------------------------------------------------- snapshot
    #: attribute names persisted by the Snapshotter (subclasses extend)
    snapshot_attrs = ()

    def state_dict(self):
        from veles_tpu_torch.memory import Vector
        out = {}
        for attr in self.snapshot_attrs:
            value = getattr(self, attr, None)
            if isinstance(value, Vector):
                value = ("__vector__", value.to_numpy())
            elif isinstance(value, Bool):
                value = ("__bool__", bool(value))
            out[attr] = value
        return out

    def load_state_dict(self, d):
        from veles_tpu_torch.memory import Vector
        for attr, value in d.items():
            if isinstance(value, tuple) and len(value) == 2 and \
                    value[0] in ("__vector__", "__bool__"):
                kind, payload = value
                if kind == "__vector__":
                    current = getattr(self, attr, None)
                    if isinstance(current, Vector):
                        current.reset(payload)
                    else:
                        setattr(self, attr, Vector(payload))
                else:
                    gate = getattr(self, attr, None)
                    if isinstance(gate, Bool) and not gate.derived:
                        gate.set(payload)
                continue
            setattr(self, attr, value)

    def __repr__(self):
        return "<%s %r>" % (type(self).__name__, self.name)


class TrivialUnit(Unit):
    """A unit whose run is a no-op — pure control-flow node."""

    def initialize(self, device=None, **kwargs):
        super().initialize(device=device, **kwargs)

    def run(self):
        pass
