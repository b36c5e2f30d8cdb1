"""Mutable booleans for graph gates and attribute aliasing.

Copy of ``veles_tpu/mutable.py`` (jax-free; the port keeps its own copy).

Ref: veles/mutable.py::Bool/LinkableAttribute [H] (SURVEY §2.1).  ``Bool`` is
a shared mutable flag composable with ``&``, ``|``, ``~`` into lazily
evaluated expressions — workflow control edges are gated on these, so flipping
one flag (e.g. ``decision.complete``) reroutes the graph without rebuilding
it.
"""

from __future__ import annotations


class Bool:
    """Mutable boolean usable as a gate condition.

    Derived Bools (from ``&``, ``|``, ``~``) re-evaluate their sources on
    every truth test, so they always see the current value of the underlying
    flags.
    """

    __slots__ = ("_value", "_expr", "_sources")

    def __init__(self, value=False):
        self._value = bool(value)
        self._expr = None
        self._sources = ()

    @classmethod
    def _derived(cls, expr, sources):
        b = cls()
        b._expr = expr
        b._sources = tuple(sources)
        return b

    @property
    def derived(self):
        return self._expr is not None

    def __bool__(self):
        if self._expr is not None:
            return self._expr(*[bool(s) for s in self._sources])
        return self._value

    def __ilshift__(self, value):
        """``b <<= True`` assigns; mirrors the reference's assignment idiom."""
        if self._expr is not None:
            raise ValueError("cannot assign to a derived Bool expression")
        self._value = bool(value)
        return self

    def set(self, value=True):
        if self._expr is not None:
            raise ValueError("cannot assign to a derived Bool expression")
        self._value = bool(value)

    def unset(self):
        self.set(False)

    def __and__(self, other):
        other = other if isinstance(other, Bool) else Bool(other)
        return Bool._derived(lambda a, b: a and b, (self, other))

    def __or__(self, other):
        other = other if isinstance(other, Bool) else Bool(other)
        return Bool._derived(lambda a, b: a or b, (self, other))

    def __invert__(self):
        return Bool._derived(lambda a: not a, (self,))

    def __repr__(self):
        kind = "derived " if self.derived else ""
        return "<%sBool: %s>" % (kind, bool(self))


class LinkableAttribute:
    """Descriptor record for an aliased attribute.

    ``unit_a.link_attrs(unit_b, "x")`` makes ``unit_a.x`` transparently read
    (and write, when two_way) ``unit_b.x`` — the reference's data-flow edge
    (ref: veles/mutable.py::LinkableAttribute [H]).  The actual forwarding is
    implemented in :class:`veles_tpu_torch.units.Unit` via ``__getattr__`` /
    ``__setattr__`` consulting the unit's ``_linked_attrs_`` table; this class
    is the table entry.
    """

    __slots__ = ("target", "target_name", "two_way")

    def __init__(self, target, target_name, two_way=True):
        self.target = target
        self.target_name = target_name
        self.two_way = two_way

    def get(self):
        return getattr(self.target, self.target_name)

    def set(self, value):
        setattr(self.target, self.target_name, value)

    def __repr__(self):
        return "LinkableAttribute(-> %s.%s)" % (
            getattr(self.target, "name", self.target), self.target_name)
