"""Global dot-access configuration tree.

Copy of ``veles_tpu/config.py`` (jax-free).  The port's ``root`` is its
own tree, separate from the reference package's.

Behavioral parity with the reference config system (ref: veles/config.py
::Config/root/get [H], SURVEY §5.6): config files are plain Python executed
against the global ``root`` tree; any leaf can be overridden from the CLI with
``root.path.to.leaf=value`` tokens; ``Tune`` marks a leaf as a gene for the
genetic hyperparameter optimizer (ref: veles/genetics [H]).
"""

from __future__ import annotations

import ast


class Tune:
    """Marks a config value as tunable by the genetic optimizer.

    Ref: veles/genetics::Tune [H].  ``Tune(0.01, 0.0001, 0.1)`` behaves as its
    ``value`` everywhere except under ``--optimize``, where the optimizer
    searches [minv, maxv].
    """

    def __init__(self, value, minv, maxv):
        self.value = value
        self.minv = minv
        self.maxv = maxv

    def __repr__(self):
        return "Tune(%r, %r, %r)" % (self.value, self.minv, self.maxv)


class Config:
    """A node in the dot-access config tree.

    Accessing an unset attribute creates a child ``Config`` node, so config
    files can write ``root.mnist.loader.minibatch_size = 100`` without
    declaring intermediate nodes.  Use :func:`get` to read leaves with a
    default.
    """

    def __init__(self, path):
        self.__dict__["_path_"] = path

    @property
    def path(self):
        return self.__dict__["_path_"]

    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        child = Config("%s.%s" % (self.path, name))
        self.__dict__[name] = child
        return child

    def __setattr__(self, name, value):
        if isinstance(value, dict):
            node = Config("%s.%s" % (self.path, name))
            node.update(value)
            self.__dict__[name] = node
        else:
            self.__dict__[name] = value

    def update(self, other):
        """Recursively merge a dict or another Config into this node."""
        if isinstance(other, Config):
            other = other.as_dict()
        for key, value in other.items():
            if isinstance(value, dict):
                existing = self.__dict__.get(key)
                if not isinstance(existing, Config):
                    existing = Config("%s.%s" % (self.path, key))
                    self.__dict__[key] = existing
                existing.update(value)
            else:
                setattr(self, key, value)
        return self

    def defaults(self, other):
        """Like update(), but existing leaves win (config-file semantics:
        defaults fill gaps, they never clobber earlier settings)."""
        if isinstance(other, Config):
            other = other.as_dict()
        for key, value in other.items():
            if isinstance(value, dict):
                existing = self.__dict__.get(key)
                if not isinstance(existing, Config):
                    if key in self.__dict__:
                        continue  # an explicit leaf shadows the subtree
                    existing = Config("%s.%s" % (self.path, key))
                    self.__dict__[key] = existing
                existing.defaults(value)
            elif key not in self.__dict__:
                setattr(self, key, value)
        return self

    def as_dict(self):
        out = {}
        for key, value in self.__dict__.items():
            if key == "_path_":
                continue
            out[key] = value.as_dict() if isinstance(value, Config) else value
        return out

    def items(self):
        return self.as_dict().items()

    def __contains__(self, name):
        return name in self.__dict__

    def __repr__(self):
        return "Config(%r: %r)" % (self.path, self.as_dict())

    def print_(self, indent=0, file=None):
        for key, value in sorted(self.__dict__.items()):
            if key == "_path_":
                continue
            if isinstance(value, Config):
                print("%s%s:" % ("  " * indent, key), file=file)
                value.print_(indent + 1, file=file)
            else:
                print("%s%s: %r" % ("  " * indent, key, value), file=file)


def get(value, default=None):
    """Read a config leaf: returns ``default`` for unset nodes, unwraps Tune."""
    if isinstance(value, Config):
        return default
    if isinstance(value, Tune):
        return value.value
    return value


#: The global configuration tree every config file mutates (ref:
#: veles/config.py::root [H]).
root = Config("root")


def parse_override(token, cfg=None):
    """Apply one CLI override token ``root.a.b=value`` to the tree.

    Values are parsed with ``ast.literal_eval`` falling back to string, same
    ergonomics as the reference CLI (ref: veles/__main__.py [H]).
    """
    cfg = cfg if cfg is not None else root
    path, _, raw = token.partition("=")
    if not _:
        raise ValueError("config override must look like root.a.b=value: %r"
                         % token)
    try:
        value = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        value = raw
    parts = path.split(".")
    if parts[0] == "root":
        parts = parts[1:]
    if not parts:
        raise ValueError("cannot override the root node itself")
    node = cfg
    for part in parts[:-1]:
        node = getattr(node, part)
        if not isinstance(node, Config):
            raise ValueError("%s is a leaf, cannot descend into it" % part)
    setattr(node, parts[-1], value)
    return value
