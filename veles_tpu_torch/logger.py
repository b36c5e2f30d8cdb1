"""Logging mixin used by every framework object.

Port of ``veles_tpu/logger.py``: per-class log channels under the
``veles`` namespace with ``self.info/debug/warning/error`` and a colored
console formatter, and the reference's structured event sinks: the
JSON-lines file (``JsonLinesHandler``) and MongoDB (``MongoHandler``,
gated on ``pymongo`` being importable; it raises when built without it).
Both write the one event dict of ``_event_dict``.
"""

from __future__ import annotations

import json
import logging
import sys

_COLORS = {
    logging.DEBUG: "\033[37m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[1;31m",
}
_RESET = "\033[0m"

#: all framework loggers live under this namespace so configuring them
#: never disturbs the host application's root logging setup
NAMESPACE = "veles"


class ColoredFormatter(logging.Formatter):
    def format(self, record):
        message = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelno, "")
            return "%s%s%s" % (color, message, _RESET)
        return message


def _event_dict(record):
    """The one structured-event schema both sinks write.  ``t`` is the
    moment the event was logged (``record.created``), not written: a
    slow sink must not skew timestamps."""
    return {
        "t": record.created,
        "level": record.levelname,
        "logger": record.name,
        "msg": record.getMessage(),
    }


class JsonLinesHandler(logging.Handler):
    """Append-only structured event sink: one JSON object a line."""

    def __init__(self, path):
        super().__init__()
        self._file = open(path, "a", encoding="utf-8")

    def emit(self, record):
        try:
            self._file.write(json.dumps(_event_dict(record)) + "\n")
            self._file.flush()
        except Exception:  # never raise from logging
            self.handleError(record)

    def close(self):
        try:
            self._file.close()
        finally:
            super().close()


class MongoHandler(logging.Handler):
    """MongoDB event sink: the same event dicts, inserted into
    ``<db>.<collection>`` by a daemon thread (a server outage never
    blocks a log call, which holds the handler's lock).

    Needs ``pymongo``: without it, building the handler raises
    ``RuntimeError`` (never a log call), as does an unreachable server
    (a ping with a short server-selection timeout)."""

    def __init__(self, address, db="veles", collection="events",
                 timeout_ms=2000):
        super().__init__()
        try:
            import pymongo
        except ImportError as e:
            raise RuntimeError(
                "MongoDB log sink requires the 'pymongo' package, which is "
                "not installed in this environment; use the JSON-lines "
                "events file sink instead (setup_logging(events_file=...))"
            ) from e
        self._client = pymongo.MongoClient(
            address, serverSelectionTimeoutMS=timeout_ms)
        try:
            self._client.admin.command("ping")
        except Exception as e:
            self._client.close()
            raise RuntimeError(
                "MongoDB log sink cannot reach %s: %s" % (address, e)) from e
        self._coll = self._client[db][collection]
        import queue
        import threading
        self._queue = queue.SimpleQueue()
        self._closed = False
        self._drain = threading.Thread(target=self._drain_loop, daemon=True)
        self._drain.start()

    def _drain_loop(self):
        while True:
            event = self._queue.get()
            if event is None:
                return
            try:
                self._coll.insert_one(event)
            except Exception:  # a sink outage drops the event
                pass

    def emit(self, record):
        try:
            self._queue.put(_event_dict(record))
        except Exception:  # never raise from logging
            self.handleError(record)

    def close(self):
        try:
            if not self._closed:
                self._closed = True
                self._queue.put(None)
                self._drain.join(timeout=2)
                self._client.close()
        finally:
            super().close()


class _State:
    """setup_logging's bookkeeping: whether it ran, and the handlers it
    installed (the only ones it may remove on reconfiguration)."""
    configured = False
    installed = []


def setup_logging(level=logging.INFO, events_file=None, events_mongo=None):
    """Configure the framework's logger namespace (NOT the root
    logger): one colored stderr handler, plus the JSON-lines sink when
    ``events_file`` is given and the Mongo sink when ``events_mongo``
    (a ``mongodb://`` address) is; both may be given.  A second call
    closes only the handlers the first installed."""
    base = logging.getLogger(NAMESPACE)
    for old in _State.installed:
        if old in base.handlers:
            base.removeHandler(old)
            old.close()
    _State.installed = []
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(ColoredFormatter(
        "%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S"))
    installed = [handler]
    if events_file:
        installed.append(JsonLinesHandler(events_file))
    if events_mongo:
        try:
            installed.append(MongoHandler(events_mongo))
        except RuntimeError:
            for h in installed[1:]:
                h.close()
            raise
    for h in installed:
        base.addHandler(h)
    base.setLevel(level)
    base.propagate = False
    _State.installed = installed
    _State.configured = True


class Logger:
    """Mixin granting named logging channels to any class."""

    @property
    def logger(self):
        logger = getattr(self, "_logger_", None)
        if logger is None:
            if not _State.configured:
                setup_logging()
            name = getattr(self, "name", None) or type(self).__name__
            channel = ("%s.%s" % (type(self).__name__, name)
                       if name != type(self).__name__ else name)
            logger = logging.getLogger("%s.%s" % (NAMESPACE, channel))
            self._logger_ = logger
        return logger

    def debug(self, msg, *args):
        self.logger.debug(msg, *args)

    def info(self, msg, *args):
        self.logger.info(msg, *args)

    def warning(self, msg, *args):
        self.logger.warning(msg, *args)

    def error(self, msg, *args):
        self.logger.error(msg, *args)

    def exception(self, msg, *args):
        self.logger.exception(msg, *args)
