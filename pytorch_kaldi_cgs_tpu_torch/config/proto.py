"""Config helpers (the port's copy of the parts of the JAX package's
``config/proto.py`` that the training step uses).

``.proto`` files are INI files whose values are field types; this
package ships its own ``proto/`` directory, and :func:`resolve_proto`
looks there, never in the JAX package's.
"""

from __future__ import annotations

import os

PROTO_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "proto")


class ConfigError(ValueError):
    pass


def strtobool(s) -> bool:
    if isinstance(s, bool):
        return s
    v = str(s).strip().lower()
    if v in ("true", "1", "yes", "on"):
        return True
    if v in ("false", "0", "no", "off"):
        return False
    raise ConfigError("invalid boolean %r" % s)


def resolve_proto(path: str) -> str:
    """A proto path as given, else by its base name in this package's
    ``proto/`` directory (so configs can say ``proto/model.proto``)."""
    if os.path.isfile(path):
        return path
    cand = os.path.join(PROTO_DIR, os.path.basename(path))
    if os.path.isfile(cand):
        return cand
    raise ConfigError("proto file %r not found (also tried %s)" % (path, cand))
