"""Per-process, per-component logging with a verbosity flag
(counterpart: janus_tpu/utils/log.py).

Reference: the reference threads an ILogger with a numeric verbosity
through every constructor and names loggers per node
(BFT-CRDT/Globals.cs:16-49, Program.cs:12-14). Here components get stdlib
loggers under the ``janus`` root ("janus.splitnode.pnc", "janus.peer.a"),
configured once per process by ``configure``. Receive threads log their
failure context (peer identity, cause) instead of dying silently.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "off": logging.CRITICAL + 10,
}


def get_logger(component: str, sub: Optional[object] = None) -> logging.Logger:
    """Component logger: ``janus.<component>[.<sub>]`` — ``sub`` names
    the process/node/type instance (the reference's per-node logger
    naming, Globals.cs:16-49)."""
    name = f"janus.{component}"
    if sub is not None:
        name += f".{sub}"
    return logging.getLogger(name)


def configure(level: str = "info", proc: Optional[str] = None) -> None:
    """Configure the ``janus`` logger tree for this process: one stderr
    handler, ``[pid/proc] component: message`` lines, numeric verbosity
    by name (debug|info|warning|error|off). Idempotent; later calls
    re-level."""
    root = logging.getLogger("janus")
    lvl = LEVELS.get(str(level).lower())
    if lvl is None:
        raise ValueError(f"unknown log level {level!r} "
                         f"(choose from {sorted(LEVELS)})")
    tag = proc if proc is not None else str(os.getpid())
    if not root.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            f"%(asctime)s %(levelname).1s [{tag}] %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        root.addHandler(h)
        root.propagate = False
    root.setLevel(lvl)
