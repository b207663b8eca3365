"""Leveled, per-concern rotating loggers (reference: internal/dflog).

Port of ``dragonfly2_tpu/utils/dflog.py``; handlers attach to the
``dragonfly2_tpu_torch`` package tree.

The reference writes separate rotating files per concern (core, grpc, gc,
job, storage — logcore.go) with an optional ``--console`` override
(cmd/dependency).  ``setup()`` configures the same shape on the stdlib
logging tree: concern loggers are children of ``dragonfly.<concern>`` with
their own rotating file handlers.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Dict, Optional

CONCERNS = ("core", "grpc", "gc", "job", "storage", "training")

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

_configured: Dict[str, bool] = {}


def setup(
    *,
    level: str = "info",
    log_dir: Optional[str] = None,
    console: bool = False,
    max_bytes: int = 50 << 20,
    backups: int = 5,
    service: str = "dragonfly",
) -> None:
    """Configure the package logger tree. Idempotent per service.

    Handlers attach to the ``dragonfly2_tpu_torch`` package tree — that is
    where every module logger (``logging.getLogger(__name__)``) actually
    lives.  Attaching to a logger named after the service ("trainer")
    captured NOTHING from the modules doing the work; ``service`` now
    only names the log files."""
    if _configured.get(service):
        return
    _configured[service] = True
    root = logging.getLogger("dragonfly2_tpu_torch")
    root.setLevel(_LEVELS.get(level, logging.INFO))
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)-7s %(name)s: %(message)s"
    )
    if console or not log_dir:
        h = logging.StreamHandler()
        h.setFormatter(fmt)
        root.addHandler(h)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        core = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, f"{service}-core.log"),
            maxBytes=max_bytes,
            backupCount=backups,
        )
        core.setFormatter(fmt)
        root.addHandler(core)
        for concern in CONCERNS[1:]:
            lg = logging.getLogger(f"{service}.{concern}")
            fh = logging.handlers.RotatingFileHandler(
                os.path.join(log_dir, f"{service}-{concern}.log"),
                maxBytes=max_bytes,
                backupCount=backups,
            )
            fh.setFormatter(fmt)
            lg.addHandler(fh)


def get(concern: str = "core", service: str = "dragonfly") -> logging.Logger:
    if concern == "core":
        return logging.getLogger(service)
    return logging.getLogger(f"{service}.{concern}")
