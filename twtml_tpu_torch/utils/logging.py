"""Logging setup (counterpart of ``twtml_tpu/utils/logging.py``): the root
logger at WARNING to stderr, the package's own loggers at ``TWTML_LOG``
(default INFO)."""

from __future__ import annotations

import logging
import os
import sys

ROOT = "twtml_tpu_torch"
_CONFIGURED = False


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    root = logging.getLogger()
    if not root.handlers:
        root.addHandler(handler)
        root.setLevel(logging.WARNING)
    level = os.environ.get("TWTML_LOG", "INFO").upper()
    logging.getLogger(ROOT).setLevel(getattr(logging, level, logging.INFO))
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
