"""Logging setup (port of utils/logging.py): file and console handlers, as
soft_intro_vae_3d/utils/util.py:11-31 and the style launcher's per-rank
logger (launcher.py:52-72) set them up."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def setup_logging(log_dir: Optional[str] = None, name: str = "soft_intro_vae_torch",
                  level: int = logging.INFO, filename: str = "log.txt") -> logging.Logger:
    """The logger ``name`` with a stdout handler, and a ``log_dir/filename``
    handler when ``log_dir`` is given. Calling it again replaces the handlers,
    so they never pile up."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, filename))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger
