"""Logging setup: a console handler and a per-run ``run.log``.

The port of ``gsc_tpu.utils.logging``: one console handler on the
package logger ``gsc_tpu_torch`` (INFO, DEBUG with ``verbose``), quieter
simulator and env modules, and an optional file handler in the run's
result directory.  Repeated calls replace the handlers an earlier call
added rather than stack them.  Unlike the JAX package's, it leaves the
logger's propagation to the root logger as it is, so handlers a host
program put on the root (a test's log capture) keep seeing the records.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
# marks the handlers this module added
_MARK = "_gsc_tpu_torch_setup"
_MODULE_LEVELS = {
    "gsc_tpu_torch.sim": logging.WARNING,
    "gsc_tpu_torch.env": logging.WARNING,
}


def setup_logging(verbose: bool = False,
                  logfile: Optional[str] = None) -> logging.Logger:
    """Configure the ``gsc_tpu_torch`` logger tree; returns its root."""
    logger = logging.getLogger("gsc_tpu_torch")
    logger.setLevel(logging.DEBUG)
    for h in [h for h in logger.handlers if getattr(h, _MARK, False)]:
        logger.removeHandler(h)
        h.close()
    console = logging.StreamHandler()
    setattr(console, _MARK, True)
    console.setLevel(logging.DEBUG if verbose else logging.INFO)
    console.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(console)
    for name, level in _MODULE_LEVELS.items():
        logging.getLogger(name).setLevel(logging.DEBUG if verbose else level)
    if logfile:
        os.makedirs(os.path.dirname(os.path.realpath(logfile)),
                    exist_ok=True)
        fh = logging.FileHandler(logfile, mode="a")
        setattr(fh, _MARK, True)
        fh.setFormatter(logging.Formatter(_FORMAT))
        fh.setLevel(logging.DEBUG if verbose else logging.INFO)
        logger.addHandler(fh)
    return logger
