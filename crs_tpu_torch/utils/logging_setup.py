"""Central logging configuration (port of ``crs_tpu.utils.logging_setup``).

Presets for development / production / benchmarking / notebooks, plus
suppression of noisy third-party loggers (torch's in place of JAX's).
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

__all__ = [
    "setup_logging",
    "setup_for_development",
    "setup_for_production",
    "setup_for_benchmarking",
    "setup_for_notebook",
]

_NOISY_LIBRARIES = [
    "torch",
    "torch._dynamo",
    "torch._inductor",
    "torch.distributed",
    "urllib3",
    "filelock",
    "fsspec",
    "matplotlib",
    "PIL",
]


def setup_logging(
    level: int = logging.INFO,
    log_file: Optional[str] = None,
    fmt: str = "%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    suppress_libraries: bool = True,
) -> logging.Logger:
    """Configure the root logger; returns it."""
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
    formatter = logging.Formatter(fmt)
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(formatter)
    root.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(formatter)
        root.addHandler(fh)
    if suppress_libraries:
        for name in _NOISY_LIBRARIES:
            logging.getLogger(name).setLevel(logging.WARNING)
    return root


def setup_for_development() -> logging.Logger:
    return setup_logging(level=logging.DEBUG)


def setup_for_production(log_file: Optional[str] = None) -> logging.Logger:
    return setup_logging(level=logging.WARNING, log_file=log_file)


def setup_for_benchmarking(log_file: Optional[str] = None) -> logging.Logger:
    """INFO to the console, and to ``log_file`` when one is given."""
    return setup_logging(level=logging.INFO, log_file=log_file)


def setup_for_notebook() -> logging.Logger:
    """Compact format for notebooks."""
    return setup_logging(level=logging.INFO, fmt="%(levelname)s %(message)s")
