"""Filesystem and logging helpers (counterpart of
`dualpixelface_tpu/utils/file_manager.py`; ref src/utils/file_manager.py:39-119):
`error_handler`, `makedir_custom` and `setup_logger`. `tensor2numpy` is in
`utils/__init__.py`.
"""
from __future__ import annotations

import logging
import os
import sys
from pathlib import Path


def error_handler(condition: bool, message: str = "", name: str = "", raise_error: bool = True):
    """Assert-style guard (ref src/utils/file_manager.py:55-71): raises a
    RuntimeError, or prints to stderr, when `condition` is false."""
    if condition:
        return
    text = f"[{name}] {message}" if name else message
    if raise_error:
        raise RuntimeError(text)
    print(text, file=sys.stderr)


def makedir_custom(path, exist_ok: bool = True) -> Path:
    """mkdir -p returning the Path (ref file_manager.py:74-90)."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=exist_ok)
    return p


def setup_logger(name: str, log_file: str, level=logging.INFO) -> logging.Logger:
    """File + stream logger (ref file_manager.py:109-119). Each log file
    gets its own file handler, so a second workspace in one process writes
    its own `log_text.txt`; the stream handler is added once."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    formatter = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    path = os.path.abspath(log_file)
    if not any(getattr(h, "baseFilename", None) == path for h in logger.handlers):
        fh = logging.FileHandler(path)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    return logger
