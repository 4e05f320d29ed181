"""Logging: stdlib logging configured once per process.

A copy of ``xrnerf_tpu/utils/logger.py``. Only rank 0 of an initialised
``torch.distributed`` group logs at the requested level; other ranks log
errors only.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

from ..parallel.mesh import is_main

_INITIALIZED: set[str] = set()


def get_logger(
    name: str = "xrnerf_torch",
    log_file: Optional[str] = None,
    level: int = logging.INFO,
) -> logging.Logger:
    logger = logging.getLogger(name)
    if name in _INITIALIZED:
        return logger

    main = is_main()
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stdout)]
    if log_file is not None and main:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        handlers.append(logging.FileHandler(log_file, "a"))

    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.setLevel(level if main else logging.ERROR)
    logger.propagate = False
    _INITIALIZED.add(name)
    return logger
