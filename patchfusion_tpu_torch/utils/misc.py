"""Runtime utilities (patchfusion_tpu/utils/misc.py; reference
estimator/utils/misc.py): seed fixing and the run logger."""

from __future__ import annotations

import logging
import os
import random
from typing import Optional

import numpy as np
import torch

from patchfusion_tpu_torch.parallel.dist import rank


def fix_random_seed(seed: int) -> None:
    """Seed every ambient RNG in play: Python's, numpy's global one and
    torch's on every device (reference misc.py:16-26)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def setup_logger(name: str = "patchfusion_tpu_torch",
                 log_file: Optional[str] = None) -> logging.Logger:
    """An INFO logger to stderr (and `log_file`), set up once per name."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def rank_logger(logger: logging.Logger) -> logging.Logger:
    """`logger` on rank 0 (or without a process group); on another rank a
    child of it that passes warnings and errors only, so that one rank
    logs the run."""
    r = rank()
    if r == 0:
        return logger
    quiet = logger.getChild(f"rank{r}")
    quiet.setLevel(logging.WARNING)
    return quiet
