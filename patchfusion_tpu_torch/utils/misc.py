"""Runtime utilities (patchfusion_tpu/utils/misc.py; reference
estimator/utils/misc.py and runner.py): seed fixing, environment logging,
the RunnerInfo attribute bag and the run logger."""

from __future__ import annotations

import logging
import os
import random
import sys
from typing import Optional

import numpy as np
import torch

from patchfusion_tpu_torch.parallel.dist import rank, world_size


class RunnerInfo:
    """Dynamic attribute bag threaded through train/test tools (reference
    estimator/utils/runner.py:3-22)."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)


def fix_random_seed(seed: int) -> None:
    """Seed every ambient RNG in play: Python's, numpy's global one and
    torch's on every device (reference misc.py:16-26)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def log_env(logger: logging.Logger, device=None) -> None:
    """Log the runtime environment (reference misc.py:28-54): python, torch
    and CUDA versions, the device in use (default the current CUDA device
    where there is one, else the CPU) and this process's rank and world
    size."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    logger.info("python: %s", sys.version.replace("\n", ""))
    logger.info("torch: %s, cuda: %s", torch.__version__, torch.version.cuda)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    logger.info("device: %s (%s)", device, name)
    logger.info("rank: %d / %d", rank(), world_size())


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
