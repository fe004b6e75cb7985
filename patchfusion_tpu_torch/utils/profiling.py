"""Profiling hooks (patchfusion_tpu/utils/profiling.py): a torch.profiler
trace context and wall-clock section timers that synchronise the card
before the clock stops."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block with torch.profiler (CPU and, where there is a
    card, CUDA activities) and write a Chrome trace
    (`<host>_<pid>.<time>.pt.trace.json`, for chrome://tracing, Perfetto or
    TensorBoard) under `log_dir`, which is created. None profiles
    nothing."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield


def _synchronize(sync) -> None:
    """Wait for the CUDA device of `sync` (a tensor or a device); nothing
    for another device."""
    device = sync.device if isinstance(sync, torch.Tensor) \
        else torch.device(sync)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SectionTimer:
    """Accumulating wall-clock timers with device synchronization."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """Time the block under `name`. sync: a tensor or a device whose
        CUDA device is synchronised before the clock stops (the card runs
        behind the host)."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _synchronize(sync)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        """One line per section, the largest total first: name, total
        seconds, count."""
        lines = []
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{k:32s} {self.totals[k]:8.3f}s "
                         f"({self.counts[k]}x)")
        return "\n".join(lines)
