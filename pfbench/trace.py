"""What the profiled stretch of a traced run shows: device busy time and
the breakdown.

Busy time is the union of the intervals of every kernel and memcpy on the
card (the arithmetic of the program's `profile_request._busy_us`, copied),
and the idle share is taken over the stretch's host-clock length; the
`pfb.` ranges' own intervals on the device timeline are not work and are
left out. The stretch ends with
one short sentinel kernel (`torch.cuda._sleep`), left out of every sum:
without one, the profiler on the H100 has been seen to drop a window's
last kernel record.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

SENTINEL_KERNEL = "spin_kernel"
TOP = 10
NAME_CHARS = 120


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of the intervals, as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of the intervals."""
    return sum(e - s for s, e in merged(intervals))


def _annotation(event) -> bool:
    """A range's own interval on the device timeline (a user annotation),
    not work."""
    return bool(getattr(event, "is_user_annotation", False)) \
        or event.name.startswith("pfb.")


class Stretch:
    """A profiled stretch of whole requests: `with stretch.on(): ...`. On
    the CPU (the tests) it profiles the host alone and reads no device
    time."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None
        self.window_s = 0.0

    @contextlib.contextmanager
    def on(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        t0 = time.perf_counter()
        try:
            yield
            if self.cuda:
                torch.cuda.synchronize()
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            self.window_s = time.perf_counter() - t0
        finally:
            prof.__exit__(None, None, None)
        self.prof = prof

    def summary(self) -> Dict:
        """busy_s, window_s and the breakdown."""
        events = self.prof.events()
        device = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not _annotation(e) and SENTINEL_KERNEL not in e.name]
        if self.cuda and not device:
            raise RuntimeError("the profiler recorded no device activity")
        spans = [(e.time_range.start, e.time_range.end) for e in device]
        host = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CPU]
        by_name = defaultdict(float)
        for e in device:
            by_name[e.name[:NAME_CHARS]] += (e.time_range.end
                                             - e.time_range.start) / 1e6
        return {"busy_s": busy_us(spans) / 1e6, "window_s": self.window_s,
                "device_ops": sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:TOP],
                "idle_gaps": self._gaps(merged(spans), host)}

    @staticmethod
    def _gaps(busy: List[Tuple[float, float]], host) -> List:
        """The longest gaps between busy intervals, each named by what the
        host was doing when it began: the innermost `pfb.` range and the
        innermost host operation then open."""
        gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])),
                      reverse=True)[:TOP]
        out = []
        for length, at in gaps:
            open_ = [e for e in host
                     if e.time_range.start <= at < e.time_range.end]
            inner = max(open_, key=lambda e: e.time_range.start, default=None)
            span = max((e for e in open_ if e.name.startswith("pfb.")),
                       key=lambda e: e.time_range.start, default=None)
            name = " / ".join(e.name for e in (span, inner) if e is not None)
            out.append([name[:NAME_CHARS] or "host idle", length / 1e6])
        return out
