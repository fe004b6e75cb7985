"""Profiling hooks (patchfusion_tpu/utils/profiling.py): the per-request
span tracer, a torch.profiler trace context that turns it on, and
wall-clock section timers that synchronise the card before the clock stops.

The tracer is off by default (`enable()`, `disable()`, `enabled()`). Off,
`span(name)` and `request(device)` return one shared null context manager
and `count` returns at once: each site in the program costs one flag test.

On, `request(device)` opens a record around one call of an entry point that
ends in a blocking copy of its result to the host (`api.PatchFusion.infer`,
`api.BaselinePretrain.infer`). Inside it `span(name)` records, for the
range `pf.<name>`:

  * its name and its parent, the innermost span open when it began (the
    request itself, `pf.request`, is the root, span 0);
  * host start and end (`time.perf_counter_ns`);
  * on a CUDA device, a pair of `torch.cuda.Event(enable_timing=True)` on
    the request's current stream (from a pool: creating one costs more than
    recording it), unless `span(name, device=False)` asks for host times
    only, as the spans around single kernel-wrapper calls do: there a pair
    of events would cost more host time than the call's own launch;
  * while a torch.profiler is recording, a `torch.profiler.
    record_function("pf.<name>")` range, so that its trace (`trace()`
    below) carries the program's steps on the clock of the device's
    kernels; a span that opened before the profiler started has none.

`count(name, n)` adds to a counter of the open request. Outside an open
request, `span` and `count` record nothing; a request inside a request is
part of the outer one. One request is open at a time: the entry points are
called from one thread.

The clock. The request's first event, the anchor, is recorded when the
request opens. Where the stream holds no work at that moment, as after the
previous request's blocking copy back, the device reaches the anchor when
the host records it, and every event of the request sits on the host clock
at `request start + anchor.elapsed_time(event)`. A span then has a host and
a device interval on one clock, and `dev_start - host_start` is how long the
stream took to reach the span after the host opened it. The anchor is late,
and every device time early by as much, where work queued before the
request was still running (the first request after a build that did not
synchronise), and it says nothing of work on other streams.

The record closes after the entry point's own blocking copy, which has
drained the stream, so waiting for the request's last event costs nothing;
it then reads every event, returns them to the pool, and adds the
per-request launch counts of the hand-written kernels (`ops/fused_head.
LAUNCHES`, `ops/vit_attention.LAUNCHES`, `ops/resize.LAUNCHES`) as
counters `launches.<kernel>`.
Records are kept in memory, the newest MAX_RECORDS (the oldest dropped
and counted, `dropped()`), as plain values through `records()`:

    {"id": 7, "device": "cuda:0", "failed": False, "t0_s": <perf_counter>,
     "spans": [{"name": "pf.request", "parent": -1, "host_start_ms": 0.0,
                "host_end_ms": 228.4, "dev_start_ms": 0.0,
                "dev_end_ms": 228.5}, ...],
     "counters": {"tiles": 16, "chunks": 1, "launches.clb_pt": 3, ...}}

Times in ms from the request's host start; `dev_*` None on the CPU, for a
host-only span, and in a failed request's record (`failed` True: the entry
point raised).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Any, Deque, Dict, List, Optional

import torch

MAX_RECORDS = 1024  # records kept: a 30 s window holds ~140 requests
_NULL = contextlib.nullcontext()
_on = False
_req: Optional["_Request"] = None  # the open request
_store: Deque[Dict[str, Any]] = collections.deque()
_events: Dict[torch.device, List[torch.cuda.Event]] = {}  # read, reusable
_dropped = 0
_next_id = 0


def enable() -> None:
    """Turn the tracer on."""
    global _on
    _on = True


def disable() -> None:
    """Turn the tracer off; the records stay until `clear()`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, device: bool = True):
    """A context manager timing the block as `pf.<name>` in the open
    request (module docstring), on the host only where `device` is False;
    the shared null one when off or outside a request."""
    if not _on or _req is None:
        return _NULL
    return _Span(_req, "pf." + name, device)


def count(name: str, n: int = 1) -> None:
    """Add n to the open request's counter `name`; nothing when off or
    outside a request."""
    if _on and _req is not None:
        _req.counters[name] = _req.counters.get(name, 0) + n


def request(device):
    """A context manager recording one request on `device` as `pf.request`
    (module docstring); the shared null one when off or inside a
    request."""
    if not _on or _req is not None:
        return _NULL
    return _Request(torch.device(device))


def records() -> List[Dict[str, Any]]:
    """Every kept record, oldest first, as plain values."""
    return list(_store)


def clear() -> None:
    """Drop every record and the count of dropped ones."""
    global _dropped
    _store.clear()
    _dropped = 0


def dropped() -> int:
    """Records dropped to keep the newest MAX_RECORDS since `clear()`."""
    return _dropped


def _event(req: "_Request") -> torch.cuda.Event:
    try:
        ev = _events[req.device].pop()
    except (KeyError, IndexError):
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(req.stream)
    return ev


class _Span:
    __slots__ = ("req", "name", "device", "parent", "t0", "t1", "ev0",
                 "ev1", "rf")

    def __init__(self, req: "_Request", name: str, device: bool = True):
        self.req = req
        self.name = name
        self.device = device and req.stream is not None
        self.ev0 = self.ev1 = self.rf = None

    def __enter__(self):
        req = self.req
        self.parent = req.stack[-1] if req.stack else -1
        req.stack.append(len(req.spans))
        req.spans.append(self)
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        if self.device:
            self.ev0 = _event(req)
        return self

    def __exit__(self, *exc):
        req = self.req
        if self.device:
            self.ev1 = _event(req)
        self.t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        req.stack.pop()
        return False


class _Request:
    __slots__ = ("id", "device", "stream", "spans", "stack", "counters",
                 "launches", "root", "record")

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.current_stream(device) \
            if device.type == "cuda" else None
        self.spans: List[_Span] = []
        self.stack: List[int] = []
        self.counters: Dict[str, int] = {}

    def __enter__(self):
        global _next_id, _req
        self.id = _next_id
        _next_id += 1
        self.launches = _launches()
        _req = self
        self.root = _Span(self, "pf.request")
        self.root.__enter__()
        return self

    def __exit__(self, exc_type, *exc):
        global _dropped, _req
        self.root.__exit__(exc_type, *exc)
        _req = None
        for kernel, n in _launches().items():
            self.counters[f"launches.{kernel}"] = n - self.launches.get(
                kernel, 0)
        t0 = self.root.t0
        self.record = {
            "id": self.id, "device": str(self.device),
            "failed": exc_type is not None, "t0_s": t0 / 1e9,
            "spans": [{"name": s.name, "parent": s.parent,
                       "host_start_ms": (s.t0 - t0) / 1e6,
                       "host_end_ms": (s.t1 - t0) / 1e6,
                       "dev_start_ms": None, "dev_end_ms": None}
                      for s in self.spans],
            "counters": dict(self.counters)}
        if len(_store) >= MAX_RECORDS:
            _store.popleft()
            _dropped += 1
        _store.append(self.record)
        # a failed request's events are not read: the work may have
        # stopped short of them
        if self.stream is not None and exc_type is None:
            self.read()
        self.spans = self.root = None
        return False

    def read(self) -> None:
        """Fill the record's device times from its events and return them
        to the pool. The last event follows the entry point's blocking
        copy, so the wait for it is over at once."""
        self.root.ev1.synchronize()
        anchor = self.root.ev0
        pool = _events.setdefault(self.device, [])
        for s, out in zip(self.spans, self.record["spans"]):
            if s.device:
                out["dev_start_ms"] = anchor.elapsed_time(s.ev0)
                out["dev_end_ms"] = anchor.elapsed_time(s.ev1)
                pool += (s.ev0, s.ev1)


def _launches() -> Dict[str, int]:
    from patchfusion_tpu_torch.ops import fused_head, resize, vit_attention
    return {**fused_head.LAUNCHES, **vit_attention.LAUNCHES,
            **resize.LAUNCHES}


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block with torch.profiler (CPU and, where there is a
    card, CUDA activities) and write a Chrome trace
    (`<host>_<pid>.<time>.pt.trace.json`, for chrome://tracing, Perfetto or
    TensorBoard) under `log_dir`, which is created. The tracer is on for
    the block, so the trace carries the `pf.` ranges of every request, and
    the block's records are written beside it as
    `pf_records_<pid>_<time_ns>.json` ({"records": [...], "dropped": n}).
    None profiles and records nothing."""
    if log_dir is None:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    was_on = _on
    first = _next_id
    enable()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    log_dir)):
            yield
    finally:
        if not was_on:
            disable()
        recs = [r for r in records() if r["id"] >= first]
        path = os.path.join(
            log_dir, f"pf_records_{os.getpid()}_{time.time_ns()}.json")
        with open(path, "w") as f:
            json.dump({"records": recs, "dropped": _dropped}, f)


def _synchronize(sync) -> None:
    """Wait for the CUDA device of `sync` (a tensor or a device); nothing
    for another device."""
    device = sync.device if isinstance(sync, torch.Tensor) \
        else torch.device(sync)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SectionTimer:
    """Accumulating wall-clock timers with device synchronization (between
    requests: a section synchronises the card, so it cannot sit inside a
    request; the tracer above can)."""

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
