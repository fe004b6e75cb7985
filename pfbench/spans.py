"""Spans recorded from the benchmark's own files, around the program's
calls into each layer.

A metric's reader declares what it reads:

    SPANS = {"coarse": ["net.coarse_forward", "net.attend_coarse"]}
    RANGES = {"attn": ["patchfusion_tpu_torch.models.dinov2:fused_attention"]}

A target is an attribute path from the model object the entry point is
called on (`net.coarse_forward`: the method of that instance), or
`module:attribute` (a module-level function, looked up by the program at
each call). `Recorder.install` wraps each target in place, edits no file of
the program, and `restore` puts the originals back.

Every call of a target is timed by a pair of CUDA events recorded on the
stream before and after it (the host clock on the CPU), inside a profiler
range named `pfb.<name>`: the device time from the first to the last of
its work, whatever launches it, the hand-written kernels the profiler
cannot tie to a host operation included. The events of a request are read
after the request has returned its depth to the host, which has
synchronised the device; `Recorder.spans` holds, per request, each name's
summed milliseconds. A RANGES name also keeps the shapes of every call's
tensor arguments (`Recorder.calls`), from which its reader computes the
calls' bound.
"""

from __future__ import annotations

import importlib
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.profiler import record_function


def _shapes(args) -> List[Any]:
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(tuple(a.shape))
        elif isinstance(a, (list, tuple)):
            out.append(_shapes(a))
        else:
            out.append(None)
    return out


class Recorder:
    def __init__(self, root: Any, cuda: bool):
        self.root = root
        self.cuda = cuda
        self.spans: List[Dict[str, float]] = []      # per request
        self.calls: Dict[str, List[List[Any]]] = defaultdict(list)
        self._pending: Dict[str, List[Tuple[Any, Any]]] = defaultdict(list)
        self._undo: List[Callable[[], None]] = []

    # -- wrapping ---------------------------------------------------------

    def _patch(self, target: str, make: Callable[[Callable], Callable]):
        if ":" in target:
            mod_name, attr = target.split(":")
            owner = importlib.import_module(mod_name)
            orig = getattr(owner, attr)
            setattr(owner, attr, make(orig))
            self._undo.append(lambda: setattr(owner, attr, orig))
            return
        *path, attr = target.split(".")
        owner = self.root
        for part in path:
            owner = getattr(owner, part)
        orig = getattr(owner, attr)
        # an instance attribute shadows the class's method
        object.__setattr__(owner, attr, make(orig))
        self._undo.append(lambda: object.__delattr__(owner, attr))

    def _span(self, name: str, orig: Callable, shapes: bool) -> Callable:
        label = f"pfb.{name}"

        def call(*args, **kwargs):
            if shapes:
                self.calls[name].append(_shapes(args))
            with record_function(label):
                start = self._mark()
                out = orig(*args, **kwargs)
                self._pending[name].append((start, self._mark()))
            return out
        return call

    def install(self, spans: Dict[str, List[str]],
                ranges: Dict[str, List[str]]) -> None:
        for shapes, table in ((False, spans), (True, ranges)):
            for name, targets in table.items():
                for t in targets:
                    self._patch(t, lambda orig, n=name, k=shapes:
                                self._span(n, orig, k))

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()

    # -- per request ------------------------------------------------------

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def close_request(self, keep: bool = True) -> None:
        """Reads the request's spans (kept unless `keep` is False: a failed
        request); call after the request returned to the host."""
        if not keep:
            self._pending.clear()
            return
        out = {}
        for name, pairs in self._pending.items():
            if self.cuda:
                out[name] = sum(a.elapsed_time(b) for a, b in pairs)
            else:
                out[name] = sum(b - a for a, b in pairs) * 1e3
        self._pending.clear()
        self.spans.append(out)
