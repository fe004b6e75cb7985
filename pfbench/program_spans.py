"""The program's own spans and counters (`patchfusion_tpu_torch.utils.
profiling`), for the per-layer metrics that read them.

Each reader that reads it calls `begin()` when it is loaded, which turns
the tracer on and drops the records of an earlier run in the same process;
importing this module alone changes nothing. The harness loads a cell's
per-layer readers only in a traced run (`spec.Cell.metrics`) and before it
builds the program (`harness._readers`), so the tracer is on for the whole
of every traced run, its warm request included, and off in every measured
run.

The first record of a run is its warm request's; the window's are the
records after it that completed. A span's milliseconds are its device
interval on a card (the CUDA events around it) and its host interval on
the CPU, where the work runs as the host calls it. A program without the
tracer (from before it had one) records nothing: `begin()` returns False
and every reader returns None.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional

from patchfusion_tpu_torch.utils import profiling


def begin() -> bool:
    """Turn the program's tracer on with no records; False where the
    program has none."""
    enable = getattr(profiling, "enable", None)
    if enable is None:
        return False
    enable()
    profiling.clear()
    return True


def records() -> List[Dict[str, Any]]:
    """The program's records of this run, oldest first."""
    read = getattr(profiling, "records", None)
    return read() if read is not None else []


def _dropped() -> int:
    return getattr(profiling, "dropped", lambda: 0)()


def warm() -> Optional[Dict[str, Any]]:
    """The warm request's record: the run's first, unless it was
    dropped."""
    recs = records()
    return recs[0] if recs and not _dropped() else None


def window() -> List[Dict[str, Any]]:
    """The completed records after the warm request's."""
    recs = records()
    if not _dropped():
        recs = recs[1:]
    return [r for r in recs if not r["failed"]]


def host_ms(span: Dict[str, Any]) -> float:
    return span["host_end_ms"] - span["host_start_ms"]


def span_ms(span: Dict[str, Any], cuda: bool) -> Optional[float]:
    """The span's device milliseconds on a card (None where they were not
    read: a failed request, a host-only span), its host ones on the
    CPU."""
    if not cuda:
        return host_ms(span)
    if span["dev_start_ms"] is None:
        return None
    return span["dev_end_ms"] - span["dev_start_ms"]


def total_ms(record: Dict[str, Any], name: str) -> Optional[float]:
    """The summed milliseconds of the record's spans named `name`; None
    where it has none."""
    cuda = record["device"].startswith("cuda")
    ms = [span_ms(s, cuda) for s in record["spans"] if s["name"] == name]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms)


def median_ms(name: str, per: Optional[str] = None) -> Optional[float]:
    """The median over the window's requests of the summed milliseconds of
    `name`, divided by the request's counter `per` where one is named;
    None where no request has the span."""
    vals = []
    for r in window():
        ms = total_ms(r, name)
        if ms is None:
            continue
        if per is not None:
            n = r["counters"].get(per, 0)
            if not n:
                continue
            ms /= n
        vals.append(ms)
    return statistics.median(vals) if vals else None
