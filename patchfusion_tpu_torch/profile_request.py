"""Where one warm request's device time goes, on one CUDA card.

    python -m patchfusion_tpu_torch.profile_request [--mode m1] [--out F]
        [--config configs/patchfusion_zoedepth/zoedepth_patchfusion_u4k.py]

Builds PatchFusion at full width from --config (default DA-vitl, the
config chip_smoke.py runs first; bf16, seeded random weights), answers one warm-up request on a seeded
2160x3840 image, then profiles one request with torch.profiler and the
span tracer (utils/profiling) for each attention implementation
(PF_ATTN_IMPL einsum, then pallas). For each it reports the wall time, the
device busy time (the union of all kernel and memcpy intervals), the idle
share of the device span, the kernels that took the most device time and
the port's own kernels, with their launch counts; the request's spans by
name (`spans`: calls, host ms, device ms, and the stream's lag behind the
host at the span's first start and at its worst), its counters, and the
device's idle time by the innermost `pf.` range open on the host when each
gap began (`idle_by_span`), and the host's calls that wait on the card
(copies, synchronisations) by the same range (`blocking_by_span`). Prints
the span table on stderr, one JSON line on stdout, and writes the same
object to --out.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from patchfusion_tpu_torch.api import PatchFusion
from patchfusion_tpu_torch.config import Config
from patchfusion_tpu_torch.ops.resize import interpolate
from patchfusion_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
VITL_CONFIG = ROOT / ("configs/patchfusion_depthanything/"
                      "depthanything_vitl_patchfusion_u4k.py")
TOP = 15  # kernels listed per request
# the port's own kernels (csrc/*.cu), listed whatever their rank
PORT_KERNELS = ("vit_attention_kernel", "clb_", "logbinomial_depth")
# CUDA runtime calls in which the host can wait for the card (a pageable
# copy waits for the stream)
BLOCKING = ("cudaMemcpyAsync", "cudaMemcpy", "cudaStreamSynchronize",
            "cudaEventSynchronize", "cudaDeviceSynchronize")


def _annotation(event) -> bool:
    """A `record_function` range's own interval on the device timeline
    (the tracer's `pf.` ranges): not work."""
    return bool(getattr(event, "is_user_annotation", False)) \
        or event.name.startswith("pf.")


def _device_events(prof):
    """(name, start_us, end_us) of every kernel and memcpy on the card."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not _annotation(e):
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _host_events(prof, keep):
    """(name, start_us, end_us) of the host events whose name `keep`
    accepts."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and keep(e.name)]


def _innermost(ranges, t) -> str:
    """The name of the innermost of `ranges` open at t, or "outside"."""
    inner = max((r for r in ranges if r[1] <= t < r[2]),
                key=lambda r: r[1], default=None)
    return inner[0] if inner else "outside"


def span_table(record):
    """The record's spans by (name, parent's name), in order of first
    start: calls, summed host and device ms, and the lag of the device
    behind the host at the first start and the largest (device ms None on
    the CPU)."""
    spans = record["spans"]
    rows = {}
    for s in spans:
        parent = spans[s["parent"]]["name"] if s["parent"] >= 0 else ""
        row = rows.setdefault((s["name"], parent), {
            "name": s["name"], "parent": parent, "calls": 0, "host_ms": 0.0,
            "device_ms": None, "lag_ms": None, "lag_ms_max": None})
        row["calls"] += 1
        row["host_ms"] += s["host_end_ms"] - s["host_start_ms"]
        if s["dev_start_ms"] is not None:
            lag = s["dev_start_ms"] - s["host_start_ms"]
            row["device_ms"] = (row["device_ms"] or 0.0) \
                + s["dev_end_ms"] - s["dev_start_ms"]
            if row["lag_ms"] is None:
                row["lag_ms"] = row["lag_ms_max"] = lag
            row["lag_ms_max"] = max(row["lag_ms_max"], lag)
    return list(rows.values())


def idle_by_span(device, ranges):
    """Idle time between the merged device intervals `device` ((name,
    start_us, end_us)), in ms, by the innermost host range of `ranges`
    open when each gap began ("outside" where none was)."""
    busy = _merged((s, e) for _, s, e in device)
    out = defaultdict(float)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        out[_innermost(ranges, end)] += (start - end) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def blocking_by_span(calls, ranges):
    """The host calls `calls` ((name, start_us, end_us)) by the innermost
    range of `ranges` open when each began: {range: {call: [count, ms]}}."""
    out = defaultdict(lambda: defaultdict(lambda: [0, 0.0]))
    for name, s, e in calls:
        row = out[_innermost(ranges, s)][name]
        row[0] += 1
        row[1] += (e - s) / 1e3
    return {k: dict(v) for k, v in out.items()}


def _merged(intervals):
    """The union of (start, end) intervals as disjoint sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _busy_us(intervals) -> float:
    return sum(e - s for s, e in _merged(intervals))


def profile(model, lr, hr, mode: str):
    was_on = profiling.enabled()
    profiling.enable()
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.infer(lr, hr, cai_mode=mode)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        if not was_on:
            profiling.disable()
    record = profiling.records()[-1]
    events = _device_events(prof)
    ranges = _host_events(prof, lambda n: n.startswith("pf."))
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    spans = [(s, e) for _, s, e in events]
    span = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = _busy_us(spans)
    by_name = defaultdict(lambda: [0.0, 0])
    for name, s, e in events:
        by_name[name][0] += e - s
        by_name[name][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_span_ms": span / 1e3, "idle_share": 1 - busy / span,
            "top_kernels": [{"name": n[:120], "ms": t / 1e3, "launches": c}
                            for n, (t, c) in ranked[:TOP]],
            "port_kernels": [{"name": n[:120], "ms": t / 1e3, "launches": c}
                             for n, (t, c) in ranked
                             if any(k in n for k in PORT_KERNELS)],
            "spans": span_table(record), "counters": record["counters"],
            "idle_by_span": idle_by_span(events, ranges),
            "blocking_by_span": blocking_by_span(
                _host_events(prof, lambda n: n in BLOCKING), ranges)}


def _fmt(v) -> str:
    return "-" if v is None else f"{v:.3f}"


def print_spans(label: str, result) -> None:
    """The span table, counters and idle time by span, on stderr."""
    say = functools.partial(print, file=sys.stderr)
    say(f"{label}: wall {result['wall_ms']:.1f} ms, idle "
        f"{100 * result['idle_share']:.1f}%")
    say(f"{'span':28s} {'parent':18s} {'calls':>5s} {'host ms':>9s} "
        f"{'device ms':>9s} {'lag ms':>8s} {'max lag':>8s}")
    for r in result["spans"]:
        say(f"{r['name']:28s} {r['parent']:18s} {r['calls']:5d} "
            f"{r['host_ms']:9.3f} {_fmt(r['device_ms']):>9s} "
            f"{_fmt(r['lag_ms']):>8s} {_fmt(r['lag_ms_max']):>8s}")
    say("counters: " + json.dumps(result["counters"]))
    say("idle ms by span: " + json.dumps(
        {k: round(v, 3) for k, v in result["idle_by_span"].items()}))
    say("calls waiting on the card by span (count, ms): " + json.dumps(
        {k: {c: [n, round(ms, 3)] for c, (n, ms) in v.items()}
         for k, v in result["blocking_by_span"].items()}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="m1")
    ap.add_argument("--config", default=str(VITL_CONFIG))
    ap.add_argument("--out",
                    default=str(ROOT / "chiprun_out/profile_request.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = Config.fromfile(args.config).model.config.to_dict()
    model = PatchFusion.from_config(cfg, dtype=torch.bfloat16, seed=0)
    rng = np.random.default_rng(100)
    hr = rng.random((*model.tile_cfg.image_raw_shape, 3), dtype=np.float32)
    with torch.no_grad():
        lr = interpolate(torch.from_numpy(hr)[None],
                         model.tile_cfg.patch_process_shape, mode="bilinear",
                         align_corners=True).numpy()
    result = {"card": smi, "mode": args.mode, "config": args.config}
    old = os.environ.get("PF_ATTN_IMPL")
    try:
        for impl in ("einsum", "pallas"):
            os.environ["PF_ATTN_IMPL"] = impl
            model.infer(lr, hr, cai_mode=args.mode)  # warm-up
            result[impl] = profile(model, lr, hr, args.mode)
            print_spans(impl, result[impl])
    finally:
        if old is None:
            os.environ.pop("PF_ATTN_IMPL", None)
        else:
            os.environ["PF_ATTN_IMPL"] = old
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
