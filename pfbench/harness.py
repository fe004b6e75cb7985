"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the reference, and the metrics.

    result = run_cell(cell, seed, seconds, trace, device, t0)

Set-up (`setup_s`, from `t0`): the program's network built on the card by
its own builder, the harness's seeded weights loaded strictly over its
own initial ones (`weights.py`, with the rules of the configuration's
reference module), the entry-point object
`api.PatchFusion`, the image pool (`images.py`), and one warm request of
the cell's own mode and chunking, which also builds or loads the
program's kernels.

The window is a closed loop of one client: each request is a call of
`PatchFusion.infer(image_lr, image_hr, cai_mode, process_num)` on the next
image of the pool, timed by the host clock from the call to the numpy
depth it returns, the next sent when it has returned, until `seconds` have
passed; the last request ends after that. With `trace` the spans and
ranges that the cell's per-layer readers declare (`spans.py`) are
installed for the whole window, and a stretch of whole requests (from
the second, for at least PROFILE_S seconds) runs under torch.profiler.

After the window the program is freed and every returned depth map is
held against the reference's and the control's depths of its image
(`check.py`). The cell's metrics are read from the run's `Record` by
their readers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pfbench import check, images, spec, weights
from pfbench.reference import engine as ref_engine
from pfbench.spans import Recorder
from pfbench.trace import Stretch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
PROFILE_S = 2.0  # the least length of the profiled stretch


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Record:
    """What a run measured, for the metrics' readers."""
    cell: spec.Cell
    cuda: bool
    setup_s: float
    latencies_s: List[float]       # every completed request of the window
    window_s: float                # first call to the last request's end
    peak_bytes: int
    tiles_per_request: int
    spans: List[Dict[str, float]]  # per request, each span's ms (traced)
    calls: Dict[str, list]         # RANGES' argument shapes (traced)
    profile: Optional[Dict[str, Any]] = None  # the stretch (traced)


def seeded_weights(cell: spec.Cell, wspec: weights.Spec, seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """The weights of `wspec` from `seed`, drawn by the rules of the cell's
    reference module; the program and the reference both load them."""
    return weights.make(wspec, seed, device, cell.reference, cell.model)


def build_program(cell: spec.Cell, seed: int, device):
    """(api.PatchFusion with the seeded weights, the weights' spec)."""
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.models.builder import build_patchfusion

    net, tile_cfg = build_patchfusion(
        cell.model, dtype=DTYPES[cell.config["dtype"]], device=device)
    wspec = weights.spec(net)
    net.load_state_dict(seeded_weights(cell, wspec, seed, device),
                        strict=True)
    return PatchFusion(net.eval(), tile_cfg, cell.model,
                       process_num=cell.traffic["process_num"]), wspec


def request(model, pair, traffic: Dict[str, Any]) -> np.ndarray:
    lr, hr = pair
    return model.infer(lr, hr, cai_mode=traffic["mode"],
                       process_num=traffic["process_num"])


def closed_loop(model, pool, traffic, seconds: float,
                recorder: Optional[Recorder] = None,
                stretch: Optional[Stretch] = None):
    """(latencies, outputs, the image of each, failed, window seconds)."""
    lat: List[float] = []
    outs: List[np.ndarray] = []
    which: List[int] = []
    failed = 0
    profiling = None
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t_end = t_start
    i = 0
    while time.perf_counter() < deadline:
        if stretch is not None and i == 1:
            profiling = stretch.on()
            profiling.__enter__()
            t_prof = time.perf_counter()
        pair = i % len(pool)
        t0 = time.perf_counter()
        try:
            if recorder is not None:
                with torch.profiler.record_function("pfb.request"):
                    depth = request(model, pool[pair], traffic)
            else:
                depth = request(model, pool[pair], traffic)
        except RuntimeError:
            failed += 1
            say(traceback.format_exc())
            depth = None
        t_end = time.perf_counter()
        if recorder is not None:
            recorder.close_request(keep=depth is not None)
        if depth is not None:
            lat.append(t_end - t0)
            outs.append(depth)
            which.append(pair)
        i += 1
        if profiling is not None and (t_end - t_prof >= PROFILE_S
                                      or t_end >= deadline):
            profiling.__exit__(None, None, None)
            profiling = stretch = None
    return lat, outs, which, failed, t_end - t_start


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the reference's float32 products, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def reference_depths(cell: spec.Cell, seed: int, wspec, inputs, device
                     ) -> Dict[str, list]:
    """The depth of the reference ("f32", TF32 off) and of the control
    ("fp8": the reference with e4m3 operands, `reference/control.py`; its
    products run under bf16 autocast, which keeps the e4m3 values and
    rounds their scaled copies by 2^-9, against e4m3's 2^-4) for each
    (lr, hr) pair of `inputs`, from the same seeded weights."""
    from pfbench.reference import control

    out = {}
    with float32_exact():
        net = ref_engine.build(cell.config,
                               seeded_weights(cell, wspec, seed, device),
                               device)
        tiles = ref_engine.Tiles(cell.model)
        for precision in ("f32", "fp8"):
            if precision == "fp8":
                control.to_fp8(net)
            with torch.autocast(torch.device(device).type,
                                dtype=torch.bfloat16,
                                enabled=precision == "fp8"):
                out[precision] = [ref_engine.infer(
                    net, tiles, torch.from_numpy(lr).to(device),
                    torch.from_numpy(hr).to(device),
                    cell.traffic["mode"]).float() for lr, hr in inputs]
    return out


def check_outputs(cell, seed, wspec, pool, outs, which, device):
    """(correct, {number: {value, limit}}): every returned depth map against
    the reference's and the control's depths of its image, which run once
    per image of the pool that a request used."""
    if not outs:
        return check.judge({k: float("inf") for k in check.NUMBERS},
                           cell.check["limits"])
    used = sorted(set(which))
    refs = reference_depths(cell, seed, wspec, [pool[i] for i in used],
                            device)
    f32 = dict(zip(used, refs["f32"]))
    fp8 = dict(zip(used, refs["fp8"]))
    block = tuple(cell.model["patch_process_shape"])
    return check.judge(check.worst([check.compare(d, f32[i], fp8[i], block)
                                    for d, i in zip(outs, which)]),
                       cell.check["limits"])


def _readers(cell: spec.Cell, trace: bool):
    return {m["name"]: spec.reader(m["name"]) for m in cell.metrics(trace)}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float) -> Dict[str, Any]:
    """One run; returns the result's fields (see run.py)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    readers = _readers(cell, trace)
    marks = [("start", time.perf_counter())]
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        marks.append(("cuda context", time.perf_counter()))
    model, wspec = build_program(cell, seed, device)
    marks.append(("program and weights", time.perf_counter()))
    tiles = ref_engine.Tiles(cell.model)
    if cell.traffic["arrival"] != "closed" or cell.traffic["clients"] != 1:
        raise NotImplementedError("the harness drives one closed-loop client")
    if tuple(cell.traffic["image_shape"]) != tiles.raw:
        raise ValueError(f"the traffic's images are "
                         f"{cell.traffic['image_shape']}, the "
                         f"configuration's {tiles.raw}")
    pool = images.pool(seed, cell.traffic["pool"], tiles.raw, tiles.process,
                       device)
    marks.append(("image pool", time.perf_counter()))
    request(model, pool[0], cell.traffic)
    marks.append(("warm request", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    say(f"set-up {setup_s:.2f} s: imports {marks[0][1] - t0:.2f} s, "
        + ", ".join(f"{name} {t - marks[i][1]:.2f} s"
                    for i, (name, t) in enumerate(marks[1:])))

    recorder = stretch = None
    if trace:
        recorder = Recorder(model, cuda)
        recorder.install(
            {k: v for r in readers.values()
             for k, v in getattr(r, "SPANS", {}).items()},
            {k: v for r in readers.values()
             for k, v in getattr(r, "RANGES", {}).items()})
        stretch = Stretch(cuda)
    try:
        lat, outs, which, failed, window_s = closed_loop(
            model, pool, cell.traffic, seconds, recorder, stretch)
    finally:
        if recorder is not None:
            recorder.restore()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if lat:
        say(f"window: {len(lat)} requests in {window_s:.3f} s; latency ms: "
            f"first {[round(t * 1e3, 1) for t in lat[:3]]}, median "
            f"{np.median(lat) * 1e3:.1f}, max {max(lat) * 1e3:.1f}; "
            f"median by thirds of the window "
            f"{[round(float(np.median(p)) * 1e3, 1) for p in np.array_split(lat, 3) if len(p)]}")
    record = Record(cell=cell, cuda=cuda, setup_s=setup_s, latencies_s=lat,
                    window_s=window_s, peak_bytes=peak,
                    tiles_per_request=tiles.count(cell.traffic["mode"]),
                    spans=recorder.spans if recorder else [],
                    calls=dict(recorder.calls) if recorder else {})
    if stretch is not None and stretch.prof is not None:
        record.profile = stretch.summary()

    del model, recorder, stretch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ok, table = check_outputs(cell, seed, wspec, pool, outs, which, device)

    metrics = {}
    for name, mod in readers.items():
        value = mod.read(record)
        if value is not None:
            unit = next(m["unit"] for m in cell.metrics(trace)
                        if m["name"] == name)
            metrics[name] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and failed == 0 and outs),
              "attempted": len(outs) + failed, "failed": failed,
              "metrics": metrics, "device": dev}
    if record.profile is not None:
        dev["busy_s"] = record.profile["busy_s"]
        dev["window_s"] = record.profile["window_s"]
        result["breakdown"] = {"device_ops": record.profile["device_ops"],
                               "idle_gaps": record.profile["idle_gaps"]}
    result["checks"] = table
    return result
