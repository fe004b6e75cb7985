"""Where one warm request's device time goes, on one CUDA card.

    python -m patchfusion_tpu_torch.profile_request [--mode m1] [--out F]
        [--config configs/patchfusion_zoedepth/zoedepth_patchfusion_u4k.py]

Builds PatchFusion at full width from --config (default DA-vitl, the
config chip_smoke.py runs first; bf16, seeded random weights), answers one warm-up request on a seeded
2160x3840 image, then profiles one request with torch.profiler for each
attention implementation (PF_ATTN_IMPL einsum, then pallas). For each it
reports the wall time, the device busy time (the union of all kernel and
memcpy intervals), the idle share of the device span, the kernels that
took the most device time and the port's own kernels, with their launch
counts. Prints one JSON line and writes the same object to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from patchfusion_tpu_torch.api import PatchFusion
from patchfusion_tpu_torch.config import Config
from patchfusion_tpu_torch.ops.resize import interpolate

ROOT = Path(__file__).resolve().parent.parent
VITL_CONFIG = ROOT / ("configs/patchfusion_depthanything/"
                      "depthanything_vitl_patchfusion_u4k.py")
TOP = 15  # kernels listed per request
# the port's own kernels (csrc/*.cu), listed whatever their rank
PORT_KERNELS = ("vit_attention_kernel", "clb_", "logbinomial_depth")


def _device_events(prof):
    """(name, start_us, end_us) of every kernel and memcpy on the card."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def profile(model, lr, hr, mode: str):
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.infer(lr, hr, cai_mode=mode)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = _device_events(prof)
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
                             if any(k in n for k in PORT_KERNELS)]}


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
