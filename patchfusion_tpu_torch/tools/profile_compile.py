"""The cold and warm cost of a fresh process, per engine mode bucket (the
port of the JAX package's tools/profile_compile.py, whose XLA programs
have no counterpart in eager torch). Rows:

  kernels build (cold)   the CUDA kernels built from csrc/ by nvcc (one
                         nvcc per source, all started together, then the
                         link) into a fresh temporary directory, as on a
                         machine that has never built them; the package's
                         own build directory (_build/) is not touched
  kernels load (warm)    loading that freshly built library (ctypes)
  <mode> first request   the first request of each mode on a freshly
                         built model (cuDNN / cuBLAS set-up, the first
                         launches, the allocator's first growth)
  <mode> warm request    the median of the next three requests

    python -m patchfusion_tpu_torch.tools.profile_compile [--core vitl]
        [--modes m1,m2] [--process-num 16] [--dtype bf16] [--no-cold]
        [--device cuda]

--no-cold skips the build and load rows (they need nvcc and a card). The
requests take a seeded 2160x3840 image through PatchFusion.infer with the
attention of PF_ATTN_IMPL. Prints the rows, then one JSON line with them,
the card's nvidia-smi name and power limit and the torch version.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from patchfusion_tpu_torch.models.builder import check_device
from patchfusion_tpu_torch.tools import _bench_util as bu

TOOL = "profile_compile"


def cold_build(build_dir: Path) -> dict:
    """Seconds to build the kernel library into `build_dir` and to load
    it."""
    from patchfusion_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    lib = cuda_lib.build_kernels(build_dir)
    built = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctypes.CDLL(str(lib))
    return {"build_s": built, "load_s": time.perf_counter() - t0,
            "library": str(lib)}


def mode_tiles(engine, mode: str) -> int:
    """Tiles an image of `mode` runs on `engine`: its regular and random
    tiles, by the engine's own rules (`shard_report`)."""
    report = engine.shard_report(mode)
    return report["regular_tiles"] + report["random_tiles"]


def profile(config: dict, modes=("m1", "m2"), process_num: int = 16,
            dtype: torch.dtype = torch.bfloat16, cold: bool = True,
            iters: int = 3, device="cuda") -> dict:
    """The module note's rows for the PatchFusion `config`."""
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.ops.resize import interpolate

    device = check_device(device)
    rows = []
    if cold:
        if device.type != "cuda":
            raise ValueError("the kernels' build needs a card; pass "
                             "--no-cold on the CPU")
        with tempfile.TemporaryDirectory(prefix="pf_cold_build_") as tmp:
            res = cold_build(Path(tmp))
        rows.append(bu.stage_row("kernels build (cold)", res["build_s"]))
        rows.append(bu.stage_row("kernels load (warm)", res["load_s"]))
    t0 = time.perf_counter()
    model = PatchFusion.from_config(config, device=device, dtype=dtype,
                                    seed=0)
    bu.sync(device)
    rows.append(bu.stage_row("model build + seeded init",
                             time.perf_counter() - t0))
    tc = model.tile_cfg
    rng = np.random.default_rng(0)
    hr = rng.random((*tc.image_raw_shape, 3), dtype=np.float32)
    with torch.no_grad():
        lr = interpolate(torch.from_numpy(hr)[None], tc.patch_process_shape,
                         mode="bilinear", align_corners=True).numpy()

    def request(mode):
        bu.sync(device)
        t = time.perf_counter()
        depth = model.infer(lr, hr, cai_mode=mode, process_num=process_num)
        bu.sync(device)
        if not np.isfinite(depth).all():
            raise RuntimeError(f"{mode}: non-finite depth")
        return time.perf_counter() - t

    for mode in modes:
        n = mode_tiles(model.engine(process_num), mode)
        extra = dict(tiles=n, chunk=process_num,
                     chunks=math.ceil(n / process_num))
        rows.append(bu.stage_row(f"{mode} first request", request(mode),
                                 **extra))
        warm = float(np.median([request(mode) for _ in range(iters)]))
        rows.append(bu.stage_row(f"{mode} warm request", warm, **extra))
    return bu.emit(TOOL, device, rows, dtype=str(dtype),
                   process_num=process_num)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--core", default="vitl")
    ap.add_argument("--modes", default="m1,m2")
    ap.add_argument("--process-num", type=int, default=16)
    ap.add_argument("--dtype", default="bf16", choices=sorted(bu.DTYPES))
    ap.add_argument("--no-cold", action="store_true",
                    help="skip the kernels' cold build and load")
    bu.add_device_arg(ap)
    args = ap.parse_args(argv)
    return profile(bu.published_config(args.core), args.modes.split(","),
                   args.process_num, bu.DTYPES[args.dtype],
                   not args.no_cold, device=args.device)


if __name__ == "__main__":
    main()
