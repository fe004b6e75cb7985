"""Where the fused ConditionalLogBinomial depth kernel
(csrc/clb_depth.cu) spends its time, at a head's shape in bf16.

A timing build of csrc/clb_depth.cu alone, compiled with
`-DPF_PHASE_TIMING` into its own library under `_build/timing/` (never
the library the wrappers load), has every warp sum `clock64()` deltas per
phase of its work and add them to a device array at its end. The kernel
has two warp roles (the MLP warps and the depth warps, "role: phase" in
the names), which run side by side: one run of `calls` launches gives
each phase's share of its role's warp time, and each share times the
timing build's own time per call (CUDA events over back-to-back calls) is
the phase's milliseconds within that role. The stamps cost a `__syncwarp`
and a clock read each, so the timing build runs a little slower than the
kernel it splits: its time is printed beside the split.

    python -m patchfusion_tpu_torch.tools.clb_depth_split [--batch 4]
        [--beit] [--device cuda]

Prints one line per phase, then one JSON line with the split, the card's
nvidia-smi name and power limit and the torch version.
"""

from __future__ import annotations

import argparse
import ctypes
from typing import List, Optional

import torch

from patchfusion_tpu_torch.models.builder import check_device
from patchfusion_tpu_torch.tools import _bench_util as bu

TOOL = "clb_depth_split"
TEMPS = (0.0212, 50.0)
P_EPS = 1e-4
MAX_PHASES = 16  # the timing build's cycle array

_timing_lib = None


def build_timing_library():
    """Builds the timing build of csrc/clb_depth.cu (unless this source's
    build is there) and returns its path, without loading it."""
    from patchfusion_tpu_torch.ops import cuda_lib

    return cuda_lib.build_kernels(cuda_lib.BUILD_DIR / "timing",
                                  sources=("clb_depth.cu",),
                                  defines=("PF_PHASE_TIMING",))


def timing_library() -> ctypes.CDLL:
    """The timing build of csrc/clb_depth.cu, built once and loaded once
    per process."""
    global _timing_lib
    if _timing_lib is None:
        from patchfusion_tpu_torch.ops import cuda_lib

        lib = ctypes.CDLL(str(build_timing_library()))
        cuda_lib.bind_clb_depth(lib)
        lib.pf_clb_depth_phases.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int, ctypes.c_int]
        lib.pf_clb_depth_phases.restype = ctypes.c_int
        lib.pf_clb_depth_phase_names.argtypes = []
        lib.pf_clb_depth_phase_names.restype = ctypes.c_char_p
        lib.pf_clb_depth_role_warps.argtypes = [ctypes.c_int]
        lib.pf_clb_depth_role_warps.restype = ctypes.c_int
        _timing_lib = lib
    return _timing_lib


def _read(lib, reset: bool) -> List[int]:
    from patchfusion_tpu_torch.ops.cuda_lib import raise_on

    buf = (ctypes.c_ulonglong * MAX_PHASES)()
    raise_on(lib.pf_clb_depth_phases(buf, MAX_PHASES, int(reset)),
             "clb_depth phase read")
    return list(buf)


def split(last_cat, cond_lo, centers, weights, calls: int = 20) -> dict:
    """The phase split of the timing build on these CUDA inputs:
    {"ms": its time per call, "phases": [{"phase", "share", "ms",
    "cycles_per_warp_call"}, ...]} in the kernel's phase order; shares are
    of the phase's role."""
    from patchfusion_tpu_torch.ops import fused_head as fh

    lib = timing_library()
    names = lib.pf_clb_depth_phase_names().decode().split(",")
    roles = [name.split(":")[0] for name in names]

    def run():
        return fh.clb_depth_launch(lib, last_cat, cond_lo, centers,
                                   *weights, *TEMPS, P_EPS)

    ms = bu.device_time(run, device=last_cat.device, inner=calls) * 1e3
    _read(lib, reset=True)
    for _ in range(calls):
        run()
    torch.cuda.synchronize()
    cycles = _read(lib, reset=True)[:len(names)]
    total = {r: sum(c for c, q in zip(cycles, roles) if q == r)
             for r in set(roles)}
    # every warp of a role stamps its role's phases, so a role's sum over a
    # launch's warps divided by its warps per launch is one warp's cycles
    blocks = _blocks(last_cat, cond_lo, centers)
    warps = {r: blocks * lib.pf_clb_depth_role_warps(int(r == "depth"))
             * calls for r in total}
    return {"ms": ms, "calls": calls, "blocks": blocks, "phases": [
        {"phase": name, "share": c / total[r], "ms": ms * c / total[r],
         "cycles_per_warp_call": c / warps[r]}
        for name, r, c in zip(names, roles, cycles)]}


def _blocks(last_cat, cond_lo, centers) -> int:
    """Blocks of one launch: one per SM, at most one per tile (the plan's
    tile rows by 32 columns)."""
    from patchfusion_tpu_torch.ops import fused_head as fh

    b, oh, ow, cin = last_cat.shape
    _, ih, iw, _ = cond_lo.shape
    plan = fh.clb_depth_plan(oh, ow, ih, iw, cin, centers.shape[-1], 0)
    tiles = b * -(-oh // plan.th) * -(-ow // fh.CLB_DEPTH_TW)
    props = torch.cuda.get_device_properties(last_cat.device)
    return min(tiles, props.multi_processor_count)


def profile(batch: int = 4, beit: bool = False, device="cuda") -> dict:
    """The split at the DA head's shape (392x518 from 224x296), or the
    BEiT head's (384x512 from 192x256), on profile_clb's seeded inputs."""
    from patchfusion_tpu_torch.tools.profile_clb import SHAPE, clb_inputs

    device = check_device(device)
    if device.type != "cuda":
        raise SystemExit("the timing build runs on a CUDA card only")
    shape = (384, 512, 192, 256, *SHAPE[4:]) if beit else SHAPE
    last, cond, cent, ws = clb_inputs(batch, device, shape)
    out = split(last, cond, cent, ws)
    for row in out["phases"]:
        bu.say(f"{row['phase']:<40s} {100 * row['share']:6.2f}%  "
               f"{row['ms']:.4f} ms")
    return bu.emit(TOOL, device, out["phases"], ms=out["ms"], batch=batch,
                   shape=list(shape))


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--beit", action="store_true",
                    help="the BEiT head's shape (384x512 from 192x256)")
    bu.add_device_arg(ap)
    args = ap.parse_args(argv)
    return profile(args.batch, args.beit, args.device)


if __name__ == "__main__":
    main()
