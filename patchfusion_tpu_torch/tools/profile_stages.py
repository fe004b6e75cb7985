"""Fine-branch stage breakdown (the port of the JAX package's
tools/profile_stages.py): time, counted matmul+conv FLOPs, TFLOP/s and
share of the card's peak for the DINOv2 trunk alone, the trunk with the
DPT head, and the full fine ZoeDepth branch, at each batch of a sweep; the
DPT head's and the metric-bins head's parts are the differences.

    python -m patchfusion_tpu_torch.tools.profile_stages [--core vitl]
        [--batches 8] [--dtype bf16] [--iters 10] [--device cuda]

One seeded DA-ZoeDepth branch at 392x518; the attention follows
PF_ATTN_IMPL, the FLOP count is the einsum path's (_bench_util). Prints the
rows, then one JSON line with them, the card's nvidia-smi name and power
limit and the torch version.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import torch

from patchfusion_tpu_torch.models.builder import check_device
from patchfusion_tpu_torch.tools import _bench_util as bu

TOOL = "profile_stages"


def seeded_branch(branch_cfg: dict, dtype: torch.dtype, device):
    """A ZoeDepth branch of `branch_cfg` with seeded weights (drawn in f32,
    then cast), in eval mode, over the configs' depth range (1e-3, 80)."""
    from patchfusion_tpu_torch.api import init_weights
    from patchfusion_tpu_torch.models.builder import build_zoedepth_branch

    branch = build_zoedepth_branch(branch_cfg, 1e-3, 80.0, device=device)
    init_weights(branch, 0)
    return branch.to(dtype)


def profile(branch_cfg: dict, batches: Sequence[int] = (8,),
            dtype: torch.dtype = torch.bfloat16, iters: int = 10,
            device="cuda", shape: Tuple[int, int] = (392, 518)) -> dict:
    """The module note's rows for a DA-ZoeDepth branch config."""
    device = check_device(device)
    branch = seeded_branch(branch_cfg, dtype, device)
    dpt = branch.core.core
    trunk = dpt.pretrained
    peak, peak_label = bu.peak_flops(dtype, device)
    rows = []

    def row(name, fn, x, b):
        flops = bu.count_flops(fn, x)
        t = bu.device_time(fn, x, inner=iters, device=device)
        rows.append(bu.stage_row(name, t, flops, peak, batch=b))
        return t

    with torch.no_grad():
        for b in batches:
            bu.say(f"== batch {b} ==")
            x = bu.seeded_input((b, 3, *shape), device, 0, dtype)
            t_vit = row("vit trunk", trunk, x, b)
            t_dpt = row("vit+dpt", dpt, x, b)
            t_zoe = row("fine zoe branch", branch, x, b)
            rows.append(bu.stage_row("-> dpt-head part", t_dpt - t_vit,
                                     batch=b))
            rows.append(bu.stage_row("bins-head part", t_zoe - t_dpt,
                                     batch=b))
    return bu.emit(TOOL, device, rows, peak=peak_label, dtype=str(dtype))


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--core", default="vitl")
    ap.add_argument("--batches", default="8")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="bf16", choices=sorted(bu.DTYPES))
    bu.add_device_arg(ap)
    args = ap.parse_args(argv)
    return profile(bu.published_config(args.core)["fine_branch"],
                   [int(s) for s in args.batches.split(",")],
                   bu.DTYPES[args.dtype], args.iters, args.device)


if __name__ == "__main__":
    main()
