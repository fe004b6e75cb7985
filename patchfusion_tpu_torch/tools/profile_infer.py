"""Stage-level profile of the tiled-inference pipeline (the port of the
JAX package's tools/profile_infer.py): time, counted matmul+conv FLOPs,
TFLOP/s and share of the card's peak for (a) the coarse pass (ZoeDepth on
the whole image, then G2L attention over its features), (b) one chunk of n
tiles through the fine branch and the fusion stage (`infer_tiles`, the ROI
features broadcast from the coarse pass), (c) the fine branch alone on that
chunk, and the p49 (m2, 49 tiles) projection: coarse + ceil(49 / n) x
chunk.

    python -m patchfusion_tpu_torch.tools.profile_infer [--core vitl]
        [--chunk 8] [--dtype bf16] [--iters 10] [--device cuda]

The attention follows PF_ATTN_IMPL (unset or `pallas`, the attention
kernel; `einsum`, the einsum path); the FLOP count is the same either way
(_bench_util).
Prints one row per stage, then one JSON line with the rows, the card's
nvidia-smi name and power limit and the torch version.
"""

from __future__ import annotations

import argparse
import math
from typing import List, Optional

import torch

from patchfusion_tpu_torch.models.builder import check_device
from patchfusion_tpu_torch.tools import _bench_util as bu

TOOL = "profile_infer"


def coarse_stage(net, image_lr: torch.Tensor):
    """The coarse pass and G2L, once per image: (coarse depth, the six
    coarse features, the six attended features)."""
    cd, cf = net.coarse_forward(image_lr)
    return cd, cf, net.attend_coarse(cf)


def broadcast_rois(coarse, n: int):
    """The coarse pass's outputs broadcast to n tiles, as the JAX tool
    feeds infer_tiles (every tile's ROI is the whole image)."""
    cd, cf, g2l = coarse
    return (cd.expand(n, *cd.shape[1:]),
            [f.expand(n, *f.shape[1:]) for f in cf],
            [f.expand(n, *f.shape[1:]) for f in g2l])


def chunk_stage(net, crops: torch.Tensor, droi, frois, grois):
    """One chunk of tiles: the fine branch and the fusion stage."""
    return net.infer_tiles(crops, frois, grois, droi)


def fine_stage(net, crops: torch.Tensor):
    return net.fine_forward(crops)


def p49_projection(coarse_s: float, chunk_s: float, n: int) -> dict:
    """Seconds per p49 image: the coarse pass plus ceil(49 / n) chunks."""
    chunks = math.ceil(49 / n)
    total = coarse_s + chunks * chunk_s
    return {"chunks": chunks, "seconds": total, "img_per_s": 1 / total}


def profile(config: dict, chunk: int = 8, dtype: torch.dtype = torch.bfloat16,
            iters: int = 10, device="cuda") -> dict:
    """The rows of the module note for the PatchFusion `config` (seeded
    weights)."""
    from patchfusion_tpu_torch.api import PatchFusion

    device = check_device(device)
    model = PatchFusion.from_config(config, device=device, dtype=dtype,
                                    seed=0)
    net = model.net
    ph, pw = model.tile_cfg.patch_process_shape
    peak, peak_label = bu.peak_flops(net.dtype, device)
    n = chunk
    img_lr = bu.seeded_input((1, 3, ph, pw), device, 0, net.dtype)
    crops = bu.seeded_input((n, 3, ph, pw), device, 1, net.dtype)
    rows = []

    def row(name, fn, *args):
        flops = bu.count_flops(fn, *args)
        t = bu.device_time(fn, *args, inner=iters, device=device)
        rows.append(bu.stage_row(name, t, flops, peak))
        return t, flops

    with torch.no_grad():
        t_coarse, _ = row("coarse+g2l", coarse_stage, net, img_lr)
        rois = broadcast_rois(coarse_stage(net, img_lr), n)
        t_chunk, f_chunk = row(f"chunk[{n}]", chunk_stage, net, crops, *rois)
        rows.append(bu.stage_row("per tile", t_chunk / n, f_chunk / n, peak))
        row(f"fine[{n}]", fine_stage, net, crops)
    p49 = p49_projection(t_coarse, t_chunk, n)
    rows.append({"name": "p49 projection", "ms": p49["seconds"] * 1e3,
                 "img_per_s": p49["img_per_s"], "chunks": p49["chunks"]})
    bu.say(f"p49 projection: {p49['seconds'] * 1e3:.1f} ms/img = "
           f"{p49['img_per_s']:.3f} img/s (coarse {t_coarse * 1e3:.1f} + "
           f"{p49['chunks']} x chunk {t_chunk * 1e3:.1f})")
    return bu.emit(TOOL, device, rows, peak=peak_label, chunk=n,
                   dtype=str(net.dtype))


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--core", default="vitl")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--dtype", default="bf16", choices=sorted(bu.DTYPES))
    ap.add_argument("--iters", type=int, default=10)
    bu.add_device_arg(ap)
    args = ap.parse_args(argv)
    return profile(bu.published_config(args.core), chunk=args.chunk,
                   dtype=bu.DTYPES[args.dtype], iters=args.iters,
                   device=args.device)


if __name__ == "__main__":
    main()
