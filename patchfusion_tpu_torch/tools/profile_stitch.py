"""The stitch chain's cost (the port of the JAX package's
tools/profile_stitch.py): the engine's own stitch of the full 4-pass p49
plan at its exact shapes (engine/inference.stitch_passes: each pass's
tiles times the blend mask pasted onto the reensemble canvas, the mask
itself pasted as the count, the AvgMap updates, the final average: 49
tiles of 392x518 onto 1568x2072 for the 4K config), one pass's paste
alone (`paste_pass`, the 16-tile grid), and the concat that joins the
chunks' outputs (48 + 1 tiles).

    python -m patchfusion_tpu_torch.tools.profile_stitch [--device cuda]

f32, as the engine stitches. Prints the rows, then one JSON line with
them, the card's nvidia-smi name and power limit and the torch version.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from patchfusion_tpu_torch.engine.inference import paste_pass, stitch_passes
from patchfusion_tpu_torch.models.builder import check_device
from patchfusion_tpu_torch.models.patchfusion import (TileConfig,
                                                      regular_passes)
from patchfusion_tpu_torch.ops.masks import blend_mask
from patchfusion_tpu_torch.tools import _bench_util as bu

TOOL = "profile_stitch"


def profile(tile_cfg, inner: int = 20, device="cuda") -> dict:
    """The module note's rows for a TileConfig."""
    device = check_device(device)
    tc = tile_cfg
    canvas = tc.patch_reensemble_shape
    passes = regular_passes(tc, "m2")
    counts = [len(p.origins) for p in passes]
    n_all = sum(counts)
    pph, ppw = tc.patch_process_shape
    bu.say(f"pass tile counts: {counts} (total {n_all})")
    blur = torch.as_tensor(blend_mask(tc.patch_process_shape),
                           dtype=torch.float32, device=device)
    tiles_all = bu.seeded_input((n_all, pph, ppw), device, 0, normal=True)
    a = bu.seeded_input((n_all - 1, pph, ppw), device, 1, normal=True)
    b = bu.seeded_input((1, pph, ppw), device, 2, normal=True)
    rows = []

    def row(name, fn, *args):
        t = bu.device_time(fn, *args, inner=inner, device=device)
        rows.append(bu.stage_row(name, t))

    with torch.no_grad():
        row("full 4-pass stitch chain",
            lambda x: stitch_passes(passes, x, blur, canvas).average,
            tiles_all)
        row(f"single {counts[0]}-tile paste pass",
            lambda x: paste_pass(passes[0], x, blur, canvas),
            tiles_all[:counts[0]])
        row(f"chunk-output concat ({n_all - 1}+1)",
            lambda x, y: torch.cat([x, y], 0), a, b)
    return bu.emit(TOOL, device, rows, pass_tiles=counts)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    bu.add_device_arg(ap)
    args = ap.parse_args(argv)
    tc = TileConfig(image_raw_shape=(2160, 3840), patch_split_num=(4, 4),
                    patch_process_shape=(392, 518))
    return profile(tc, device=args.device)


if __name__ == "__main__":
    main()
