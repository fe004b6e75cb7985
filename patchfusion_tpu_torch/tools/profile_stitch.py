"""The stitch chain's cost (the port of the JAX package's
tools/profile_stitch.py): the full 4-pass p49 stitch at its exact shapes
(each pass's tiles times the blend mask pasted onto the reensemble canvas,
the mask itself pasted as the count, the AvgMap updates, the final
average: 49 tiles of 392x518 onto 1568x2072 for the 4K config), one
pass's paste alone (the 16-tile grid), and the concat that joins the
chunks' outputs (48 + 1 tiles).

    python -m patchfusion_tpu_torch.tools.profile_stitch [--device cuda]

f32, as the engine stitches. Prints the rows, then one JSON line with
them, the card's nvidia-smi name and power limit and the torch version.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from patchfusion_tpu_torch.models.builder import check_device
from patchfusion_tpu_torch.tools import _bench_util as bu

TOOL = "profile_stitch"


def pass_plan(tc):
    """The m2 (p49) passes: (raw offset, process offset) of the regular
    grid and its three half-tile shifts, and each pass's raw origins."""
    prh, prw = tc.patch_raw_shape
    pph, ppw = tc.patch_process_shape
    offsets = [((0, 0), (0, 0)), ((0, prw // 2), (0, ppw // 2)),
               ((prh // 2, 0), (pph // 2, 0)),
               ((prh // 2, prw // 2), (pph // 2, ppw // 2))]
    grids = [tc.regular_origins(off_raw) for off_raw, _ in offsets]
    return offsets, grids, [len(oh) * len(ow) for oh, ow in grids]


def stitch_chain(tc, tiles_all: torch.Tensor, blur: torch.Tensor
                 ) -> torch.Tensor:
    """The 4-pass stitch of (n_all, th, tw) tiles: per pass, the tiles
    times the blend mask and the mask pasted onto the reensemble canvas,
    folded into the running AvgMap; returns its average."""
    from patchfusion_tpu_torch.ops.stitch import AvgMap, paste_grid

    offsets, _, counts = pass_plan(tc)
    avg = None
    start = 0
    for (_, off_proc), n in zip(offsets, counts):
        poh, pow_ = tc.process_origins(off_proc)
        tiles = tiles_all[start:start + n]
        start += n
        num = paste_grid(tiles * blur, poh, pow_, tc.patch_reensemble_shape)
        den = paste_grid(blur.expand(tiles.shape), poh, pow_,
                         tc.patch_reensemble_shape)
        avg = AvgMap.init(num, den) if avg is None else avg.update(num, den)
    return avg.average


def one_pass(tc, tiles: torch.Tensor, blur: torch.Tensor):
    """The regular grid's pass alone: its two canvases."""
    from patchfusion_tpu_torch.ops.stitch import paste_grid

    poh, pow_ = tc.process_origins((0, 0))
    num = paste_grid(tiles * blur, poh, pow_, tc.patch_reensemble_shape)
    den = paste_grid(blur.expand(tiles.shape), poh, pow_,
                     tc.patch_reensemble_shape)
    return num, den


def profile(tile_cfg, inner: int = 20, device="cuda") -> dict:
    """The module note's rows for a TileConfig."""
    from patchfusion_tpu_torch.ops.masks import blend_mask

    device = check_device(device)
    tc = tile_cfg
    _, _, counts = pass_plan(tc)
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
            lambda x: stitch_chain(tc, x, blur), tiles_all)
        row(f"single {counts[0]}-tile paste pass",
            lambda x: one_pass(tc, x, blur), tiles_all[:counts[0]])
        row(f"chunk-output concat ({n_all - 1}+1)",
            lambda x, y: torch.cat([x, y], 0), a, b)
    return bu.emit(TOOL, device, rows, pass_tiles=counts)


def main(argv: Optional[List[str]] = None) -> dict:
    from patchfusion_tpu_torch.models.patchfusion import TileConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    bu.add_device_arg(ap)
    args = ap.parse_args(argv)
    tc = TileConfig(image_raw_shape=(2160, 3840), patch_split_num=(4, 4),
                    patch_process_shape=(392, 518))
    return profile(tc, device=args.device)


if __name__ == "__main__":
    main()
