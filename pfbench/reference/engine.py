"""The plain tiled 4K engine of the frozen reference (modes m1 and m2),
and `network` / `build`, which make a configuration's reference network
from the module that the configuration names (`spec.reference`), with a
weights dict loaded.

The arithmetic of the program's `engine/inference.py` for one image: one
coarse pass and G2L over the whole image; the regular pass of P x Q tiles
(m1), plus three passes shifted by half a tile (m2); each tile cropped from
the raw image, resized bilinear (align_corners) to the process shape, run
through the fine branch and fusion; the tiles blended into a running
weighted average with the Gaussian mask. Computed in float32 with TF32
off, in blocks of `block` tiles so that it fits beside nothing else.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from pfbench import spec
from pfbench.reference.ops import (AvgMap, blend_mask, interpolate_nchw,
                                   paste_grid)


class Tiles:
    """The tile geometry of a configuration: raw image (H, W), split
    (P, Q), process shape (h, w)."""

    def __init__(self, config: Dict[str, Any]):
        self.raw = tuple(config["image_raw_shape"])
        self.split = tuple(config["patch_split_num"])
        self.process = tuple(config["patch_process_shape"])
        self.patch_raw = (self.raw[0] // self.split[0],
                          self.raw[1] // self.split[1])
        self.canvas = (self.process[0] * self.split[0],
                       self.process[1] * self.split[1])

    def passes(self, mode: str) -> List[Tuple[List[int], List[int],
                                              List[int], List[int]]]:
        """Per pass: raw origins (rows, cols) and canvas origins (rows,
        cols). m1 is the regular pass; m2 adds the passes shifted by half a
        tile down, right, and both."""
        if mode not in ("m1", "m2"):
            raise NotImplementedError(f"the reference runs m1 and m2, not "
                                      f"{mode!r}")
        (prh, prw), (pph, ppw) = self.patch_raw, self.process
        shifts = [(0, 0, 0, 0)]
        if mode == "m2":
            shifts += [(0, prw // 2, 0, ppw // 2), (prh // 2, 0, pph // 2, 0),
                       (prh // 2, prw // 2, pph // 2, ppw // 2)]
        out = []
        for ry, rx, cy, cx in shifts:
            nh = (self.raw[0] - ry) // prh
            nw = (self.raw[1] - rx) // prw
            out.append(([ry + prh * i for i in range(nh)],
                        [rx + prw * j for j in range(nw)],
                        [cy + pph * i for i in range(nh)],
                        [cx + ppw * j for j in range(nw)]))
        return out

    def count(self, mode: str) -> int:
        """Tiles per request."""
        return sum(len(r) * len(c) for r, c, _, _ in self.passes(mode))


def network(config: Dict[str, Any]) -> torch.nn.Module:
    """The reference network of the configuration file `config`: its
    reference module's `PatchFusionNet` of `config["model"]`, built on the
    current default device, in eval mode. Every reference network is built
    here."""
    return spec.reference(config).PatchFusionNet(config["model"]).eval()


def build(config: Dict[str, Any], weights: Dict[str, torch.Tensor],
          device) -> torch.nn.Module:
    """The reference network of the configuration file `config` on
    `device` with `weights` (state_dict names; any dtype, copied in as
    float32) loaded strictly, in eval mode."""
    with torch.device(device):
        net = network(config)
    net.load_state_dict(weights, strict=True)
    return net


@torch.no_grad()
def infer(net: torch.nn.Module, tiles: Tiles, image_lr: torch.Tensor,
          image_hr: torch.Tensor, mode: str, block: int = 8) -> torch.Tensor:
    """image_lr (1, h, w, 3) and image_hr (H, W, 3) float32 in [0, 1], on
    the network's device -> depth on the blended canvas (P h, Q w)."""
    ctx = net.coarse(image_lr.permute(0, 3, 1, 2))
    hr = image_hr.permute(2, 0, 1)
    (prh, prw), (pph, ppw) = tiles.patch_raw, tiles.process
    fx, fy = ppw / tiles.raw[1], pph / tiles.raw[0]
    blur = torch.from_numpy(blend_mask(tiles.process)).to(hr.device)
    avg = None
    for rows, cols, crows, ccols in tiles.passes(mode):
        origins = [(y, x) for y in rows for x in cols]
        depth = []
        for s in range(0, len(origins), block):
            part = origins[s:s + block]
            crops = torch.stack([hr[:, y:y + prh, x:x + prw]
                                 for y, x in part])
            crops = interpolate_nchw(crops, tiles.process, "bilinear",
                                     align_corners=True)
            boxes = torch.tensor([[x * fx, y * fy, (x + prw) * fx,
                                   (y + prh) * fy] for y, x in part],
                                 dtype=torch.float32, device=hr.device)
            depth.append(net.tiles(crops, boxes, ctx)[:, 0])
        depth = torch.cat(depth)
        num = paste_grid(depth * blur, crows, ccols, tiles.canvas)
        den = paste_grid(blur.expand(depth.shape), crows, ccols,
                         tiles.canvas)
        avg = AvgMap.init(num, den) if avg is None else avg.update(num, den)
    return avg.average

