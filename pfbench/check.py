"""The comparison that decides `correct`: the depth maps the timed requests
returned, against the frozen float32 reference on the same inputs and
weights, measured in units of the gap that the fp8 control opens on them.

With seeded random weights the depth map sits in a narrow band, and how
far rounding moves it differs from seed to seed: over 24 seeds a sound
run's mean gap to the f32 reference spans 1.9x and the fp8 control's
3.2x, so that a gap measured against the map alone puts the worst sound
seed within 3x of the mildest control seed (PERF.md §2). On each seed the
control's gap is 3.7x the program's or more. So each request's gap is
divided by the mean gap of the control (`reference/control.py`: the
reference with e4m3 operands) on the same weights and image, which moves
with the seed in step. Two numbers, each the worst over every request of
the window:

- `gap_mean`: mean |program - f32 reference| over the canvas, over the
  control's mean |fp8 reference - f32 reference|; the control itself
  reads 1;
- `gap_tile`: the same mean over the worst block of the canvas's grid of
  tile-sized blocks (P x Q blocks of the process shape), over the same
  control gap, so that a fault in one tile shows whole and is not diluted
  over the image.

A map of another shape, or one with a value that is not finite, reads
infinity. Each number has its limit in pfbench/checks/<cell>.json, set
from the readings of sound runs and of the control (`readings.py`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

NUMBERS = ("gap_mean", "gap_tile")


def _gaps(depth, ref, control):
    r = ref.double()
    d = torch.as_tensor(np.asarray(depth)).to(r.device).double()
    return (d - r).abs(), (control.double().to(r.device) - r).abs()


def compare(depth: np.ndarray, ref: torch.Tensor, control: torch.Tensor,
            block: Tuple[int, int]) -> Dict[str, float]:
    """The numbers of one request: the program's depth (host numpy)
    against the f32 reference's, over the control's gap (any device);
    `block` is the tile-sized block (h, w)."""
    if tuple(depth.shape) != tuple(ref.shape):
        return {k: math.inf for k in NUMBERS}
    err, unit = _gaps(depth, ref, control)
    scale = unit.mean()
    (h, w), (bh, bw) = err.shape, block
    blocks = err[:h // bh * bh, :w // bw * bw].reshape(
        h // bh, bh, w // bw, bw).mean((1, 3))
    out = {"gap_mean": float(err.mean() / scale),
           "gap_tile": float(blocks.max() / scale)}
    return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}


def absolute(depth: np.ndarray, ref: torch.Tensor,
             control: torch.Tensor) -> Dict[str, float]:
    """The gaps in the map's own terms, read beside NUMBERS by
    `readings.py`: the mean gap as a share of the mean depth, the largest
    as a share of the reference's range, and the control's mean gap."""
    err, unit = _gaps(depth, ref, control)
    r = ref.double()
    return {"mean_of_depth": float(err.mean() / r.abs().mean()),
            "max_of_range": float(err.max() / (r.max() - r.min())),
            "control_mean_of_depth": float(unit.mean() / r.abs().mean())}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {number: {value, limit}})."""
    table = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table

