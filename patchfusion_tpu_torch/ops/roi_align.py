"""ROI-align with torchvision `aligned=True` semantics
(patchfusion_tpu/ops/roi_align.py; replaces the reference's
`torchvision.ops.roi_align` calls, patchfusion.py:232-251 and
guided_fusion_model.py:202 — torchvision is not a dependency).

Every PatchFusion ROI is an axis-aligned box, so bilinear ROI sampling
separates into one 1-D interpolation along H and one along W, per box:
  roi_start = coord * spatial_scale - 0.5
  sample s  : c = roi_start + (s + 0.5) * roi_size / (out * grid)
  zero where c < -1 or c > size; else c clamped to [0, size-1];
  each bin the mean of its grid samples.
At sampling_ratio=1 (every PatchFusion call site) that is a 2-tap
gather+lerp per axis; a larger ratio contracts per-box weight matrices
(out, in) along each axis, each row the mean of its bin's grid hat
weights, in float32, as the JAX package's dense path. The coordinate
arithmetic is float32, as in the JAX package; the result is cast back to
the feature dtype. sampling_ratio=None raises, as there: the caller
passes the static grid count (adaptive_sampling_ratio).

Layouts follow the JAX package: features channels-last, boxes
[x1, y1, x2, y2].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _taps(start: torch.Tensor, size: torch.Tensor, out: int, in_size: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(i0, i1, t, valid), each (N, out), for one sample per bin."""
    s = torch.arange(out, dtype=torch.float32, device=start.device)
    coord = start[:, None] + (s[None, :] + 0.5) * (size[:, None] / out)
    valid = (coord >= -1.0) & (coord <= in_size)
    cc = coord.clamp(0.0, in_size - 1)
    i0 = cc.floor().long().clamp(0, in_size - 1)
    i1 = (i0 + 1).clamp(max=in_size - 1)
    return i0, i1, cc - i0.to(torch.float32), valid


def _lerp_w(rows: torch.Tensor, start: torch.Tensor, size: torch.Tensor,
            out_w: int) -> torch.Tensor:
    """rows (N, out_h, W, C) f32 -> (N, out_h, out_w, C): per-box W taps."""
    n, oh, w, c = rows.shape
    i0, i1, t, valid = _taps(start, size, out_w, w)

    def take(i):
        idx = i[:, None, :, None].expand(n, oh, out_w, c)
        return torch.gather(rows, 2, idx)

    t = t[:, None, :, None]
    out = take(i0) * (1.0 - t) + take(i1) * t
    return torch.where(valid[:, None, :, None], out, 0.0)


def _axis_weights(start: torch.Tensor, size: torch.Tensor, out: int,
                  grid: int, in_size: int) -> torch.Tensor:
    """(N, out, in_size) float32 interpolation matrix per box, each row the
    mean of its bin's `grid` samples' hat weights (zero rows where every
    sample falls outside [-1, in_size], as torchvision)."""
    s = torch.arange(out * grid, dtype=torch.float32, device=start.device)
    coord = start[:, None] + (s[None, :] + 0.5) * (size[:, None]
                                                   / (out * grid))
    valid = (coord >= -1.0) & (coord <= in_size)
    cc = coord.clamp(0.0, in_size - 1)
    idx = torch.arange(in_size, dtype=torch.float32, device=start.device)
    w = (1.0 - (cc[..., None] - idx).abs()).clamp(min=0.0)
    w = torch.where(valid[..., None], w, 0.0)
    return w.reshape(start.shape[0], out, grid, in_size).mean(2)


def _grid_count(sampling_ratio: Optional[int]) -> int:
    if sampling_ratio is None:
        raise ValueError("pass a static sampling_ratio (PatchFusion boxes "
                         "share one size; grid = ceil(roi/out), "
                         "adaptive_sampling_ratio)")
    grid = int(sampling_ratio)
    if grid < 1:
        raise ValueError(f"sampling_ratio must be >= 1, not {grid}")
    return grid


def adaptive_sampling_ratio(patch_extent_feat: float, out_size: int) -> int:
    """torchvision's adaptive grid count, ceil(extent / out) and at least 1,
    for a known static ROI extent."""
    return max(1, int(math.ceil(patch_extent_feat / out_size)))


def roi_align_single(feat: torch.Tensor, boxes: torch.Tensor, out_h: int,
                     out_w: int, spatial_scale: float,
                     sampling_ratio: Optional[int] = 1) -> torch.Tensor:
    """ROI-align N boxes from ONE channels-last feature map.

    feat: (H, W, C) or (1, H, W, C); boxes: (N, 4) [x1, y1, x2, y2] in
    pre-scale coordinates; sampling_ratio: samples per bin along each axis.
    Returns (N, out_h, out_w, C) in feat's dtype.
    """
    grid = _grid_count(sampling_ratio)
    if feat.ndim == 4:
        feat = feat[0]
    h, w, c = feat.shape
    boxes = boxes.to(torch.float32)
    x1 = boxes[:, 0] * spatial_scale - 0.5
    y1 = boxes[:, 1] * spatial_scale - 0.5
    x2 = boxes[:, 2] * spatial_scale - 0.5
    y2 = boxes[:, 3] * spatial_scale - 0.5
    n = boxes.shape[0]
    f32 = feat.to(torch.float32)
    if grid > 1:
        wy = _axis_weights(y1, y2 - y1, out_h, grid, h)
        wx = _axis_weights(x1, x2 - x1, out_w, grid, w)
        rows = torch.einsum("nph,hwc->npwc", wy, f32)
        return torch.einsum("npwc,nqw->npqc", rows, wx).to(feat.dtype)
    i0, i1, t, valid = _taps(y1, y2 - y1, out_h, h)
    g0 = f32[i0.reshape(-1)].reshape(n, out_h, w, c)
    g1 = f32[i1.reshape(-1)].reshape(n, out_h, w, c)
    t = t[:, :, None, None]
    rows = torch.where(valid[:, :, None, None], g0 * (1.0 - t) + g1 * t, 0.0)
    return _lerp_w(rows, x1, x2 - x1, out_w).to(feat.dtype)


def roi_align_batched(feat: torch.Tensor, boxes: torch.Tensor, out_h: int,
                      out_w: int, spatial_scale: float,
                      sampling_ratio: Optional[int] = 1) -> torch.Tensor:
    """ROI-align where box i samples feature map i (the training path).

    feat: (N, H, W, C); boxes: (N, 4) [x1, y1, x2, y2]; sampling_ratio as
    roi_align_single. Returns (N, out_h, out_w, C) in feat's dtype.
    """
    grid = _grid_count(sampling_ratio)
    n, h, w, c = feat.shape
    boxes = boxes.to(torch.float32)
    x1 = boxes[:, 0] * spatial_scale - 0.5
    y1 = boxes[:, 1] * spatial_scale - 0.5
    roi_w = (boxes[:, 2] - boxes[:, 0]) * spatial_scale
    roi_h = (boxes[:, 3] - boxes[:, 1]) * spatial_scale
    f32 = feat.to(torch.float32)
    if grid > 1:
        wy = _axis_weights(y1, roi_h, out_h, grid, h)
        wx = _axis_weights(x1, roi_w, out_w, grid, w)
        rows = torch.einsum("nph,nhwc->npwc", wy, f32)
        return torch.einsum("npwc,nqw->npqc", rows, wx).to(feat.dtype)
    i0, i1, t, valid = _taps(y1, roi_h, out_h, h)

    def take(i):
        idx = i[:, :, None, None].expand(n, out_h, w, c)
        return torch.gather(f32, 1, idx)

    t = t[:, :, None, None]
    rows = torch.where(valid[:, :, None, None],
                       take(i0) * (1.0 - t) + take(i1) * t, 0.0)
    return _lerp_w(rows, x1, roi_w, out_w).to(feat.dtype)
