"""Plain float32 operations of the frozen reference: resize, ROI-align,
Swin windows and masks, the Gaussian blend mask and the stitch.

Each is a copy of the arithmetic of the program's `ops/` modules at the
settings the benchmark's configurations use (bilinear and bicubic
`F.interpolate`, ROI-align at sampling ratio 1, the m1 / m2 grid paste),
frozen here so that a change to the program cannot move its own yardstick.
Nothing here imports the program.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

def interpolate_nchw(x: torch.Tensor, size: Tuple[int, int],
                     mode: str = "bilinear", align_corners: bool = False,
                     scale: Optional[Tuple[float, float]] = None
                     ) -> torch.Tensor:
    """`F.interpolate` of an NCHW tensor to `size`; a tensor already at
    `size` (and given no explicit scale) is returned as it is. scale: the
    explicit `scale_factor` coordinate mapping of the DINOv2 position
    embedding, whose output must then be `size`."""
    if scale is None and tuple(x.shape[-2:]) == tuple(size):
        return x
    if scale is not None:
        y = F.interpolate(x, scale_factor=tuple(float(s) for s in scale),
                          mode=mode, align_corners=align_corners,
                          recompute_scale_factor=False)
        if tuple(y.shape[-2:]) != tuple(size):
            raise ValueError(f"scale {scale} gives {tuple(y.shape[-2:])}, "
                             f"not {tuple(size)}")
        return y
    return F.interpolate(x, size=tuple(size), mode=mode,
                         align_corners=align_corners)


# ---------------------------------------------------------------------------
# ROI-align (torchvision aligned=True, one sample per bin)
# ---------------------------------------------------------------------------

def _taps(start: torch.Tensor, size: torch.Tensor, out: int, in_size: int):
    s = torch.arange(out, dtype=torch.float32, device=start.device)
    coord = start[:, None] + (s[None, :] + 0.5) * (size[:, None] / out)
    valid = (coord >= -1.0) & (coord <= in_size)
    cc = coord.clamp(0.0, in_size - 1)
    i0 = cc.floor().long().clamp(0, in_size - 1)
    i1 = (i0 + 1).clamp(max=in_size - 1)
    return i0, i1, cc - i0.to(torch.float32), valid


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, out_h: int,
              out_w: int, spatial_scale: float) -> torch.Tensor:
    """ROI-align N boxes [x1, y1, x2, y2] from ONE NCHW map (1, C, H, W)
    with one bilinear sample per bin -> (N, C, out_h, out_w)."""
    f = feat[0].permute(1, 2, 0)                       # (H, W, C)
    h, w, c = f.shape
    boxes = boxes.to(torch.float32)
    x1 = boxes[:, 0] * spatial_scale - 0.5
    y1 = boxes[:, 1] * spatial_scale - 0.5
    x2 = boxes[:, 2] * spatial_scale - 0.5
    y2 = boxes[:, 3] * spatial_scale - 0.5
    n = boxes.shape[0]
    i0, i1, t, valid = _taps(y1, y2 - y1, out_h, h)
    g0 = f[i0.reshape(-1)].reshape(n, out_h, w, c)
    g1 = f[i1.reshape(-1)].reshape(n, out_h, w, c)
    t = t[:, :, None, None]
    rows = torch.where(valid[:, :, None, None], g0 * (1.0 - t) + g1 * t, 0.0)
    j0, j1, u, valid_w = _taps(x1, x2 - x1, out_w, w)

    def take(j):
        idx = j[:, None, :, None].expand(n, out_h, out_w, c)
        return torch.gather(rows, 2, idx)

    u = u[:, None, :, None]
    out = take(j0) * (1.0 - u) + take(j1) * u
    out = torch.where(valid_w[:, None, :, None], out, 0.0)
    return out.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Swin windows
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def relative_position_index(window: int) -> np.ndarray:
    """(N, N) lookup into the (2w-1)^2 relative-position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int,
                   w: int) -> torch.Tensor:
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // window) * (w // window))
    x = windows.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(hp: int, wp: int, window: int,
                        shift: int) -> np.ndarray:
    """(-100 / 0) additive mask (nW, window^2, window^2) of the cyclic
    shift's nine regions."""
    img_mask = np.zeros((hp, wp), np.float32)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for ws in cuts:
            img_mask[hs, ws] = cnt
            cnt += 1
    nh, nw = hp // window, wp // window
    m = img_mask.reshape(nh, window, nw, window).transpose(0, 2, 1, 3)
    m = m.reshape(nh * nw, window * window)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def pad_to_multiple(x: torch.Tensor, window: int):
    """Zero-pad H, W of (B, H, W, C) at the bottom / right to multiples of
    `window`."""
    h, w = x.shape[1], x.shape[2]
    hp = -(-h // window) * window
    wp = -(-w // window) * window
    if hp == h and wp == w:
        return x, hp, wp
    return F.pad(x, (0, 0, 0, wp - w, 0, hp - h)), hp, wp


# ---------------------------------------------------------------------------
# blend mask and stitch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def blend_mask(size: Tuple[int, int]) -> np.ndarray:
    """The Gaussian tile-blend weights: an inset box of ones (10% margins)
    blurred as cv2.GaussianBlur does (sigma h // 16, kernel 2 ceil(2 sigma)
    + 1, reflect-101 borders), min-max normalised, plus 1e-3."""
    h, w = size
    sigma = int(h / 16)
    ksize = int(2 * np.ceil(2 * sigma) + 1)
    c = (ksize - 1) / 2.0
    i = np.arange(ksize, dtype=np.float64)
    kern = np.exp(-((i - c) ** 2) / (2.0 * sigma * sigma))
    kern /= kern.sum()
    mask = np.zeros((h, w), np.float64)
    mask[int(0.1 * h):h - int(0.1 * h), int(0.1 * w):w - int(0.1 * w)] = 1.0
    pad = ksize // 2
    m = np.pad(mask, ((pad, pad), (0, 0)), mode="reflect")
    m = np.apply_along_axis(lambda v: np.convolve(v, kern, "valid"), 0, m)
    m = np.pad(m, ((0, 0), (pad, pad)), mode="reflect")
    m = np.apply_along_axis(lambda v: np.convolve(v, kern, "valid"), 1, m)
    m = (m - m.min()) / (m.max() - m.min())
    return m.astype(np.float32) + np.float32(1e-3)


class AvgMap(NamedTuple):
    """The running weighted-average canvas: avg <- (pred + count avg) /
    (count + ct), one update per pass."""
    average: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(pred: torch.Tensor, count: torch.Tensor) -> "AvgMap":
        return AvgMap(pred / count, count)

    def update(self, pred: torch.Tensor, ct: torch.Tensor) -> "AvgMap":
        return AvgMap((pred + self.count * self.average) / (self.count + ct),
                      self.count + ct)


def paste_grid(tiles: torch.Tensor, origins_h: Sequence[int],
               origins_w: Sequence[int], canvas_hw: Tuple[int, int]
               ) -> torch.Tensor:
    """Tiles (nh * nw, th, tw) of one regular pass, row-major, onto a zero
    canvas at their origins, one tile at a time."""
    th, tw = tiles.shape[-2], tiles.shape[-1]
    canvas = torch.zeros(canvas_hw, dtype=tiles.dtype, device=tiles.device)
    origins: List[Tuple[int, int]] = [(y, x) for y in origins_h
                                      for x in origins_w]
    for tile, (y, x) in zip(tiles, origins):
        canvas[y:y + th, x:x + tw] += tile
    return canvas
