"""Depth-map rendering (patchfusion_tpu/utils/colorize.py): the Tester's
`--save` dumps, the trainer's panels, the min-max and shared-scale
renderers; matplotlib and PIL are imported where they are used.

Output contract (kept for artifact parity with the reference's dumps,
estimator/utils/color.py): depth is normalized to [0, 1] by the 2nd/95th
percentiles of the valid pixels, mapped through matplotlib's reversed
turbo colormap to RGBA uint8, and invalid pixels are painted opaque gray.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

# the percentile convention all PatchFusion artifact dumps share
DEFAULT_PERCENTILES = (2.0, 95.0)
DEFAULT_CMAP = "turbo_r"
INVALID_FILL = (128, 128, 128, 255)


def _normalize(depth: np.ndarray, vmin: Optional[float],
               vmax: Optional[float], percentiles: Tuple[float, float],
               valid: Optional[np.ndarray] = None,
               clip: bool = False) -> np.ndarray:
    """Scale depth to [0, 1] by an explicit or percentile-derived range
    (over the `valid` pixels); zeros where the range is empty."""
    sample = depth if valid is None else depth[valid]
    lo = np.percentile(sample, percentiles[0]) if vmin is None else vmin
    hi = np.percentile(sample, percentiles[1]) if vmax is None else vmax
    if lo == hi:
        return np.zeros_like(depth)
    out = (depth - lo) / (hi - lo)
    return np.clip(out, 0.0, 1.0) if clip else out


def _apply_cmap(unit: np.ndarray, cmap: str) -> np.ndarray:
    """[0, 1] (NaN allowed) -> RGBA uint8 through a matplotlib colormap."""
    import matplotlib
    return matplotlib.colormaps.get_cmap(cmap)(unit, bytes=True)


def colorize(value, vmin: Optional[float] = None,
             vmax: Optional[float] = None, cmap: str = DEFAULT_CMAP,
             invalid_val: float = -99,
             invalid_mask: Optional[np.ndarray] = None,
             background_color: Tuple[int, ...] = INVALID_FILL,
             gamma_corrected: bool = False,
             value_transform: Optional[Callable] = None,
             vminp: float = DEFAULT_PERCENTILES[0],
             vmaxp: float = DEFAULT_PERCENTILES[1]) -> np.ndarray:
    """Render a depth map to RGBA uint8 under the percentile contract.

    Pixels equal to `invalid_val` (or flagged by `invalid_mask`) are left
    out of the percentile range (vminp / vmaxp; vmin / vmax, where given,
    replace them) and painted `background_color`. value_transform maps the
    normalized map before the colormap; gamma_corrected raises the result
    to the power 2.2."""
    depth = np.asarray(value, np.float64).squeeze()
    bad = (depth == invalid_val) if invalid_mask is None else invalid_mask

    unit = _normalize(depth, vmin, vmax, (vminp, vmaxp), valid=~bad)
    unit[bad] = np.nan
    if value_transform is not None:
        unit = value_transform(unit)
    img = _apply_cmap(unit, cmap)
    img[bad] = background_color
    if gamma_corrected:
        img = ((img / 255.0) ** 2.2 * 255).astype(np.uint8)
    return img


def colorize_infer_pfv1(value, cmap: str = "magma_r",
                        vmin: Optional[float] = None,
                        vmax: Optional[float] = None) -> np.ndarray:
    """Min-max (not percentile) rendering, the PatchFusion-v1 style."""
    depth = np.asarray(value, np.float64).squeeze()
    lo = depth.min() if vmin is None else vmin
    hi = depth.max() if vmax is None else vmax
    unit = np.zeros_like(depth) if lo == hi else (depth - lo) / (hi - lo)
    return _apply_cmap(unit, cmap)


def colorize_rescale(value, vmin: Optional[float] = None,
                     vmax: Optional[float] = None, cmap: str = DEFAULT_CMAP,
                     vminp: float = DEFAULT_PERCENTILES[0],
                     vmaxp: float = DEFAULT_PERCENTILES[1],
                     rescale_vmin: Optional[float] = None,
                     rescale_vmax: Optional[float] = None) -> np.ndarray:
    """Percentile rendering, clipped to [0, 1], against an optional
    external range (rescale_vmin and rescale_vmax together): side-by-side
    panels that must share one color scale."""
    depth = np.asarray(value, np.float64).squeeze()
    if rescale_vmin is not None and rescale_vmax is not None:
        vmin, vmax = rescale_vmin, rescale_vmax
    unit = _normalize(depth, vmin, vmax, (vminp, vmaxp), clip=True)
    return _apply_cmap(unit, cmap)


def save_depth_png(depth: np.ndarray, path_color: str,
                   path_uint16: Optional[str] = None,
                   gray_scale: bool = False) -> None:
    """Artifact dump matching the reference tester (tester.py:66-76):
    colorized PNG plus an optional uint16 depth*256 PNG."""
    from PIL import Image

    d = np.asarray(depth).squeeze()
    if gray_scale:
        img = (np.clip(d / max(d.max(), 1e-8), 0, 1) * 255).astype(np.uint8)
        Image.fromarray(img).save(path_color)
    else:
        Image.fromarray(colorize(d)).save(path_color)
    if path_uint16:
        Image.fromarray((d * 256).astype(np.uint16)).save(path_uint16)
