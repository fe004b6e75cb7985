"""Depth-map rendering for the Tester's `--save` (patchfusion_tpu/utils/
colorize.py; matplotlib and PIL are imported where they are used).

Output contract (kept for artifact parity with the reference's dumps,
estimator/utils/color.py): depth is normalized to [0, 1] by the 2nd/95th
percentiles of the valid pixels, mapped through matplotlib's reversed
turbo colormap to RGBA uint8, and invalid pixels are painted opaque gray.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

PERCENTILES = (2.0, 95.0)
CMAP = "turbo_r"
INVALID_FILL = (128, 128, 128, 255)


def colorize(value, vmin: Optional[float] = None,
             vmax: Optional[float] = None, cmap: str = CMAP,
             invalid_val: float = -99) -> np.ndarray:
    """Render a depth map to RGBA uint8 under the percentile contract.
    Pixels equal to `invalid_val` are left out of the percentile range and
    painted gray; vmin / vmax, where given, replace the percentiles."""
    import matplotlib

    depth = np.asarray(value, np.float64).squeeze()
    bad = depth == invalid_val
    valid = depth[~bad]
    lo = np.percentile(valid, PERCENTILES[0]) if vmin is None else vmin
    hi = np.percentile(valid, PERCENTILES[1]) if vmax is None else vmax
    unit = (np.zeros_like(depth) if lo == hi
            else (depth - lo) / (hi - lo))
    unit[bad] = np.nan
    img = matplotlib.colormaps.get_cmap(cmap)(unit, bytes=True)
    img[bad] = INVALID_FILL
    return img


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
