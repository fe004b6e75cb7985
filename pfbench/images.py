"""The request pool: seeded 4K images and their low-resolution copies.

Each image is uniform in [0, 1) (H, W, 3) float32, drawn on the device
from a generator keyed by the run's seed, with its bilinear
(align_corners=True) copy at the process shape: the arithmetic of the
program's `bench.bench_images`, moved to the device. Both come back to the
host as numpy arrays, because the user's entry point takes numpy images;
the reference is handed the same arrays.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the images' generator is keyed apart from the weights' (which use the
# seed itself)
IMAGE_KEY = 2 ** 32 + 1


def pool(seed: int, n: int, raw_shape: Tuple[int, int],
         process_shape: Tuple[int, int], device
         ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """n pairs (image_lr (1, h, w, 3), image_hr (H, W, 3))."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed + IMAGE_KEY) % 2 ** 63)
    out = []
    for _ in range(n):
        hr = torch.rand((*raw_shape, 3), generator=gen, device=device)
        lr = F.interpolate(hr.permute(2, 0, 1)[None], size=process_shape,
                           mode="bilinear", align_corners=True)
        out.append((lr.permute(0, 2, 3, 1).contiguous().cpu().numpy(),
                    hr.cpu().numpy()))
    return out
