"""Host-side data transforms (numpy HWC; a copy of
patchfusion_tpu/data/transforms.py), matching the reference
estimator/datasets/transformers/ semantics:
  aug_flip / aug_color (gamma+brightness+per-channel color) / aug_rotate
  (PIL bilinear image, nearest depth) / random_crop (returns crop origin).

The network-input resize (`HostResizer`) reproduces the reference `Resize`
transform (bilinear align_corners=True + multiple-of rounding,
depth_anything/transform.py) on the host with the same weight-matrix math as
the device op, through the native host-IO library (data/native.py).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

from patchfusion_tpu_torch.ops.resize import minimal_multiple_resize_size

ArrayList = Union[np.ndarray, List[np.ndarray]]


def aug_flip(image: np.ndarray, gts: ArrayList,
             rng: np.random.Generator) -> Tuple[np.ndarray, ArrayList]:
    if rng.random() > 0.5:
        image = image[:, ::-1, :].copy()
        if isinstance(gts, list):
            gts = [g[:, ::-1].copy() for g in gts]
        else:
            gts = gts[:, ::-1].copy()
    return image, gts


def aug_color(image: np.ndarray, rng: np.random.Generator,
              brightness_range=(0.9, 1.1)) -> np.ndarray:
    if rng.random() > 0.5:
        gamma = rng.uniform(0.9, 1.1)
        # in-place passes: a 4K float image is 95 MB; avoid temporaries on
        # small 1-vCPU loader hosts
        out = (image ** np.float32(gamma)).astype(np.float32, copy=False)
        out *= np.float32(rng.uniform(*brightness_range))
        out *= rng.uniform(0.9, 1.1, size=3).astype(np.float32)
        np.clip(out, 0, 1, out=out)
        image = out
    return image


def aug_rotate(image: np.ndarray, gts: ArrayList, degree: float,
               rng: np.random.Generator) -> Tuple[np.ndarray, ArrayList]:
    """Center rotation, bilinear image / nearest GT, zero fill (the
    reference's PIL Image.rotate semantics, augmentations.py:32-43) via
    cv2.warpAffine — ~3x faster at 4K on 1-vCPU loader hosts; output
    differs from PIL only by sub-LSB resampling rounding at ~2% of edge
    pixels (random aug, not a parity surface)."""
    import cv2

    angle = (rng.random() - 0.5) * 2 * degree
    h, w = image.shape[:2]
    mat = cv2.getRotationMatrix2D(((w - 1) / 2, (h - 1) / 2), angle, 1.0)
    image = cv2.warpAffine(image, mat, (w, h), flags=cv2.INTER_LINEAR)

    def rot(d):
        return cv2.warpAffine(d, mat, (w, h), flags=cv2.INTER_NEAREST)

    if isinstance(gts, list):
        gts = [rot(g) for g in gts]
    else:
        gts = rot(gts)
    return image, gts


def random_crop(image: np.ndarray, gts: ArrayList,
                crop_size: Tuple[int, int], rng: np.random.Generator
                ) -> Tuple[np.ndarray, ArrayList, List[int]]:
    """image HWC; returns (crop, gt crops, [h_start, w_start])."""
    h, w = image.shape[:2]
    hs = int(rng.integers(0, h - crop_size[0], endpoint=True))
    ws = int(rng.integers(0, w - crop_size[1], endpoint=True))
    image = image[hs:hs + crop_size[0], ws:ws + crop_size[1]].copy()

    def crop(d):
        return d[hs:hs + crop_size[0], ws:ws + crop_size[1]].copy()

    if isinstance(gts, list):
        gts = [crop(g) for g in gts]
    else:
        gts = crop(gts)
    return image, gts, [hs, ws]


class HostResizer:
    """Reference Resize transform on host numpy HWC arrays: bilinear
    align_corners=True to the multiple-of-constrained target size."""

    def __init__(self, width: int, height: int,
                 keep_aspect_ratio: bool = False, ensure_multiple_of: int = 1,
                 resize_method: str = "minimal"):
        self.width = width
        self.height = height
        self.keep_aspect_ratio = keep_aspect_ratio
        self.multiple_of = ensure_multiple_of
        self.resize_method = resize_method

    def get_size(self, height: int, width: int) -> Tuple[int, int]:
        return minimal_multiple_resize_size(
            height, width, self.height, self.width, self.multiple_of,
            self.keep_aspect_ratio, self.resize_method)

    def __call__(self, image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        oh, ow = self.get_size(h, w)
        if (oh, ow) == (h, w):
            return image.astype(np.float32)
        from patchfusion_tpu_torch.data import native
        return native.resize_bilinear_ac(image.astype(np.float32), oh, ow)


def make_resizer(resize_mode: str, network_process_size: Sequence[int]
                 ) -> HostResizer:
    """'zoe' -> multiple-of-32, 'depth-anything' -> multiple-of-14
    (reference u4k_dataset.py:45-52)."""
    net_h, net_w = network_process_size
    if resize_mode == "zoe":
        return HostResizer(net_w, net_h, keep_aspect_ratio=False,
                           ensure_multiple_of=32, resize_method="minimal")
    if resize_mode == "depth-anything":
        return HostResizer(net_w, net_h, keep_aspect_ratio=False,
                           ensure_multiple_of=14, resize_method="minimal")
    raise NotImplementedError(resize_mode)
