"""Host-side data transforms (numpy HWC; a copy of
patchfusion_tpu/data/transforms.py), matching the reference
estimator/datasets/transformers/ semantics:
  aug_flip / aug_color (gamma+brightness+per-channel color) / aug_rotate
  (bilinear image, nearest depth, in scipy where the JAX package calls
  cv2) / random_crop (returns crop origin).

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


def rotation_matrix(center: Tuple[float, float], angle: float
                    ) -> np.ndarray:
    """The 2x3 matrix cv2.getRotationMatrix2D(center, angle, 1.0) builds:
    a rotation by `angle` degrees (counter-clockwise on screen) about
    `center` = (x, y), mapping source to destination pixels."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a), np.sin(a)
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_affine(src: np.ndarray, mat: np.ndarray, order: int) -> np.ndarray:
    """cv2.warpAffine(src, mat, (w, h)) with zero fill, in scipy: each
    destination pixel reads the source at the inverse of `mat`, bilinear
    (order=1; uint8 rounds to nearest) or nearest (order=0). cv2 quantises
    its bilinear weights to 1/32 of a pixel, so a uint8 image may differ
    from cv2's by a few levels where it is steep, and the nearest pick by
    one pixel where a source coordinate lies at a half-pixel tie."""
    from scipy import ndimage

    inv = np.linalg.inv(np.vstack([mat, [0.0, 0.0, 1.0]]))[:2]
    # (row, col) = (y, x): swap both axes of the inverse map
    m = inv[::-1, 1::-1]
    off = inv[::-1, 2]
    planes = src[..., None] if src.ndim == 2 else src
    out = np.empty(planes.shape, np.float32 if order else planes.dtype)
    for c in range(planes.shape[-1]):
        ndimage.affine_transform(
            planes[..., c].astype(np.float32) if order else planes[..., c],
            m, off, output=out[..., c], order=order, mode="grid-constant",
            cval=0.0, prefilter=False)
    if order and src.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.reshape(src.shape).astype(src.dtype, copy=False)


def aug_rotate(image: np.ndarray, gts: ArrayList, degree: float,
               rng: np.random.Generator) -> Tuple[np.ndarray, ArrayList]:
    """Center rotation, bilinear image / nearest GT, zero fill (the
    reference's PIL Image.rotate semantics, augmentations.py:32-43), about
    ((w - 1) / 2, (h - 1) / 2) with the matrix cv2.getRotationMatrix2D
    builds, as the JAX package's cv2.warpAffine does, but without OpenCV
    (`warp_affine`). The angle is drawn from `rng` as the JAX package
    draws it, so the two loaders' sample streams stay aligned."""
    angle = (rng.random() - 0.5) * 2 * degree
    h, w = image.shape[:2]
    mat = rotation_matrix(((w - 1) / 2, (h - 1) / 2), angle)
    image = warp_affine(image, mat, order=1)
    if isinstance(gts, list):
        gts = [warp_affine(g, mat, order=0) for g in gts]
    else:
        gts = warp_affine(gts, mat, order=0)
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
