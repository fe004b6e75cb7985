"""Swin window partition/reverse and shifted-window attention masks
(patchfusion_tpu/ops/windows.py; reference swin_layers.py:53-82, 325-345).
Tensors are channels-last (B, H, W, C), as in the JAX package.

`shifted_window_mask` is the host (numpy) mask, as the JAX package builds
it. `shifted_window_mask_on` forms the same mask on a device from region
labels built there once per shape and device (`shifted_window_labels`), so
a forward after the first copies nothing from the host."""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from patchfusion_tpu_torch.utils import profiling


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, window, window, C). H, W % window == 0."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window, window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int,
                   w: int) -> torch.Tensor:
    """(B*nH*nW, window, window, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // window) * (w // window))
    x = windows.reshape(b, h // window, w // window, window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(hp: int, wp: int, window: int,
                        shift: int) -> np.ndarray:
    """(-100/0) additive attention mask, (nW, window^2, window^2): label the
    padded (hp, wp) canvas with the 9 regions the cyclic shift induces,
    partition into windows, mask pairs with differing labels."""
    img_mask = np.zeros((hp, wp), np.float32)
    h_slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    w_slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in h_slices:
        for ws in w_slices:
            img_mask[hs, ws] = cnt
            cnt += 1
    nh, nw = hp // window, wp // window
    m = img_mask.reshape(nh, window, nw, window).transpose(0, 2, 1, 3)
    m = m.reshape(nh * nw, window * window)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def shifted_window_labels(hp: int, wp: int, window: int, shift: int,
                          device: torch.device) -> torch.Tensor:
    """(nW, window^2) uint8 region labels of `shifted_window_mask`'s
    canvas, partitioned into windows, built on `device` with torch ops and
    kept for the process (209 KB at the largest G2L level, 1452 windows).
    Each build, a cache miss, counts `g2l_mask_builds` in the open
    request."""
    profiling.count("g2l_mask_builds")
    lab = torch.empty((hp, wp), dtype=torch.uint8, device=device)
    bands = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for i, hs in enumerate(bands):
        for j, ws in enumerate(bands):
            lab[hs, ws] = 3 * i + j
    nh, nw = hp // window, wp // window
    lab = lab.reshape(nh, window, nw, window).permute(0, 2, 1, 3)
    return lab.reshape(nh * nw, window * window)


def shifted_window_mask_on(hp: int, wp: int, window: int, shift: int,
                           device: torch.device) -> torch.Tensor:
    """`shifted_window_mask` as an f32 tensor on `device`, formed there
    from the cached labels at each call: nothing is copied from the host
    once the labels are built, and no (nW, N, N) mask stays resident."""
    lab = shifted_window_labels(hp, wp, window, shift, torch.device(device))
    return torch.where(lab[:, None, :] != lab[:, :, None], -100.0, 0.0)


def pad_to_multiple(x: torch.Tensor, window: int
                    ) -> Tuple[torch.Tensor, int, int]:
    """Zero-pad H, W (axes -3, -2) at the bottom/right up to multiples of
    `window`."""
    h, w = x.shape[-3], x.shape[-2]
    hp = -(-h // window) * window
    wp = -(-w // window) * window
    if hp == h and wp == w:
        return x, hp, wp
    return F.pad(x, (0, 0, 0, wp - w, 0, hp - h)), hp, wp
