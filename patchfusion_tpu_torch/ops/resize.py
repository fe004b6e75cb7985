"""Image resizing with PyTorch `F.interpolate` semantics.

The JAX package emulates five `F.interpolate` semantics with separable
matrices (patchfusion_tpu/ops/resize.py); here `F.interpolate` is the
semantics itself for bilinear and bicubic. Nearest picks the JAX package's
source index, src = (dst * in) // out in exact integer arithmetic, which
`F.interpolate` computes from a float32 scale and so misses at some ratios
(84 -> 100: row 75 reads 62, not 63). `interpolate` keeps the JAX
signature: the spatial axes are `h_axis`/`w_axis` (default NHWC), so callers
with NCHW tensors pass `h_axis=-2, w_axis=-1`.

On a CUDA tensor a bilinear or bicubic `interpolate` launches the resize
kernel (`csrc/resize.cu`), which computes F.interpolate's arithmetic; on
any other tensor it takes the plain version `interpolate_plain`, the
F.interpolate route the CPU tests hold against the JAX package.
`LAUNCHES` counts the kernel's launches by mode. Under a gradient the
kernel runs inside `_ResizeFunction`, whose backward is the plain
version's vector-Jacobian product, recomputed.

`NetResizer`, `minimal_multiple_resize_size` and the numpy
`resize_matrix` / `tap_plan` (the host-side resizes of the metrics and the
datasets) are copied from the JAX package (pure host arithmetic).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from patchfusion_tpu_torch.ops.cuda_lib import load_kernels, raise_on, stream

# kernel launches since the count was last set to 0
LAUNCHES = {"resize_bilinear": 0, "resize_bicubic": 0}


def interpolate(x: torch.Tensor, size: Tuple[int, int],
                mode: str = "bilinear", align_corners: bool = False,
                scale: Optional[Tuple[float, float]] = None,
                h_axis: int = -3, w_axis: int = -2) -> torch.Tensor:
    """`F.interpolate` over the (`h_axis`, `w_axis`) plane of `x`.

    mode: 'bilinear' | 'bicubic' | 'nearest' ('nearest' reads source index
    (dst * in) // out, exactly; see the module docstring). scale: explicit (scale_h, scale_w), the
    `scale_factor=` coordinate mapping the DINOv2 pos-embed uses; the output
    size must then be floor(in * scale) == size. Axes whose size is already
    `size` (and carry no explicit scale) are left untouched, as in the JAX
    version. A bilinear or bicubic call on a CUDA tensor launches the
    resize kernel; any other tensor takes `interpolate_plain`.
    """
    h_axis, w_axis = _axes(x, h_axis, w_axis)
    in_h, in_w = x.shape[h_axis], x.shape[w_axis]
    if scale is None and (in_h, in_w) == tuple(size):
        return x
    if mode == "nearest":
        for axis, n_in, n_out in ((h_axis, in_h, size[0]),
                                  (w_axis, in_w, size[1])):
            if n_in != n_out:
                x = x.index_select(axis, nearest_index(n_out, n_in,
                                                       x.device))
        return x
    if x.device.type != "cuda":
        return interpolate_plain(x, size, mode, align_corners, scale,
                                 h_axis, w_axis)
    if torch.is_grad_enabled() and x.requires_grad:
        return _ResizeFunction.apply(x, tuple(size), mode, align_corners,
                                     scale, h_axis, w_axis)
    return resize_cuda(x, size, mode, align_corners, scale, h_axis, w_axis)


def _axes(x: torch.Tensor, h_axis: int, w_axis: int) -> Tuple[int, int]:
    h_axis = h_axis % x.ndim
    w_axis = w_axis % x.ndim
    if w_axis != h_axis + 1:
        raise ValueError("interpolate needs adjacent (h, w) axes")
    return h_axis, w_axis


def _planes(x: torch.Tensor, h_axis: int, w_axis: int):
    """(lead shape, trail shape, L, T): the axes before H flattened to L,
    those after W to T."""
    lead = x.shape[:h_axis]
    trail = x.shape[w_axis + 1:]
    return lead, trail, math.prod(lead), math.prod(trail)


def interpolate_plain(x: torch.Tensor, size: Tuple[int, int],
                      mode: str = "bilinear", align_corners: bool = False,
                      scale: Optional[Tuple[float, float]] = None,
                      h_axis: int = -3, w_axis: int = -2) -> torch.Tensor:
    """The plain version of a bilinear or bicubic `interpolate`:
    `F.interpolate` on the (N, C, H, W) view of `x`, on any device. An
    unresized plane with no explicit scale is `x` itself."""
    h_axis, w_axis = _axes(x, h_axis, w_axis)
    lead, trail, n_lead, n_trail = _planes(x, h_axis, w_axis)
    in_h, in_w = x.shape[h_axis], x.shape[w_axis]
    if scale is None and (in_h, in_w) == tuple(size):
        return x
    # to (N, C, H, W): trailing axes become channels, leading ones batch
    y = x.reshape(n_lead, in_h, in_w, n_trail)
    y = y.permute(0, 3, 1, 2)
    if scale is not None:
        y = F.interpolate(y, scale_factor=tuple(float(s) for s in scale),
                          mode=mode, align_corners=align_corners,
                          recompute_scale_factor=False)
        if tuple(y.shape[-2:]) != tuple(size):
            raise ValueError(f"scale {scale} gives {tuple(y.shape[-2:])}, "
                             f"not {tuple(size)}")
    else:
        y = F.interpolate(y, size=tuple(size), mode=mode,
                          align_corners=align_corners)
    out_h, out_w = y.shape[-2:]
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, *trail)


def _axis_scale(n_in: int, n_out: int, align_corners: bool,
                scale: Optional[float]) -> float:
    """PyTorch's area_pixel_compute_scale in float32: the source step per
    output index that its CUDA kernels take from the host."""
    if align_corners:
        return float(np.float32(n_in - 1) / np.float32(n_out - 1)) \
            if n_out > 1 else 0.0
    if scale is not None and scale > 0:
        return float(np.float32(1.0 / scale))
    return float(np.float32(n_in) / np.float32(n_out))


@functools.lru_cache(maxsize=None)
def _steps(in_h: int, in_w: int, out_h: int, out_w: int,
           align_corners: bool, scale: Optional[Tuple[float, float]]
           ) -> Tuple[float, float, bool]:
    """The kernel's (rh, rw, align_corners) for one resize, once per
    shape: each axis's `_axis_scale`, or identity taps where the plane is
    unresized, as F.interpolate copies it. Raises where an explicit scale
    gives another size."""
    if scale is not None:
        got = tuple(int(math.floor(n * s))
                    for n, s in zip((in_h, in_w), scale))
        if got != (out_h, out_w):
            raise ValueError(f"scale {scale} gives {got}, not "
                             f"{(out_h, out_w)}")
    if (in_h, in_w) == (out_h, out_w):
        return 1.0, 1.0, False
    scale_h, scale_w = (None, None) if scale is None else scale
    return (_axis_scale(in_h, out_h, align_corners, scale_h),
            _axis_scale(in_w, out_w, align_corners, scale_w), align_corners)


def resize_cuda(x: torch.Tensor, size: Tuple[int, int], mode: str,
                align_corners: bool,
                scale: Optional[Tuple[float, float]], h_axis: int,
                w_axis: int) -> torch.Tensor:
    """A bilinear or bicubic `interpolate` of a CUDA tensor by the kernel:
    x viewed as (L, H, W, T), the output allocated as (*lead, out_h,
    out_w, *trail). Raises on what the kernel does not take."""
    if mode not in ("bilinear", "bicubic"):
        raise ValueError(f"the resize kernel has no mode {mode!r}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the resize kernel takes bfloat16 and float32, "
                        f"got {x.dtype}")
    h_axis, w_axis = _axes(x, h_axis, w_axis)
    lead, trail, n_lead, n_trail = _planes(x, h_axis, w_axis)
    in_h, in_w = x.shape[h_axis], x.shape[w_axis]
    out_h, out_w = (int(s) for s in size)
    rh, rw, ac = _steps(in_h, in_w, out_h, out_w, bool(align_corners),
                        None if scale is None else
                        (float(scale[0]), float(scale[1])))
    x4 = x.reshape(n_lead, in_h, in_w, n_trail)
    out = torch.empty((n_lead, out_h, out_w, n_trail), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out.reshape(*lead, out_h, out_w, *trail)
    sl, sh, sw, st = x4.stride()
    err = load_kernels().pf_resize(
        x4.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
        int(mode == "bicubic"), n_lead, in_h, in_w, out_h, out_w, n_trail,
        sl, sh, sw, st, rh, rw, int(ac), x.device.index, stream(x.device))
    raise_on(err, "resize")
    LAUNCHES["resize_" + mode] += 1
    return out.reshape(*lead, out_h, out_w, *trail)


class _ResizeFunction(torch.autograd.Function):
    """The kernel's forward; the backward is the plain version's
    vector-Jacobian product, recomputed on an input of the same shape
    (the map is linear, so the input's values do not enter it)."""

    @staticmethod
    def forward(ctx, x, size, mode, align_corners, scale, h_axis, w_axis):
        ctx.args = (size, mode, align_corners, scale, h_axis, w_axis)
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return resize_cuda(x, size, mode, align_corners, scale, h_axis,
                           w_axis)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.x_meta
        with torch.enable_grad():
            x = torch.zeros(shape, dtype=dtype, device=device,
                            requires_grad=True)
            y = interpolate_plain(x, *ctx.args)
            (gx,) = torch.autograd.grad(y, x, grad)
        return gx, None, None, None, None, None, None


def nearest_index(out_size: int, in_size: int,
                  device: torch.device = torch.device("cpu")
                  ) -> torch.Tensor:
    """Source index of each output index for 'nearest' (`_nearest_src`) on
    `device`. The exact (dst * in) // out is the JAX package's
    floor(dst * in / out) in float64 at every size it can meet."""
    return torch.from_numpy(_nearest_src(out_size, in_size)).to(device)


def interpolate_nchw(x: torch.Tensor, size: Tuple[int, int],
                     mode: str = "bilinear",
                     align_corners: bool = False) -> torch.Tensor:
    """`interpolate` for the NCHW tensors inside the modules."""
    return interpolate(x, size, mode, align_corners, h_axis=-2, w_axis=-1)


def minimal_multiple_resize_size(height: int, width: int, target_h: int,
                                 target_w: int, multiple_of: int,
                                 keep_aspect_ratio: bool = False,
                                 resize_method: str = "minimal",
                                 ) -> Tuple[int, int]:
    """Output size of the reference `Resize` transform: scale to the
    target, optionally preserving aspect ratio per `resize_method`, then
    round each side to the nearest multiple."""
    scale_h = target_h / height
    scale_w = target_w / width
    if keep_aspect_ratio:
        if resize_method == "lower_bound":
            scale_h = scale_w = max(scale_h, scale_w)
        elif resize_method == "upper_bound":
            scale_h = scale_w = min(scale_h, scale_w)
        elif resize_method == "minimal":
            if abs(1 - scale_w) < abs(1 - scale_h):
                scale_h = scale_w
            else:
                scale_w = scale_h
        else:
            raise ValueError(resize_method)

    def constrain(v, min_val=0, max_val=None):
        y = int(np.round(v / multiple_of) * multiple_of)
        if max_val is not None and y > max_val:
            y = int(np.floor(v / multiple_of) * multiple_of)
        if y < min_val:
            y = int(np.ceil(v / multiple_of) * multiple_of)
        return y

    if resize_method == "lower_bound":
        new_h = constrain(scale_h * height, min_val=target_h)
        new_w = constrain(scale_w * width, min_val=target_w)
    elif resize_method == "upper_bound":
        new_h = constrain(scale_h * height, max_val=target_h)
        new_w = constrain(scale_w * width, max_val=target_w)
    elif resize_method == "minimal":
        new_h = constrain(scale_h * height)
        new_w = constrain(scale_w * width)
    else:
        raise ValueError(resize_method)
    return new_h, new_w


class NetResizer:
    """The reference's `Resize` transform (bilinear, align_corners=True) with
    multiple-of rounding; ResizeDA = multiple_of 14, ResizeZoe = 32."""

    def __init__(self, width: int, height: int, keep_aspect_ratio: bool = False,
                 ensure_multiple_of: int = 1, resize_method: str = "minimal"):
        self.width = width
        self.height = height
        self.keep_aspect_ratio = keep_aspect_ratio
        self.multiple_of = ensure_multiple_of
        self.resize_method = resize_method

    def get_size(self, height: int, width: int) -> Tuple[int, int]:
        return minimal_multiple_resize_size(
            height, width, self.height, self.width, self.multiple_of,
            self.keep_aspect_ratio, self.resize_method)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC."""
        out_h, out_w = self.get_size(x.shape[-3], x.shape[-2])
        return interpolate(x, (out_h, out_w), mode="bilinear",
                           align_corners=True)


# -- host-side (numpy) resize weights, copied from the JAX package --------

def _source_coords(out_size: int, in_size: int, align_corners: bool,
                   scale: Optional[float] = None) -> np.ndarray:
    """Source-space sample coordinate for each output index (PyTorch rules).

    All arithmetic in float32 to match PyTorch's CPU/CUDA kernels
    (area_pixel_compute_scale/source_index are computed in float32), which
    matters for bit-level parity on large downsamples.
    """
    d = np.arange(out_size, dtype=np.float32)
    if align_corners:
        if out_size == 1:
            return np.zeros((1,), np.float32)
        s = np.float32(in_size - 1) / np.float32(out_size - 1)
        return (d * s).astype(np.float32)
    # half-pixel. PyTorch uses the *given* scale_factor when provided
    # (recompute_scale_factor=False path), else out/in.
    s = (np.float32(in_size) / np.float32(out_size) if scale is None
         else np.float32(1.0) / np.float32(scale))
    return ((d + np.float32(0.5)) * s - np.float32(0.5)).astype(np.float32)


def _linear_weights(out_size: int, in_size: int, align_corners: bool,
                    scale: Optional[float] = None) -> np.ndarray:
    """Dense (out_size, in_size) bilinear weight matrix, PyTorch semantics.

    PyTorch clamps the source coordinate to >= 0 and clamps gather indices to
    in_size-1; for linear interpolation that is equivalent to clamping the
    coordinate into [0, in_size-1] and using hat weights.
    """
    src = np.clip(_source_coords(out_size, in_size, align_corners, scale),
                  0.0, in_size - 1)
    idx = np.arange(in_size, dtype=np.float64)
    w = np.maximum(0.0, 1.0 - np.abs(src[:, None] - idx[None, :]))
    # rows sum to 1 except possibly the degenerate in_size==1 case
    return w.astype(np.float32)


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (PyTorch/OpenCV use a=-0.75)."""
    at = np.abs(t)
    at2 = at * at
    at3 = at2 * at
    r = np.where(at <= 1, (a + 2) * at3 - (a + 3) * at2 + 1,
                 np.where(at < 2, a * at3 - 5 * a * at2 + 8 * a * at - 4 * a,
                          0.0))
    return r


def _cubic_weights(out_size: int, in_size: int, align_corners: bool,
                   scale: Optional[float] = None) -> np.ndarray:
    """Dense (out_size, in_size) bicubic weight matrix, PyTorch semantics.

    PyTorch does NOT clamp the source coordinate for cubic; it clamps the four
    gather indices (border replication), so edge rows still sum to 1.
    """
    src = _source_coords(out_size, in_size, align_corners, scale)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    w_mat = np.zeros((out_size, in_size), np.float64)
    rows = np.arange(out_size)
    for k in range(-1, 3):
        wk = _cubic_kernel(frac - k)
        idx = np.clip(i0 + k, 0, in_size - 1)
        np.add.at(w_mat, (rows, idx), wk)
    return w_mat.astype(np.float32)


def _nearest_src(out_size: int, in_size: int) -> np.ndarray:
    """'nearest' source indices: (dst * in) // out, clipped to in - 1."""
    idx = np.arange(out_size, dtype=np.int64) * in_size // out_size
    return np.minimum(idx, in_size - 1)


def _nearest_weights(out_size: int, in_size: int) -> np.ndarray:
    idx = _nearest_src(out_size, in_size)
    w = np.zeros((out_size, in_size), np.float32)
    w[np.arange(out_size), idx] = 1.0
    return w


def resize_matrix(out_size: int, in_size: int, mode: str = "bilinear",
                  align_corners: bool = False,
                  scale: Optional[float] = None) -> np.ndarray:
    """The (out_size, in_size) 1-D interpolation matrix for one axis."""
    if out_size == in_size and scale is None:
        return np.eye(out_size, dtype=np.float32)
    if mode == "bilinear" or mode == "linear":
        return _linear_weights(out_size, in_size, align_corners, scale)
    if mode == "bicubic" or mode == "cubic":
        return _cubic_weights(out_size, in_size, align_corners, scale)
    if mode == "nearest":
        return _nearest_weights(out_size, in_size)
    raise ValueError(f"unsupported resize mode: {mode}")


def _tap_plan(out_size: int, in_size: int, mode: str, align_corners: bool,
              scale: Optional[float]) -> Tuple[np.ndarray, np.ndarray]:
    """Static (taps, weights) for one axis: indices (out, k) into the input
    and f32 weights (out, k) — k=1 (nearest), 2 (bilinear), 4 (bicubic).

    The host-side resizes (the datasets' bicubic image resize) gather these
    taps instead of multiplying by the dense (out, in) matrix.
    """
    if mode == "nearest":
        idx = _nearest_src(out_size, in_size)
        return idx[:, None], np.ones((out_size, 1), np.float32)
    src = _source_coords(out_size, in_size, align_corners, scale)
    if mode in ("bilinear", "linear"):
        src = np.clip(src, 0.0, in_size - 1)
        i0 = np.floor(src).astype(np.int64)
        i0 = np.clip(i0, 0, in_size - 1)
        i1 = np.clip(i0 + 1, 0, in_size - 1)
        t = (src - i0).astype(np.float32)
        taps = np.stack([i0, i1], -1)
        weights = np.stack([1.0 - t, t], -1)
        return taps, weights.astype(np.float32)
    if mode in ("bicubic", "cubic"):
        i0 = np.floor(src).astype(np.int64)
        frac = src - i0
        taps = np.stack([np.clip(i0 + k, 0, in_size - 1)
                         for k in range(-1, 3)], -1)
        weights = np.stack([_cubic_kernel(frac - k)
                            for k in range(-1, 3)], -1)
        return taps, weights.astype(np.float32)
    raise ValueError(f"unsupported resize mode: {mode}")
