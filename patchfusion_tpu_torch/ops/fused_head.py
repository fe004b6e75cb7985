"""Metric-bins head kernels: the CUDA counterparts of
patchfusion_tpu/ops/pallas_head.py::clb_pt, ::logbinomial_depth and
::clb_logbinomial_depth.

Each kernel has three pieces here:

  * the wrapper (`clb_pt`, `logbinomial_depth`, `clb_logbinomial_depth`),
    with the JAX signature and channels-last layout. For CPU tensors it
    returns the plain PyTorch twin; for CUDA tensors it launches the
    hand-written kernel on the current stream, or raises. It never falls
    back from CUDA to the twin.
  * the plain twin (`*_plain`), a direct transcription of the JAX
    `*_reference` functions (pallas_head.py:670-745), plain PyTorch on
    any device: it resizes with `resize.interpolate_plain`, never with the
    resize kernel.
  * a launch count in `LAUNCHES`, raised by one per kernel launch and
    nowhere else.

Each wrapper is differentiable, as the JAX package's custom VJPs make its
kernels (pallas_head.py:137-164, :296-321, :507-528): when grad mode is on
and an input requires grad, the call goes through `Recompute`, whose
forward is the wrapper's own (the kernel on the card) and whose backward
recomputes the plain twin under autograd and returns its input gradients.
Otherwise the wrapper runs its forward directly, as in inference. No
backward kernel exists, in either package.

The kernels live in `patchfusion_tpu_torch/csrc/` (built and loaded by
`ops/cuda_lib.py`). They read their 4-D inputs through strides, so the
model hands them permuted views of its NCHW tensors instead of
channels-last copies.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from patchfusion_tpu_torch.ops.cuda_lib import (load_kernels, on_cpu,
                                                raise_on, stream)
from patchfusion_tpu_torch.ops.resize import (_source_coords,
                                              interpolate_plain)

CLB_HIDDEN = 80  # the hidden width csrc/common.cuh is compiled for

# kernel launches since the counts were last set to 0; logbinomial_depth
# counts its tiled kernel, logbinomial_depth_pixel the per-pixel kernel
# that takes the shapes the tiled one does not (a downsample of the centers)
LAUNCHES = {"clb_pt": 0, "logbinomial_depth": 0,
            "logbinomial_depth_pixel": 0, "clb_logbinomial_depth": 0}


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _check_dense_nhwc(t: torch.Tensor, name: str) -> None:
    """A 4-D (B, H, W, C) tensor that is contiguous, or a permuted view of a
    contiguous NCHW tensor: the two layouts the kernels' strides cover
    without overlap or gaps."""
    if t.dim() != 4:
        raise ValueError(f"{name} must be 4-D (B, H, W, C), got {t.shape}")
    if not (t.is_contiguous() or t.permute(0, 3, 1, 2).is_contiguous()):
        raise ValueError(f"{name} must be contiguous channels-last or a "
                         "permuted contiguous NCHW tensor")


# ---------------------------------------------------------------------------
# logbinomial_depth
# ---------------------------------------------------------------------------

def _log_binom_coeffs(k: int) -> np.ndarray:
    """log nCk via the reference's Stirling form (dist_layers.py:29-33)."""
    e = 1e-7
    n = np.float64(k - 1) + e
    kk = np.arange(k, dtype=np.float64) + e
    d = np.maximum(n - kk, 0.0)
    return (n * np.log(n) - kk * np.log(kk) - d * np.log(d + e)
            ).astype(np.float32)


_C0_TABLES = {}  # (K, device) -> the kernels' c0 table on that device


def _c0_table(k: int, device: torch.device) -> torch.Tensor:
    """_log_binom_coeffs(k) as a float32 tensor on `device`, made once."""
    key = (k, device)
    table = _C0_TABLES.get(key)
    if table is None:
        table = _C0_TABLES[key] = torch.from_numpy(
            _log_binom_coeffs(k)).to(device)
    return table


def logbinomial_depth_plain(p: torch.Tensor, t: torch.Tensor,
                            centers: torch.Tensor, min_temp: float = 0.0212,
                            max_temp: float = 50.0) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: logbinomial_depth_reference."""
    _, oh, ow = p.shape
    k = centers.shape[-1]
    cent = interpolate_plain(centers.to(torch.float32), (oh, ow),
                             mode="bilinear", align_corners=True)
    tv = t.to(torch.float32) * (max_temp - min_temp) + min_temp
    eps = 1e-4
    pc = p.to(torch.float32).clamp(eps, 1.0)[..., None]
    omp = (1.0 - pc).clamp(eps, 1.0)
    kk = torch.arange(k, dtype=torch.float32, device=p.device)
    c0 = torch.from_numpy(_log_binom_coeffs(k)).to(p.device)
    y = (c0 + kk * torch.log(pc) + (float(k - 1) - kk) * torch.log(omp)) \
        / tv[..., None]
    probs = torch.softmax(y, dim=-1)
    return torch.sum(probs * cent, dim=-1)


# ---------------------------------------------------------------------------
# gradients: the kernel forward, the twin's recomputed backward
# ---------------------------------------------------------------------------

class Recompute(torch.autograd.Function):
    """forward(fwd, plain, kwargs, *inputs) = fwd(*inputs, **kwargs); the
    backward recomputes plain(*inputs, **kwargs) under autograd, with
    autocast off (the twins compute in f32 inside), and returns
    torch.autograd.grad of it for every input that requires grad, each in
    its input's dtype and shape (a permuted NCHW view gets a gradient of
    the view's shape). `fwd` is a wrapper's kernel route; a test may hand
    it the twin, so that the backward runs on the CPU too. The inputs are
    saved for the backward; nothing else is."""

    @staticmethod
    def forward(ctx, fwd, plain, kwargs, *inputs):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*inputs)
        with torch.autocast(inputs[0].device.type, enabled=False):
            return fwd(*inputs, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad(), torch.autocast(saved[0].device.type,
                                                 enabled=False):
            inputs = [x.detach().requires_grad_(n)
                      for x, n in zip(saved, needs)]
            outs = ctx.plain(*inputs, **ctx.kwargs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            wrt = [x for x, n in zip(inputs, needs) if n]
            got = iter(torch.autograd.grad(outs, wrt, grads,
                                           allow_unused=True))
        return (None, None, None,
                *(next(got) if n else None for n in needs))


def _differentiable(*inputs: torch.Tensor) -> bool:
    """Whether a call must record a gradient: grad mode on and an input
    that requires grad."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in inputs)


def logbinomial_depth(p: torch.Tensor, t: torch.Tensor,
                      centers: torch.Tensor, min_temp: float = 0.0212,
                      max_temp: float = 50.0) -> torch.Tensor:
    """Depth expectation of the log-binomial bins.

    p, t: (B, OH, OW) float32 (t before the min/max temperature scaling);
    centers: (B, IH, IW, K) bin centers, float32 or bfloat16, channels-last
    or a permuted NCHW view. Returns (B, OH, OW) float32. Differentiable in
    p, t and centers (see Recompute).
    """
    kw = dict(min_temp=min_temp, max_temp=max_temp)
    if _differentiable(p, t, centers):
        return Recompute.apply(_logbinomial_depth, logbinomial_depth_plain,
                               kw, p, t, centers)
    return _logbinomial_depth(p, t, centers, **kw)


def _logbinomial_depth(p: torch.Tensor, t: torch.Tensor,
                       centers: torch.Tensor, min_temp: float,
                       max_temp: float) -> torch.Tensor:
    """logbinomial_depth's forward: the twin for CPU tensors, else the
    kernel."""
    if on_cpu(p, t, centers):
        return logbinomial_depth_plain(p, t, centers, min_temp, max_temp)
    if p.dim() != 3 or t.shape != p.shape:
        raise ValueError(f"p and t must share a (B, OH, OW) shape, got "
                         f"{p.shape} and {t.shape}")
    if p.dtype != torch.float32 or t.dtype != torch.float32:
        raise TypeError("p and t must be float32")
    if not (p.is_contiguous() and t.is_contiguous()):
        raise ValueError("p and t must be contiguous")
    _check_dense_nhwc(centers, "centers")
    if centers.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"centers must be float32 or bfloat16, got "
                        f"{centers.dtype}")
    b, oh, ow = p.shape
    cb, ih, iw, k = centers.shape
    if cb != b:
        raise ValueError(f"batch mismatch: p {b}, centers {cb}")
    if not 0 < k <= 12288:
        raise ValueError(f"unsupported bin count {k}")
    out = torch.empty((b, oh, ow), dtype=torch.float32, device=p.device)
    variant = ctypes.c_int(0)
    err = load_kernels().pf_logbinomial_depth(
        p.data_ptr(), t.data_ptr(), centers.data_ptr(),
        _c0_table(k, p.device).data_ptr(), out.data_ptr(),
        int(centers.dtype == torch.bfloat16), b, oh, ow, ih, iw, k,
        *centers.stride(), float(min_temp), float(max_temp),
        p.device.index, stream(p.device), ctypes.byref(variant))
    raise_on(err, "logbinomial_depth")
    LAUNCHES[_DEPTH_VARIANTS[variant.value]] += 1
    return out


# pf_logbinomial_depth's *variant -> its count in LAUNCHES
_DEPTH_VARIANTS = {1: "logbinomial_depth", 2: "logbinomial_depth_pixel"}


# ---------------------------------------------------------------------------
# clb_pt
# ---------------------------------------------------------------------------

def clb_pt_plain(last_cat: torch.Tensor, cond_lo: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, p_eps: float = 1e-4
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: clb_pt_reference (f32 throughout,
    tanh-GELU)."""
    cin = last_cat.shape[-1]
    oh, ow = last_cat.shape[1:3]
    w1 = w1.to(torch.float32)
    a = torch.einsum("bhwc,cf->bhwf", last_cat.to(torch.float32), w1[:cin])
    bb = torch.einsum("bhwc,cf->bhwf", cond_lo.to(torch.float32), w1[cin:])
    bb = interpolate_plain(bb, (oh, ow), mode="bilinear",
                           align_corners=True)
    h = a + bb + b1.to(torch.float32)
    h = F.gelu(h, approximate="tanh")
    pt = F.softplus(torch.einsum("bhwf,fo->bhwo", h, w2.to(torch.float32))
                    + b2.to(torch.float32))
    p = pt[..., :2] + p_eps
    p = p[..., 0] / (p[..., 0] + p[..., 1])
    t = pt[..., 2:] + p_eps
    t = t[..., 0] / (t[..., 0] + t[..., 1])
    return p, t


def clb_pt(last_cat: torch.Tensor, cond_lo: torch.Tensor, w1: torch.Tensor,
           b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
           p_eps: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p, t_norm) parameter maps of the ConditionalLogBinomial head.

    last_cat: (B, OH, OW, Cin); cond_lo: (B, IH, IW, Cc), the bin embedding
    at the low (attractor) resolution; both float32 or both bfloat16,
    channels-last or permuted NCHW views. w1/b1: mlp_0 as (Cin+Cc, 80) and
    (80,); w2/b2: mlp_2 as (80, 4) and (4,). Returns p and t_norm, each
    (B, OH, OW) float32, t before the temperature scaling. Differentiable
    in every tensor argument (see Recompute).
    """
    args = (last_cat, cond_lo, w1, b1, w2, b2)
    if _differentiable(*args):
        return Recompute.apply(_clb_pt, clb_pt_plain, dict(p_eps=p_eps),
                               *args)
    return _clb_pt(*args, p_eps=p_eps)


def _clb_pt(last_cat: torch.Tensor, cond_lo: torch.Tensor, w1: torch.Tensor,
            b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
            p_eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """clb_pt's forward: the twin for CPU tensors, else the kernel."""
    if on_cpu(last_cat, cond_lo, w1, b1, w2, b2):
        return clb_pt_plain(last_cat, cond_lo, w1, b1, w2, b2, p_eps)
    weights = _check_clb(last_cat, cond_lo, w1, b1, w2, b2)
    b, oh, ow, cin = last_cat.shape
    _, ih, iw, cc = cond_lo.shape
    if last_cat.dtype == torch.bfloat16:
        _check_clb_bf16(oh, ow, ih, iw, cin, cc)
    p = torch.empty((b, oh, ow), dtype=torch.float32, device=last_cat.device)
    t = torch.empty_like(p)
    err = load_kernels().pf_clb_pt(
        last_cat.data_ptr(), cond_lo.data_ptr(),
        *(w.data_ptr() for w in weights), p.data_ptr(), t.data_ptr(),
        int(last_cat.dtype == torch.bfloat16), b, oh, ow, ih, iw, cin, cc,
        CLB_HIDDEN, *last_cat.stride(), *cond_lo.stride(), float(p_eps),
        last_cat.device.index, stream(last_cat.device))
    raise_on(err, "clb_pt")
    LAUNCHES["clb_pt"] += 1
    return p, t


def _check_clb(last_cat, cond_lo, w1, b1, w2, b2) -> Tuple[torch.Tensor, ...]:
    """Raises on inputs the clb kernels do not take; returns the weights as
    contiguous float32 (w1, b1, w2, b2)."""
    _check_dense_nhwc(last_cat, "last_cat")
    _check_dense_nhwc(cond_lo, "cond_lo")
    if last_cat.dtype != cond_lo.dtype or last_cat.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"last_cat and cond_lo must both be float32 or both "
                        f"bfloat16, got {last_cat.dtype}, {cond_lo.dtype}")
    b, _, _, cin = last_cat.shape
    cb, _, _, cc = cond_lo.shape
    if cb != b:
        raise ValueError(f"batch mismatch: last_cat {b}, cond_lo {cb}")
    hidden = CLB_HIDDEN
    if (tuple(w1.shape) != (cin + cc, hidden) or tuple(b1.shape) != (hidden,)
            or tuple(w2.shape) != (hidden, 4) or tuple(b2.shape) != (4,)):
        raise ValueError(
            f"weights must be w1 ({cin + cc}, {hidden}), b1 ({hidden},), "
            f"w2 ({hidden}, 4), b2 (4,); got {tuple(w1.shape)}, "
            f"{tuple(b1.shape)}, {tuple(w2.shape)}, {tuple(b2.shape)}")
    if (cin + cc) * hidden * 4 > 200 * 1024:  # W1 is staged in shared memory
        raise ValueError(f"input width {cin + cc} too large for the kernel")
    return tuple(w.to(torch.float32).contiguous() for w in (w1, b1, w2, b2))


CLB_BF16_MAX_CIN = 48   # the bf16 clb_pt kernel's padded input channels
CLB_BF16_CC = 128       # and its condition channels
SMEM_LIMIT = 227 * 1024  # shared memory one block may use on the H100


def _check_clb_channels(oh: int, ow: int, ih: int, iw: int, cin: int,
                        cc: int) -> None:
    """What both bf16 clb kernels take beyond _check_clb: up to 48 input
    channels, 128 condition channels, and an upsample (IH <= OH,
    IW <= OW)."""
    if not 0 < cin <= CLB_BF16_MAX_CIN or cc != CLB_BF16_CC:
        raise ValueError(f"the bf16 clb kernels take 1-{CLB_BF16_MAX_CIN} "
                         f"input and {CLB_BF16_CC} condition channels, got "
                         f"{cin} and {cc}")
    if ih > oh or iw > ow:
        raise ValueError(f"the bf16 clb kernels upsample; got {ih}x{iw} "
                         f"-> {oh}x{ow}")


def _check_clb_bf16(oh: int, ow: int, ih: int, iw: int, cin: int,
                    cc: int) -> None:
    """What the bf16 clb_pt kernel takes: _check_clb_channels, and an
    upsample steep enough that an 8 x 32 output tile's low-resolution
    footprint fits in shared memory beside the weights (upsampling by
    about 1.4 or more; the heads upsample by ~1.75 and 2)."""
    _check_clb_channels(oh, ow, ih, iw, cin, cc)
    need = load_kernels().pf_clb_tc_smem(oh, ow, ih, iw)
    if need > SMEM_LIMIT:
        raise ValueError(f"upsample {ih}x{iw} -> {oh}x{ow} too shallow for "
                         f"the bf16 clb_pt kernel: its tile footprint needs "
                         f"{need} bytes of shared memory")


# ---------------------------------------------------------------------------
# clb_logbinomial_depth: clb_pt and logbinomial_depth in one launch
# ---------------------------------------------------------------------------

def clb_logbinomial_depth_plain(last_cat: torch.Tensor, cond_lo: torch.Tensor,
                                centers: torch.Tensor, w1: torch.Tensor,
                                b1: torch.Tensor, w2: torch.Tensor,
                                b2: torch.Tensor, min_temp: float = 0.0212,
                                max_temp: float = 50.0, p_eps: float = 1e-4
                                ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: clb_depth_reference, i.e. the two
    twins composed."""
    p, t = clb_pt_plain(last_cat, cond_lo, w1, b1, w2, b2, p_eps)
    return logbinomial_depth_plain(p, t, centers, min_temp, max_temp)


def clb_logbinomial_depth(last_cat: torch.Tensor, cond_lo: torch.Tensor,
                          centers: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, min_temp: float = 0.0212,
                          max_temp: float = 50.0, p_eps: float = 1e-4
                          ) -> torch.Tensor:
    """Depth of the whole ConditionalLogBinomial stage in one launch:
    logbinomial_depth(*clb_pt(last_cat, cond_lo, w1, b1, w2, b2, p_eps),
    centers, min_temp, max_temp), with p and t kept on the chip (the bf16
    kernel computes both to the bit as the two kernels do).

    last_cat: (B, OH, OW, Cin); cond_lo: (B, IH, IW, Cc) and centers
    (B, IH, IW, K) at the same low resolution; all three float32 or all
    bfloat16, channels-last or permuted NCHW views. Weights as for clb_pt.
    Returns (B, OH, OW) float32. Differentiable in every tensor argument
    (see Recompute).
    """
    args = (last_cat, cond_lo, centers, w1, b1, w2, b2)
    kw = dict(min_temp=min_temp, max_temp=max_temp, p_eps=p_eps)
    if _differentiable(*args):
        return Recompute.apply(_clb_logbinomial_depth,
                               clb_logbinomial_depth_plain, kw, *args)
    return _clb_logbinomial_depth(*args, **kw)


def _clb_logbinomial_depth(last_cat: torch.Tensor, cond_lo: torch.Tensor,
                           centers: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, w2: torch.Tensor,
                           b2: torch.Tensor, min_temp: float,
                           max_temp: float, p_eps: float) -> torch.Tensor:
    """clb_logbinomial_depth's forward: the twin for CPU tensors, else the
    kernel."""
    if on_cpu(last_cat, cond_lo, centers, w1, b1, w2, b2):
        return clb_logbinomial_depth_plain(last_cat, cond_lo, centers, w1,
                                           b1, w2, b2, min_temp, max_temp,
                                           p_eps)
    out = clb_depth_launch(load_kernels(), last_cat, cond_lo, centers, w1,
                           b1, w2, b2, min_temp, max_temp, p_eps)
    LAUNCHES["clb_logbinomial_depth"] += 1
    return out


def clb_depth_launch(lib, last_cat: torch.Tensor, cond_lo: torch.Tensor,
                     centers: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     min_temp: float, max_temp: float,
                     p_eps: float) -> torch.Tensor:
    """Checks CUDA inputs and launches `lib`'s pf_clb_logbinomial_depth
    once (the kernel library, or a timing build of csrc/clb_depth.cu);
    counts nothing. bf16 inputs take clb_depth_plan's plan (raising where
    none fits), with TMA copies for the maps tma_ok allows."""
    weights = _check_clb(last_cat, cond_lo, w1, b1, w2, b2)
    _check_dense_nhwc(centers, "centers")
    if centers.dtype != last_cat.dtype:
        raise TypeError(f"centers must share the inputs' dtype "
                        f"{last_cat.dtype}, got {centers.dtype}")
    b, oh, ow, cin = last_cat.shape
    _, ih, iw, cc = cond_lo.shape
    k = centers.shape[-1]
    if tuple(centers.shape[:3]) != (b, ih, iw):
        raise ValueError(f"centers must be (B, IH, IW, K) = ({b}, {ih}, {iw},"
                         f" K) like cond_lo, got {tuple(centers.shape)}")
    if not 0 < k <= 4096:  # the f32 kernel's c0 table sits beside W1
        raise ValueError(f"unsupported bin count {k}")
    plan = (ctypes.c_int * len(ClbDepthPlan._fields))()
    if last_cat.dtype == torch.bfloat16:
        _check_clb_channels(oh, ow, ih, iw, cin, cc)
        if k > CLB_DEPTH_MAX_BINS:
            raise ValueError(f"the bf16 clb_logbinomial_depth kernel takes "
                             f"up to {CLB_DEPTH_MAX_BINS} bins, got {k}")
        tma = (TMA_COND * tma_ok(cond_lo) + TMA_CENT * tma_ok(centers)
               + TMA_LAST * tma_ok(last_cat))
        plan[:] = clb_depth_plan(oh, ow, ih, iw, cin, k, tma)
    out = torch.empty((b, oh, ow), dtype=torch.float32,
                      device=last_cat.device)
    err = lib.pf_clb_logbinomial_depth(
        last_cat.data_ptr(), cond_lo.data_ptr(), centers.data_ptr(),
        *(w.data_ptr() for w in weights),
        _c0_table(k, last_cat.device).data_ptr(), out.data_ptr(),
        int(last_cat.dtype == torch.bfloat16), plan, b, oh, ow, ih, iw, cin,
        cc, k, CLB_HIDDEN, *last_cat.stride(), *cond_lo.stride(),
        *centers.stride(), float(p_eps), float(min_temp), float(max_temp),
        last_cat.device.index, stream(last_cat.device))
    raise_on(err, "clb_logbinomial_depth")
    return out


# ---------------------------------------------------------------------------
# the bf16 clb_logbinomial_depth kernel's plan (csrc/clb_depth.cu's Plan,
# field for field; the kernel checks it before each launch)
# ---------------------------------------------------------------------------

CLB_DEPTH_MAX_BINS = 128
CLB_DEPTH_TW = 32                  # tile columns
CLB_DEPTH_TILE_ROWS = (8, 4)       # tile rows, in the order tried
CLB_DEPTH_MAX_CHUNK = 64           # bins per H-lerp chunk, at most
CLB_DEPTH_DEPTH_WARPS = 4
# ClbDepthPlan.tma bits: the maps the kernel copies by TMA boxes
TMA_COND, TMA_CENT, TMA_LAST = 1, 2, 4


class ClbDepthPlan(NamedTuple):
    th: int      # tile rows
    fy: int      # footprint rows of a tile, at most
    fx: int      # footprint columns of a tile, at most
    ws: int      # staged footprint columns: fx + 7 rounded up to 8
    tma: int     # TMA_* bits
    kc: int      # bins per H-lerp chunk (even)
    smem: int    # bytes of shared memory


def tma_ok(t: torch.Tensor) -> bool:
    """Whether the kernel can copy a bf16 (B, H, W, C) view by TMA boxes: a
    permuted NCHW tensor (each channel's H W pixels contiguous) whose base
    and channel and batch strides are 16-byte aligned, with at most 256
    channels (a box's limit)."""
    b, h, w, c = t.shape
    return (t.stride(2) == 1 and t.stride(1) == w and c <= 256
            and t.data_ptr() % 16 == 0
            and all((2 * t.stride(d)) % 16 == 0 for d in (0, 3)))


def align_corners_taps(out_size: int, in_size: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(i0, i1) per output index of an out -> in bilinear align_corners
    resize, as the kernels take them (pf::align_corners_tap: the source
    coordinate in float32, clipped, floored)."""
    src = np.clip(_source_coords(out_size, in_size, True), 0, in_size - 1)
    i0 = np.floor(src).astype(np.int64)
    return i0, np.minimum(i0 + 1, in_size - 1)


def tile_footprints(out_size: int, in_size: int, tile: int
                    ) -> Iterator[Tuple[int, int, int]]:
    """(first output, first source index, source span) of each tile of
    `tile` outputs along one axis: the tile's taps cover source indices
    first .. first + span - 1 (the kernel's window for the tile)."""
    i0, i1 = align_corners_taps(out_size, in_size)
    for o in range(0, out_size, tile):
        last = min(o + tile, out_size) - 1
        yield o, int(i0[o]), int(i1[last] - i0[o] + 1)


def clb_depth_smem(th: int, fy: int, fx: int, ws: int, kc: int, cin: int,
                   k: int) -> int:
    """Bytes of shared memory of the kernel's layout (csrc/clb_depth.cu
    layout(): W1 hi + lo, W2, b1, b2, c0 and its pairs, the mbarriers; the
    last_cat tile, the condition footprint, its f32 projection, the two p /
    t slots, the centers footprint, the depth warps' H-lerped rows; 128 for
    the base's alignment)."""
    def a128(n):
        return (n + 127) & ~127
    k2 = k + (k & 1)
    hid, cc = CLB_HIDDEN, 128
    o = (2 * hid * (48 + cc + 8) * 2 + 8 * (hid + 8) * 2 + hid * 4 + 16
         + ((4 * k + 15) & ~15) + k2 // 2 * 16 + 32)
    o = a128(o) + th * a128(cin * (CLB_DEPTH_TW + 8) * 2)
    o += fy * cc * ws * 2 + fy * fx * (hid + 8) * 4
    o = a128(o + 2 * 2 * CLB_DEPTH_TW * th * 4)
    o += fy * a128(k * ws * 2)
    return o + CLB_DEPTH_DEPTH_WARPS * fx * ((kc // 2) | 1) * 8 + 128


@functools.lru_cache(maxsize=64)
def clb_depth_plan(oh: int, ow: int, ih: int, iw: int, cin: int, k: int,
                   tma: int) -> ClbDepthPlan:
    """The bf16 kernel's plan for this shape: the first of 8 and 4 tile
    rows, with the largest H-lerp chunk of bins (at most 64, at least 16
    where either height allows it), whose buffers fit the H100's 227 KB of
    shared memory; the footprint rows and columns are the largest over the
    shape's tiles, a staged row holds 7 columns more (a TMA box starts on
    the 8-pixel boundary at or before the footprint) rounded up to 8;
    `tma` names the maps copied by TMA (TMA_* bits, from tma_ok). Raises
    ValueError where none fits (an upsample too shallow for the tiles'
    footprints). Cached per shape: the wrapper asks on every call."""
    fx = max(span for _, _, span in tile_footprints(ow, iw, CLB_DEPTH_TW))
    ws = (fx + 14) // 8 * 8
    need = None
    top = min(k + (k & 1), CLB_DEPTH_MAX_CHUNK)
    # chunks of at least 16 bins where either tile height allows them
    for low in (min(16, top), 2):
        for th in CLB_DEPTH_TILE_ROWS:
            fy = max(span for _, _, span in tile_footprints(oh, ih, th))
            for kmax in range(top, low - 1, -2):
                chunks = -(-k // kmax)
                kc = -(-(-(-k // chunks)) // 2) * 2
                smem = clb_depth_smem(th, fy, fx, ws, kc, cin, k)
                if smem <= SMEM_LIMIT:
                    return ClbDepthPlan(th, fy, fx, ws, tma, kc, smem)
                need = smem if need is None else min(need, smem)
    raise ValueError(f"upsample {ih}x{iw} -> {oh}x{ow} too shallow for the "
                     f"bf16 clb_logbinomial_depth kernel: its smallest tile "
                     f"needs {need} bytes of shared memory")
