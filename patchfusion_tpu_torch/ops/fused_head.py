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
    `*_reference` functions (pallas_head.py:670-745).
  * a launch count in `LAUNCHES`, raised by one per kernel launch and
    nowhere else.

The kernels live in `patchfusion_tpu_torch/csrc/` (built and loaded by
`ops/cuda_lib.py`). They read their 4-D inputs through strides, so the
model hands them permuted views of its NCHW tensors instead of
channels-last copies.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from patchfusion_tpu_torch.ops.cuda_lib import (load_kernels, on_cpu,
                                                raise_on, stream)
from patchfusion_tpu_torch.ops.resize import interpolate

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
    cent = interpolate(centers.to(torch.float32), (oh, ow), mode="bilinear",
                       align_corners=True)
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


def logbinomial_depth(p: torch.Tensor, t: torch.Tensor,
                      centers: torch.Tensor, min_temp: float = 0.0212,
                      max_temp: float = 50.0) -> torch.Tensor:
    """Depth expectation of the log-binomial bins.

    p, t: (B, OH, OW) float32 (t before the min/max temperature scaling);
    centers: (B, IH, IW, K) bin centers, float32 or bfloat16, channels-last
    or a permuted NCHW view. Returns (B, OH, OW) float32.
    """
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
    bb = interpolate(bb, (oh, ow), mode="bilinear", align_corners=True)
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
    (B, OH, OW) float32, t before the temperature scaling.
    """
    if on_cpu(last_cat, cond_lo, w1, b1, w2, b2):
        return clb_pt_plain(last_cat, cond_lo, w1, b1, w2, b2, p_eps)
    weights = _check_clb(last_cat, cond_lo, w1, b1, w2, b2)
    b, oh, ow, cin = last_cat.shape
    _, ih, iw, cc = cond_lo.shape
    if last_cat.dtype == torch.bfloat16:
        _check_clb_bf16(oh, ow, ih, iw, cin, cc, 0)
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


def _check_clb_bf16(oh: int, ow: int, ih: int, iw: int, cin: int, cc: int,
                    k: int) -> None:
    """What the bf16 clb kernels (clb_pt, and with k bins
    clb_logbinomial_depth) take beyond _check_clb: up to 48 input channels,
    128 condition channels, up to 128 bins (staged in the condition's
    buffer), and an upsample (IH <= OH, IW <= OW) steep enough that an
    8 x 32 output tile's low-resolution footprint fits in shared memory
    beside the weights (upsampling by about 1.2 or more; the head upsamples
    by ~1.75)."""
    if not 0 < cin <= CLB_BF16_MAX_CIN or cc != CLB_BF16_CC:
        raise ValueError(f"the bf16 clb_pt kernel takes 1-{CLB_BF16_MAX_CIN} "
                         f"input and {CLB_BF16_CC} condition channels, got "
                         f"{cin} and {cc}")
    if k > CLB_BF16_CC:
        raise ValueError(f"the bf16 clb_logbinomial_depth kernel takes up to "
                         f"{CLB_BF16_CC} bins, got {k}")
    if ih > oh or iw > ow:
        raise ValueError(f"the bf16 clb_pt kernel upsamples; got {ih}x{iw} "
                         f"-> {oh}x{ow}")
    need = load_kernels().pf_clb_tc_smem(oh, ow, ih, iw, k)
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
    centers, min_temp, max_temp), with p and t kept in registers.

    last_cat: (B, OH, OW, Cin); cond_lo: (B, IH, IW, Cc) and centers
    (B, IH, IW, K) at the same low resolution; all three float32 or all
    bfloat16, channels-last or permuted NCHW views. Weights as for clb_pt.
    Returns (B, OH, OW) float32.
    """
    if on_cpu(last_cat, cond_lo, centers, w1, b1, w2, b2):
        return clb_logbinomial_depth_plain(last_cat, cond_lo, centers, w1,
                                           b1, w2, b2, min_temp, max_temp,
                                           p_eps)
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
    if not 0 < k <= 4096:  # the c0 table sits beside W1 in shared memory
        raise ValueError(f"unsupported bin count {k}")
    if last_cat.dtype == torch.bfloat16:
        _check_clb_bf16(oh, ow, ih, iw, cin, cc, k)
    out = torch.empty((b, oh, ow), dtype=torch.float32,
                      device=last_cat.device)
    err = load_kernels().pf_clb_logbinomial_depth(
        last_cat.data_ptr(), cond_lo.data_ptr(), centers.data_ptr(),
        *(w.data_ptr() for w in weights), out.data_ptr(),
        int(last_cat.dtype == torch.bfloat16), b, oh, ow, ih, iw, cin, cc, k,
        CLB_HIDDEN, *last_cat.stride(), *cond_lo.stride(), *centers.stride(),
        float(p_eps), float(min_temp), float(max_temp),
        last_cat.device.index, stream(last_cat.device))
    raise_on(err, "clb_logbinomial_depth")
    LAUNCHES["clb_logbinomial_depth"] += 1
    return out
