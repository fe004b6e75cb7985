"""Guided-fusion U-Net (patchfusion_tpu/models/fusion.py; reference
estimator/models/blocks/guided_fusion_model.py).

A 6-level U-Net over the 5-channel tile input (coarse-depth ROI, fine
depth, RGB crop). Every decoder level fuses the `guide_cat` skip and the
G2L-attended whole-image coarse feature cropped to the tile. As in the JAX
package, the G2L attention runs once per image (`attend_coarse`) and this
module takes the pre-cropped `g2l_roi` features, instead of re-running G2L
per tile chunk as the reference does (gf:201-202).

Training follows the JAX package's flax semantics, not torch's defaults:
the BatchNorms update their running statistics as flax's
`nn.BatchNorm(momentum=0.9)` does (`FlaxBatchNorm2d`), and `remat=True`
recomputes the blocks flax's `nn.remat` wraps (`remat_call`), without
updating those statistics a second time.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from patchfusion_tpu_torch.models.swin import G2LFusion
from patchfusion_tpu_torch.ops.resize import interpolate_nchw


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d (eps 1e-5) whose train mode updates its running
    statistics as flax's `nn.BatchNorm(momentum=0.9)` does
    (patchfusion_tpu/models/fusion.py:42,48): 0.9 * running + 0.1 * batch,
    with the biased batch variance (torch keeps the unbiased one,
    n / (n - 1) larger), reduced in f32. It normalises with the batch mean
    and biased variance, as both frameworks do; torch takes the variance in
    two passes where flax takes E[x^2] - E[x]^2, which loses digits where
    a channel's mean is large against its spread. In eval mode it is
    BatchNorm2d. While `recomputing` is set (remat_call's recompute) it
    leaves the running statistics alone."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.recomputing = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if not self.recomputing:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           unbiased=False)
                rm, rv = self.running_mean, self.running_var
                rm.lerp_(mean.to(rm.dtype), self.momentum)
                rv.lerp_(var.to(rv.dtype), self.momentum)
                self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)


@contextlib.contextmanager
def _recomputing(fn: Callable):
    """Marks the FlaxBatchNorm2d layers of `fn` (where it is a module) as
    recomputing for the block."""
    bns = [m for m in fn.modules() if isinstance(m, FlaxBatchNorm2d)] \
        if isinstance(fn, nn.Module) else []
    for bn in bns:
        bn.recomputing = True
    try:
        yield
    finally:
        for bn in bns:
            bn.recomputing = False


def remat_call(remat: bool, fn: Callable, *args):
    """fn(*args), recomputed in the backward (torch.utils.checkpoint,
    non-reentrant) when `remat` is set and a gradient is being recorded:
    flax's nn.remat, which keeps the parameter tree. During the recompute
    the FlaxBatchNorm2d layers of fn (where it is a module) do not update
    their running statistics again."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recomputing(fn)))


class DoubleConvBN(nn.Module):
    """(conv3x3 no-bias -> BN -> relu) x2 (reference gf:52-69), with flax's
    BatchNorm update rule in train mode (FlaxBatchNorm2d)."""

    def __init__(self, cin: int, out: int, mid: int = None):
        super().__init__()
        mid = mid or out
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, mid, 3, padding=1, bias=False),
            FlaxBatchNorm2d(mid), nn.ReLU(),
            nn.Conv2d(mid, out, 3, padding=1, bias=False),
            FlaxBatchNorm2d(out), nn.ReLU())

    def forward(self, x):
        return self.double_conv(x)


class DoubleConvWOBN(nn.Module):
    """(conv3x3 + bias -> relu) x2 (reference gf:34-50)."""

    def __init__(self, cin: int, out: int, mid: int = None):
        super().__init__()
        mid = mid or out
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, mid, 3, padding=1), nn.ReLU(),
            nn.Conv2d(mid, out, 3, padding=1), nn.ReLU())

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, cin: int, out: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConvBN(cin, out))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    def __init__(self, cin: int, out: int, mid: int):
        super().__init__()
        self.conv = DoubleConvWOBN(cin, out, mid)


class GuidedFusion(nn.Module):
    """reference GuidedFusionPatchFusion (gf:102-206) with hoisted G2L/ROI.

    in_channels: the U-Net encoder channels high -> low resolution
    ([32, C, C, C, C, C]); depth/num_heads/num_patches: the per-level G2L
    stacks in the same high -> low order, as in the configs. The guide
    features share the decoder widths (inv[i - 1]), as in every config.
    remat: recompute every conv block and G2L stage in the backward
    (flax's nn.remat in the JAX package, fusion.py:87-99); the parameter
    tree is the same.
    """

    def __init__(self, n_channels: int = 5,
                 in_channels: Sequence[int] = (32, 256, 256, 256, 256, 256),
                 depth: Sequence[int] = (2, 2, 3, 3, 4, 4),
                 num_heads: Sequence[int] = (8, 8, 16, 16, 32, 32),
                 num_patches: Sequence[int] = (392 * 518, 224 * 296,
                                               112 * 148, 56 * 74, 28 * 37,
                                               14 * 19),
                 g2l: bool = True, window: int = 12, remat: bool = False):
        super().__init__()
        self.remat = remat
        if not g2l:
            raise NotImplementedError("g2l=False is not ported")
        chans = list(in_channels)
        inv = chans[::-1]
        self.inc = DoubleConvBN(n_channels, chans[0])
        self.down_conv_list = nn.ModuleList(
            [Down(chans[i], chans[i + 1]) for i in range(len(chans) - 1)])
        self.up_conv_list = nn.ModuleList([
            Up(inv[i] + 2 * inv[i - 1], inv[i], inv[i] + 2 * inv[i - 1])
            for i in range(1, len(inv))])
        heads_inv = list(num_heads)[::-1]
        depth_inv = list(depth)[::-1]
        np_inv = list(num_patches)[::-1]
        self.g2l_list = nn.ModuleList([
            G2LFusion(inv[i], window, heads_inv[i], depth_inv[i], np_inv[i])
            for i in range(len(inv))])
        self.convs = nn.ModuleList(
            [DoubleConvWOBN(2 * c, c, c) for c in inv])

    def attend_coarse(self, coarse_feats: List[torch.Tensor]
                      ) -> List[torch.Tensor]:
        """Per-level G2L attention over the whole-image coarse features
        (low -> high resolution). Once per image."""
        return [remat_call(self.remat, g, f)
                for g, f in zip(self.g2l_list, coarse_feats)]

    def forward(self, input_tensor: torch.Tensor,
                guide_cat: List[torch.Tensor],
                g2l_roi: List[torch.Tensor]) -> List[torch.Tensor]:
        """input_tensor (N, 5, H, W); guide_cat: 6 fusion-conv outputs low ->
        high resolution; g2l_roi: 6 ROI-cropped attended coarse features low
        -> high, whose sizes set the decoder grid. Returns the 6 decoder
        outputs low -> high resolution."""
        x = remat_call(self.remat, self.inc, input_tensor)
        feats = [x]
        for down in self.down_conv_list:
            pool, conv = down.maxpool_conv
            x = remat_call(self.remat, conv, pool(x))
            feats.append(x)
        outputs = []
        temp = None
        for idx, (enc, froi) in enumerate(zip(feats[::-1], g2l_roi)):
            size = tuple(froi.shape[-2:])
            if tuple(enc.shape[-2:]) != size:
                enc = interpolate_nchw(enc, size, mode="bilinear",
                                       align_corners=True)
            if idx > 0:
                up_in = torch.cat([temp, guide_cat[idx - 1]], dim=1)
                up_in = interpolate_nchw(up_in, size, mode="bilinear",
                                         align_corners=True)
                enc = remat_call(self.remat, self.up_conv_list[idx - 1].conv,
                                 torch.cat([enc, up_in], dim=1))
            x = remat_call(self.remat, self.convs[idx],
                           torch.cat([enc, froi], dim=1))
            temp = x
            outputs.append(x)
        return outputs
