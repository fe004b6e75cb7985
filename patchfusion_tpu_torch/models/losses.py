"""Training loss (patchfusion_tpu/models/losses.py; reference
estimator/models/losses.py).

SILogLoss is the only loss a shipped config uses (`sigloss=dict(type=
'SILogLoss')`). The JAX package's research losses (EdgeClsLoss, ErrorLoss,
EdgeguidedRankingLoss, ScaleAndShiftInvariantLoss, ExistLoss) are not
ported yet (ROADMAP.md). Masks select by `torch.where`, as the JAX
package's static-shape formulation does, so no step waits on the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from patchfusion_tpu_torch.config.registry import MODELS
from patchfusion_tpu_torch.ops.resize import interpolate_nchw


@MODELS.register_module
class SILogLoss:
    """Scale-invariant log loss (reference losses.py:14-60):
    10 * sqrt(var(g) + beta * mean(g)^2), g = log(pred + 1e-7) -
    log(gt + 1e-7), over the pixels with min_depth < gt < max_depth; the
    variance is unbiased (n - 1), as torch.var's default. Returns 0 where
    fewer than 2 pixels are valid (the reference's nan-guard, ls:37-40),
    with a zero gradient there."""

    def __init__(self, beta: float = 0.15, **kwargs):
        self.beta = beta

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 min_depth: float, max_depth: float,
                 additional_mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """pred (B, 1, h, w), target (B, 1, H, W), NCHW; additional_mask a
        boolean map like target. A bf16 pred (--amp) is reduced in f32; a
        pred of another size is resized to the target's (bilinear,
        align_corners=True)."""
        pred = pred.float()
        h_i, w_i = pred.shape[-2:]  # the pre-resize size, as the reference
        if tuple(pred.shape[-2:]) != tuple(target.shape[-2:]):
            pred = interpolate_nchw(pred, tuple(target.shape[-2:]),
                                    mode="bilinear", align_corners=True)
        mask = (target > min_depth) & (target < max_depth)
        if additional_mask is not None:
            # stability fallback (reference ls:30-36): when the merged mask
            # covers < 0.1% of the pred's pixel count, keep the plain
            # validity mask
            merged = mask & additional_mask
            enough = merged.sum() >= h_i * w_i * 0.001
            mask = torch.where(enough, merged, mask)
        n = mask.sum().float()
        alpha = 1e-7
        g = torch.where(mask, torch.log(pred + alpha)
                        - torch.log(target + alpha), 0.0)
        mean = g.sum() / n.clamp(min=1.0)
        var = torch.where(mask, (g - mean) ** 2, 0.0).sum() \
            / (n - 1.0).clamp(min=1.0)
        valid = n > 1
        # the square root only of a valid sum, so that no 0 / 0 reaches the
        # gradient of the discarded branch
        safe = torch.where(valid, var + self.beta * mean ** 2, 1.0)
        return torch.where(valid, 10.0 * torch.sqrt(safe), 0.0)
