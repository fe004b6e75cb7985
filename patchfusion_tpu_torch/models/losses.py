"""Training losses (patchfusion_tpu/models/losses.py; reference
estimator/models/losses.py), NCHW.

SILogLoss is the only loss a shipped config uses (`sigloss=dict(type=
'SILogLoss')`). The research losses (EdgeClsLoss, ErrorLoss,
EdgeguidedRankingLoss, ScaleAndShiftInvariantLoss, ExistLoss) and their
helpers (get_incoherent_mask, the Sobel maps, dice and focal) are the JAX
package's, with its call signatures and NCHW where it is NHWC; each is
registered in MODELS as there. Masks select by `torch.where`, as the JAX
package's static-shape formulation does, so no step waits on the host.
The ranking loss draws its samples from an explicit torch.Generator on
the tensors' device (the JAX package's PRNG key), or takes them injected.

With `global_batch=True` (the data-parallel step asks for it) SILog is
the loss of the global batch over the ranks of the process group, as the
JAX step computes it over the global array: the valid count, the sum of g
and the sum of squared deviations are reduced across the ranks
(parallel/dist.all_reduce_sum, differentiable). SILog is not linear in
the batch, so averaging each rank's loss would give another loss and
another gradient. The research losses reduce over the batch they are
given, as in the JAX package; no training step calls them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from patchfusion_tpu_torch.config.registry import MODELS
from patchfusion_tpu_torch.ops.resize import interpolate_nchw
from patchfusion_tpu_torch.parallel.dist import all_reduce_, all_reduce_sum


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
                 additional_mask: Optional[torch.Tensor] = None,
                 global_batch: bool = False) -> torch.Tensor:
        """pred (B, 1, h, w), target (B, 1, H, W), NCHW; additional_mask a
        boolean map like target. A bf16 pred (--amp) is reduced in f32; a
        pred of another size is resized to the target's (bilinear,
        align_corners=True). global_batch: this rank's batch is a shard;
        reduce over every rank's (module docstring)."""
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
            count = merged.sum()
            if global_batch:
                all_reduce_(count)
            enough = count >= h_i * w_i * 0.001
            mask = torch.where(enough, merged, mask)
        alpha = 1e-7
        g = torch.where(mask, torch.log(pred + alpha)
                        - torch.log(target + alpha), 0.0)
        if global_batch:
            n, sum_g = all_reduce_sum(torch.stack([mask.sum().float(),
                                                   g.sum()]))
            mean = sum_g / n.clamp(min=1.0)
            var = all_reduce_sum(torch.where(mask, (g - mean) ** 2,
                                             0.0).sum()) \
                / (n - 1.0).clamp(min=1.0)
        else:
            n = mask.sum().float()
            mean = g.sum() / n.clamp(min=1.0)
            var = torch.where(mask, (g - mean) ** 2, 0.0).sum() \
                / (n - 1.0).clamp(min=1.0)
        valid = n > 1
        # the square root only of a valid sum, so that no 0 / 0 reaches the
        # gradient of the discarded branch
        safe = torch.where(valid, var + self.beta * mean ** 2, 1.0)
        return torch.where(valid, 10.0 * torch.sqrt(safe), 0.0)


def _sobel_grad_map(x: torch.Tensor) -> torch.Tensor:
    """|grad| of (B, 1, H, W) by the 3x3 Sobel pair divided by 8, over a
    reflect-padded border (kornia's spatial_gradient default, which the
    reference uses, losses.py:63-66). Where the magnitude is 0 (at a corner
    the reflected neighbours cancel) its gradient is 0: the JAX package's
    sqrt gives NaN there, which reaches every input pixel of that window
    whatever the loss does with the magnitude."""
    kx = torch.tensor([[-1., 0., 1.], [-2., 0., 2.], [-1., 0., 1.]],
                      device=x.device) / 8.0
    g = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"),
                 torch.stack([kx, kx.T])[:, None])
    sq = g[:, :1] ** 2 + g[:, 1:] ** 2
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def get_incoherent_mask(gt: torch.Tensor, shape=(384, 512), min_depth=1e-3,
                        max_depth=80,
                        coarse_prediction: Optional[torch.Tensor] = None,
                        use_grad: bool = False,
                        use_value: bool = False) -> torch.Tensor:
    """Incoherence labels (reference losses.py:90-149) of gt (B, 1, H, W):
    1 where detail is lost at `shape` (|gt - up(down(gt))| >= 0.01), or'd
    with the coarse prediction's gradient error (use_grad) or value error
    (use_value); 2 outside (min_depth, max_depth); 3 where gt > 10000; else
    0. Returns (B, H, W) int64. The gradient error divides by gt, as the
    JAX package does: where gt = 0 its NaN counts as coherent and its inf
    as incoherent (IEEE comparisons), and such pixels are labelled 2."""
    ori = tuple(gt.shape[-2:])
    gt_lr = interpolate_nchw(gt, tuple(shape), align_corners=True)
    gt_rec = interpolate_nchw(gt_lr, ori, align_corners=True)
    bad = (gt - gt_rec).abs() >= 0.01
    if coarse_prediction is not None and (use_grad or use_value):
        cp = interpolate_nchw(coarse_prediction, ori, align_corners=True)
        if use_grad:
            grad_err = ((_sobel_grad_map(gt) - _sobel_grad_map(cp))
                        / gt).abs()
            bad = bad | (grad_err > 0.001)
        if use_value:
            bad = bad | ((gt - cp).abs() > 0.5)
    label = bad.long()
    label = torch.where((gt <= min_depth) | (gt >= max_depth), 2, label)
    label = torch.where(gt > 10000, 3, label)
    return label[:, 0]


def _one_hot(labels: torch.Tensor, n_classes: int,
             dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W) labels -> (B, C, H, W); a label outside [0, C) gives a
    row of zeros, as jax.nn.one_hot does (F.one_hot raises there, and
    ErrorLoss's labels 2 and 3 meet a 2-class head)."""
    classes = torch.arange(n_classes, device=labels.device)
    return (labels[:, None] == classes[None, :, None, None]).to(dtype)


def _dice_loss(probs: torch.Tensor, labels: torch.Tensor,
               n_classes: int) -> torch.Tensor:
    """Soft dice over class probabilities (kornia.losses.dice_loss):
    probs (B, C, H, W), labels (B, H, W) int."""
    onehot = _one_hot(labels, n_classes, probs.dtype)
    inter = (probs * onehot).sum((2, 3))
    card = (probs + onehot).sum((2, 3))
    return (1.0 - 2.0 * inter / (card + 1e-8)).mean()


def _focal_loss(probs: torch.Tensor, labels: torch.Tensor, n_classes: int,
                alpha: float = 0.5, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss over class probabilities (kornia.losses.focal_loss,
    mean reduction): probs (B, C, H, W), labels (B, H, W) int."""
    onehot = _one_hot(labels, n_classes, probs.dtype)
    p = probs.clamp(1e-8, 1.0)
    w = alpha * (1.0 - p) ** gamma
    return (-w * onehot * torch.log(p)).sum(1).mean()


@MODELS.register_module
class EdgeClsLoss:
    """Edge classification loss: dice + focal over predicted edge-class
    probabilities (reference losses.py:176-197)."""

    def __init__(self, focal_weight: float = 0.5, **kwargs):
        self.focal_weight = focal_weight

    def __call__(self, probs: torch.Tensor, target: torch.Tensor):
        """probs (B, C, h, w), resized to target's size (bilinear,
        align_corners=True); target (B, H, W) int labels. -> (dice,
        focal)."""
        if tuple(probs.shape[-2:]) != tuple(target.shape[-2:]):
            probs = interpolate_nchw(probs, tuple(target.shape[-2:]),
                                     align_corners=True)
        n_classes = probs.shape[1]
        return (_dice_loss(probs, target, n_classes),
                _focal_loss(probs, target, n_classes,
                            alpha=self.focal_weight))


@MODELS.register_module
class ErrorLoss:
    """Error-region prediction loss (reference losses.py:200-236): the
    incoherence labels of the gt and the coarse prediction (loss_type
    containing "grad" and / or "depth" adds those error terms) supervise
    the error head with dice + focal."""

    def __init__(self, loss_type: str = "incoh", focal_weight: float = 0.5,
                 **kwargs):
        self.loss_type = loss_type
        self.focal_weight = focal_weight

    def __call__(self, probs: torch.Tensor, target: torch.Tensor,
                 coarse_prediction: torch.Tensor, min_depth: float,
                 max_depth: float):
        """probs (B, C, h, w); target (B, 1, H, W) depth; coarse_prediction
        (B, 1, h', w'). -> (dice, focal, labels (B, H, W))."""
        shape = tuple(probs.shape[-2:])
        if shape != tuple(target.shape[-2:]):
            probs = interpolate_nchw(probs, tuple(target.shape[-2:]),
                                     align_corners=True)
        gt_mask = get_incoherent_mask(
            target, shape=shape, min_depth=min_depth, max_depth=max_depth,
            coarse_prediction=coarse_prediction,
            use_grad="grad" in self.loss_type,
            use_value="depth" in self.loss_type)
        n_classes = probs.shape[1]
        return (_dice_loss(probs, gt_mask, n_classes),
                _focal_loss(probs, gt_mask, n_classes,
                            alpha=self.focal_weight), gt_mask)


def _ranking_edge_maps(gray: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's getEdge (losses.py:285-300) of (B, H, W): the raw
    3x3 Sobel pair without padding, its magnitude and angle zero-padded
    back to full size (the border's edges and angles are 0)."""
    kx = torch.tensor([[-1., 0., 1.], [-2., 0., 2.], [-1., 0., 1.]],
                      device=gray.device)
    ky = torch.tensor([[1., 2., 1.], [0., 0., 0.], [-1., -2., -1.]],
                      device=gray.device)
    g = F.conv2d(gray[:, None], torch.stack([kx, ky])[:, None])
    gx, gy = g[:, 0], g[:, 1]
    edges = F.pad(torch.sqrt(gx ** 2 + gy ** 2), (1, 1, 1, 1))
    thetas = F.pad(torch.atan2(gy, gx), (1, 1, 1, 1))
    return edges, thetas


@MODELS.register_module
class EdgeguidedRankingLoss:
    """Edge-guided ranking loss (reference losses.py:255-539): anchors on
    the image's edges, 4 points walked along the edge normal (or its
    90-degree rotation, by a coin per image), and a ratio-thresholded
    ranking loss on the chained pairs (a, b), (b, c), (c, d).

    Static shapes, as the JAX package: point_pairs anchors per image with
    a validity mask. The samples come from a torch.Generator on the
    tensors' device: anchors uniform over the allowed pixels (the
    reference's randint over the nonzero list; over every pixel where an
    image has none, as the JAX package's categorical over all-masked
    logits), distances in [2, 30], the coin in [0, 1). `anchor_rc` /
    `dist` / `direct_p` inject them instead."""

    def __init__(self, point_pairs: int = 10000, sigma: float = 0.03,
                 alpha: float = 1.0, mask_value: float = -1e-8,
                 reweight_target: bool = False,
                 only_missing_area: bool = False, min_depth: float = -1e-3,
                 max_depth: float = 80, missing_value: float = -99,
                 random_direct: bool = True, **kwargs):
        self.point_pairs = point_pairs
        self.sigma = sigma
        self.alpha = alpha
        self.reweight_target = reweight_target
        self.only_missing_area = only_missing_area
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.missing_value = missing_value
        self.random_direct = random_direct

    def sample(self, anchor_ok: torch.Tensor, generator: torch.Generator
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(anchor_rc (B, n, 2) int64, dist (B, 4, n) int64, direct_p (B,))
        drawn from `generator` for the allowed anchors (B, H, W)."""
        b, h, w = anchor_ok.shape
        n_s = self.point_pairs
        weight = anchor_ok.reshape(b, -1).float()
        weight = torch.where(weight.sum(1, keepdim=True) > 0, weight, 1.0)
        flat = torch.multinomial(weight, n_s, replacement=True,
                                 generator=generator)
        dist = torch.randint(2, 31, (b, 4, n_s), generator=generator,
                             device=anchor_ok.device)
        direct_p = torch.rand(b, generator=generator,
                              device=anchor_ok.device)
        return torch.stack([flat // w, flat % w], -1), dist, direct_p

    def anchor_mask(self, targets: torch.Tensor, images: torch.Tensor,
                    depth_gt: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(allowed anchors (B, H, W) bool, edge angles (B, H, W)) of
        inputs already at the prediction's size."""
        edges, thetas = _ranking_edge_maps(images[:, 0])
        if self.only_missing_area:
            return (depth_gt == self.missing_value)[:, 0], thetas
        strict = ((depth_gt > self.min_depth) & (depth_gt < self.max_depth)
                  & (targets != 80))
        emax = edges.amax((1, 2), keepdim=True)
        return (edges >= 0.1 * emax) & strict[:, 0], thetas

    def __call__(self, inputs: torch.Tensor, targets: torch.Tensor,
                 images: torch.Tensor, depth_gt: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 anchor_rc: Optional[torch.Tensor] = None,
                 dist: Optional[torch.Tensor] = None,
                 direct_p: Optional[torch.Tensor] = None) -> torch.Tensor:
        """inputs / targets / depth_gt (B, 1, H, W); images (B, 3, H, W);
        the last three resized to inputs' size (bilinear,
        align_corners=True). generator: where the samples come from, unless
        anchor_rc (B, n, 2) int (row, col), dist (B, 4, n) in [2, 30] and
        direct_p (B,) in [0, 1) inject them (reference losses.py:321-322,
        337, 346)."""
        hw = tuple(inputs.shape[-2:])
        targets, images, depth_gt = (
            interpolate_nchw(x, hw, align_corners=True)
            for x in (targets, images, depth_gt))
        b, _, h, w = inputs.shape
        anchor_ok, thetas = self.anchor_mask(targets, images, depth_gt)
        if anchor_rc is None:
            if generator is None:
                raise ValueError("EdgeguidedRankingLoss: pass a "
                                 "torch.Generator or injected samples")
            anchor_rc, dist, direct_p = self.sample(anchor_ok, generator)
        elif not self.random_direct:
            direct_p = torch.zeros(b, device=inputs.device)
        elif direct_p is None:
            raise ValueError(
                "EdgeguidedRankingLoss: anchor_rc injected with "
                "random_direct=True requires direct_p (the per-image "
                "direction coin flips the reference draws at "
                "losses.py:346)")
        ah, aw = anchor_rc[..., 0].long(), anchor_rc[..., 1].long()
        n_s = ah.shape[1]
        theta_a = thetas.reshape(b, -1).gather(1, ah * w + aw)
        sign = torch.tensor([-1., -1., 1., 1.],
                            device=inputs.device)[None, :, None]
        sdist = dist.float() * sign  # (B, 4, n)

        # two direction branches (reference losses.py:346-360): p < 0.5
        # walks along theta; otherwise along theta + pi/2, with the
        # reference's literal sin/cos swap after wrapping (remainder takes
        # the divisor's sign, as jnp.mod)
        th2 = torch.remainder(theta_a + math.pi + math.pi / 2,
                              2 * math.pi) - math.pi
        use_rot = ((direct_p >= 0.5) & self.random_direct)[:, None]
        dcol = torch.where(use_rot, torch.sin(th2), torch.cos(theta_a))
        drow = torch.where(use_rot, torch.cos(th2), torch.sin(theta_a))
        # torch.round rounds half to even, as jnp.round
        col = aw[:, None] + torch.round(sdist * dcol[:, None]).long()
        row = ah[:, None] + torch.round(sdist * drow[:, None]).long()
        valid = ((col >= 0) & (col <= w - 1) & (row >= 0)
                 & (row <= h - 1)).all(1)  # (B, n)
        lin = (row.clamp(0, h - 1) * w + col.clamp(0, w - 1)).reshape(b, -1)

        def gather(img):
            return img.reshape(b, -1).gather(1, lin).reshape(b, 4, n_s)

        inp = gather(inputs[:, 0])
        tgt = gather(targets[:, 0])
        # chained pairs A = (a, b, c), B = (b, c, d): losses.py:419-420
        ia, ib = inp[:, :3].reshape(b, -1), inp[:, 1:].reshape(b, -1)
        ta, tb = tgt[:, :3].reshape(b, -1), tgt[:, 1:].reshape(b, -1)
        vm = valid.repeat(1, 3).float()

        ratio = (ta + 1e-6) / (tb + 1e-6)
        # the weight's max over KEPT pairs only (the reference drops the
        # invalid columns before it, losses.py:366-369,516)
        absdiff = (ta - tb).abs()
        wmax = (absdiff * vm).amax(-1, keepdim=True)
        weight = torch.exp(absdiff / (wmax + 1e-6))
        hi, lo = 1.0 + self.sigma, 1.0 / (1.0 + self.sigma)
        eq = (ratio < hi) & (ratio > lo)
        labels = torch.where(ratio >= hi, 1.0,
                             torch.where(ratio <= lo, -1.0, 0.0))
        if self.reweight_target:
            equal_loss = (ia - ib) ** 2 * eq
            unequal_loss = torch.log1p(
                torch.exp((-ia + ib) / weight * labels)) * ~eq
        else:
            equal_loss = (ia - ib) ** 2 / weight * eq
            unequal_loss = torch.log1p(
                torch.exp((-ia + ib) * labels)) * ~eq
        denom = vm.sum(-1).clamp(min=1.0)
        per_img = (self.alpha * (equal_loss * vm).sum(-1) / denom
                   + (unequal_loss * vm).sum(-1) / denom)
        return per_img.mean()


@MODELS.register_module
class ScaleAndShiftInvariantLoss:
    """Reference losses.py:565-592: pred aligned to the target by the
    least-squares scale and shift over the mask, per image, then the
    masked MSE; scale and shift 0 where the normal equations are singular
    (det <= 0)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        """pred / target / mask (B, 1, H, W)."""
        m = mask.float()
        dims = (1, 2, 3)
        a00 = (m * pred * pred).sum(dims)
        a01 = (m * pred).sum(dims)
        a11 = m.sum(dims)
        b0 = (m * pred * target).sum(dims)
        b1 = (m * target).sum(dims)
        det = a00 * a11 - a01 * a01
        scale = torch.where(det > 0, (a11 * b0 - a01 * b1) / det, 0.0)
        shift = torch.where(det > 0, (-a01 * b0 + a00 * b1) / det, 0.0)
        aligned = scale[:, None, None, None] * pred \
            + shift[:, None, None, None]
        res = (m * (aligned - target) ** 2).sum(dims) / a11.clamp(min=1.0)
        return res.mean()


@MODELS.register_module
class ExistLoss:
    """Reference losses.py:594-613: push the fine gradients above the
    coarse ones on the masked pixels: mean of exp(-(pred_grad -
    coarse_grad)) over the mask (over max(count, 1))."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, pred_grad: torch.Tensor, coarse_grad: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        m = mask.float()
        ratio = torch.exp(-(pred_grad - coarse_grad)) * m
        return ratio.sum() / m.sum().clamp(min=1.0)
