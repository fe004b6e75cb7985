"""ZoeDepth metric-bins head and the DA-ZoeDepth and BEiT ZoeDepth models
(patchfusion_tpu/models/zoedepth.py; reference external/zoedepth/models/
zoedepth/zoedepth_v1.py with localbins_layers.py, attractor.py and
dist_layers.py).

`MetricBinsHead` holds the head's submodules as direct attributes, the way
the reference's ZoeDepth and PatchFusion modules do, so `ZoeDepthDA`,
`ZoeDepthBEiT` and `PatchFusionNet` inherit from it and their state_dict
keys match the reference checkpoints. NCHW throughout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from patchfusion_tpu_torch.models.beit import (MIDAS_FEATURES, PATCH,
                                               MidasDPTBEiT)
from patchfusion_tpu_torch.models.dpt import DPT_CONFIGS, DPTDinov2
from patchfusion_tpu_torch.ops import fused_head
from patchfusion_tpu_torch.ops.activations import Gelu, gelu
from patchfusion_tpu_torch.ops.resize import interpolate_nchw
from patchfusion_tpu_torch.utils import profiling

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# DepthAnythingCore.output_channels (reference depth_anything.py:331-337)
DA_OUTPUT_CHANNELS = {"vits": 64, "vitb": 128, "vitl": 256, "vitmicro": 32}
N_MIDAS_OUT = 32


def _up(x: torch.Tensor, size) -> torch.Tensor:
    return interpolate_nchw(x, tuple(size), mode="bilinear",
                            align_corners=True)


def _mlp2(cin: int, hidden: int, out: int, act: Optional[nn.Module] = None
          ) -> nn.Sequential:
    """conv1x1 -> relu -> conv1x1 [-> act]: the reference's `_net`."""
    layers = [nn.Conv2d(cin, hidden, 1), nn.ReLU(),
              nn.Conv2d(hidden, out, 1)]
    if act is not None:
        layers.append(act)
    return nn.Sequential(*layers)


class SeedBinRegressorUnnormed(nn.Module):
    """localbins_layers.py:71-96: softplus bin centers (unbounded)."""

    def __init__(self, cin: int, n_bins: int, mlp_dim: int = 256):
        super().__init__()
        self._net = _mlp2(cin, mlp_dim, n_bins, nn.Softplus())

    def forward(self, x):
        c = self._net(x)
        return c, c


class SeedBinRegressor(nn.Module):
    """localbins_layers.py:29-68: normalized widths -> cumsum bin centers
    bounded in (min_depth, max_depth)."""

    def __init__(self, cin: int, n_bins: int, min_depth: float,
                 max_depth: float, mlp_dim: int = 256):
        super().__init__()
        self.min_depth = min_depth
        self.max_depth = max_depth
        self._net = _mlp2(cin, mlp_dim, n_bins, nn.ReLU())

    def forward(self, x):
        b = self._net(x) + 1e-3
        widths_normed = b / b.sum(dim=1, keepdim=True)
        widths = (self.max_depth - self.min_depth) * widths_normed
        widths = F.pad(widths, (0, 0, 0, 0, 1, 0), value=self.min_depth)
        edges = torch.cumsum(widths, dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        return widths_normed, centers


class Projector(nn.Module):
    """localbins_layers.py:99-117."""

    def __init__(self, cin: int, out_features: int, mlp_dim: int = 128):
        super().__init__()
        self._net = _mlp2(cin, mlp_dim, out_features)

    def forward(self, x):
        return self._net(x)


class LinearSplitter(nn.Module):
    """localbins_layers.py:121-169: splits each of `prev_nbins` bins into
    `split_factor` fractions (registered in the reference layer zoo; no
    shipped PatchFusion config uses it). Returns the normed widths
    b (B, prev_nbins * split_factor, H, W) and their centers."""

    def __init__(self, cin: int, prev_nbins: int, split_factor: int = 2,
                 mlp_dim: int = 128, min_depth: float = 1e-3,
                 max_depth: float = 10.0):
        super().__init__()
        self.prev_nbins = prev_nbins
        self.split_factor = split_factor
        self.min_depth = min_depth
        self.max_depth = max_depth
        self._net = nn.Sequential(
            nn.Conv2d(cin, mlp_dim, 1), Gelu(),
            nn.Conv2d(mlp_dim, prev_nbins * split_factor, 1), nn.ReLU())

    def forward(self, x, b_prev, prev_b_embedding=None):
        if prev_b_embedding is not None:
            x = x + _up(prev_b_embedding, x.shape[-2:])
        s = self._net(x) + 1e-3
        n, _, h, w = s.shape
        s = s.view(n, self.prev_nbins, self.split_factor, h, w)
        s_normed = s / s.sum(dim=2, keepdim=True)
        b_prev = _up(b_prev, (h, w))
        b_prev = b_prev / b_prev.sum(dim=1, keepdim=True)
        b = (b_prev[:, :, None] * s_normed).flatten(1, 2)
        widths = (self.max_depth - self.min_depth) * b
        widths = F.pad(widths, (0, 0, 0, 0, 1, 0), value=self.min_depth)
        edges = torch.cumsum(widths, dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        return b, centers


def _attractor_dist(dx: torch.Tensor, attractor_type: str) -> torch.Tensor:
    """attractor.py:29-57. REFERENCE QUIRK, kept for checkpoint fidelity:
    the reference calls `dist(dx)` without alpha/gamma, so the TorchScript
    defaults alpha=300, gamma=2 apply whatever the config says."""
    if attractor_type == "exp":
        return torch.exp(-300.0 * dx.abs() ** 2) * dx
    return dx / (1 + 300.0 * dx ** 2)


class AttractorLayerUnnormed(nn.Module):
    """attractor.py:139-208: unbounded bin-center refinement."""

    def __init__(self, cin: int, n_attractors: int, kind: str,
                 attractor_type: str, mlp_dim: int = 128):
        super().__init__()
        self.kind = kind
        self.attractor_type = attractor_type
        self._net = _mlp2(cin, mlp_dim, n_attractors, nn.Softplus())

    def forward(self, x, b_prev, prev_b_embedding=None):
        if prev_b_embedding is not None:
            x = x + _up(prev_b_embedding, x.shape[-2:])
        a = self._net(x)                               # (B, A, H, W)
        b_centers = _up(b_prev, x.shape[-2:])          # (B, K, H, W)
        delta = _attractor_dist(a[:, :, None] - b_centers[:, None],
                                self.attractor_type)   # (B, A, K, H, W)
        red = delta.mean(dim=1) if self.kind == "mean" else delta.sum(dim=1)
        b_new = b_centers + red
        return b_new, b_new


class AttractorLayer(nn.Module):
    """attractor.py:60-136: normed variant, centers bounded to
    (min_depth, max_depth) and sorted."""

    def __init__(self, cin: int, n_attractors: int, kind: str,
                 attractor_type: str, min_depth: float, max_depth: float,
                 mlp_dim: int = 128):
        super().__init__()
        self.n_attractors = n_attractors
        self.kind = kind
        self.attractor_type = attractor_type
        self.min_depth = min_depth
        self.max_depth = max_depth
        self._net = _mlp2(cin, mlp_dim, n_attractors * 2, nn.ReLU())

    def forward(self, x, b_prev, prev_b_embedding=None):
        if prev_b_embedding is not None:
            x = x + _up(prev_b_embedding, x.shape[-2:])
        a = self._net(x) + 1e-3
        b, _, h, w = a.shape
        # the reference normalizes and then discards it (attractor.py:
        # 105-106): channel 0 of each pair, unnormalized
        a_normed = a.reshape(b, self.n_attractors, 2, h, w)[:, :, 0]
        b_centers = _up(b_prev, x.shape[-2:])
        delta = _attractor_dist(a_normed[:, :, None] - b_centers[:, None],
                                self.attractor_type)
        red = delta.mean(dim=1) if self.kind == "mean" else delta.sum(dim=1)
        b_new = b_centers + red
        centers = (self.max_depth - self.min_depth) * b_new + self.min_depth
        centers = torch.sort(centers, dim=1).values
        return b_new, centers.clamp(self.min_depth, self.max_depth)


class LogBinomialBuffers(nn.Module):
    """The constant buffers the reference LogBinomial registers
    (dist_layers.py:46-49); unused here, held for strict loading."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.register_buffer("k_idx", torch.arange(
            n_classes, dtype=torch.float32).reshape(1, -1, 1, 1))
        self.register_buffer("K_minus_1", torch.tensor(
            [n_classes - 1], dtype=torch.float32).reshape(1, -1, 1, 1))


class ConditionalLogBinomial(nn.Module):
    """dist_layers.py:36-121: MLP -> (p, t) -> log-binomial over n_classes."""

    def __init__(self, in_features: int, condition_dim: int, n_classes: int,
                 min_temp: float, max_temp: float,
                 bottleneck_factor: int = 2, p_eps: float = 1e-4):
        super().__init__()
        self.n_classes = n_classes
        self.min_temp = min_temp
        self.max_temp = max_temp
        self.p_eps = p_eps
        bottleneck = (in_features + condition_dim) // bottleneck_factor
        self.mlp = nn.Sequential(
            nn.Conv2d(in_features + condition_dim, bottleneck, 1), Gelu(),
            nn.Conv2d(bottleneck, 4, 1))
        self.log_binomial_transform = LogBinomialBuffers(n_classes)

    def params_pt(self, x, cond) -> Tuple[torch.Tensor, torch.Tensor]:
        """(p, t_norm) per pixel, both (B, H, W), t before the temperature
        scaling; erf GELU in f32 (the unfused path)."""
        h = self.mlp[0](torch.cat([x, cond], dim=1))
        pt = F.softplus(self.mlp[2](gelu(h)).float())
        p = pt[:, :2] + self.p_eps
        p = p[:, 0] / (p[:, 0] + p[:, 1])
        t = pt[:, 2:] + self.p_eps
        t = t[:, 0] / (t[:, 0] + t[:, 1])
        return p, t

    def params_pt_fused(self, x_hi, cond_lo
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """params_pt with the condition at its low resolution, through the
        clb_pt kernel (plain twin on the CPU): the kernel projects the
        condition at its low resolution, upsamples the projection itself
        and never writes the full-resolution bottleneck.
        The NCHW tensors go in as permuted channels-last views (no copy)."""
        with profiling.span("head.clb_pt", device=False):
            return fused_head.clb_pt(
                x_hi.permute(0, 2, 3, 1), cond_lo.permute(0, 2, 3, 1),
                *self.mlp_weights(), self.p_eps)

    def depth_fused(self, x_hi, cond_lo, centers) -> torch.Tensor:
        """The whole stage, params_pt_fused and the log-binomial depth, in
        one launch of the clb_logbinomial_depth kernel (plain twin on the
        CPU): p and t never leave registers. x_hi (B, Cin, OH, OW); cond_lo
        (B, Cc, IH, IW) and centers (B, K, IH, IW) at the attractor
        resolution. Returns depth (B, 1, OH, OW) float32. bf16 only, as in
        the JAX package (models/zoedepth.py:318-348): the kernel's tanh-GELU
        is the bf16 path's activation."""
        if x_hi.dtype != torch.bfloat16:
            raise TypeError(f"depth_fused is bf16-only (tanh-GELU contract); "
                            f"got {x_hi.dtype}")
        with profiling.span("head.clb_logbinomial_depth", device=False):
            return fused_head.clb_logbinomial_depth(
                x_hi.permute(0, 2, 3, 1), cond_lo.permute(0, 2, 3, 1),
                centers.permute(0, 2, 3, 1), *self.mlp_weights(),
                self.min_temp, self.max_temp, self.p_eps)[:, None]

    def mlp_weights(self) -> Tuple[torch.Tensor, ...]:
        """mlp_0 and mlp_2 as the kernels take them: w1 (Cin + Cc, H), b1,
        w2 (H, 4), b2."""
        return (self.mlp[0].weight[:, :, 0, 0].t(), self.mlp[0].bias,
                self.mlp[2].weight[:, :, 0, 0].t(), self.mlp[2].bias)

    def forward(self, x, cond) -> torch.Tensor:
        """Probabilities (B, K, H, W) over the bins (unfused path)."""
        p, t = self.params_pt(x, cond)
        t = (self.max_temp - self.min_temp) * t + self.min_temp
        k = torch.arange(self.n_classes, dtype=torch.float32,
                         device=p.device)[None, :, None, None]
        km1 = float(self.n_classes - 1)
        eps = 1e-4
        p = p.clamp(eps, 1.0)[:, None]
        one_minus_p = (1.0 - p).clamp(eps, 1.0)

        def log_binom(n, kk, e=1e-7):
            # the max() keeps (n - kk + e) from being reassociated into
            # (n + e) - kk, which is 0 in f32 at kk == n and gives
            # 0 * log(0) = NaN (zoedepth.py:361-371)
            n = n + e
            kk = kk + e
            d = torch.clamp(n - kk, min=0.0)
            return (n * np.log(n) - kk * torch.log(kk)
                    - d * torch.log(d + e))

        y = (log_binom(km1, k) + k * torch.log(p)
             + (km1 - k) * torch.log(one_minus_p))
        return torch.softmax(y / t[:, None], dim=1)


class MetricBinsHead(nn.Module):
    """The shared ZoeDepth decoder head: seed bins -> 4 x (projector +
    attractor) -> conditional log-binomial -> depth = sum p*c
    (zoedepth_v1.py:106-123, 173-233; PatchFusion's own head,
    patchfusion.py:131-170).

    x_channels: channels of the bottleneck feature; block_channels: of the
    four decoder features (low -> high resolution).
    """

    def __init__(self, x_channels: int, block_channels: Sequence[int],
                 n_bins: int, bin_embedding_dim: int, min_depth: float,
                 max_depth: float, n_attractors: Sequence[int],
                 attractor_alpha: float, attractor_gamma: int,
                 attractor_kind: str, attractor_type: str,
                 bin_centers_type: str, min_temp: float, max_temp: float,
                 last_in: int = N_MIDAS_OUT + 1):
        super().__init__()
        del attractor_alpha, attractor_gamma  # see _attractor_dist
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.bin_centers_type = bin_centers_type
        self.min_temp = min_temp
        self.max_temp = max_temp
        normed_seed = bin_centers_type in ("normed", "hybrid1")
        normed_attr = bin_centers_type in ("normed", "hybrid2")
        if normed_seed:
            self.seed_bin_regressor = SeedBinRegressor(
                x_channels, n_bins, min_depth, max_depth)
        else:
            self.seed_bin_regressor = SeedBinRegressorUnnormed(
                x_channels, n_bins)
        self.seed_projector = Projector(x_channels, bin_embedding_dim)
        self.projectors = nn.ModuleList(
            [Projector(c, bin_embedding_dim) for c in block_channels[:4]])
        if normed_attr:
            self.attractors = nn.ModuleList([
                AttractorLayer(bin_embedding_dim, n, attractor_kind,
                               attractor_type, min_depth, max_depth)
                for n in n_attractors])
        else:
            self.attractors = nn.ModuleList([
                AttractorLayerUnnormed(bin_embedding_dim, n, attractor_kind,
                                       attractor_type)
                for n in n_attractors])
        self.conditional_log_binomial = ConditionalLogBinomial(
            last_in, bin_embedding_dim, n_bins, min_temp, max_temp)

    def head_forward(self, x, x_blocks, last, rel_cond
                     ) -> Dict[str, Any]:
        """x: bottleneck feature; x_blocks: 4 decoder features (low -> high
        resolution); last: final 32-ch feature; rel_cond: (B, 1, H, W)
        relative-depth condition (zeros in PatchFusion)."""
        _, seed_b_centers = self.seed_bin_regressor(x)
        if self.bin_centers_type in ("normed", "hybrid2"):
            b_prev = (seed_b_centers - self.min_depth) / \
                (self.max_depth - self.min_depth)
        else:
            b_prev = seed_b_centers
        prev_b_embedding = self.seed_projector(x)
        b_centers = b_prev
        b_embedding = prev_b_embedding
        for proj, attr, xb in zip(self.projectors, self.attractors,
                                  x_blocks[:4]):
            b_embedding = proj(xb)
            b_prev, b_centers = attr(b_embedding, b_prev, prev_b_embedding)
            prev_b_embedding = b_embedding

        rel_cond = _up(rel_cond, last.shape[-2:])
        last_cat = torch.cat([last, rel_cond.to(last.dtype)], dim=1)
        clb = self.conditional_log_binomial
        if last.dtype == torch.bfloat16:
            # the bf16 path's fused formulation (zoedepth.py:457-479): the
            # clb_pt and logbinomial_depth kernels on the card, their plain
            # twins on the CPU; both read the low-resolution condition and
            # centers, so no full-resolution K-channel tensor is formed.
            # Each wrapper call is a host-only span of the tracer,
            # pf.head.<kernel> (utils/profiling).
            # Under autocast (--amp) the twins keep their f32 arithmetic.
            with torch.autocast(last.device.type, enabled=False):
                p, tn = clb.params_pt_fused(last_cat, b_embedding)
                with profiling.span("head.logbinomial_depth", device=False):
                    depth = fused_head.logbinomial_depth(
                        p, tn, b_centers.permute(0, 2, 3, 1), self.min_temp,
                        self.max_temp)[:, None]
            return {"metric_depth": depth, "bin_centers": b_centers,
                    "b_embedding": b_embedding, "probs": None}

        b_embedding = _up(b_embedding, last.shape[-2:])
        probs = clb(last_cat, b_embedding)
        b_centers = _up(b_centers, probs.shape[-2:])
        depth = torch.sum(probs * b_centers, dim=1, keepdim=True)
        return {"metric_depth": depth, "bin_centers": b_centers,
                "b_embedding": b_embedding, "probs": probs}


def head_kwargs(kw: Dict[str, Any], min_depth: float,
                max_depth: float) -> Dict[str, Any]:
    """MetricBinsHead hyperparameters from a branch's kwargs."""
    return dict(
        n_bins=kw.get("n_bins", 64),
        bin_embedding_dim=kw.get("bin_embedding_dim", 128),
        min_depth=min_depth, max_depth=max_depth,
        n_attractors=tuple(kw.get("n_attractors", (16, 8, 4, 1))),
        attractor_alpha=kw.get("attractor_alpha", 1000.0),
        attractor_gamma=kw.get("attractor_gamma", 2),
        attractor_kind=kw.get("attractor_kind", "mean"),
        attractor_type=kw.get("attractor_type", "inv"),
        bin_centers_type=kw.get("bin_centers_type", "softplus"),
        min_temp=kw.get("min_temp", 0.0212),
        max_temp=kw.get("max_temp", 50.0))


class DepthAnythingCore(nn.Module):
    """Holds the DPT model under the reference's `core.core` prefix."""

    def __init__(self, core_type: str):
        super().__init__()
        self.core = DPTDinov2(core_type)


class ZoeDepthDA(MetricBinsHead):
    """DA-ZoeDepth: DepthAnything (DINOv2 + DPT) core + metric-bins head.

    forward(x (B, 3, H, W) in [0, 1]) -> dict(metric_depth (B, 1, H, W),
    rel_depth (B, H, W), temp_features {x_d0, x_blocks_feat_0..3,
    midas_final_feat}, bin_centers). ImageNet normalization happens here
    (reference PrepForMidas, do_resize=False in every shipped config).
    """

    def __init__(self, core_type: str = "vitl", min_depth: float = 1e-3,
                 max_depth: float = 80.0, **kw):
        features = DPT_CONFIGS[core_type]["features"]
        c = DA_OUTPUT_CHANNELS[core_type]
        super().__init__(c, [features] * 4,
                         **head_kwargs(kw, min_depth, max_depth))
        self.core = DepthAnythingCore(core_type)
        self.conv2 = nn.Conv2d(features, c, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        # in the input's dtype, like the JAX package (not the weights')
        mean, std = (torch.as_tensor(v).to(x.device, x.dtype)[:, None, None]
                     for v in (IMAGENET_MEAN, IMAGENET_STD))
        x = (x - mean) / std
        rel_depth, feats = self.core.core(x)
        x_blocks = [feats["r4"], feats["r3"], feats["r2"], feats["r1"]]
        last = feats["out_conv"]
        x_d0 = self.conv2(feats["l4_rn"])
        temp_features = {"x_d0": x_d0, "midas_final_feat": last}
        for i, xb in enumerate(x_blocks):
            temp_features[f"x_blocks_feat_{i}"] = xb
        out = self.head_forward(x_d0, x_blocks, last, rel_depth[:, None])
        out["rel_depth"] = rel_depth
        out["temp_features"] = temp_features
        return out


# MidasCore.output_channels for DPT_BEiT_L_384 (midas.py:368-376: 256 x 5)
MIDAS_BTLNCK_CHANNELS = 256


class MidasCore(nn.Module):
    """Holds the MiDaS DPT-BEiT model under the reference's `core.core`
    prefix."""

    def __init__(self, core_type: str, grid: Tuple[int, int]):
        super().__init__()
        self.core = MidasDPTBEiT(core_type, grid)


class ZoeDepthBEiT(MetricBinsHead):
    """ZoeDepth v1 over MiDaS DPT_BEiT_L_384, the branch of the
    `patchfusion_zoedepth` family (patchfusion_tpu/models/zoedepth.py:
    549-608): the metric-bins head of ZoeDepthDA over the BEiT core, with
    a 256-channel conv2 and the mean/std 0.5 normalization (reference
    PrepForMidas, midas.py:180-181; do_resize=False in every shipped
    config, so inputs arrive at the process shape). process_shape (H, W),
    multiples of 32, sets the BEiT grid (H // 16, W // 16). forward as
    ZoeDepthDA's."""

    def __init__(self, core_type: str = "DPT_BEiT_L_384",
                 min_depth: float = 1e-3, max_depth: float = 80.0,
                 process_shape: Sequence[int] = (384, 512), **kw):
        c = MIDAS_BTLNCK_CHANNELS
        super().__init__(c, [c] * 4, **head_kwargs(kw, min_depth, max_depth))
        ph, pw = process_shape
        if ph % 32 or pw % 32:
            raise ValueError(f"the BEiT branch takes multiples of 32, got "
                             f"process shape {tuple(process_shape)}")
        self.core = MidasCore(core_type, (ph // PATCH, pw // PATCH))
        self.conv2 = nn.Conv2d(MIDAS_FEATURES, c, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        # in the input's dtype, like the JAX package (not the weights')
        x = (x - 0.5) / 0.5
        rel_depth, feats = self.core.core(x)
        x_blocks = [feats["r4"], feats["r3"], feats["r2"], feats["r1"]]
        last = feats["out_conv"]
        x_d0 = self.conv2(feats["l4_rn"])
        temp_features = {"x_d0": x_d0, "midas_final_feat": last}
        for i, xb in enumerate(x_blocks):
            temp_features[f"x_blocks_feat_{i}"] = xb
        out = self.head_forward(x_d0, x_blocks, last, rel_depth[:, None])
        out["rel_depth"] = rel_depth
        out["temp_features"] = temp_features
        return out


def make_zoe_branch(kwargs: Dict[str, Any], min_depth: float,
                    max_depth: float,
                    process_shape: Optional[Sequence[int]] = None
                    ) -> nn.Module:
    """Branch factory: `core_family` selects the DA (DINOv2) or the MiDaS
    (BEiT) ZoeDepth (zoedepth_v1.py:300-305). process_shape: the BEiT
    branch's input size, which fixes its relative-position grid (default
    384x512); the DA branch takes any multiple of 14."""
    kw = dict(kwargs)
    family = kw.pop("core_family", "da")
    if family == "midas":
        return ZoeDepthBEiT(min_depth=min_depth, max_depth=max_depth,
                            process_shape=tuple(process_shape or (384, 512)),
                            **kw)
    return ZoeDepthDA(min_depth=min_depth, max_depth=max_depth, **kw)


def branch_channels(kwargs: Dict[str, Any]) -> int:
    """Feature-pyramid channel count of a branch config (the `C` of the six
    fusion convs, reference patchfusion.py:119-127)."""
    if kwargs.get("core_family", "da") == "midas":
        return MIDAS_BTLNCK_CHANNELS
    return DA_OUTPUT_CHANNELS[kwargs.get("core_type", "vitl")]
