"""The plain float32 PatchFusion network of the DA-ZoeDepth configurations
(DINOv2 + DPT branches, the metric-bins head, G2L Swin attention, the
guided-fusion U-Net), frozen as the benchmark's reference.

A copy of the program's float32 arithmetic (`models/dinov2.py`, `dpt.py`,
`zoedepth.py`, `swin.py`, `fusion.py`, `patchfusion.py`) with every kernel
and every bf16 branch taken out: dense einsum attention, exact erf GELU,
the unfused conditional log-binomial head over full-resolution bins,
BatchNorm in eval mode. The attribute names are the program's state_dict
names, so one weights dict loads strictly into both. Only what the
benchmark's configurations use is here: the `softplus` bin centers, the
unnormed attractors, `g2l=True`. Nothing here imports the program.

This is the default reference module (`spec.reference`): a configuration
file without a "reference" key, such as da-vitl's and da-vits's, is run
against this `PatchFusionNet`. It brings no weight rules of its own
(`LEAF_RULES`, `computed`): every leaf of the DA networks has a built-in
rule in weights.py.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pfbench.reference.ops import (interpolate_nchw, pad_to_multiple,
                                   relative_position_index, roi_align,
                                   shifted_window_mask, window_partition,
                                   window_reverse)

VIT_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
    "vitmicro": dict(embed_dim=64, depth=4, num_heads=2),
}
DPT_CONFIGS = {
    "vits": dict(features=64, out_channels=(48, 96, 192, 384)),
    "vitb": dict(features=128, out_channels=(96, 192, 384, 768)),
    "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024)),
    "vitmicro": dict(features=32, out_channels=(16, 32, 64, 128)),
}
DA_OUTPUT_CHANNELS = {"vits": 64, "vitb": 128, "vitl": 256, "vitmicro": 32}
N_MIDAS_OUT = 32
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _up(x: torch.Tensor, size) -> torch.Tensor:
    return interpolate_nchw(x, tuple(size), "bilinear", align_corners=True)


# ---------------------------------------------------------------------------
# DINOv2
# ---------------------------------------------------------------------------

def dense_attention(q, k, v):
    """(B, N, H, Dh) softmax(q k^T / sqrt(Dh)) v."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, -1), v)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads,
                                  d // self.num_heads)
        o = dense_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(o.reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class DinoViT(nn.Module):
    """DINOv2: 14x14 patches, cls token, the position embedding resampled
    bicubic with scale factors (g + 0.1) / 37, pre-norm LayerScale blocks;
    the last four blocks' outputs after the final LayerNorm."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int):
        super().__init__()
        self.depth = depth
        self.grid = 518 // 14
        self.patch_embed = PatchEmbed(embed_dim, 14)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid * self.grid + 1, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.blocks = nn.ModuleList(
            [Block(embed_dim, num_heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def _pos_embed(self, gh: int, gw: int):
        g = self.grid
        if gh == g and gw == g:
            return self.pos_embed
        patch = self.pos_embed[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
        patch = interpolate_nchw(patch, (gh, gw), "bicubic",
                                 scale=((gh + 0.1) / g, (gw + 0.1) / g))
        patch = patch.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        return torch.cat([self.pos_embed[:, :1], patch], dim=1)

    def forward(self, x):
        b, _, h, w = x.shape
        tokens = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(b, 1, -1), tokens], 1)
        tokens = tokens + self._pos_embed(h // 14, w // 14)
        taps = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i >= self.depth - 4:
                taps.append(self.norm(tokens)[:, 1:])
        return taps


# ---------------------------------------------------------------------------
# DPT decoder
# ---------------------------------------------------------------------------

def conv3x3(cin, cout, bias=True, stride=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = conv3x3(features, features)
        self.conv2 = conv3x3(features, features)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if size is None:
            size = (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out_conv(_up(x, size))


class Scratch(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int]):
        super().__init__()
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn",
                    conv3x3(out_channels[i], features, bias=False))
        for i in range(4):
            setattr(self, f"refinenet{i + 1}", FeatureFusionBlock(features))
        self.output_conv1 = conv3x3(features, features // 2)
        self.output_conv2 = nn.Sequential(
            conv3x3(features // 2, 32), nn.ReLU(), nn.Conv2d(32, 1, 1),
            nn.ReLU())


class DPTHead(nn.Module):
    def __init__(self, in_dim: int, features: int,
                 out_channels: Sequence[int]):
        super().__init__()
        c = out_channels
        self.projects = nn.ModuleList([nn.Conv2d(in_dim, ch, 1) for ch in c])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(c[0], c[0], 4, stride=4),
            nn.ConvTranspose2d(c[1], c[1], 2, stride=2),
            nn.Identity(),
            conv3x3(c[3], c[3], stride=2)])
        self.scratch = Scratch(features, out_channels)

    def forward(self, taps: List[torch.Tensor], ph: int, pw: int):
        s = self.scratch
        rn = []
        for i, tok in enumerate(taps):
            b, _, d = tok.shape
            x = tok.transpose(1, 2).reshape(b, d, ph, pw)
            x = self.resize_layers[i](self.projects[i](x))
            rn.append(getattr(s, f"layer{i + 1}_rn")(x))
        p4 = s.refinenet4(rn[3], size=rn[2].shape[-2:])
        p3 = s.refinenet3(p4, rn[2], size=rn[1].shape[-2:])
        p2 = s.refinenet2(p3, rn[1], size=rn[0].shape[-2:])
        p1 = s.refinenet1(p2, rn[0])
        out = _up(s.output_conv1(p1), (ph * 14, pw * 14))
        last = F.relu(s.output_conv2[0](out))
        rel = F.relu(s.output_conv2[2](last))
        feats = {"l4_rn": rn[3], "r4": p4, "r3": p3, "r2": p2, "r1": p1,
                 "out_conv": last}
        return rel, feats


class DPTDinov2(nn.Module):
    def __init__(self, core_type: str):
        super().__init__()
        vit = VIT_CONFIGS[core_type]
        self.pretrained = DinoViT(**vit)
        self.depth_head = DPTHead(vit["embed_dim"], **DPT_CONFIGS[core_type])

    def forward(self, x):
        _, _, h, w = x.shape
        rel, feats = self.depth_head(self.pretrained(x), h // 14, w // 14)
        return F.relu(_up(rel, (h, w)))[:, 0], feats


class DepthAnythingCore(nn.Module):
    def __init__(self, core_type: str):
        super().__init__()
        self.core = DPTDinov2(core_type)


# ---------------------------------------------------------------------------
# metric-bins head
# ---------------------------------------------------------------------------

class _Mlp2(nn.Module):
    """conv1x1 -> relu -> conv1x1 -> softplus, under the key `_net`."""

    def __init__(self, cin: int, hidden: int, out: int, softplus: bool):
        super().__init__()
        layers = [nn.Conv2d(cin, hidden, 1), nn.ReLU(),
                  nn.Conv2d(hidden, out, 1)]
        if softplus:
            layers.append(nn.Softplus())
        self._net = nn.Sequential(*layers)

    def forward(self, x):
        return self._net(x)


class AttractorLayerUnnormed(nn.Module):
    def __init__(self, cin: int, n_attractors: int, kind: str,
                 attractor_type: str):
        super().__init__()
        self.kind = kind
        self.attractor_type = attractor_type
        self._net = nn.Sequential(nn.Conv2d(cin, 128, 1), nn.ReLU(),
                                  nn.Conv2d(128, n_attractors, 1),
                                  nn.Softplus())

    def forward(self, x, b_prev, prev_b_embedding):
        x = x + _up(prev_b_embedding, x.shape[-2:])
        a = self._net(x)
        centers = _up(b_prev, x.shape[-2:])
        dx = a[:, :, None] - centers[:, None]
        # the reference's dist() runs at alpha 300, gamma 2, whatever the
        # configuration says
        if self.attractor_type == "exp":
            delta = torch.exp(-300.0 * dx.abs() ** 2) * dx
        else:
            delta = dx / (1 + 300.0 * dx ** 2)
        red = delta.mean(1) if self.kind == "mean" else delta.sum(1)
        return centers + red


class LogBinomialBuffers(nn.Module):
    def __init__(self, n_classes: int):
        super().__init__()
        self.register_buffer("k_idx", torch.arange(
            n_classes, dtype=torch.float32).reshape(1, -1, 1, 1))
        self.register_buffer("K_minus_1", torch.tensor(
            [n_classes - 1], dtype=torch.float32).reshape(1, -1, 1, 1))


class ConditionalLogBinomial(nn.Module):
    def __init__(self, in_features: int, condition_dim: int, n_classes: int,
                 min_temp: float, max_temp: float):
        super().__init__()
        self.n_classes = n_classes
        self.min_temp = min_temp
        self.max_temp = max_temp
        hidden = (in_features + condition_dim) // 2
        self.mlp = nn.Sequential(
            nn.Conv2d(in_features + condition_dim, hidden, 1), nn.GELU(),
            nn.Conv2d(hidden, 4, 1))
        self.log_binomial_transform = LogBinomialBuffers(n_classes)

    def forward(self, x, cond):
        """Probabilities (B, K, H, W) of the log-binomial over the bins."""
        pt = F.softplus(self.mlp(torch.cat([x, cond], dim=1)))
        p = pt[:, :2] + 1e-4
        p = p[:, 0] / (p[:, 0] + p[:, 1])
        t = pt[:, 2:] + 1e-4
        t = t[:, 0] / (t[:, 0] + t[:, 1])
        t = (self.max_temp - self.min_temp) * t + self.min_temp
        k = torch.arange(self.n_classes, dtype=x.dtype,
                         device=x.device)[None, :, None, None]
        km1 = float(self.n_classes - 1)
        p = p.clamp(1e-4, 1.0)[:, None]
        q = (1.0 - p).clamp(1e-4, 1.0)
        n, kk = km1 + 1e-7, k + 1e-7
        d = torch.clamp(n - kk, min=0.0)
        log_binom = n * np.log(n) - kk * torch.log(kk) \
            - d * torch.log(d + 1e-7)
        y = log_binom + k * torch.log(p) + (km1 - k) * torch.log(q)
        return torch.softmax(y / t[:, None], dim=1)


class MetricBinsHead(nn.Module):
    """Seed bins -> four projector + attractor refinements -> conditional
    log-binomial -> depth = sum over bins of p * center."""

    def __init__(self, x_channels: int, block_channels: Sequence[int],
                 cfg: Dict[str, Any]):
        super().__init__()
        if cfg.get("bin_centers_type", "softplus") != "softplus":
            raise NotImplementedError("the reference holds the softplus "
                                      "bin centers only")
        n_bins = cfg.get("n_bins", 64)
        emb = cfg.get("bin_embedding_dim", 128)
        self.seed_bin_regressor = _Mlp2(x_channels, 256, n_bins, True)
        self.seed_projector = _Mlp2(x_channels, 128, emb, False)
        self.projectors = nn.ModuleList(
            [_Mlp2(c, 128, emb, False) for c in block_channels[:4]])
        self.attractors = nn.ModuleList([
            AttractorLayerUnnormed(emb, n, cfg.get("attractor_kind", "mean"),
                                   cfg.get("attractor_type", "inv"))
            for n in cfg.get("n_attractors", (16, 8, 4, 1))])
        self.conditional_log_binomial = ConditionalLogBinomial(
            N_MIDAS_OUT + 1, emb, n_bins, cfg.get("min_temp", 0.0212),
            cfg.get("max_temp", 50.0))

    def head_forward(self, x, x_blocks, last, rel=None):
        """x: bottleneck feature; x_blocks: the four decoder features, low
        to high resolution; last: the final 32-channel feature; rel: the
        relative-depth condition (a branch's own relative depth; zeros in
        PatchFusion's head). Returns depth (B, 1, H, W) at last's size."""
        b_centers = self.seed_bin_regressor(x)
        emb = self.seed_projector(x)
        for proj, attr, xb in zip(self.projectors, self.attractors,
                                  x_blocks[:4]):
            prev_emb, emb = emb, proj(xb)
            b_centers = attr(emb, b_centers, prev_emb)
        size = last.shape[-2:]
        rel = torch.zeros_like(last[:, :1]) if rel is None else _up(rel, size)
        probs = self.conditional_log_binomial(torch.cat([last, rel], 1),
                                              _up(emb, size))
        return torch.sum(probs * _up(b_centers, size), dim=1, keepdim=True)


class ZoeDepthDA(MetricBinsHead):
    """DA-ZoeDepth branch: ImageNet normalisation, DINOv2 + DPT, conv2 on
    the bottleneck, the metric-bins head conditioned on relative depth."""

    def __init__(self, cfg: Dict[str, Any]):
        core_type = cfg.get("midas_model_type", "vitl")
        features = DPT_CONFIGS[core_type]["features"]
        c = DA_OUTPUT_CHANNELS[core_type]
        super().__init__(c, [features] * 4, cfg)
        self.core = DepthAnythingCore(core_type)
        self.conv2 = nn.Conv2d(features, c, 1)

    def forward(self, x):
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
        rel, feats = self.core.core((x - mean) / std)
        blocks = [feats["r4"], feats["r3"], feats["r2"], feats["r1"]]
        last = feats["out_conv"]
        x_d0 = self.conv2(feats["l4_rn"])
        depth = self.head_forward(x_d0, blocks, last, rel[:, None])
        return depth, [x_d0, *blocks, last]


# ---------------------------------------------------------------------------
# G2L Swin attention
# ---------------------------------------------------------------------------

class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.window = window
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.tensor(
            relative_position_index(window)))

    def forward(self, x, mask):
        b_, n, c = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, nh, c // nh)
        idx = self.relative_position_index.reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, nh)
        bias = bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            m = torch.from_numpy(mask).to(x.device)
            bias = (bias[None] + m[None, :, None]).expand(
                b_ // nw, nw, nh, n, n).reshape(b_, nh, n, n)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * (c // nh) ** -0.5
        probs = torch.softmax(logits + bias, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", probs, v)
        return self.proj(out.reshape(b_, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int):
        super().__init__()
        self.window = window
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x, h, w):
        b, _, c = x.shape
        win = self.window
        y = self.norm1(x).reshape(b, h, w, c)
        y, hp, wp = pad_to_multiple(y, win)
        mask = None
        if self.shift > 0:
            y = torch.roll(y, (-self.shift, -self.shift), dims=(1, 2))
            mask = shifted_window_mask(hp, wp, win, self.shift)
        wins = window_partition(y, win).reshape(-1, win * win, c)
        wins = self.attn(wins, mask).reshape(-1, win, win, c)
        y = window_reverse(wins, win, hp, wp)
        if self.shift > 0:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        x = x + y[:, :h, :w].reshape(b, h * w, c)
        return x + self.mlp(self.norm2(x))


class SwinLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, depth: int):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window, 0 if i % 2 == 0 else window // 2)
            for i in range(depth)])


class G2LFusion(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int, depth: int,
                 num_patches: int):
        super().__init__()
        self.absolute_pos_embed = nn.Parameter(
            torch.zeros(1, num_patches, dim))
        self.g2l_layer = SwinLayer(dim, num_heads, window, depth)
        self.g2l_layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.embed_proj = nn.Conv2d(1, dim, 1)  # unused, held for the keys

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2) + self.absolute_pos_embed
        for blk in self.g2l_layer.blocks:
            tokens = blk(tokens, h, w)
        tokens = self.g2l_layer_norm(tokens)
        return tokens.transpose(1, 2).reshape(b, c, h, w)


# ---------------------------------------------------------------------------
# guided-fusion U-Net
# ---------------------------------------------------------------------------

class DoubleConvBN(nn.Module):
    def __init__(self, cin: int, out: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, out, 3, padding=1, bias=False),
            nn.BatchNorm2d(out), nn.ReLU(),
            nn.Conv2d(out, out, 3, padding=1, bias=False),
            nn.BatchNorm2d(out), nn.ReLU())

    def forward(self, x):
        return self.double_conv(x)


class DoubleConvWOBN(nn.Module):
    def __init__(self, cin: int, out: int, mid: int):
        super().__init__()
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


class Up(nn.Module):
    def __init__(self, cin: int, out: int, mid: int):
        super().__init__()
        self.conv = DoubleConvWOBN(cin, out, mid)


class GuidedFusion(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        if not cfg.get("g2l", True):
            raise NotImplementedError("g2l=False")
        chans = list(cfg.get("in_channels", (32, 256, 256, 256, 256, 256)))
        inv = chans[::-1]
        heads = list(cfg.get("num_heads", (8, 8, 16, 16, 32, 32)))[::-1]
        depth = list(cfg.get("depth", (2, 2, 3, 3, 4, 4)))[::-1]
        patches = list(cfg["num_patches"])[::-1]
        self.inc = DoubleConvBN(cfg.get("n_channels", 5), chans[0])
        self.down_conv_list = nn.ModuleList(
            [Down(chans[i], chans[i + 1]) for i in range(len(chans) - 1)])
        self.up_conv_list = nn.ModuleList([
            Up(inv[i] + 2 * inv[i - 1], inv[i], inv[i] + 2 * inv[i - 1])
            for i in range(1, len(inv))])
        self.g2l_list = nn.ModuleList([
            G2LFusion(inv[i], 12, heads[i], depth[i], patches[i])
            for i in range(len(inv))])
        self.convs = nn.ModuleList([DoubleConvWOBN(2 * c, c, c) for c in inv])

    def forward(self, x, guide_cat, g2l_roi):
        feats = [self.inc(x)]
        for down in self.down_conv_list:
            feats.append(down.maxpool_conv(feats[-1]))
        outputs = []
        for idx, (enc, froi) in enumerate(zip(feats[::-1], g2l_roi)):
            size = tuple(froi.shape[-2:])
            enc = _up(enc, size)
            if idx > 0:
                up_in = _up(torch.cat([outputs[-1], guide_cat[idx - 1]], 1),
                            size)
                enc = self.up_conv_list[idx - 1].conv(
                    torch.cat([enc, up_in], 1))
            outputs.append(self.convs[idx](torch.cat([enc, froi], 1)))
        return outputs


# ---------------------------------------------------------------------------
# the PatchFusion network
# ---------------------------------------------------------------------------

class PatchFusionNet(MetricBinsHead):
    """Coarse and fine DA-ZoeDepth branches, six fusion convs, the guided
    fusion U-Net with G2L, and the PF metric-bins head at the top level."""

    def __init__(self, config: Dict[str, Any]):
        gf = config["guided_fusion"]
        inv = list(gf.get("in_channels", (32, 256, 256, 256, 256, 256)))[::-1]
        super().__init__(inv[0], inv[1:5], config["coarse_branch"])
        self.process_shape = tuple(config["patch_process_shape"])
        self.coarse_branch = ZoeDepthDA(config["coarse_branch"])
        self.fine_branch = ZoeDepthDA(config["fine_branch"])
        c = DA_OUTPUT_CHANNELS[config["fine_branch"]["midas_model_type"]]
        self.fusion_conv_list = nn.ModuleList(
            [nn.Conv2d(2 * ch, ch, 3, padding=1)
             for ch in [c] * 5 + [N_MIDAS_OUT]])
        self.guided_fusion = GuidedFusion(gf)

    def coarse(self, image_lr):
        """Whole image (1, 3, h, w) -> (coarse depth, its six features,
        their G2L-attended copies)."""
        depth, feats = self.coarse_branch(image_lr)
        g2l = [g(f) for g, f in zip(self.guided_fusion.g2l_list, feats)]
        return depth, feats, g2l

    def _roi(self, feat, boxes):
        h, w = feat.shape[-2:]
        # one spatial scale, from the height, for both axes (a quirk of the
        # published model kept by the program)
        return roi_align(feat, boxes, h, w, h / self.process_shape[0])

    def tiles(self, crops, boxes, coarse_ctx):
        """Fine pass + fusion of a block of tiles -> depth (N, 1, h, w)."""
        coarse_depth, coarse_feats, g2l = coarse_ctx
        fine_depth, fine_feats = self.fine_branch(crops)
        guide = [conv(torch.cat([self._roi(cf, boxes), ff], 1))
                 for conv, cf, ff in zip(self.fusion_conv_list, coarse_feats,
                                         fine_feats)]
        x = torch.cat([self._roi(coarse_depth, boxes), fine_depth, crops], 1)
        outs = self.guided_fusion(x, guide, [self._roi(f, boxes) for f in g2l])
        return self.head_forward(outs[0], outs[1:5], outs[-1])
