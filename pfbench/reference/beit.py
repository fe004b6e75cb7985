"""The plain float32 PatchFusion network of the BEiT ZoeDepth configuration
(PatchFusion's configs/patchfusion_zoedepth/zoedepth_patchfusion_u4k.py:
both branches ZoeDepth over MiDaS v3.1 DPT_BEiT_L_384, timm's
beit_large_patch16_384; Bao et al., "BEiT", ICLR 2022), frozen as the
benchmark's reference.

  * BEiT-L/16: a 16x16 patch conv, a class token, no absolute position
    embedding; 24 pre-norm blocks of width 1024, 16 heads of 64, MLP 4096,
    each `x += gamma_1 * Attn(LN(x))`, then `x += gamma_2 * MLP(LN(x))`;
    `Attn` takes qkv = x W + [q_bias, 0, v_bias] and computes
    softmax(q k^T / sqrt(Dh) + T[idx]) v, then a projection. T is the
    block's learned ((2gh-1)(2gw-1)+3, heads) table and idx the (1+N, 1+N)
    offset index of the (gh, gw) patch grid (`grid_index`), three of whose
    rows serve the class token. The raw outputs of blocks 5, 11, 17, 23.
  * The MiDaS DPT head: readout `project` (each patch token beside the
    class token, Linear + GELU), 1x1 projections to (256, 512, 1024, 1024),
    ConvTranspose 4x and 2x, identity, a stride-2 conv, the layerN_rn
    convs, refinenet4..1 and the output convs.
  * The ZoeDepth branch: inputs normalised as (x - 0.5) / 0.5, conv2 to a
    256-channel bottleneck, the metric-bins head of `reference/model.py`.
  * PatchFusion: two such branches, six fusion convs (256 x 5, 32), the
    guided-fusion U-Net with G2L Swin and the PF head of
    `reference/model.py`, driven by `reference/engine.py` through
    `PatchFusionNet.coarse` and `.tiles`.

Departures from the published model: dense float32 attention with the bias
gathered from the table in every forward, exact erf GELU, no dropout or
drop-path (eval), and the grid fixed when the module is built from the
configuration's process shape (the published code resamples the table for
another input size; the benchmark's tiles are always at the process
shape). `BEiT_tiny` (width 64, 4 blocks, 4 heads, hooks 0-3) is the CPU
tests' toy width, not a published model.

The attribute names are the program's state_dict names, so one weights
dict loads strictly into both. Nothing here imports the program or JAX.

Weight rules for `weights.py` (`LEAF_RULES`, `computed`): the q and v
biases are drawn as biases; the LayerScale `gamma_1` and `gamma_2` as
DINOv2's `gamma`, about 1, so that the seeded blocks are far from identity
maps; every `relative_position_bias_table` (the BEiT blocks' and the G2L
Swin blocks') at std 1.0, where the bias moves the logits as much as
q k^T / sqrt(Dh) does (about 1 with unit-variance LayerNorm outputs and
LeCun-normal weights): at the built-in 0.02 a program that left the bias
out would pass the check. `computed` gives each BEiT block's grid index
and leaves the rest (the G2L Swin index) to the built-ins.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pfbench.reference import model
from pfbench.reference.model import (FeatureFusionBlock, GuidedFusion,
                                     MetricBinsHead, Mlp, N_MIDAS_OUT, _up,
                                     conv3x3)

BEIT_CONFIGS = {
    # timm beit_large_patch16_384, MiDaS v3.1 DPT_BEiT_L_384
    "DPT_BEiT_L_384": dict(embed_dim=1024, depth=24, num_heads=16,
                           hooks=(5, 11, 17, 23)),
    # the CPU tests' toy width
    "BEiT_tiny": dict(embed_dim=64, depth=4, num_heads=4, hooks=(0, 1, 2, 3)),
}
PATCH = 16
FEATURES = 256                          # the MiDaS DPT features
OUT_CHANNELS = (256, 512, 1024, 1024)   # the four projections
BOTTLENECK = 256                        # MidasCore's output channels

LEAF_RULES = {
    "q_bias": (0.02, 0.0, False),
    "v_bias": (0.02, 0.0, False),
    "gamma_1": (0.05, 1.0, False),
    "gamma_2": (0.05, 1.0, False),
    "relative_position_bias_table": (1.0, 0.0, False),
}


def grid_index(gh: int, gw: int) -> np.ndarray:
    """(1 + gh gw, 1 + gh gw) int64 index into the ((2gh-1)(2gw-1)+3)-row
    table: [i+1, j+1] the 2-D offset of patch i from patch j (row-major
    patches), row 0 the class token's query (row R of the table, R =
    (2gh-1)(2gw-1)), column 0 its key (R + 1), [0, 0] R + 2."""
    rows = (2 * gh - 1) * (2 * gw - 1)
    yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    y, x = yy.reshape(-1), xx.reshape(-1)
    idx = np.empty((gh * gw + 1, gh * gw + 1), np.int64)
    idx[1:, 1:] = ((y[:, None] - y[None, :] + gh - 1) * (2 * gw - 1)
                   + x[:, None] - x[None, :] + gw - 1)
    idx[0, :] = rows
    idx[:, 0] = rows + 1
    idx[0, 0] = rows + 2
    return idx


def process_grid(config: Dict[str, Any]) -> Tuple[int, int]:
    """The patch grid of the model configuration's process shape."""
    h, w = config["patch_process_shape"]
    return h // PATCH, w // PATCH


def computed(key: str, shapes, config: Dict[str, Any]
             ) -> Optional[torch.Tensor]:
    """A BEiT block's relative_position_index, from the configuration's
    process shape; None for every other key."""
    if ".core.core.pretrained.model.blocks." not in key or not key.endswith(
            ".relative_position_index"):
        return None
    return torch.from_numpy(grid_index(*process_grid(config)))


# ---------------------------------------------------------------------------
# BEiT
# ---------------------------------------------------------------------------

class BeitAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, grid: Tuple[int, int]):
        super().__init__()
        gh, gw = grid
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * gh - 1) * (2 * gw - 1) + 3, num_heads))
        self.register_buffer("relative_position_index",
                             torch.tensor(grid_index(gh, gw)))
        self.proj = nn.Linear(dim, dim)

    def rel_bias(self) -> torch.Tensor:
        """(H, 1+N, 1+N): the table gathered by the grid index."""
        n1 = self.relative_position_index.shape[0]
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)]
        return bias.reshape(n1, n1, -1).permute(2, 0, 1)

    def forward(self, x):
        b, n, d = x.shape
        nh = self.num_heads
        qkv_bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                              self.v_bias])
        qkv = (self.qkv(x) + qkv_bias).reshape(b, n, 3, nh, d // nh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * (d // nh) ** -0.5
        probs = torch.softmax(logits + self.rel_bias()[None], dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", probs, v)
        return self.proj(out.reshape(b, n, d))


class BeitBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, grid: Tuple[int, int]):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = BeitAttention(dim, num_heads, grid)
        self.gamma_1 = nn.Parameter(torch.ones(dim))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)
        self.gamma_2 = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x + self.gamma_1 * self.attn(self.norm1(x))
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class BeitBackbone(nn.Module):
    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 hooks: Sequence[int], grid: Tuple[int, int]):
        super().__init__()
        self.hooks = tuple(hooks)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.patch_embed = model.PatchEmbed(embed_dim, PATCH)
        self.blocks = nn.ModuleList([BeitBlock(embed_dim, num_heads, grid)
                                     for _ in range(depth)])

    def forward(self, x):
        b = x.shape[0]
        tokens = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(b, 1, -1), tokens], 1)
        taps = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i in self.hooks:
                taps.append(tokens)
        return taps


# ---------------------------------------------------------------------------
# MiDaS DPT head
# ---------------------------------------------------------------------------

class ProjectReadout(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tok):
        cls = tok[:, :1].expand_as(tok[:, 1:])
        return self.project(torch.cat([tok[:, 1:], cls], dim=-1))


def act_postprocess(level: int, dim: int) -> nn.Sequential:
    """Readout, two empty slots (MiDaS's transpose and unflatten), the 1x1
    projection and the level's resample (none at 1/16)."""
    oc = OUT_CHANNELS[level]
    mods = [ProjectReadout(dim), nn.Identity(), nn.Identity(),
            nn.Conv2d(dim, oc, 1)]
    if level == 0:
        mods.append(nn.ConvTranspose2d(oc, oc, 4, stride=4))
    elif level == 1:
        mods.append(nn.ConvTranspose2d(oc, oc, 2, stride=2))
    elif level == 3:
        mods.append(conv3x3(oc, oc, stride=2))
    return nn.Sequential(*mods)


class Pretrained(nn.Module):
    def __init__(self, core_type: str, grid: Tuple[int, int]):
        super().__init__()
        cfg = BEIT_CONFIGS[core_type]
        self.model = BeitBackbone(cfg["embed_dim"], cfg["depth"],
                                  cfg["num_heads"], cfg["hooks"], grid)
        for i in range(4):
            setattr(self, f"act_postprocess{i + 1}",
                    act_postprocess(i, cfg["embed_dim"]))


class MidasScratch(nn.Module):
    def __init__(self):
        super().__init__()
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn",
                    conv3x3(OUT_CHANNELS[i], FEATURES, bias=False))
        for i in range(4):
            setattr(self, f"refinenet{i + 1}", FeatureFusionBlock(FEATURES))
        self.output_conv = nn.Sequential(
            conv3x3(FEATURES, FEATURES // 2), nn.Identity(),
            conv3x3(FEATURES // 2, 32), nn.ReLU(), nn.Conv2d(32, 1, 1),
            nn.ReLU())


class MidasDPTBEiT(nn.Module):
    """x (B, 3, 16 gh, 16 gw) -> (relative depth (B, H, W), the taps)."""

    def __init__(self, core_type: str, grid: Tuple[int, int]):
        super().__init__()
        self.pretrained = Pretrained(core_type, grid)
        self.scratch = MidasScratch()

    def forward(self, x):
        b, _, h, w = x.shape
        gh, gw = h // PATCH, w // PATCH
        pyramid = []
        for i, tok in enumerate(self.pretrained.model(x)):
            post = getattr(self.pretrained, f"act_postprocess{i + 1}")
            t = post[0](tok)
            t = t.transpose(1, 2).reshape(b, t.shape[-1], gh, gw)
            pyramid.append(post[3:](t))
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(pyramid[i]) for i in range(4)]
        r4 = s.refinenet4(rn[3], size=rn[2].shape[-2:])
        r3 = s.refinenet3(r4, rn[2], size=rn[1].shape[-2:])
        r2 = s.refinenet2(r3, rn[1], size=rn[0].shape[-2:])
        r1 = s.refinenet1(r2, rn[0])
        oc = s.output_conv
        out = oc[0](r1)
        out = _up(out, (out.shape[-2] * 2, out.shape[-1] * 2))
        last = F.relu(oc[2](out))
        rel = _up(F.relu(oc[4](last)), (h, w))
        feats = {"l4_rn": rn[3], "r4": r4, "r3": r3, "r2": r2, "r1": r1,
                 "out_conv": last}
        return rel[:, 0], feats


class MidasCore(nn.Module):
    def __init__(self, core_type: str, grid: Tuple[int, int]):
        super().__init__()
        self.core = MidasDPTBEiT(core_type, grid)


class ZoeDepthBEiT(MetricBinsHead):
    """ZoeDepth over the BEiT core: (x - 0.5) / 0.5, conv2 on the
    bottleneck, the metric-bins head conditioned on relative depth."""

    def __init__(self, cfg: Dict[str, Any], grid: Tuple[int, int]):
        super().__init__(BOTTLENECK, [BOTTLENECK] * 4, cfg)
        self.core = MidasCore(cfg.get("midas_model_type", "DPT_BEiT_L_384"),
                              grid)
        self.conv2 = nn.Conv2d(FEATURES, BOTTLENECK, 1)

    def forward(self, x):
        rel, feats = self.core.core((x - 0.5) / 0.5)
        blocks = [feats["r4"], feats["r3"], feats["r2"], feats["r1"]]
        last = feats["out_conv"]
        x_d0 = self.conv2(feats["l4_rn"])
        depth = self.head_forward(x_d0, blocks, last, rel[:, None])
        return depth, [x_d0, *blocks, last]


# ---------------------------------------------------------------------------
# the PatchFusion network
# ---------------------------------------------------------------------------

class PatchFusionNet(model.PatchFusionNet):
    """Coarse and fine BEiT ZoeDepth branches on the process shape's grid,
    six fusion convs, the guided-fusion U-Net with G2L and the PF head;
    `coarse` and `tiles` as the DA reference's."""

    def __init__(self, config: Dict[str, Any]):
        gf = config["guided_fusion"]
        inv = list(gf.get("in_channels", (32, 256, 256, 256, 256, 256)))[::-1]
        MetricBinsHead.__init__(self, inv[0], inv[1:5],
                                config["coarse_branch"])
        self.process_shape = tuple(config["patch_process_shape"])
        grid = process_grid(config)
        self.coarse_branch = ZoeDepthBEiT(config["coarse_branch"], grid)
        self.fine_branch = ZoeDepthBEiT(config["fine_branch"], grid)
        self.fusion_conv_list = nn.ModuleList(
            [nn.Conv2d(2 * ch, ch, 3, padding=1)
             for ch in [BOTTLENECK] * 5 + [N_MIDAS_OUT]])
        self.guided_fusion = GuidedFusion(gf)
