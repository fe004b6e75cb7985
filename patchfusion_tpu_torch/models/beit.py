"""BEiT-L/16 backbone + MiDaS v3.1 DPT head (DPT_BEiT_L_384), the base model
of the `patchfusion_zoedepth` family (patchfusion_tpu/models/beit.py; the
reference fetches it from torch.hub, external/zoedepth/models/base_models/
midas.py:340).

  * BEiT ViT: 16x16 patch conv, a cls token, no absolute position
    embedding; pre-norm blocks with LayerScale (`gamma_1`, `gamma_2`) and a
    per-block relative-position bias, a learned table of
    ((2gh-1)(2gw-1)+3, heads) rows indexed by pairwise token offsets (the
    +3 rows: cls->patch, patch->cls, cls->cls); the qkv bias is
    [q_bias, 0, v_bias] (no k-bias parameter); raw block outputs at the
    MiDaS hooks.
  * DPT head: readout 'project' (cat [patch, cls], Linear + GELU), 1x1
    projections to (256, 512, 1024, 1024), resampled to 1/4, 1/8, 1/16 and
    1/32 (ConvTranspose 4x and 2x, identity, a stride-2 conv), the
    layerN_rn convs, refinenet4..1 and the output head. The six taps
    MidasCore hooks (out_conv, l4_rn, r4, r3, r2, r1) come back in a dict.

The table is sized for one grid (gh, gw), fixed when the module is built,
as the JAX package fixes it at trace time; weights of another grid are
resampled on loading (engine/checkpoint.py). Module and parameter names
are the published MiDaS ones (pretrained.model.* in timm's BEiT naming,
pretrained.act_postprocessN.*, scratch.*), so the reference's checkpoints
and the output of patchfusion_tpu/convert/jax2torch.py load strictly.
NCHW outside the transformer.

bf16 attention follows the JAX package's contract (beit.py:117-125), not
the DINOv2 one: q * scale in bf16, the logits in f32 (the bf16 operands'
products are exact in f32; the sums are f32), the bias added and the
softmax taken in f32, the probabilities cast to bf16, P.V summed in f32
and cast to bf16. These are plain matmuls, outside any kernel, in both
packages; they need TF32 off (PyTorch's default) to be f32 products.

Tracing (utils/profiling, off by default): each BeitAttention's core, from
obtaining the (H, N, N) bias through P.V, is the device span
`pf.beit_attn`, and obtaining the bias inside it `pf.relpos`; the qkv and
output projections lie outside. Counters: `beit_attn` (calls),
`beit_attn_seqs` (their summed batch), `relpos_bytes` (bytes of the bias
produced).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from patchfusion_tpu_torch.models.dinov2 import Mlp
from patchfusion_tpu_torch.models.dpt import FeatureFusionBlock, conv3x3
from patchfusion_tpu_torch.ops.activations import Gelu
from patchfusion_tpu_torch.ops.resize import interpolate_nchw
from patchfusion_tpu_torch.utils import profiling

BEIT_CONFIGS = {
    # timm beit_large_patch16_384
    "DPT_BEiT_L_384": dict(embed_dim=1024, depth=24, num_heads=16,
                           hooks=(5, 11, 17, 23)),
    # structurally complete toy variant (tests)
    "BEiT_tiny": dict(embed_dim=64, depth=4, num_heads=4, hooks=(0, 1, 2, 3)),
}
PATCH = 16
MIDAS_FEATURES = 256
MIDAS_OUT_CHANNELS = (256, 512, 1024, 1024)


@functools.lru_cache(maxsize=8)
def relative_position_index(gh: int, gw: int) -> np.ndarray:
    """(1+N, 1+N) int64 index into the ((2gh-1)(2gw-1)+3)-row bias table:
    entry [i+1, j+1] encodes the 2-D offset between patches i and j
    (h-major); row and column 0 (the cls token) read the three extra rows."""
    num_rel = (2 * gh - 1) * (2 * gw - 1)
    coords = np.stack(np.meshgrid(np.arange(gh), np.arange(gw),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += gh - 1
    rel[:, :, 1] += gw - 1
    rel[:, :, 0] *= 2 * gw - 1
    n = gh * gw
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel      # cls -> patch
    idx[0:, 0] = num_rel + 1  # patch -> cls
    idx[0, 0] = num_rel + 2   # cls -> cls
    return idx


def table_rows(grid: Tuple[int, int]) -> int:
    """Rows of the relative-position-bias table of a (gh, gw) grid."""
    return (2 * grid[0] - 1) * (2 * grid[1] - 1) + 3


class BeitAttention(nn.Module):
    """BEiT MHSA with the q/v-only qkv bias and the relative-position bias
    of its grid."""

    def __init__(self, dim: int, num_heads: int, grid: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        self.grid = tuple(grid)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(table_rows(self.grid), num_heads))
        self.register_buffer("relative_position_index", torch.tensor(
            relative_position_index(*self.grid)))
        self.proj = nn.Linear(dim, dim)

    def rel_bias(self) -> torch.Tensor:
        """(H, 1+N, 1+N) float32: the table gathered once for all heads."""
        n1 = self.relative_position_index.shape[0]
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)]
        return bias.reshape(n1, n1, -1).permute(2, 0, 1).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        hd = d // h
        if n != self.relative_position_index.shape[0]:
            raise ValueError(f"BEiT attention is built for the {self.grid} "
                             f"grid ({self.relative_position_index.shape[0]}"
                             f" tokens), got {n} tokens")
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias]).to(x.dtype)
        qkv = (F.linear(x, self.qkv.weight) + bias).reshape(
            b, n, 3, h, hd).permute(2, 0, 3, 1, 4)      # (3, B, H, N, Dh)
        # the attention core, from the bias through P.V, is the tracer's
        # pf.beit_attn; obtaining the bias, pf.relpos (utils/profiling)
        with profiling.span("beit_attn"):
            with profiling.span("relpos"):
                rel = self.rel_bias()
            q = qkv[0] * hd ** -0.5
            logits = torch.matmul(q.float(),
                                  qkv[1].float().transpose(-1, -2))
            logits = logits + rel[None]
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            o = torch.matmul(probs.float(), qkv[2].float()).to(x.dtype)
        profiling.count("beit_attn")
        profiling.count("beit_attn_seqs", b)
        profiling.count("relpos_bytes", rel.numel() * rel.element_size())
        return self.proj(o.transpose(1, 2).reshape(b, n, d))


class BeitBlock(nn.Module):
    """Pre-norm block with LayerScale (timm's beit Block)."""

    def __init__(self, dim: int, num_heads: int, grid: Tuple[int, int],
                 mlp_ratio: float = 4.0, init_values: float = 1e-5):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = BeitAttention(dim, num_heads, grid)
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x)) * self.gamma_1.to(x.dtype)
        return x + self.mlp(self.norm2(x)) * self.gamma_2.to(x.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, stride=PATCH)


class BeitBackbone(nn.Module):
    """BEiT ViT (timm naming); forward returns the raw block outputs
    (B, 1+N, D) at the hook indices."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 hooks: Sequence[int], grid: Tuple[int, int]):
        super().__init__()
        self.hooks = tuple(hooks)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.patch_embed = PatchEmbed(embed_dim)
        self.blocks = nn.ModuleList([BeitBlock(embed_dim, num_heads, grid)
                                     for _ in range(depth)])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        b = x.shape[0]
        x = x.to(self.patch_embed.proj.weight.dtype)
        tokens = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        cls = self.cls_token.to(tokens.dtype).expand(b, 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        taps = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i in self.hooks:
                taps.append(tokens)
        return taps


class ProjectReadout(nn.Module):
    """readout='project': each patch token concatenated with the cls token,
    then Linear(2D, D) and GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), Gelu())

    def forward(self, tok: torch.Tensor) -> torch.Tensor:
        cls = tok[:, :1].expand_as(tok[:, 1:])
        return self.project(torch.cat([tok[:, 1:], cls], dim=-1))


def act_postprocess(level: int, dim: int) -> nn.Sequential:
    """MiDaS's act_postprocessN: readout, (transpose), (unflatten), 1x1
    projection and the level's resample (none at 1/16)."""
    oc = MIDAS_OUT_CHANNELS[level]
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
    """MiDaS's `pretrained`: the backbone under `model` and the four
    act_postprocess stacks."""

    def __init__(self, cfg: Dict, grid: Tuple[int, int]):
        super().__init__()
        self.model = BeitBackbone(cfg["embed_dim"], cfg["depth"],
                                  cfg["num_heads"], cfg["hooks"], grid)
        for i in range(4):
            setattr(self, f"act_postprocess{i + 1}",
                    act_postprocess(i, cfg["embed_dim"]))


class MidasScratch(nn.Module):
    """MiDaS's `scratch`: layerN_rn, refinenetN and output_conv (its
    Identity and ReLU slots hold the reference's indices)."""

    def __init__(self, features: int = MIDAS_FEATURES,
                 out_channels: Sequence[int] = MIDAS_OUT_CHANNELS):
        super().__init__()
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn",
                    conv3x3(out_channels[i], features, bias=False))
        for i in range(4):
            setattr(self, f"refinenet{i + 1}", FeatureFusionBlock(features))
        self.output_conv = nn.Sequential(
            conv3x3(features, features // 2), nn.Identity(),
            conv3x3(features // 2, 32), nn.ReLU(), nn.Conv2d(32, 1, 1),
            nn.ReLU())


class MidasDPTBEiT(nn.Module):
    """DPT_BEiT_L_384 for one input grid: forward(x (B, 3, 16 gh, 16 gw))
    -> (relative depth (B, H, W), the six taps)."""

    def __init__(self, model_type: str = "DPT_BEiT_L_384",
                 grid: Tuple[int, int] = (24, 32)):
        super().__init__()
        if model_type not in BEIT_CONFIGS:
            raise ValueError(f"unknown midas_model_type {model_type!r}; "
                             f"available: {sorted(BEIT_CONFIGS)}")
        self.grid = tuple(grid)
        self.pretrained = Pretrained(BEIT_CONFIGS[model_type], self.grid)
        self.scratch = MidasScratch()

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        b, _, h, w = x.shape
        gh, gw = h // PATCH, w // PATCH
        taps = self.pretrained.model(x)
        pyramid = []
        for i, tok in enumerate(taps):
            post = getattr(self.pretrained, f"act_postprocess{i + 1}")
            t = post[0](tok)
            t = t.transpose(1, 2).reshape(b, t.shape[-1], gh, gw)
            pyramid.append(post[3:](t))
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(pyramid[i]) for i in range(4)]
        feats = {"l4_rn": rn[3]}
        feats["r4"] = s.refinenet4(rn[3], size=rn[2].shape[-2:])
        feats["r3"] = s.refinenet3(feats["r4"], rn[2], size=rn[1].shape[-2:])
        feats["r2"] = s.refinenet2(feats["r3"], rn[1], size=rn[0].shape[-2:])
        feats["r1"] = s.refinenet1(feats["r2"], rn[0])
        oc = s.output_conv
        out = oc[0](feats["r1"])
        out = interpolate_nchw(out, (out.shape[-2] * 2, out.shape[-1] * 2),
                               mode="bilinear", align_corners=True)
        out = F.relu(oc[2](out))
        feats["out_conv"] = out  # the reference's hooked ReLU activation
        out = F.relu(oc[4](out))
        if tuple(out.shape[-2:]) != (h, w):
            out = interpolate_nchw(out, (h, w), mode="bilinear",
                                   align_corners=True)
        return out[:, 0], feats

