"""Global-to-local (G2L) shifted-window attention
(patchfusion_tpu/models/swin.py; reference estimator/models/blocks/
swin_layers.py): a small Swin stack over whole-image coarse features with a
learned absolute position embedding sized to each level's num_patches.
The shifted-window mask is formed on the logits' device from cached region
labels (`ops/windows.shifted_window_mask_on`) and joins the logits after
the relative-position bias, broadcast over the images and heads.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from patchfusion_tpu_torch.models.dinov2 import Mlp
from patchfusion_tpu_torch.ops.windows import (pad_to_multiple,
                                               shifted_window_mask_on,
                                               window_partition,
                                               window_reverse)
from patchfusion_tpu_torch.utils import profiling


@functools.lru_cache(maxsize=None)
def relative_position_index(window: int) -> np.ndarray:
    """(N, N) lookup into the (2w-1)^2 relative-position-bias table
    (reference swin_layers.py:112-123)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def biased_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, H, Dh) attention with an additive f32 bias broadcastable to
    (B, H, N, N): logits, scale and bias in f32, f32 softmax, probabilities
    in the value dtype (jax.nn.dot_product_attention's order). mask: an
    (nW, N, N) f32 mask added after the bias, window w of each image taking
    mask[w]: B is images x nW, windows in order within an image."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float() * scale + bias
    if mask is not None:
        b, h, n, _ = logits.shape
        nw = mask.shape[0]
        logits = (logits.view(b // nw, nw, h, n, n) + mask[:, None]).view(
            b, h, n, n)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v)


class WindowAttention(nn.Module):
    """W-MSA with relative position bias (swin_layers.py:85-164), over
    (num_windows * B, N, C)."""

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

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B * nW, N, C); mask: the (nW, N, N) f32 shifted-window mask
        on x's device, or None."""
        b_, n, c = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, nh, c // nh)
        idx = self.relative_position_index.reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, nh)
        bias = bias.permute(2, 0, 1).float()[None]     # (1, nh, N, N)
        out = biased_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                               bias, (c // nh) ** -0.5, mask)
        return self.proj(out.reshape(b_, n, c))


class SwinBlock(nn.Module):
    """One (shifted-)window transformer block (swin_layers.py:171-268)."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window = window
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, _, c = x.shape
        win = self.window
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        x, hp, wp = pad_to_multiple(x, win)
        mask = None
        if self.shift > 0:
            profiling.count("g2l_shift_blocks")
            x = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
            mask = shifted_window_mask_on(hp, wp, win, self.shift, x.device)
        wins = window_partition(x, win).reshape(-1, win * win, c)
        wins = self.attn(wins, mask).reshape(-1, win, win, c)
        x = window_reverse(wins, win, hp, wp)
        if self.shift > 0:
            x = torch.roll(x, (self.shift, self.shift), dims=(1, 2))
        x = shortcut + x[:, :h, :w].reshape(b, h * w, c)
        return x + self.mlp(self.norm2(x))


class SwinLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, depth: int):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window,
                      0 if i % 2 == 0 else window // 2)
            for i in range(depth)])


class G2LFusion(nn.Module):
    """Whole-image G2L attention stage (swin_layers.py:360-431): APE +
    `depth` alternating W-MSA/SW-MSA blocks + final LayerNorm, over
    (B, C, H, W) with H*W == num_patches (the APE pins the resolution)."""

    def __init__(self, embed_dim: int, window: int, num_heads: int,
                 depth: int, num_patches: int):
        super().__init__()
        self.num_patches = num_patches
        self.absolute_pos_embed = nn.Parameter(
            torch.zeros(1, num_patches, embed_dim))
        self.g2l_layer = SwinLayer(embed_dim, num_heads, window, depth)
        self.g2l_layer_norm = nn.LayerNorm(embed_dim, eps=1e-5)
        # the reference's dead area-prior projection; held for strict loads
        self.embed_proj = nn.Conv2d(1, embed_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        if h * w != self.num_patches:
            raise ValueError(f"G2L APE is sized for {self.num_patches} "
                             f"patches, got {h}x{w}")
        tokens = x.flatten(2).transpose(1, 2)
        tokens = tokens + self.absolute_pos_embed.to(tokens.dtype)
        for blk in self.g2l_layer.blocks:
            tokens = blk(tokens, h, w)
        tokens = self.g2l_layer_norm(tokens)
        return tokens.transpose(1, 2).reshape(b, c, h, w)
