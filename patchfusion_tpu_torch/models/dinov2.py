"""DINOv2 vision transformer (patchfusion_tpu/models/dinov2.py; reference
external/torchhub/facebookresearch_dinov2_main/vision_transformer.py).

Patch embed (14x14), cls token, bicubic pos-embed interpolation with the
reference's explicit scale factors, pre-norm LayerScale blocks, and the
last-n block outputs after the final LayerNorm (`get_intermediate_layers`
with norm=True, return_class_token=True). Attribute names follow the
reference state_dict.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from patchfusion_tpu_torch.ops.activations import gelu
from patchfusion_tpu_torch.ops.resize import interpolate
from patchfusion_tpu_torch.ops.vit_attention import (carries_grad,
                                                     vit_attention,
                                                     vit_attention_plain)
from patchfusion_tpu_torch.utils import profiling

VIT_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
    # structurally complete micro variant (tests): depth 4 is the minimum,
    # the DPT head taps the last four blocks
    "vitmicro": dict(embed_dim=64, depth=4, num_heads=2),
}


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    impl: Optional[str] = None) -> torch.Tensor:
    """(B, N, H, Dh) self-attention, dtype-aware, dispatched as the JAX
    package's fused_attention (models/dinov2.py:79-84).

    float32: plain dense attention. bfloat16: `impl`, or the environment
    variable PF_ATTN_IMPL. "pallas" launches the hand-written attention
    kernel (ops/vit_attention.py; its plain twin on CPU tensors), and
    "einsum" runs the JAX einsum contract in plain torch ops
    (vit_attention_plain): bf16 logits of (q * scale) k^T, bf16 s - m, f32
    exp, bf16 probabilities, f32 normaliser applied after the f32
    probability-value product. Unset, the call takes the kernel where no
    gradient has to pass through it, and the einsum path where one does
    (grad mode on and q, k or v requiring grad): the kernel has no
    backward. Both compute the one function; on the CPU they are the same
    ops, bit for bit.
    """
    if q.dtype != torch.bfloat16:
        scale = q.shape[-1] ** -0.5
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bhnm,bmhd->bnhd", probs, v)
    impl = impl or os.environ.get("PF_ATTN_IMPL")
    if impl is None:
        impl = "einsum" if carries_grad(q, k, v) else "pallas"
    if impl == "pallas":
        return vit_attention(q, k, v)
    return vit_attention_plain(q, k, v)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads,
                                  d // self.num_heads)
        # host time per call (the span tracer's pf.attn; utils/profiling)
        with profiling.span("attn", device=False):
            o = fused_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(o.reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale (dinov2 block.py)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class DinoViT(nn.Module):
    """DINOv2 ViT. forward returns the last `n_taps` block outputs, each as
    (patch_tokens (B, N, D), cls (B, D)) after the final LayerNorm."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 patch_size: int = 14, img_size: int = 518,
                 interpolate_offset: float = 0.1):
        super().__init__()
        self.depth = depth
        self.patch_size = patch_size
        self.grid = img_size // patch_size
        self.interpolate_offset = interpolate_offset
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid * self.grid + 1, embed_dim))
        # unused by inference; kept so reference checkpoints load strictly
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.blocks = nn.ModuleList(
            [Block(embed_dim, num_heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def _interp_pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        """Bicubic pos-embed resampling with the reference's explicit scale
        factors (gh + offset) / grid, computed in float32."""
        pos_embed = self.pos_embed
        grid = self.grid
        if gh == grid and gw == grid:
            return pos_embed
        cls_pe = pos_embed[:, :1]
        patch_pe = pos_embed[:, 1:].reshape(1, grid, grid, -1)
        sy = float(gh + self.interpolate_offset) / grid
        sx = float(gw + self.interpolate_offset) / grid
        patch_pe = interpolate(patch_pe.float(), (gh, gw), mode="bicubic",
                               align_corners=False, scale=(sy, sx))
        patch_pe = patch_pe.reshape(1, gh * gw, -1).to(pos_embed.dtype)
        return torch.cat([cls_pe, patch_pe], dim=1)

    def forward(self, x: torch.Tensor, n_taps: int = 4
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """x: (B, 3, H, W), H and W multiples of patch_size."""
        b, _, h, w = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        x = x.to(self.patch_embed.proj.weight.dtype)
        tokens = self.patch_embed(x).flatten(2).transpose(1, 2)
        cls = self.cls_token.to(tokens.dtype).expand(b, 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self._interp_pos_embed(gh, gw).to(tokens.dtype)
        outs = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i >= self.depth - n_taps:
                outs.append(tokens)
        result = []
        for o in outs:
            on = self.norm(o)
            result.append((on[:, 1:], on[:, 0]))
        return result


def build_dinovit(core_type: str, dtype: torch.dtype = torch.float32,
                  device="cuda") -> DinoViT:
    """The DINOv2 ViT of a VIT_CONFIGS entry, built on `device` (the card
    unless the caller asks for the CPU; raises where CUDA is missing) and
    cast to `dtype`, in eval mode. Its parameters are the constructor's
    (zeros); load weights or draw them (api.init_weights) before use."""
    from patchfusion_tpu_torch.models.builder import check_device

    device = check_device(device)
    with torch.device(device):
        net = DinoViT(**VIT_CONFIGS[core_type])
    return net.to(dtype=dtype).eval()
