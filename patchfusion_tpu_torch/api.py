"""User-facing PatchFusion API (patchfusion_tpu/api.py):

    model = PatchFusion.from_config(cfg, device="cuda", dtype=torch.bfloat16)
    depth = model.infer(image_lr, image_hr, cai_mode="m2", process_num=4)

`cfg` is the reference `model.config` dict (e.g.
`Config.fromfile(path).model.config.to_dict()`); image_lr is the
process-resolution whole image (1, h, w, 3) and image_hr the raw image
(H, W, 3), float in [0, 1]. Weights are random, drawn from `seed`; loading
published checkpoints is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from patchfusion_tpu_torch.engine.inference import PatchFusionInference
from patchfusion_tpu_torch.models.builder import build_patchfusion
from patchfusion_tpu_torch.models.patchfusion import TileConfig
from patchfusion_tpu_torch.ops.resize import NetResizer

_NORMAL_002 = ("pos_embed", "absolute_pos_embed",
               "relative_position_bias_table")


@torch.no_grad()
def init_weights(net: nn.Module, seed: int) -> None:
    """Seeded random weights, with the distributions of the JAX package's
    `_init_variables`: conv/linear weights truncated-normal LeCun (clipped
    at 2 sigma), biases 0, norm scales and LayerScale gammas 1, position
    embeddings and relative-position tables normal(0.02), cls token
    normal(1e-6). Drawn in float32 on the weights' device from one
    torch.Generator."""
    dev = next(net.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    norms = (nn.LayerNorm, nn.BatchNorm2d)
    for mod in net.modules():
        for leaf, p in mod.named_parameters(recurse=False):
            if isinstance(mod, norms):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "weight":
                if isinstance(mod, nn.ConvTranspose2d):
                    fan_in = p.shape[0]
                else:
                    fan_in = p[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                v = torch.randn(p.shape, generator=gen, device=dev)
                p.copy_(v.clamp_(-2.0, 2.0) * std)
            elif leaf == "bias" or leaf == "mask_token":
                p.zero_()
            elif leaf == "gamma":
                p.fill_(1.0)
            elif leaf in _NORMAL_002:
                p.copy_(torch.randn(p.shape, generator=gen, device=dev)
                        * 0.02)
            elif leaf == "cls_token":
                p.copy_(torch.randn(p.shape, generator=gen, device=dev)
                        * 1e-6)
            else:
                raise ValueError(f"no init rule for parameter {leaf!r} of "
                                 f"{type(mod).__name__}")
        if isinstance(mod, nn.BatchNorm2d):
            mod.reset_running_stats()


class PatchFusion:
    def __init__(self, net, tile_cfg: TileConfig, config: Dict[str, Any],
                 process_num: int = 4):
        self.net = net
        self.tile_cfg = tile_cfg
        self.config = config
        multiple = 14 if config["coarse_branch"].get(
            "type", "DA-ZoeDepth") == "DA-ZoeDepth" else 32
        pph, ppw = tile_cfg.patch_process_shape
        self.resizer = NetResizer(ppw, pph, keep_aspect_ratio=False,
                                  ensure_multiple_of=multiple,
                                  resize_method="minimal")
        self.default_process_num = process_num
        self._engines: Dict[Tuple, PatchFusionInference] = {}

    @classmethod
    def from_config(cls, config: Dict[str, Any], device="cuda",
                    dtype: torch.dtype = torch.float32, seed: int = 0,
                    process_num: int = 4) -> "PatchFusion":
        """Build from the reference `model.config` dict with seeded random
        weights (drawn in float32, then cast to `dtype`), on the card unless
        the caller passes device="cpu"; raises where CUDA is missing."""
        net, tile_cfg = build_patchfusion(config, dtype=torch.float32,
                                          device=device)
        init_weights(net, seed)
        return cls(net.to(dtype), tile_cfg, config, process_num)

    def engine(self, process_num: Optional[int] = None,
               tile_cfg: Optional[TileConfig] = None
               ) -> PatchFusionInference:
        pn = process_num or self.default_process_num
        tc = tile_cfg or self.tile_cfg
        key = (pn, tc)
        if key not in self._engines:
            self._engines[key] = PatchFusionInference(self.net, tc,
                                                      process_num=pn)
        return self._engines[key]

    def infer(self, image_lr: np.ndarray, image_hr: np.ndarray,
              cai_mode: str = "m1", process_num: Optional[int] = None,
              image_raw_shape=None, patch_split_num=None,
              rng: Optional[np.random.Generator] = None,
              rand_origins: Optional[np.ndarray] = None) -> np.ndarray:
        """image_lr (1, h, w, 3) NHWC in [0, 1]; image_hr (H, W, 3).
        Returns depth (H', W') as a float32 numpy array."""
        tc = self.tile_cfg
        if image_raw_shape is not None or patch_split_num is not None:
            tc = TileConfig(
                tuple(image_raw_shape or tc.image_raw_shape),
                tuple(patch_split_num or tc.patch_split_num),
                tc.patch_process_shape)
        depth = self.engine(process_num, tc).infer(
            image_lr, image_hr, cai_mode=cai_mode, rng=rng,
            rand_origins=rand_origins)
        return depth.cpu().numpy()
