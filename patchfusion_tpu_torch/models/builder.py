"""Build the PatchFusion network from reference-style config dicts
(patchfusion_tpu/models/builder.py): `model.config` of
configs/**/..._patchfusion_u4k.py, loaded by patchfusion_tpu_torch.config.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from patchfusion_tpu_torch.config.registry import MODELS
from patchfusion_tpu_torch.models.patchfusion import (PatchFusionNet,
                                                      TileConfig)

ZOE_KEYS = ("n_bins", "bin_centers_type", "bin_embedding_dim",
            "n_attractors", "attractor_alpha", "attractor_gamma",
            "attractor_kind", "attractor_type", "min_temp", "max_temp")

FUSION_KEYS = ("n_channels", "in_channels", "depth", "num_heads",
               "num_patches", "g2l")


def zoe_branch_kwargs(branch_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Reference zoe_depth_config dict -> make_zoe_branch kwargs. Only the
    'DA-ZoeDepth' (DINOv2 core) family is ported; 'ZoeDepth' (BEiT) maps
    to core_family='midas', which the branch factory rejects."""
    t = branch_cfg.get("type", "DA-ZoeDepth")
    if t not in ("DA-ZoeDepth", "ZoeDepth"):
        raise NotImplementedError(f"unknown branch type {t!r}")
    kw = {k: branch_cfg[k] for k in ZOE_KEYS if k in branch_cfg}
    if "n_attractors" in kw:
        kw["n_attractors"] = tuple(kw["n_attractors"])
    kw["core_type"] = branch_cfg.get(
        "midas_model_type", "DPT_BEiT_L_384" if t == "ZoeDepth" else "vitl")
    if t == "ZoeDepth":
        kw["core_family"] = "midas"
    return kw


def guided_fusion_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    kw = {k: cfg[k] for k in FUSION_KEYS if k in cfg}
    for k in ("in_channels", "depth", "num_heads", "num_patches"):
        if k in kw:
            kw[k] = tuple(kw[k])
    return kw


@MODELS.register_module(name="PatchFusion")
def build_patchfusion(config: Dict[str, Any], dtype=torch.float32,
                      device="cuda") -> Tuple[PatchFusionNet, TileConfig]:
    """config: the reference PatchFusion `model.config` dict. The modules
    are created directly on `device` (their default init runs there) and
    cast to `dtype`, in eval mode. The default is the card; a caller who
    wants the CPU passes device="cpu". Raises if a CUDA device is asked for
    and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    tile_cfg = TileConfig(tuple(config["image_raw_shape"]),
                          tuple(config["patch_split_num"]),
                          tuple(config["patch_process_shape"]))
    with torch.device(device):
        net = PatchFusionNet(
            coarse=zoe_branch_kwargs(config["coarse_branch"]),
            fine=zoe_branch_kwargs(config["fine_branch"]),
            guided_fusion=guided_fusion_kwargs(config["guided_fusion"]),
            min_depth=config["min_depth"], max_depth=config["max_depth"],
            patch_process_shape=tuple(config["patch_process_shape"]))
    return net.to(device=device, dtype=dtype).eval(), tile_cfg
