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
from patchfusion_tpu_torch.models.zoedepth import make_zoe_branch

ZOE_KEYS = ("n_bins", "bin_centers_type", "bin_embedding_dim",
            "n_attractors", "attractor_alpha", "attractor_gamma",
            "attractor_kind", "attractor_type", "min_temp", "max_temp")

FUSION_KEYS = ("n_channels", "in_channels", "depth", "num_heads",
               "num_patches", "g2l")


def zoe_branch_kwargs(branch_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Reference zoe_depth_config dict -> make_zoe_branch kwargs:
    'DA-ZoeDepth' (DINOv2 core), or 'ZoeDepth', which maps to
    core_family='midas' (the MiDaS DPT_BEiT_L_384 core)."""
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


def check_device(device) -> torch.device:
    """`device` as a torch.device; raises if it is a CUDA device and there
    is none (no entry point falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return device


@MODELS.register_module(name="PatchFusion")
def build_patchfusion(config: Dict[str, Any], dtype=torch.float32,
                      device="cuda") -> Tuple[PatchFusionNet, TileConfig]:
    """config: the reference PatchFusion `model.config` dict. The modules
    are created directly on `device` (their default init runs there) and
    cast to `dtype`, in eval mode (`PatchFusionNet.train_mode` sets the
    fusion stage's training modes). `train_remat` in the config recomputes
    the fusion stage in the backward. The default is the card; a caller
    who wants the CPU passes device="cpu". Raises if a CUDA device is asked
    for and there is none."""
    device = check_device(device)
    tile_cfg = TileConfig(tuple(config["image_raw_shape"]),
                          tuple(config["patch_split_num"]),
                          tuple(config["patch_process_shape"]))
    with torch.device(device):
        net = PatchFusionNet(
            coarse=zoe_branch_kwargs(config["coarse_branch"]),
            fine=zoe_branch_kwargs(config["fine_branch"]),
            guided_fusion=guided_fusion_kwargs(config["guided_fusion"]),
            min_depth=config["min_depth"], max_depth=config["max_depth"],
            patch_process_shape=tuple(config["patch_process_shape"]),
            remat=bool(config.get("train_remat", False)))
    return net.to(device=device, dtype=dtype).eval(), tile_cfg


def build_zoedepth_branch(branch_cfg: Dict[str, Any], min_depth: float,
                          max_depth: float, dtype=torch.float32,
                          device="cuda", process_shape=None
                          ) -> torch.nn.Module:
    """A standalone coarse or fine branch (the BaselinePretrain stages),
    built on `device` (the card unless the caller asks for the CPU) and
    cast to `dtype`, in eval mode. process_shape: the input size, which
    fixes a BEiT branch's grid (default 384x512)."""
    device = check_device(device)
    with torch.device(device):
        net = make_zoe_branch(zoe_branch_kwargs(branch_cfg), min_depth,
                              max_depth, process_shape)
    return net.to(device=device, dtype=dtype).eval()
