"""User-facing PatchFusion API (patchfusion_tpu/api.py):

    model = PatchFusion.from_pretrained(snapshot_dir, device="cuda",
                                        dtype=torch.bfloat16)    # or
    model = PatchFusion.from_config(cfg, ckpts=(coarse, fine, fusion))
    depth = model.infer(image_lr, image_hr, cai_mode="m2", process_num=4)

`cfg` is the reference `model.config` dict (e.g.
`Config.fromfile(path).model.config.to_dict()`); image_lr is the
process-resolution whole image (1, h, w, 3) and image_hr the raw image
(H, W, 3), float in [0, 1]. Weights come from the reference's coarse, fine
and fusion `.pth` files, from a LOCAL snapshot directory (config.json +
pytorch_model.bin or model.safetensors; nothing is downloaded), or, with
neither, are random, drawn from `seed`.

`BaselinePretrain` is the coarse-only or fine-only model of the first two
training stages and their eval.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from patchfusion_tpu_torch.engine.checkpoint import (
    load_branch_state_dict, load_fusion_state_dict,
    load_patchfusion_from_torch, load_patchfusion_hub_dir,
    load_torch_state_dict, read_weights, save_params)
from patchfusion_tpu_torch.engine.inference import PatchFusionInference
from patchfusion_tpu_torch.engine.training import batch_stats, split_params
from patchfusion_tpu_torch.models.builder import (build_patchfusion,
                                                  build_zoedepth_branch,
                                                  check_device)
from patchfusion_tpu_torch.models.patchfusion import FEATURE_KEYS, TileConfig
from patchfusion_tpu_torch.ops.resize import NetResizer
from patchfusion_tpu_torch.parallel.dist import PatchMesh
from patchfusion_tpu_torch.utils import profiling

_NORMAL_002 = ("pos_embed", "absolute_pos_embed",
               "relative_position_bias_table")


@torch.no_grad()
def init_weights(net: nn.Module, seed: int) -> None:
    """Seeded random weights, with the distributions of the JAX package's
    `_init_variables`: conv/linear weights truncated-normal LeCun (clipped
    at 2 sigma), biases 0, norm scales and LayerScale gammas 1, position
    embeddings and relative-position tables normal(0.02), cls token
    normal(1e-6). Drawn in float32 on the weights' device from one
    torch.Generator.

    BEiT leaves (one difference from the JAX package): the qkv weight is
    LeCun, q_bias and v_bias 0, gamma_1 and gamma_2 1. The JAX package's
    rule, by leaf name, sends `qkv_kernel`, `gamma_1` and `gamma_2` to its
    zeros branch, so its seeded BEiT blocks are identity maps; here every
    block attends."""
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
            elif leaf in ("bias", "mask_token", "q_bias", "v_bias"):
                p.zero_()
            elif leaf in ("gamma", "gamma_1", "gamma_2"):
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


def _resizer(branch_cfg: Dict[str, Any],
             patch_process_shape: Tuple[int, int]) -> NetResizer:
    """The reference's network-input Resize: multiple of 14 for the DA
    branch, 32 for the BEiT one."""
    multiple = 14 if branch_cfg.get("type",
                                    "DA-ZoeDepth") == "DA-ZoeDepth" else 32
    pph, ppw = patch_process_shape
    return NetResizer(ppw, pph, keep_aspect_ratio=False,
                      ensure_multiple_of=multiple, resize_method="minimal")


class PatchFusion:
    def __init__(self, net, tile_cfg: TileConfig, config: Dict[str, Any],
                 process_num: int = 4):
        self.net = net
        self.tile_cfg = tile_cfg
        self.config = config
        self.resizer = _resizer(config["coarse_branch"],
                                tile_cfg.patch_process_shape)
        self.default_process_num = process_num
        self._engines: Dict[Tuple, PatchFusionInference] = {}

    @classmethod
    def from_config(cls, config: Dict[str, Any], device="cuda",
                    dtype: torch.dtype = torch.float32, seed: int = 0,
                    process_num: int = 4,
                    ckpts: Optional[Tuple[str, str, Optional[str]]] = None
                    ) -> "PatchFusion":
        """Build from the reference `model.config` dict with seeded random
        weights (drawn in float32, then cast to `dtype`), on the card unless
        the caller passes device="cpu"; raises where CUDA is missing.
        ckpts: the reference's (coarse.pth, fine.pth, fusion.pth or None),
        loaded on the CPU (engine/checkpoint.py) before the net is moved
        and cast; without a fusion file the fusion part keeps its seeded
        weights."""
        if ckpts is None:
            net, tile_cfg = build_patchfusion(config, dtype=torch.float32,
                                              device=device)
            init_weights(net, seed)
        else:
            device = check_device(device)
            net, tile_cfg = build_patchfusion(config, device="cpu")
            init_weights(net, seed)
            coarse, fine, fusion = ckpts
            load_patchfusion_from_torch(net, coarse, fine, fusion)
        return cls(net.to(device=device, dtype=dtype), tile_cfg, config,
                   process_num)

    @classmethod
    def from_pretrained(cls, path: str, device="cuda",
                        dtype: torch.dtype = torch.float32,
                        process_num: int = 4) -> "PatchFusion":
        """Load a LOCAL snapshot directory: config.json (the reference
        convert_huggingface.py export) and the full state dict in
        pytorch_model.bin or model.safetensors, loaded strictly. A path
        that is not a directory raises: nothing is downloaded."""
        if not os.path.isdir(path):
            raise FileNotFoundError(
                f"{path!r} is not a local snapshot directory (config.json + "
                "pytorch_model.bin or model.safetensors); from_pretrained "
                "downloads nothing")
        device = check_device(device)
        with open(os.path.join(path, "config.json")) as f:
            config = _normalize_hub_config(json.load(f))
        # built on the meta device, the parameters are the file's tensors
        net, tile_cfg = build_patchfusion(config, device="meta")
        load_patchfusion_hub_dir(net, path)
        return cls(net.to(device=device, dtype=dtype), tile_cfg, config,
                   process_num)

    # -- persistence (the reference's load_dict / get_save_dict) -------------

    def get_save_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The fusion-only weights (the reference strips the frozen
        branches, patchfusion.py:179-187): {"params", "batch_stats"} by
        state_dict names."""
        return {"params": split_params(self.net)[0],
                "batch_stats": batch_stats(self.net)}

    def save(self, path: str) -> None:
        """Write get_save_dict() as the port's weights file
        (engine/checkpoint.save_params)."""
        d = self.get_save_dict()
        save_params(path, d["params"], d["batch_stats"])

    def load_dict(self, path: str) -> None:
        """Merge one of the port's weight files (a `save` file or a
        training checkpoint) over the current weights, strict=False: keys
        the file lacks keep their values, keys the net lacks raise. The
        cached engines are dropped."""
        params, stats = read_weights(path)
        with torch.no_grad():
            load_fusion_state_dict(self.net, {**params, **stats})
        self._engines.clear()

    def engine(self, process_num: Optional[int] = None,
               tile_cfg: Optional[TileConfig] = None,
               mesh: Optional[PatchMesh] = None) -> PatchFusionInference:
        """mesh: split each image's tiles across the ranks of a
        parallel.dist.PatchMesh (make_patch_mesh()), the JAX package's
        `patch` mesh; every rank then passes the same image."""
        pn = process_num or self.default_process_num
        tc = tile_cfg or self.tile_cfg
        key = (pn, tc, mesh)
        if key not in self._engines:
            self._engines[key] = PatchFusionInference(self.net, tc,
                                                      process_num=pn,
                                                      mesh=mesh)
        return self._engines[key]

    def infer(self, image_lr: np.ndarray, image_hr: np.ndarray,
              cai_mode: str = "m1", process_num: Optional[int] = None,
              image_raw_shape=None, patch_split_num=None,
              rng: Optional[np.random.Generator] = None,
              rand_origins: Optional[np.ndarray] = None,
              mesh: Optional[PatchMesh] = None) -> np.ndarray:
        """image_lr (1, h, w, 3) NHWC in [0, 1]; image_hr (H, W, 3).
        Returns depth (H', W') as a float32 numpy array. mesh: as
        engine(). One request of the span tracer (utils/profiling)."""
        tc = self.tile_cfg
        if image_raw_shape is not None or patch_split_num is not None:
            tc = TileConfig(
                tuple(image_raw_shape or tc.image_raw_shape),
                tuple(patch_split_num or tc.patch_split_num),
                tc.patch_process_shape)
        with profiling.request(self.net.device):
            depth = self.engine(process_num, tc, mesh).infer(
                image_lr, image_hr, cai_mode=cai_mode, rng=rng,
                rand_origins=rand_origins)
            return _to_host(depth)

    def __call__(self, mode: str = "infer", image_lr=None, image_hr=None,
                 cai_mode: str = "m1", process_num: int = 4, tile_cfg=None,
                 **kwargs):
        """The reference's call signature (patchfusion.py:359-453):
        image_lr (1, 3, h, w) and image_hr (1, 3, H, W), NCHW tensors or
        arrays in [0, 1]; tile_cfg: an optional dict with image_raw_shape
        and patch_split_num. Returns (depth (1, 1, H', W'), {"rgb":
        image_lr, "depth_pred": depth}), tensors on the model's device.
        Other keyword arguments are ignored, as in the JAX package."""
        assert mode == "infer", "use engine/training for the train path"
        tc = self.tile_cfg
        if tile_cfg is not None:
            tc = TileConfig(
                tuple(tile_cfg.get("image_raw_shape") or tc.image_raw_shape),
                tuple(tile_cfg.get("patch_split_num")
                      or tc.patch_split_num), tc.patch_process_shape)
        depth = self.engine(process_num, tc).infer(
            _to_nhwc(image_lr), _to_nhwc(image_hr)[0], cai_mode=cai_mode)
        depth = depth[None, None]
        rgb = torch.as_tensor(image_lr).to(depth.device)
        return depth, {"rgb": rgb, "depth_pred": depth}


def _to_host(depth: torch.Tensor) -> np.ndarray:
    """The request's blocking copy back, as the span `pf.d2h`."""
    with profiling.span("d2h"):
        profiling.count("d2h_bytes", depth.nbytes)
        return depth.cpu().numpy()


def _to_nhwc(x) -> np.ndarray:
    """An (N, 3, H, W) tensor or array as an NHWC float32 numpy array;
    anything else as it is (the JAX package's rule)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    x = np.asarray(x, np.float32)
    if x.ndim == 4 and x.shape[1] == 3:
        return np.moveaxis(x, 1, -1)
    return x


class _FineOnly:
    """The PatchFusionNet surface the fusion-less engine calls
    (`fine_forward`, `dtype`, `device`) over a bare ZoeDepth branch. Any
    other attribute raises, so an engine that asks for more than a fine pass
    fails loudly instead of running the wrong computation."""

    def __init__(self, branch: nn.Module):
        self.branch = branch

    @property
    def dtype(self) -> torch.dtype:
        return self.branch.conv2.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.branch.conv2.weight.device

    def fine_forward(self, crops: torch.Tensor):
        out = self.branch(crops)
        return out["metric_depth"], [out["temp_features"][k]
                                     for k in FEATURE_KEYS]

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        raise NotImplementedError(
            f"fine-only adapter has no {name!r}: only fine_forward exists "
            "without a fusion model")


class BaselinePretrain:
    """Coarse-only / fine-only model (reference estimator/models/
    baseline_pretrain.py BaselinePretrain, target='coarse'|'fine'): stages
    1 and 2 of the training recipe and their eval paths.

    coarse: one whole-image branch pass at process resolution;
    fine:   the tiled engine without fusion, over a fine-only adapter, with
            the reference's rN count of N groups of process_num tiles
            (reference bp:364-419)."""

    def __init__(self, branch_cfg: Dict[str, Any], min_depth: float,
                 max_depth: float, target: str = "coarse",
                 image_raw_shape=(2160, 3840), patch_split_num=(4, 4),
                 patch_process_shape=(384, 512), device="cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 mesh: Optional[PatchMesh] = None):
        """Seeded random weights, or `state_dict` (a branch's, loaded
        strictly on the CPU before the branch is moved and cast; a BEiT
        branch's tables fitted to its grid). On the card unless the caller
        passes device="cpu". patch_process_shape is the branch's input
        size, which fixes a BEiT branch's grid. mesh: the fine target's
        tile split (PatchFusion.engine)."""
        if target not in ("coarse", "fine"):
            raise ValueError(f"target must be 'coarse' or 'fine', not "
                             f"{target!r}")
        device = check_device(device)
        self.target = target
        pps = tuple(patch_process_shape)
        if state_dict is None:
            net = build_zoedepth_branch(branch_cfg, min_depth, max_depth,
                                        device=device, process_shape=pps)
            init_weights(net, seed)
        else:
            net = build_zoedepth_branch(branch_cfg, min_depth, max_depth,
                                        device="cpu", process_shape=pps)
            load_branch_state_dict(net, state_dict)
        self.net = net.to(device=device, dtype=dtype)
        self.tile_cfg = TileConfig(tuple(image_raw_shape),
                                   tuple(patch_split_num),
                                   tuple(patch_process_shape))
        self.resizer = _resizer(branch_cfg, patch_process_shape)
        self.mesh = mesh
        self._fine_engines: Dict[int, PatchFusionInference] = {}

    @classmethod
    def from_torch(cls, branch_cfg: Dict[str, Any], min_depth: float,
                   max_depth: float, ckpt_path: str, **kw
                   ) -> "BaselinePretrain":
        """Load a reference branch checkpoint (.pth, strict: reference
        baseline_pretrain.py:121-127 load_dict)."""
        return cls(branch_cfg, min_depth, max_depth,
                   state_dict=load_torch_state_dict(ckpt_path), **kw)

    def engine(self, process_num: int = 4) -> PatchFusionInference:
        """The fine target's fusion-less tiled engine."""
        if process_num not in self._fine_engines:
            self._fine_engines[process_num] = PatchFusionInference(
                _FineOnly(self.net), self.tile_cfg, process_num=process_num,
                rn_times_process_num=True, fusion=False, mesh=self.mesh)
        return self._fine_engines[process_num]

    @torch.no_grad()
    def infer(self, image_lr=None, image_hr=None, cai_mode: str = "m1",
              process_num: int = 4,
              rng: Optional[np.random.Generator] = None,
              rand_origins: Optional[np.ndarray] = None) -> np.ndarray:
        """image_lr (1, h, w, 3) NHWC in [0, 1]; image_hr (H, W, 3), for the
        fine target. Returns depth as a float32 numpy array: (h, w) for
        coarse, the engine's output for fine. One request of the span
        tracer (utils/profiling)."""
        device = self.net.conv2.weight.device
        with profiling.request(device):
            if self.target == "coarse":
                x = torch.as_tensor(np.asarray(image_lr, np.float32))
                x = x.to(device).movedim(-1, -3)
                depth = self.net(x)["metric_depth"]
                return _to_host(depth[0, 0].float())
            depth = self.engine(process_num).infer(
                image_lr, image_hr, cai_mode=cai_mode, rng=rng,
                rand_origins=rand_origins)
            return _to_host(depth)


def _normalize_hub_config(raw: Dict[str, Any]) -> Dict[str, Any]:
    """The reference hub export stores the mmengine config, sometimes with
    dict-valued fields serialized as strings (patchfusion.py:71-76);
    normalize to a plain dict (a copy of patchfusion_tpu/api.py's)."""
    cfg = raw.get("config", raw)
    out = {}
    for k, v in cfg.items():
        if isinstance(v, str) and v.startswith(("{", "(", "[")):
            try:
                v = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                pass
        out[k] = v
    return out
