"""Folder-of-images inference dataset with optional per-dataset GT loaders
(a copy of patchfusion_tpu/data/general.py; reference
estimator/datasets/general_dataset.py): u4k / gta / eth3d /
middlebury-PFM / cityscapes ground-truth formats, plus GT-free inference on
arbitrary images.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, Optional

import numpy as np

from patchfusion_tpu_torch.config.registry import DATASETS
from patchfusion_tpu_torch.data.pfm import read_pfm
from patchfusion_tpu_torch.data.transforms import make_resizer
from patchfusion_tpu_torch.data.u4k import UnrealStereo4kDataset
from patchfusion_tpu_torch.ops.resize import _tap_plan
from patchfusion_tpu_torch.utils.metrics import (compute_metrics,
                                                 get_boundaries)


def _resize_bicubic_ac(img: np.ndarray, size) -> np.ndarray:
    """bicubic align_corners=True whole-image resize (reference
    general_dataset.py:31-33 F.interpolate(mode='bicubic',
    align_corners=True)) — host-side 4-tap gathers (a dense matmul at
    4K costs tens of GFLOPs in numpy)."""
    x = img.astype(np.float32)
    th, wh = _tap_plan(size[0], x.shape[0], "bicubic", True, None)
    x = sum(x[th[:, j]] * wh[:, j, None, None] for j in range(4))
    tw, ww = _tap_plan(size[1], x.shape[1], "bicubic", True, None)
    x = sum(x[:, tw[:, j]] * ww[None, :, j, None] for j in range(4))
    return x


def read_image(path: str, dataset_name: str,
               image_resolution=(2160, 3840)) -> np.ndarray:
    """reference general_dataset.py:22-47 read_image."""
    if dataset_name == "u4k":
        img = np.fromfile(path, dtype=np.uint8).reshape(2160, 3840, 3)
        return img.astype(np.float32)[:, :, ::-1] / 255.0
    from PIL import Image

    if dataset_name == "cityscapes":
        img = np.asarray(Image.open(path).convert("RGB"), np.float32)
        return img / 255.0
    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    if img.shape[:2] != tuple(image_resolution):
        img = _resize_bicubic_ac(img, image_resolution)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def load_gt(path: str, dataset_name: str):
    """Per-dataset GT depth + boundary edges (general_dataset.py:60-143)."""
    if dataset_name == "u4k":
        factor_path = path.replace("val_gt", "val_factor") \
            .replace(".npy", ".txt")
        with open(factor_path) as f:
            df = float(f.readline())
        disp = np.asarray(np.load(path, mmap_mode="c"), np.float32)
        return df / disp, get_boundaries(disp, th=1, dilation=0)
    if dataset_name == "gta":
        import imageio
        depth = np.asarray(imageio.imread(path), np.float32) / 256.0
        return depth, get_boundaries(depth, th=1, dilation=0)
    if dataset_name == "eth3d":
        depth = np.fromfile(path, dtype=np.float32).reshape(4032, 6048)
        depth = np.nan_to_num(depth, posinf=0.0, neginf=0.0, nan=0.0)
        return depth, get_boundaries(depth, th=1, dilation=0)
    if dataset_name == "mid":
        calib = path.replace("gts", "calibs").replace(".pfm", ".txt")
        with open(calib) as f:
            lines = f.readlines()
        focal = float(lines[0].strip().split(" ")[0].split("[")[1])
        doffs = float(lines[2].strip().split("=")[1])
        base = float(lines[3].strip().split("=")[1])
        disp, _ = read_pfm(path)
        disp = disp.astype(np.float32)
        invalid = np.isinf(disp)
        depth = (base * focal) / (disp + doffs) / 1000.0
        depth[invalid] = 0.0
        disp_f = disp.copy()
        disp_f[invalid] = 0.0
        return depth, get_boundaries(disp_f, th=1, dilation=0)
    raise NotImplementedError(dataset_name)


@DATASETS.register_module(name="ImageDataset")
class ImageDataset:
    """Inference over a folder of images (general_dataset.py:145-230)."""

    IMG_EXTS = (".jpg", ".jpeg", ".png", ".raw")

    def __init__(self, rgb_image_dir: str, network_process_size=(384, 512),
                 resize_mode: str = "zoe", dataset_name: str = "",
                 gt_dir: Optional[str] = None,
                 image_resolution=(2160, 3840), min_depth: float = 1e-3,
                 max_depth: float = 80.0, **kwargs):
        self.rgb_image_dir = rgb_image_dir
        self.dataset_name = dataset_name or "general"
        self.gt_dir = gt_dir
        self.image_resolution = tuple(image_resolution)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.resize = make_resizer(resize_mode, network_process_size)
        self.files = sorted(
            f for f in os.listdir(rgb_image_dir)
            if f.lower().endswith(self.IMG_EXTS))
        self.gt_files = sorted(os.listdir(gt_dir)) if gt_dir else None

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        name = self.files[idx]
        image = read_image(osp.join(self.rgb_image_dir, name),
                           self.dataset_name, self.image_resolution)
        image_lr = self.resize(image)
        base = name
        for ext in (".jpg", ".png", ".jpeg"):
            base = base.replace(ext, "")
        out = {"image_lr": image_lr, "image_hr": image,
               "img_file_basename": base}
        if self.gt_files is not None:
            depth, edges = load_gt(osp.join(self.gt_dir, self.gt_files[idx]),
                                   self.dataset_name)
            out["depth_gt"] = depth[..., None]
            out["boundary"] = edges
        return out

    def get_metrics(self, depth_gt, result, disp_gt_edges, **kwargs):
        return compute_metrics(depth_gt, result,
                               disp_gt_edges=disp_gt_edges,
                               min_depth_eval=self.min_depth,
                               max_depth_eval=self.max_depth,
                               garg_crop=False, eigen_crop=False, dataset="")

    def pre_eval_to_metrics(self, pre_eval_results):
        return UnrealStereo4kDataset.pre_eval_to_metrics(
            self, pre_eval_results)

    def evaluate(self, results, logger=None, **kwargs):
        return UnrealStereo4kDataset.evaluate(self, results, logger=logger)
