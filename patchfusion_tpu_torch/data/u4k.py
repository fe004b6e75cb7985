"""UnrealStereo4K dataset (a copy of patchfusion_tpu/data/u4k.py; reference
estimator/datasets/u4k_dataset.py).

Loads 2160x3840x3 uint8 `.raw` images and disparity `.npy` maps, converting
disparity to metric depth via baseline*focal from the Extrinsics txt pair
(u4k:88-100). Train mode applies rotate/color/flip augs + one random
540x960 crop with its bbox (u4k:121-165); infer mode also returns GT
disparity boundary edges for the SEE metric (u4k:168-169).

Outputs are numpy NHWC-style dicts (HWC images, HW1 depths): the loader
stacks them and the engine moves them to the device. Train mode's rotation
runs in scipy (data/transforms.aug_rotate); nothing here needs OpenCV.
"""

from __future__ import annotations

import os.path as osp
from collections import OrderedDict
from typing import Any, Dict, List

import numpy as np

from patchfusion_tpu_torch.config.registry import DATASETS
from patchfusion_tpu_torch.data import native
from patchfusion_tpu_torch.data.transforms import (aug_color, aug_flip,
                                                   aug_rotate, make_resizer,
                                                   random_crop)
from patchfusion_tpu_torch.utils.metrics import (compute_metrics,
                                                 get_boundaries)

METRIC_ORDER = ("a1", "a2", "a3", "abs_rel", "rmse", "log_10", "rmse_log",
                "silog", "sq_rel", "see")


@DATASETS.register_module(name="UnrealStereo4kDataset")
class UnrealStereo4kDataset:
    def __init__(self, mode: str, data_root: str, split: str,
                 transform_cfg: Dict[str, Any], min_depth: float,
                 max_depth: float, patch_raw_shape=(540, 960),
                 resize_mode: str = "zoe", seed: int = 0, **kwargs):
        self.dataset_name = "u4k"
        self.mode = mode
        self.data_root = data_root
        self.split = split
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.patch_raw_shape = tuple(patch_raw_shape)
        self.transform_cfg = dict(transform_cfg)
        self.resize = make_resizer(resize_mode,
                                   self.transform_cfg["network_process_size"])
        self.rng = np.random.default_rng(seed)
        self.data_infos = self.load_data_list()

    def load_data_list(self) -> List[Dict[str, Any]]:
        """Parse the split file: each line = img_l img_r disp_l disp_r;
        depth_factor = |baseline| * focal from the two Extrinsics files
        (u4k:58-107)."""
        infos = []
        with open(self.split) as f:
            for line in f:
                img_l, _img_r, disp_l, _disp_r = line.strip().split(" ")
                img_l = img_l[:-3] + "raw"  # the reference's .raw fast path
                info = {
                    "img_path": osp.join(self.data_root, img_l),
                    "depth_map_path": osp.join(self.data_root, disp_l),
                    "filename": img_l,
                }
                ext_l = info["depth_map_path"].replace(
                    "Disp0", "Extrinsics0").replace("npy", "txt")
                ext_r = info["depth_map_path"].replace(
                    "Disp0", "Extrinsics1").replace("npy", "txt")
                with open(ext_l) as fe:
                    lines_l = fe.readlines()
                with open(ext_r) as fe:
                    lines_r = fe.readlines()
                focal = float(lines_l[0].split(" ")[0])
                base = abs(float(lines_l[1].split(" ")[3])
                           - float(lines_r[1].split(" ")[3]))
                info["focal"] = focal
                info["depth_factor"] = base * focal
                infos.append(info)
        return sorted(infos, key=lambda x: x["img_path"])

    def __len__(self) -> int:
        return len(self.data_infos)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        info = self.data_infos[idx]
        disp_gt = np.load(info["depth_map_path"], mmap_mode="c")
        disp_gt = np.asarray(disp_gt, np.float32)
        depth_gt = info["depth_factor"] / disp_gt

        # raw image shape = the GT disparity's shape (2160x3840 for real
        # U4K; lets synthetic/toy datasets use other resolutions)
        rh, rw = disp_gt.shape
        if self.mode == "train":
            image = np.fromfile(info["img_path"], dtype=np.uint8)
            image = image.reshape(rh, rw, 3)
            image, (depth_gt, disp_gt) = aug_rotate(
                image, [depth_gt, disp_gt],
                self.transform_cfg.get("degree", 1.0), self.rng)
            # BGR raw -> RGB float [0,1] (u4k:126-129), native decode
            image = native.decode_bgr_u8(np.ascontiguousarray(image))
        else:
            # fused native read+decode
            image = native.load_raw_bgr(info["img_path"], rh, rw)

        if self.mode == "train":
            image = aug_color(image, self.rng)
            image, (depth_gt, disp_gt) = aug_flip(
                image, [depth_gt, disp_gt], self.rng)

        image_lr = self.resize(image)
        basename = osp.splitext(info["filename"])[0].replace("/", "_")[1:]

        if self.mode == "train":
            h, w = self.patch_raw_shape
            crop_img, (crop_depth, _crop_disp), (hs, ws) = random_crop(
                image, [depth_gt, disp_gt], self.patch_raw_shape, self.rng)
            crop_img = self.resize(crop_img)
            bbox = np.array([ws, hs, ws + w, hs + h], np.float32)
            return {
                "image_lr": image_lr,
                "crops_image_hr": crop_img,
                "depth_gt": depth_gt[..., None],
                "crop_depths": crop_depth[..., None],
                "bboxs": bbox,
                "img_file_basename": basename,
            }
        boundary = get_boundaries(disp_gt, th=1, dilation=0)
        return {
            "image_lr": image_lr,
            "image_hr": image,
            "depth_gt": depth_gt[..., None],
            "boundary": boundary,
            "img_file_basename": basename,
        }

    # -- evaluation (u4k:185-259) --------------------------------------------

    def get_metrics(self, depth_gt, result, disp_gt_edges, **kwargs):
        return compute_metrics(depth_gt, result,
                               disp_gt_edges=disp_gt_edges,
                               min_depth_eval=self.min_depth,
                               max_depth_eval=self.max_depth,
                               garg_crop=False, eigen_crop=False, dataset="")

    def pre_eval_to_metrics(self, pre_eval_results) -> Dict[str, float]:
        cols = {k: [] for k in METRIC_ORDER}
        for item in pre_eval_results:
            for k in METRIC_ORDER:
                cols[k].append(item.get(k, np.nan))
        return OrderedDict((k, float(np.nanmean(v)))
                           for k, v in cols.items())

    def evaluate(self, results, logger=None, **kwargs) -> Dict[str, float]:
        ret = self.pre_eval_to_metrics(results)
        header = " ".join(f"{k:>9}" for k in ret)
        values = " ".join(f"{v:9.4f}" for v in ret.values())
        msg = f"Evaluation Summary:\n{header}\n{values}"
        (logger.info if logger else print)(msg)
        return dict(ret)
