"""Evaluation run loop (patchfusion_tpu/engine/tester.py; reference
estimator/tester/tester.py).

Per image: tiled inference through the engine, optional colorized + uint16
PNG dumps (tester.py:66-76), and the metrics against GT with SEE boundary
edges. The reference gathers the metrics of several processes
(tester.py:78-95); that belongs to the port's scale-out slice, so a run
under torch.distributed with more than one process raises instead of
reporting one rank's share as the whole.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from patchfusion_tpu_torch.engine.inference import PatchFusionInference
from patchfusion_tpu_torch.models.patchfusion import TileConfig
from patchfusion_tpu_torch.utils.misc import setup_logger


class Tester:
    __test__ = False  # not a pytest class despite the Test* name

    def __init__(self, engine, dataloader, work_dir: str = "./work_dir",
                 save: bool = False, gray_scale: bool = False, logger=None):
        """engine: anything with infer(image_lr, image_hr, cai_mode=, rng=)
        returning depth (a tensor on any device, or a numpy array)."""
        self.engine = engine
        self.dataloader = dataloader
        self.work_dir = work_dir
        self.save = save
        self.gray_scale = gray_scale
        self.logger = logger or setup_logger()
        # per image of the last run: seconds waiting on the loader, in
        # inference (to the depth on the host) and in the metrics
        self.image_seconds: List[Dict[str, float]] = []
        self.metrics: Dict[str, float] = {}

    def _rebucket(self, image_raw_shape):
        """Engine for a non-default raw resolution (reference tester.py:46
        `image_raw_shape` -> prepare_tile_cfg): a new engine over the
        re-derived TileConfig; net, chunking and mode rules carry over."""
        tc = getattr(self.engine, "tile_cfg", None)
        if tc is None or tuple(image_raw_shape) == tuple(tc.image_raw_shape):
            return self.engine
        new_tc = TileConfig(tuple(image_raw_shape), tc.patch_split_num,
                            tc.patch_process_shape)
        return PatchFusionInference(
            self.engine.net, new_tc, process_num=self.engine.process_num,
            rn_times_process_num=self.engine.rn_times_process_num,
            fusion=self.engine.fusion)

    def run(self, cai_mode: str = "m1", image_raw_shape=None,
            seed: int = 0) -> Dict[str, float]:
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized() and \
                torch.distributed.get_world_size() > 1:
            raise NotImplementedError(
                "the Tester does not gather metrics across processes yet "
                "(the scale-out slice); run it in one process")
        rng = np.random.default_rng(seed)
        results: List[Dict[str, float]] = []
        dataset = self.dataloader.dataset
        engine = (self._rebucket(image_raw_shape)
                  if image_raw_shape is not None else self.engine)
        if self.save:
            os.makedirs(self.work_dir, exist_ok=True)
        self.image_seconds = []

        t_load = time.perf_counter()
        for i, batch in enumerate(self.dataloader):
            t_infer = time.perf_counter()
            image_lr = np.asarray(batch["image_lr"])
            image_hr = np.asarray(batch["image_hr"])[0]
            depth = engine.infer(image_lr, image_hr, cai_mode=cai_mode,
                                 rng=rng)
            if isinstance(depth, torch.Tensor):
                depth = depth.float().cpu().numpy()
            t_metrics = time.perf_counter()

            if self.save:
                from patchfusion_tpu_torch.utils.colorize import \
                    save_depth_png
                base = batch["img_file_basename"][0]
                save_depth_png(
                    depth,
                    os.path.join(self.work_dir, f"{base}.png"),
                    os.path.join(self.work_dir, f"{base}_uint16.png"),
                    gray_scale=self.gray_scale)

            if "depth_gt" in batch:
                results.append(dataset.get_metrics(
                    np.asarray(batch["depth_gt"])[0], depth,
                    disp_gt_edges=np.asarray(batch["boundary"])[0]
                    if "boundary" in batch else None))
            t_end = time.perf_counter()
            self.image_seconds.append({"load": t_infer - t_load,
                                       "inference": t_metrics - t_infer,
                                       "metrics": t_end - t_metrics})
            if i % 10 == 0:
                self.logger.info("tested %d/%d", i + 1,
                                 len(self.dataloader))
            t_load = time.perf_counter()

        self.metrics = (dataset.evaluate(results, logger=self.logger)
                        if results else {})
        return self.metrics
