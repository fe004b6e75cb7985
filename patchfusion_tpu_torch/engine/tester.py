"""Evaluation run loop (patchfusion_tpu/engine/tester.py; reference
estimator/tester/tester.py).

Per image: tiled inference through the engine, optional colorized + uint16
PNG dumps (tester.py:66-76), and the metrics against GT with SEE boundary
edges. Under torch.distributed the ranks either shard the samples (the
loader's ShardedSampler; the metrics are gathered across the ranks,
tester.py:78-95, parallel/gather.py) or all take every image and split its
tiles (an engine with a `mesh`; nothing to gather). Only rank 0 logs the
summary and writes the PNGs of a tile-split run.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from patchfusion_tpu_torch.engine.inference import PatchFusionInference
from patchfusion_tpu_torch.models.patchfusion import TileConfig
from patchfusion_tpu_torch.parallel.dist import is_main, rank, world_size
from patchfusion_tpu_torch.parallel.gather import gather_metric_dicts
from patchfusion_tpu_torch.utils.misc import rank_logger, setup_logger


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
        self.logger = rank_logger(logger or setup_logger())
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
            fusion=self.engine.fusion, mesh=self.engine.mesh)

    def _sharded(self) -> bool:
        """Whether the ranks shard the samples (and the metrics need
        gathering); raises where several ranks would each evaluate every
        image on its own."""
        world = world_size()
        if world == 1 or getattr(self.engine, "mesh", None) is not None:
            return False
        sampler = getattr(self.dataloader, "sampler", None)
        if getattr(sampler, "world", 1) != world:
            raise ValueError(
                f"{world} ranks: shard the loader with ShardedSampler(len, "
                f"{world}, rank), or split each image's tiles with an "
                "engine over a PatchMesh; the metrics gather of unsharded "
                f"loaders would count every image {world} times")
        return True

    def run(self, cai_mode: str = "m1", image_raw_shape=None,
            seed: int = 0) -> Dict[str, float]:
        sharded = self._sharded()
        rng = np.random.default_rng(seed)
        results: List[Dict[str, float]] = []
        dataset = self.dataloader.dataset
        engine = (self._rebucket(image_raw_shape)
                  if image_raw_shape is not None else self.engine)
        # a sharded rank writes its own images; under a tile split every
        # rank holds every image and rank 0 writes them
        writes = self.save and (sharded or is_main())
        if writes:
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

            # the sampler's wraparound duplicates are not written twice
            pad = sharded and i * world_size() + rank() >= len(dataset)
            if writes and not pad:
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

        if sharded:
            results = gather_metric_dicts(results, size=len(dataset))
        self.metrics = (dataset.evaluate(results, logger=self.logger)
                        if results else {})
        return self.metrics
