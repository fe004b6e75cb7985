"""Training run loop (patchfusion_tpu/engine/trainer.py; reference
estimator/trainer/trainer.py).

Epoch-based loop with the per-iteration OneCycle step (engine/training.py),
periodic validation through the port's tiled engine on the live weights,
checkpointing (fusion-only, as the reference's get_save_dict,
patchfusion.py:179-187) and optional wandb logging. One process: a world
size above 1 raises (scale-out is its own slice). The JAX loop's jit,
state donation and first-step rendezvous have no counterpart in eager
torch.

Each step's time is read on the device's clock (CUDA events around the
step, read at the epoch's end, so no step waits on the host for it) and
the time spent waiting for the loader on the host's; `epoch_stats` keeps
both per epoch, with steps/s and the peak allocated memory.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from patchfusion_tpu_torch.engine.checkpoint import save_checkpoint
from patchfusion_tpu_torch.engine.training import TrainState, to_device_batch
from patchfusion_tpu_torch.utils.misc import setup_logger

BATCH_KEYS = ("image_lr", "crops_image_hr", "depth_gt", "crop_depths",
              "bboxs")
# the keys the train step reads (engine/training.py); depth_gt and image_hr
# are log-only in the reference's train loop too
STEP_KEYS = ("image_lr", "crops_image_hr", "crop_depths", "bboxs")


def collect_input(batch: Dict[str, Any], collect_keys) -> Dict[str, Any]:
    """Whitelist the batch keys that reach the model (reference
    trainer.py:128-134 + config collect_input_args)."""
    return {k: batch[k] for k in collect_keys if k in batch}


def _check_single_process() -> None:
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "the port's Trainer runs in one process; data-parallel training "
            "(DDP, the metrics gather) is not ported yet")


class _StepClock:
    """Per-step times on the device's clock: CUDA events around each step,
    read once at the end (no per-step sync), or the host's clock on the
    CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[Any] = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, started) -> None:
        self.marks.append((started, self.start()))

    def seconds(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in self.marks]
        return [b - a for a, b in self.marks]


class Trainer:
    def __init__(self, state: TrainState, train_step: Callable,
                 train_loader, val_loader=None, val_fn=None,
                 max_epochs: int = 16, val_interval: int = 2,
                 save_checkpoint_interval: int = 16, log_interval: int = 100,
                 work_dir: str = "./work_dir", use_wandb: bool = False,
                 collect_keys=BATCH_KEYS, eval_start: int = 0,
                 train_log_img_interval: int = 500,
                 val_log_img_interval: int = 50, logger=None,
                 start_epoch: int = 0):
        _check_single_process()
        self.state = state
        self.step = train_step
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.val_fn = val_fn
        self.max_epochs = max_epochs
        # resume continues after the checkpoint's epoch (reference
        # trainer.py resume semantics)
        self.start_epoch = start_epoch
        self.val_interval = val_interval
        self.save_interval = save_checkpoint_interval
        self.log_interval = log_interval
        self.work_dir = work_dir
        self.collect_keys = collect_keys
        self.eval_start = eval_start
        self.train_log_img_interval = train_log_img_interval
        self.val_log_img_interval = val_log_img_interval
        self.logger = logger or setup_logger()
        self.device = next(state.net.parameters()).device
        self.epoch_stats: List[Dict[str, Any]] = []
        self.val_metrics: Dict[int, Dict[str, float]] = {}
        self.wandb = None
        if use_wandb:
            try:
                import wandb
                self.wandb = wandb
            except ImportError:
                self.logger.warning("wandb unavailable; logging to console")

    def train_epoch(self, epoch: int) -> Dict[str, Any]:
        if hasattr(self.train_loader, "sampler"):
            self.train_loader.sampler.set_epoch(epoch)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        clock = _StepClock(self.device)
        keys = [k for k in self.collect_keys if k in STEP_KEYS]
        losses, waits = [], []
        t0 = time.perf_counter()
        t_ready = t0
        it = -1
        for it, batch in enumerate(self.train_loader):
            waits.append(time.perf_counter() - t_ready)
            started = clock.start()
            device_batch = to_device_batch(collect_input(batch, keys),
                                           self.device, keys)
            logs = self.step(self.state, device_batch)
            clock.stop(started)
            losses.append(logs["total_loss"])
            if it % self.log_interval == 0:
                loss = float(logs["total_loss"])
                dt = time.perf_counter() - t0
                self.logger.info("epoch %d iter %d loss %.4f (%.2fs/it)",
                                 epoch, it, loss, dt / max(it, 1))
                if self.wandb:
                    self.wandb.log({"Train/total_loss": loss,
                                    "epoch": epoch})
            if it % self.train_log_img_interval == 0:
                self.log_images(batch, logs.get("pred"), epoch,
                                prefix="Train")
            t_ready = time.perf_counter()
        step_s = clock.seconds()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(self.device) if cuda else None
        stats = {"epoch": epoch, "steps": it + 1, "seconds": dt,
                 "steps_per_s": (it + 1) / max(dt, 1e-9),
                 "step_seconds": step_s, "data_wait_seconds": waits,
                 "losses": [float(x) for x in losses],
                 "peak_allocated_bytes": peak}
        self.epoch_stats.append(stats)
        self.logger.info(
            "epoch %d done: %d iters in %.1fs (%.2f steps/s, median step "
            "%.3fs, data wait median %.3fs, max %.3fs)%s", epoch, it + 1, dt,
            stats["steps_per_s"], float(np.median(step_s)) if step_s else 0,
            float(np.median(waits)) if waits else 0, max(waits, default=0),
            f", peak allocated {peak / 2**30:.2f} GiB" if peak else "")
        return stats

    def log_images(self, batch: Dict[str, Any], pred, epoch: int,
                   prefix: str = "Train") -> None:
        """Colorized depth, GT and RGB panels (reference
        trainer.py:55-125); pred NCHW (train) or HW1 (val)."""
        if self.wandb is None:
            return
        from patchfusion_tpu_torch.utils.colorize import colorize
        rgb = np.asarray(batch.get("crops_image_hr",
                                   batch.get("image_lr")))[0]
        panels = {f"{prefix}/rgb": self.wandb.Image(rgb)}
        if pred is not None:  # one depth map, (1, 1, h, w) or (1, H, W, 1)
            panels[f"{prefix}/depth_pred"] = self.wandb.Image(colorize(
                torch.as_tensor(pred).float().cpu().numpy().squeeze()))
        gt = batch.get("crop_depths", batch.get("depth_gt"))
        if gt is not None:
            panels[f"{prefix}/depth_gt"] = self.wandb.Image(
                colorize(np.asarray(gt)[0, ..., 0]))
        self.wandb.log(panels)

    def val_epoch(self, epoch: int) -> Optional[Dict[str, float]]:
        """Validation (reference trainer.py:137-216): per-image inference
        through val_fn on the live weights, with the fusion modules in eval
        mode (BN on running statistics), then dataset.evaluate."""
        if self.val_loader is None or self.val_fn is None:
            return None
        t0 = time.perf_counter()
        results = []
        self.state.net.eval()
        try:
            with torch.no_grad():
                for it, batch in enumerate(self.val_loader):
                    metrics_i, depth = self.val_fn(self.state, batch)
                    if it % self.val_log_img_interval == 0:
                        self.log_images(
                            batch, np.asarray(depth)[None, ..., None],
                            epoch, prefix="Val")
                    results.append(metrics_i)
        finally:
            self.state.net.train_mode()
        metrics = self.val_loader.dataset.evaluate(results,
                                                   logger=self.logger)
        self.logger.info("val epoch %d: %d images in %.1fs wall", epoch,
                         len(results), time.perf_counter() - t0)
        if self.wandb:
            self.wandb.log({f"Val/{k}": v for k, v in metrics.items()})
        self.val_metrics[epoch] = metrics
        return metrics

    def save(self, epoch: int) -> str:
        os.makedirs(self.work_dir, exist_ok=True)
        path = os.path.join(self.work_dir, f"checkpoint_{epoch:02d}.ckpt")
        save_checkpoint(path, self.state, epoch)
        self.logger.info("saved checkpoint to %s", path)
        return path

    def run(self) -> None:
        for epoch in range(self.start_epoch + 1, self.max_epochs + 1):
            self.train_epoch(epoch)
            if epoch >= self.eval_start and epoch % self.val_interval == 0:
                self.val_epoch(epoch)
            if epoch % self.save_interval == 0 or epoch == self.max_epochs:
                self.save(epoch)
