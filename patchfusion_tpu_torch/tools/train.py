"""Training CLI for the fusion stage (the port of tools/train.py; reference
tools/train.py):

    python -m patchfusion_tpu_torch.tools.train CONFIG [--work-dir DIR] \
        [--amp] [--resume --ckp-path work_dir/.../checkpoint_NN.ckpt] \
        [--seed 621] [--cfg-options key=value ...] [--wandb]

A PatchFusion config trains its fusion part over its train_dataloader,
with in-training m1 validation over its val_dataloader where that split
exists, and writes the port's checkpoints (engine/checkpoint.py) to the
work dir. With `load_branch` and `pretrain_model` in the model config the
two branches load from the reference's coarse and fine `.pth` files
(--ckp-path may then name a fusion `.pth`); otherwise every weight is drawn
from --seed. --resume continues from the port's `.ckpt` (weights, BN
statistics, optimizer and schedule position, epoch). --amp: bf16 compute
under autocast, frozen branches stored in bf16, trainable masters and
AdamW state in f32. Branch pretraining is tools/train_branch.py.

Flags as tools/train.py has them, plus --device (default cuda; raises
where CUDA is missing). The JAX launcher flags --coordinator,
--num-processes and --process-id raise: the port trains in one process.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train PatchFusion (PyTorch)")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--ckp-path", default=None, help="resume checkpoint")
    p.add_argument("--log-name", default=None)
    p.add_argument("--tags", nargs="+", default=None)
    p.add_argument("--wandb", action="store_true", dest="use_wandb")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--amp", action="store_true",
                   help="bf16 mixed precision: autocast compute, frozen "
                        "branches stored bf16, trainable masters and "
                        "optimizer f32")
    p.add_argument("--seed", type=int, default=621)
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_config(path: str, cfg_options: List[str]):
    from patchfusion_tpu_torch.config import Config, parse_cfg_option

    cfg = Config.fromfile(path)
    if cfg_options:
        opts = dict(kv.split("=", 1) for kv in cfg_options)
        cfg.merge_from_dict({k: parse_cfg_option(v)
                             for k, v in opts.items()})
    return cfg


def build_loader(dcfg, shuffle: bool, seed: int, **ds_extra):
    """A DataLoader over a config's dataloader dict (one process)."""
    from patchfusion_tpu_torch.config.registry import DATASETS
    from patchfusion_tpu_torch.data import general, u4k  # noqa: F401
    from patchfusion_tpu_torch.data.loader import DataLoader, ShardedSampler

    ds_cfg = dict(dcfg["dataset"])
    ds_cfg.update(ds_extra)
    ds = DATASETS.build(ds_cfg)
    sampler = ShardedSampler(len(ds), 1, 0, shuffle=shuffle, seed=seed)
    return DataLoader(ds, batch_size=dcfg.get("batch_size", 1),
                      sampler=sampler, num_workers=dcfg.get("num_workers", 4),
                      drop_last=shuffle)


def make_optimizer(cfg, total_steps: int, pct_start: float = 0.25,
                   div_factor: float = 10, weight_decay: float = 0.001,
                   read_momentum: bool = True):
    """make_onecycle_optimizer from a config's optim_wrapper and
    param_scheduler. The keyword defaults stand where the config is silent;
    the branch CLI passes its own and keeps the default momenta, as the
    JAX package's does."""
    from patchfusion_tpu_torch.engine.training import make_onecycle_optimizer

    ow, ps = cfg.optim_wrapper, cfg.param_scheduler
    kw = {}
    if read_momentum:
        kw = dict(base_momentum=ps.get("base_momentum", 0.85),
                  max_momentum=ps.get("max_momentum", 0.95))
    return make_onecycle_optimizer(
        max_lr=ow["optimizer"]["lr"], total_steps=total_steps,
        pct_start=ps.get("pct_start", pct_start),
        div_factor=ps.get("div_factor", div_factor),
        final_div_factor=ps.get("final_div_factor", 10000),
        weight_decay=ow["optimizer"].get("weight_decay", weight_decay),
        clip_norm=ow.get("clip_grad", {}).get("max_norm", 0.1), **kw)


def main(argv: Optional[List[str]] = None):
    """Run the training; returns the Trainer (its state, epoch_stats and
    val_metrics)."""
    args = parse_args(argv)
    for flag in ("coordinator", "num_processes", "process_id"):
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} launches the JAX package's "
                "multi-host run; the port trains in one process")

    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.engine.checkpoint import (load_checkpoint,
                                                         restore_train_state)
    from patchfusion_tpu_torch.engine.inference import PatchFusionInference
    from patchfusion_tpu_torch.engine.trainer import Trainer
    from patchfusion_tpu_torch.engine.training import (create_train_state,
                                                       make_train_step)
    from patchfusion_tpu_torch.models.builder import check_device
    from patchfusion_tpu_torch.utils.misc import fix_random_seed, setup_logger

    device = check_device(args.device)
    cfg = load_config(args.config, args.cfg_options)
    work_dir = args.work_dir or os.path.join(
        "./work_dir", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    cfg.dump(os.path.join(work_dir, "config.py"))
    logger = setup_logger(log_file=os.path.join(work_dir, "train.log"))
    fix_random_seed(args.seed)
    if args.use_wandb:
        try:
            import wandb
            wandb.init(project=cfg.get("project", "patchfusion"),
                       name=args.log_name, tags=args.tags,
                       config=cfg.to_dict())
        except ImportError:
            logger.warning("wandb unavailable; console logging only")
            args.use_wandb = False

    if cfg.model["type"] != "PatchFusion":
        raise SystemExit("branch pretraining uses "
                         "patchfusion_tpu_torch.tools.train_branch; this "
                         "entry trains the PatchFusion fusion stage")
    amp = args.amp or cfg.get("train_dtype", "f32") == "bf16"
    mc = cfg.model["config"].to_dict()
    ckpts = None
    if mc.get("load_branch") and mc.get("pretrain_model"):
        fusion = args.ckp_path if args.ckp_path and \
            args.ckp_path.endswith(".pth") else None
        ckpts = (mc["pretrain_model"][0], mc["pretrain_model"][1], fusion)
    model = PatchFusion.from_config(mc, device=device, seed=args.seed,
                                    ckpts=ckpts)
    net, tile_cfg = model.net, model.tile_cfg
    if amp:
        logger.info("mixed precision: bf16 autocast, f32 masters")

    train_loader = build_loader(cfg.train_dataloader, True, args.seed,
                                patch_raw_shape=tile_cfg.patch_raw_shape)
    logger.info("train dataset: %d samples, %d steps/epoch",
                len(train_loader.dataset), len(train_loader))
    try:
        val_loader = build_loader(cfg.val_dataloader, False, args.seed,
                                  patch_raw_shape=tile_cfg.patch_raw_shape)
    except (FileNotFoundError, KeyError):
        val_loader = None
        logger.warning("val dataloader unavailable; skipping in-training "
                       "validation")

    tcfg = cfg.train_cfg
    total_steps = max(1, len(train_loader)) * tcfg["max_epochs"]
    tx = make_optimizer(cfg, total_steps)
    state = create_train_state(net, tx, amp=amp,
                               frozen_dtype=torch.bfloat16 if amp else None)
    start_epoch = 0
    if args.resume and args.ckp_path and args.ckp_path.endswith(".ckpt"):
        start_epoch = restore_train_state(state,
                                          load_checkpoint(args.ckp_path))
        logger.info("resumed from %s (epoch %d, step %d)", args.ckp_path,
                    start_epoch, state.step)
    step_fn = make_train_step(min_depth=mc["min_depth"],
                              max_depth=mc["max_depth"])

    val_fn = None
    if val_loader is not None:
        val_engine = PatchFusionInference(net, tile_cfg, process_num=4)

        def val_fn(state, batch):
            """m1 tiled inference and metrics on one val image (the
            reference's val_epoch protocol, trainer.py:137-216), on the
            live weights, in the training's precision."""
            with torch.autocast(device.type, dtype=torch.bfloat16,
                                enabled=state.amp):
                depth = val_engine.infer(np.asarray(batch["image_lr"]),
                                         np.asarray(batch["image_hr"])[0],
                                         cai_mode="m1")
            depth = depth.float().cpu().numpy()
            metrics = val_loader.dataset.get_metrics(
                np.asarray(batch["depth_gt"])[0], depth,
                disp_gt_edges=np.asarray(batch["boundary"])[0]
                if "boundary" in batch else None)
            return metrics, depth

    trainer = Trainer(state, step_fn, train_loader, val_loader=val_loader,
                      val_fn=val_fn, max_epochs=tcfg["max_epochs"],
                      val_interval=tcfg.get("val_interval", 2),
                      save_checkpoint_interval=tcfg.get(
                          "save_checkpoint_interval", 16),
                      log_interval=tcfg.get("log_interval", 100),
                      train_log_img_interval=tcfg.get(
                          "train_log_img_interval", 500),
                      val_log_img_interval=tcfg.get(
                          "val_log_img_interval", 50),
                      work_dir=work_dir, use_wandb=args.use_wandb,
                      logger=logger, start_epoch=start_epoch)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
