"""Evaluation / inference CLI (the port of tools/test.py; reference
tools/test.py):

    python -m patchfusion_tpu_torch.tools.test CONFIG --ckp-path CKP \
        [--cai-mode m1|m2|rN] [--test-type normal|test_in|test_out|general]

--ckp-path takes a local snapshot directory (config.json +
pytorch_model.bin or model.safetensors), the reference's comma-separated
'coarse.pth,fine.pth[,fusion.pth]', or one of the port's own files
(engine/checkpoint.py: a training '.ckpt' or a weights file), which,
fusion-only, merges over the branches (seeded, or the config's
`pretrain_model` files where `load_branch` is set), as tools/test.py does,
or, full (tools.convert_checkpoint), replaces every weight;
for a BaselinePretrain config, one branch '.pth' or a weights file of
tools/train_branch.py. Without it the weights are random (seeded). The JAX
package's msgpack files are not read: they raise.

Flags as tools/test.py has them, less --chunk-policy (it shapes the JAX
package's compiled programs), plus --device (default cuda; raises where
CUDA is missing) and --dtype (default bfloat16, the port's main path,
where the metric-bins head runs its CUDA kernels; float32 is the
reference's precision).

Several ranks (torchrun --nproc-per-node N -m
patchfusion_tpu_torch.tools.test ..., one device each). The JAX package's
--mesh splits the tiles over one process's local devices and shards the
samples over processes; here every device is a rank, so --mesh chooses:
  none  the ranks shard the samples (ShardedSampler) and gather the
        metrics (the JAX package across hosts);
  patch every rank takes every image and a share of its tiles, and the
        ranks sum the canvases (the JAX patch mesh); a world of 1 errors;
  auto  none: sample sharding, the cheaper split for a test set.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Test PatchFusion (PyTorch)")
    p.add_argument("config")
    p.add_argument("--ckp-path", default=None)
    p.add_argument("--work-dir", default="./work_dir/test")
    p.add_argument("--test-type", default="normal",
                   choices=["normal", "test_in", "test_out", "general"])
    p.add_argument("--cai-mode", default="m1")
    p.add_argument("--process-num", type=int, default=4)
    p.add_argument("--image-raw-shape", nargs="+", type=int,
                   default=[2160, 3840])
    p.add_argument("--patch-split-num", nargs="+", type=int, default=[4, 4])
    p.add_argument("--save", action="store_true")
    p.add_argument("--gray-scale", action="store_true")
    p.add_argument("--image-dir", default=None,
                   help="general mode: folder of images")
    p.add_argument("--gt-dir", default=None)
    p.add_argument("--dataset-name", default="")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--mesh", default="auto",
                   choices=["auto", "patch", "none"],
                   help="several ranks: split each image's tiles across "
                        "them (patch) or shard the samples (none, auto)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    return p.parse_args(argv)



def load_patchfusion(config, ckp: Optional[str], device,
                     dtype: torch.dtype):
    """PatchFusion with the weights of --ckp-path: a local snapshot
    directory (its own config.json), the .pth triple over `config`, one
    of the port's fusion-only files merged over the branches, or a full
    weights file of tools.convert_checkpoint (no branch files read);
    without one, seeded random weights."""
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.engine.checkpoint import read_weights
    from patchfusion_tpu_torch.models.patchfusion import FROZEN_KEYS

    if ckp and os.path.isdir(ckp):
        return PatchFusion.from_pretrained(ckp, device=device, dtype=dtype)
    ckpts = None
    if ckp and "," not in ckp:
        # the port's own file: a fusion-only one over the branches
        # (tools/test.py of the JAX package: load_checkpoint's trainable
        # over from_config), or a full one (tools.convert_checkpoint)
        params, _ = read_weights(ckp)
        full = any(k.split(".")[0] in FROZEN_KEYS for k in params)
        if not full and config.get("load_branch") \
                and config.get("pretrain_model"):
            ckpts = (*config["pretrain_model"][:2], None)
        del params
        model = PatchFusion.from_config(config, device=device, ckpts=ckpts)
        model.load_dict(ckp)
        model.net.to(dtype)
        return model
    if ckp:
        paths = ckp.split(",")
        if len(paths) not in (2, 3):
            raise ValueError(f"--ckp-path {ckp!r}: expected a snapshot "
                             "directory or coarse.pth,fine.pth[,fusion.pth]")
        ckpts = (paths[0], paths[1], paths[2] if len(paths) > 2 else None)
    return PatchFusion.from_config(config, device=device, dtype=dtype,
                                   ckpts=ckpts)


def build_engine(cfg, args: argparse.Namespace, device, mesh):
    """The engine the Tester drives: a PatchFusion config's tiled engine,
    or a BaselinePretrain config's model (coarse) or fusion-less engine
    (fine), with the weights --ckp-path names (seeded random without), on
    this rank's `device`; mesh: the tile split (or None)."""
    from patchfusion_tpu_torch.api import BaselinePretrain
    from patchfusion_tpu_torch.models.patchfusion import TileConfig

    ckp, dtype = args.ckp_path, DTYPES[args.dtype]
    raw_shape = tuple(args.image_raw_shape)
    split = tuple(args.patch_split_num)
    if cfg.model["type"] == "BaselinePretrain":
        # stage-1/2 branch eval (reference baseline_pretrain.py:364-419)
        mcfg = cfg.model
        target = mcfg["target"]
        branch_cfg = mcfg["coarse_branch" if target == "coarse"
                          else "fine_branch"].to_dict()
        pps = cfg.train_dataloader["dataset"]["transform_cfg"][
            "network_process_size"]
        args_bp = (branch_cfg, mcfg["min_depth"], mcfg["max_depth"])
        kw = dict(target=target, image_raw_shape=raw_shape,
                  patch_split_num=split, patch_process_shape=tuple(pps),
                  device=device, dtype=dtype, mesh=mesh)
        model = (BaselinePretrain.from_torch(*args_bp, ckp, **kw) if ckp
                 else BaselinePretrain(*args_bp, **kw))
        return model if target == "coarse" else model.engine(
            args.process_num)

    model = load_patchfusion(cfg.model["config"].to_dict(), ckp, device,
                             dtype)
    tile_cfg = TileConfig(raw_shape, split,
                          model.tile_cfg.patch_process_shape)
    return model.engine(args.process_num, tile_cfg, mesh)


def evaluate(argv: Optional[List[str]] = None):
    """The CLI's run; returns the Tester, which holds the metrics dict
    (`metrics`, {} without GT) and each image's seconds
    (`image_seconds`)."""
    args = parse_args(argv)

    from patchfusion_tpu_torch.config import Config, parse_cfg_option
    from patchfusion_tpu_torch.config.registry import DATASETS
    from patchfusion_tpu_torch.data import general, u4k  # noqa: F401
    from patchfusion_tpu_torch.data.loader import DataLoader, ShardedSampler
    from patchfusion_tpu_torch.engine.tester import Tester
    from patchfusion_tpu_torch.parallel.dist import (init_rank, rank,
                                                     resolve_cli_mesh,
                                                     world_size)
    from patchfusion_tpu_torch.utils.misc import rank_logger, setup_logger

    device = init_rank(args.device)
    mesh = resolve_cli_mesh("none" if args.mesh == "auto" else args.mesh)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        opts = dict(kv.split("=", 1) for kv in args.cfg_options)
        cfg.merge_from_dict({k: parse_cfg_option(v)
                             for k, v in opts.items()})
    logger = rank_logger(setup_logger())
    engine = build_engine(cfg, args, device, mesh)
    if mesh is not None:
        logger.info("tile split over %d ranks; shard report (%s): %s",
                    mesh.size, args.cai_mode,
                    engine.shard_report(args.cai_mode)
                    if hasattr(engine, "shard_report") else "coarse target")

    if args.test_type == "general":
        dcfg = dict(cfg.general_dataloader)
        ds_cfg = dict(dcfg["dataset"])
        if args.image_dir:
            ds_cfg["rgb_image_dir"] = args.image_dir
        if args.gt_dir:
            ds_cfg["gt_dir"] = args.gt_dir
        if args.dataset_name:
            ds_cfg["dataset_name"] = args.dataset_name
        ds_cfg["image_resolution"] = tuple(args.image_raw_shape)
    else:
        key = {"normal": "val_dataloader", "test_in": "test_in_dataloader",
               "test_out": "test_out_dataloader"}[args.test_type]
        dcfg = dict(cfg[key])
        ds_cfg = dict(dcfg["dataset"])

    dataset = DATASETS.build(ds_cfg)
    # sample sharding without a tile split; every image on every rank with
    # one
    shards = (1, 0) if mesh is not None else (world_size(), rank())
    loader = DataLoader(dataset, batch_size=1,
                        sampler=ShardedSampler(len(dataset), *shards),
                        num_workers=dcfg.get("num_workers", 2))
    tester = Tester(engine, loader, work_dir=args.work_dir, save=args.save,
                    gray_scale=args.gray_scale, logger=logger)
    tester.run(cai_mode=args.cai_mode)
    if tester.metrics:
        logger.info("metrics: %s", tester.metrics)
    return tester


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Run the evaluation; returns the metrics dict ({} without GT)."""
    return evaluate(argv).metrics


if __name__ == "__main__":
    from patchfusion_tpu_torch.parallel.dist import shutdown

    main()
    shutdown()
