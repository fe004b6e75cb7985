"""Stage-1/2 branch pretraining CLI (the port of tools/train_branch.py; the
reference runs these through its tools/train.py with BaselinePretrain
configs):

    python -m patchfusion_tpu_torch.tools.train_branch CONFIG \
        [--work-dir DIR] [--seed 621] [--cfg-options key=value ...]

Trains one ZoeDepth branch (DA or BEiT) of a BaselinePretrain config,
target coarse on whole images or fine on random crops (reference
baseline_pretrain.py:347-360), in float32, and writes its weights (the
branch's full state dict) as the port's weights file
(engine/checkpoint.save_params) every save_checkpoint_interval epochs and
at the last. The fusion CLI's `pretrain_model` reads those files as it
reads the reference's branch `.pth` files.

Flags as tools/train_branch.py has them, plus --device (default cuda;
raises where CUDA is missing) and the fusion CLI's launcher flags
(--coordinator, --num-processes, --process-id, or torchrun's
environment): data parallel over ranks as the JAX package's data mesh
(tools/train_branch.py there), each rank on its ShardedSampler shard,
SILog over the global batch, the gradients averaged across the ranks,
rank 0 writing the weights. The DINOv2 attention runs on the einsum
path, the default route of a call that carries a gradient: the attention
kernel (PF_ATTN_IMPL=pallas) has no backward and raises under one.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None):
    """Run the pretraining; returns (state, losses): the final TrainState
    and every step's loss."""
    p = argparse.ArgumentParser(description="Pretrain a PatchFusion branch")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--seed", type=int, default=621)
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from patchfusion_tpu_torch.api import init_weights
    from patchfusion_tpu_torch.engine.checkpoint import save_params
    from patchfusion_tpu_torch.engine.training import (
        create_branch_state, make_branch_train_step, to_device_batch)
    from patchfusion_tpu_torch.models.builder import build_zoedepth_branch
    from patchfusion_tpu_torch.parallel.dist import (barrier, init_rank,
                                                     is_main)
    from patchfusion_tpu_torch.tools.train import (build_loader, load_config,
                                                   make_optimizer)
    from patchfusion_tpu_torch.utils.misc import (fix_random_seed, log_env,
                                                  rank_logger, setup_logger)

    device = init_rank(args.device, args.coordinator, args.num_processes,
                       args.process_id)
    cfg = load_config(args.config, args.cfg_options)
    fix_random_seed(args.seed)
    work_dir = args.work_dir or os.path.join(
        "./work_dir", os.path.splitext(os.path.basename(args.config))[0])
    if is_main():
        os.makedirs(work_dir, exist_ok=True)
        logger = setup_logger(log_file=os.path.join(work_dir, "train.log"))
    else:
        logger = rank_logger(setup_logger())
    log_env(logger, device)

    mcfg = cfg.model
    target = mcfg["target"]
    branch_cfg = mcfg["coarse_branch" if target == "coarse"
                      else "fine_branch"].to_dict()
    # the loader's network input size; it fixes a BEiT branch's grid
    pps = cfg.train_dataloader["dataset"]["transform_cfg"][
        "network_process_size"]
    branch = build_zoedepth_branch(branch_cfg, mcfg["min_depth"],
                                   mcfg["max_depth"], device=device,
                                   process_shape=tuple(pps))
    init_weights(branch, args.seed)

    loader = build_loader(cfg.train_dataloader, True, args.seed)
    tcfg = cfg.train_cfg
    total = max(1, len(loader)) * tcfg["max_epochs"]
    tx = make_optimizer(cfg, total, pct_start=0.5, div_factor=1,
                        weight_decay=0.01, read_momentum=False)
    state = create_branch_state(branch, tx)
    step = make_branch_train_step(target, mcfg["min_depth"],
                                  mcfg["max_depth"])
    keys = ("image_lr", "depth_gt") if target == "coarse" \
        else ("crops_image_hr", "crop_depths")
    losses = []
    for epoch in range(1, tcfg["max_epochs"] + 1):
        loader.sampler.set_epoch(epoch)
        for it, batch in enumerate(loader):
            logs = step(state, to_device_batch(batch, device, keys))
            losses.append(logs["total_loss"])
            if it % tcfg.get("log_interval", 100) == 0:
                logger.info("epoch %d iter %d loss %.4f", epoch, it,
                            float(logs["total_loss"]))
        if epoch % tcfg.get("save_checkpoint_interval", 24) == 0 \
                or epoch == tcfg["max_epochs"]:
            path = os.path.join(work_dir, f"checkpoint_{epoch:02d}.ckpt")
            if is_main():
                save_params(path, branch.state_dict())
                logger.info("saved %s", path)
            barrier()
    return state, [float(x) for x in losses]


if __name__ == "__main__":
    from patchfusion_tpu_torch.parallel.dist import shutdown

    main()
    shutdown()
