"""Train-step throughput at the reference recipe's shapes (the port of the
JAX package's tools/profile_train.py): one fusion-stage step of
engine/training.make_train_step (the frozen branches forward, the fusion
stage forward and backward, the clip and AdamW) at batch 4 of 392x518
crops: the first step, the median warm step, steps/s, crops/s, the counted
matmul+conv TFLOP of a step (forward + backward, counted once on the
einsum path, _bench_util) with TFLOP/s, and the peak allocated device
memory (torch.cuda.max_memory_allocated), which stands where the JAX tool
prints XLA's memory_analysis.

    python -m patchfusion_tpu_torch.tools.profile_train [--batch 4]
        [--core vitl] [--iters 5] [--remat] [--amp] [--device cuda]

--amp: bf16 autocast compute, frozen branches stored in bf16, f32 masters
and optimizer (tools/train.py --amp); --remat: train_remat. Prints the
rows, then one JSON line with them, the card's nvidia-smi name and power
limit and the torch version.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from patchfusion_tpu_torch.models.builder import check_device
from patchfusion_tpu_torch.tools import _bench_util as bu

TOOL = "profile_train"


def train_batch(b: int, shape, device, raw_box=(100., 100., 1060., 640.)):
    """A seeded batch at the step's layout (NCHW float32 on `device`): the
    low-resolution images, the crops, their depths in [1, 21) and one box
    per crop in the 3840x2160 frame."""
    rng = np.random.default_rng(0)
    h, w = shape

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {
        "image_lr": t(rng.random((b, 3, h, w), dtype=np.float32)),
        "crops_image_hr": t(rng.random((b, 3, h, w), dtype=np.float32)),
        "crop_depths": t((rng.random((b, 1, h, w)) * 20 + 1)
                         .astype(np.float32)),
        "bboxs": t(np.tile(np.array([raw_box], np.float32), (b, 1)))}


def profile(config: dict, batch: int = 4, iters: int = 5,
            remat: bool = False, amp: bool = False, device="cuda") -> dict:
    """The module note's rows for the PatchFusion `config`."""
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.engine.training import (
        create_train_state, make_onecycle_optimizer, make_train_step)

    device = check_device(device)
    config = dict(config, train_remat=remat)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = PatchFusion.from_config(config, device=device, seed=0)
    tx = make_onecycle_optimizer(max_lr=4e-5, total_steps=1000)
    state = create_train_state(model.net, tx, amp=amp,
                               frozen_dtype=torch.bfloat16 if amp else None)
    step = make_train_step(min_depth=config["min_depth"],
                           max_depth=config["max_depth"])
    data = train_batch(batch, model.tile_cfg.patch_process_shape, device)
    peak, peak_label = bu.peak_flops(
        torch.bfloat16 if amp else torch.float32, device)

    bu.sync(device)
    t0 = time.perf_counter()
    logs = step(state, data)
    loss = float(logs["total_loss"])
    first = time.perf_counter() - t0
    rows = [bu.stage_row("first step", first, loss=loss)]
    flops = bu.count_flops(step, state, data)
    warm = bu.device_time(step, state, data, inner=1, repeats=iters,
                          device=device)
    tag = f"b{batch} {config['coarse_branch']['midas_model_type']}" \
        f"{' remat' if remat else ''}{' amp' if amp else ''}"
    peak_bytes = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    rows.append(bu.stage_row(
        f"train step ({tag})", warm, flops, peak,
        steps_per_s=1 / warm, crops_per_s=batch / warm,
        tflop=flops / 1e12,
        peak_gib=None if peak_bytes is None else peak_bytes / 2 ** 30))
    return bu.emit(TOOL, device, rows, peak=peak_label, batch=batch,
                   remat=remat, amp=amp, state_step=state.step)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--core", default="vitl")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--amp", action="store_true",
                    help="bf16 autocast compute + bf16 frozen-branch "
                         "storage, f32 masters (the tools/train.py --amp "
                         "mode)")
    bu.add_device_arg(ap)
    args = ap.parse_args(argv)
    return profile(bu.published_config(args.core), args.batch, args.iters,
                   args.remat, args.amp, args.device)


if __name__ == "__main__":
    main()
