#!/usr/bin/env python3
"""Smoke run of patchfusion_tpu_torch on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-only DIR   # only step 3's timings, of the
                                            # kernels of the checkout at DIR

1. Prints the card (nvidia-smi name and power limit) and torch's version.
2. Builds the CUDA kernels from patchfusion_tpu_torch/csrc with nvcc (one
   nvcc per source, all started together) and prints their ptxas lines.
3. Holds each kernel against its plain PyTorch twin at the main-path shapes
   and times kernel, twin and, where one exists, the one PyTorch call that
   computes the same function, with CUDA events:
   the head kernels at B = 1 and 4, output 392x518, low-res input 224x296,
   float32 and bfloat16, channels-last and permuted-NCHW inputs
   (logbinomial_depth within 2e-4 of max |depth| in both dtypes, on its
   tiled kernel, the row naming the kernel that ran); the
   attention kernel at the vitl fine and coarse shapes (B = 4 and 1,
   N = 1037, H = 16, Dh = 64) and at the vitmicro width (Dh = 32) on
   strided qkv views, in all three roundings, each closer to its own
   rounding's twin than to the other two on inputs where the roundings
   part. Each function is timed four ways (_timings): ms, one call between
   CUDA events (host work included); ms_batched, per call over runs of 20
   back-to-back calls; device_ms, the profiler's kernel time per call
   (device_events: the device events it recorded over its 20 calls);
   host_us, the host's time to issue one call. Each row carries its bound
   and bound_share (bound_ms / ms).
4. Builds DA-vitl PatchFusion at full width from
   configs/patchfusion_depthanything/depthanything_vitl_patchfusion_u4k.py
   in bf16 with seeded random weights, answers three m1 requests and one m2
   request on seeded 2160x3840 images (the einsum attention), and checks
   every depth map and each kernel's launches per image.
5. The same model with PF_ATTN_IMPL=pallas (the attention kernel in all 24
   blocks of both branches): three m1 requests on the same images, 120
   attention launches per image, depth within 3e-2 of max of step 4's, and
   one m2 request (336 launches).
6. ConditionalLogBinomial.depth_fused (one clb_logbinomial_depth launch)
   on the PF head of that model, on the head's own inputs of one m1 chunk,
   against the head's two-kernel output and against the plain twin.
7. The eval path (phase `eval`), on the same model: (a) its weights, in
   f32, written as a snapshot directory (config.json + pytorch_model.bin)
   and loaded with PatchFusion.from_pretrained in bf16 give the seeded
   model's m1 depth (bitwise, or within 1e-6 of max); (b) the tiny config's
   coarse, fine and fusion .pth files load on the card (bf16) and on the
   CPU (f32) and agree within 3e-2 of max; (c) the eval CLI
   (patchfusion_tpu_torch.tools.test, in-process) with that snapshot runs
   m1 over a 2-scene synthetic U4K val split at 2160x3840 written with
   numpy, and returns finite metrics, with the head kernels launched 9
   times per image; it prints each image's load / inference / metrics
   seconds and whether the native host IO or its numpy fallback ran;
   (d) BaselinePretrain from the vitl coarse and fine pretrain configs,
   seeded, bf16: one image through each target, finite positive depth,
   head kernels once for coarse and once per chunk of 4 tiles for fine m1.
   Prints the snapshot's write and load times and the phase's peak memory.
8. Runs the tiny config in bf16 on the card (with the kernels, einsum and
   pallas attention) against the same weights in float32 on the CPU, and
   the toy zoedepth config (BEiT_tiny, 64x96 tiles) likewise, m1 with 5 + 5
   head launches.
9. The training path (phase `train`): (a) the three head wrappers with
   inputs that require grad at B = 4 (bf16 maps as NCHW views, f32
   weights): one kernel launch forward and none backward, the recomputed
   twin's gradients against autograd through the twin, and the backward's
   time against the forward's; (b) the tiny config's train step on the
   card, f32 and --amp, against the f32 CPU port on the same weights; (c)
   the DA-vitl fusion stage through tools.train (its main, in-process)
   with --amp at the recipe's batch of 4 over 4 synthetic 4K U4K scenes
   (2 epochs of 5 steps, m1 validation, a checkpoint per epoch): finite
   losses, trainable weights and BN statistics moved, frozen branches
   bit-identical, clb_pt and logbinomial_depth launched 3 times a step;
   images/s over the epochs' wall time, the warm step's median time, the
   loader's waits and peak memory; (d) save at step 3 and resume into a
   fresh model (restore_train_state, as --resume does): the same weights
   and losses; (e) one step with train_remat off and on: the same loss,
   each one's peak; (f) 2 steps of tools.train_branch for vitl coarse
   (f32).
10. The rest of the JAX package's surface (phase `surface`): (a) one
   DA-vitl fusion train_forward at batch 4 with --amp on 392x518 crops of
   synthetic 4K scenes; on its prediction SILog and the research losses
   (ScaleAndShiftInvariantLoss over the valid mask, ExistLoss over the
   Sobel magnitudes of the prediction and of the coarse ROI depth,
   EdgeguidedRankingLoss at 10,000 pairs from a seeded CUDA generator,
   ErrorLoss "incoh_grad_depth" and EdgeClsLoss over a seeded 3-class
   softmax): each finite and within 1e-4 relative of the port's CPU value
   on the same tensors (the ranking loss with the card's draws injected),
   the sum's backward finite on the fusion parameters, 3 + 3 head launches
   forward and none in the recompute backward, each loss's time on CUDA
   events; (b) the seeded vitl model's weights through `python -m
   patchfusion_tpu_torch.tools.export_hub` and PatchFusion.from_pretrained
   on the card: m1 at 2160x3840 bitwise equal to the live model's; a
   fusion-only export (from save) holds exactly the fusion keys; the write
   and load seconds and the snapshot's bytes; (c) the vitl model's
   published-layout .pth triple through `python -m
   patchfusion_tpu_torch.tools.convert_checkpoint`: the model the CLIs'
   loader reads from that one file gives from_config(ckpts=triple)'s m1,
   bitwise; (d) 2 train and 1 val scenes at 2160x3840 from the port's
   make_synth_u4k (no OpenCV), seconds per scene, and
   configs/demo/train_fusion_synth_vitl.py through tools.train on them for
   one epoch (2 steps at batch 2 with train_remat): finite losses,
   images/s over the epoch and the peak; (e) 3 warm m1 requests under
   utils/profiling.SectionTimer and one under trace(dir), whose Chrome
   trace names 9 clb_pt and 9 logbinomial_depth launches; (f)
   model("infer", image_lr=..., image_hr=...) on NCHW card tensors:
   infer's m1 depth (1568x2072 from 2160x3840) as (1, 1, H, W), bitwise.
11. The BEiT ZoeDepth family (phase `beit`,
   configs/patchfusion_zoedepth): (a) the head kernels against their twins
   at the BEiT head's shapes (B = 1 and 4, 384x512 from 192x256, K = 64,
   f32 and bf16, channels-last and NCHW views, the tolerances of step 3),
   timed as there, each row naming its route (logbinomial_depth's tiled
   kernel, checked; clb_pt's bf16 tensor-core kernel with its tile's
   shared memory), run with step 3 (the profiler, late in a run, has lost
   launches of the port's kernels; a row's profile must hold every
   launch); (b) one BEiT-L block (B = 4, 769 tokens, width 1024,
   16 heads, LayerScale gammas U(0.5, 1.5)) in bf16 against f32 on the
   card, within 3e-2 of max; (c) zoedepth_patchfusion_u4k.py at full
   width in bf16 with seeded weights (load_branch=False,
   pretrain_model=None): four m1 requests (the first warms up) and one m2
   on seeded 2160x3840 images, each with 9 / 27 launches of each head
   kernel and none of the per-pixel kernel, then one m1 with
   PF_ATTN_IMPL=pallas (no attention launch, the same depth); warm
   latency and peak memory; (d) a synthetic reference coarse-branch .pth
   in the published layout (24x24 tables, 577 x 577 index buffers, numpy
   values) loaded through BaselinePretrain.from_torch on the coarse
   pretrain config: the tables resampled to 24x32, one request, the load
   time; (e) two fusion-stage steps at batch 4 with --amp on one fixed
   batch: finite losses, 3 + 3 head launches a step, the step time on the
   device's clock and the peak.
12. Scale-out over torch.distributed (phase `dist`; child processes of
   this script, `--dist-child PART DIR`, with torchrun's variables, each
   with a time limit that kills them all): (a) one rank over nccl at
   world 1: the tiny config's m1 through the tile split on cuda:0
   bitwise equal to the engine without it, and one fusion step; against
   this process's DA-vitl bf16 reference (three m1 and two m2 requests,
   the Tester over 3 synthetic 4K scenes, one --amp fusion step at batch
   4), two ranks over gloo, both on cuda:0: (b) m1 and m2 with each
   image's tiles split over the ranks, m1 bitwise equal to one process's
   depth and m2 within 5e-3 of its max, each rank's head launches per
   request (5 / 15 each: its share of the chunks and the repeated coarse
   head); (c) one --amp
   step at batch 2 per rank, its loss within 1e-3 of one process's at
   batch 4 (which also prints the two halves' SILog, the losses a
   per-rank reduction would give, and fails unless they miss the limit), the averaged gradients' and the updates' cosine with one
   process's; (d) the Tester with the ranks
   sharding the scenes, its gathered metrics within 1e-4 of one
   process's; walls, step times on CUDA events and peaks per rank. Two
   ranks on one card show the collectives, not a speed-up.
13. Prints one JSON line with the kernels' launches (the main path's, and
   for the head kernels the eval phase's, the training steps', phase
   surface's, the 2-rank tile split's per rank and the BEiT path's with
   their BEiT-shape rows), errors, times (the head kernels' recompute
   backward too) and bounds, then {"ok": true, "device": {...}} as the
   last line.

Any failed check raises, so the script exits non-zero without the last line.
It needs one CUDA card and nothing but this repository.

--time-only DIR builds the kernels of the checkout at DIR (another commit
of this repository, for a comparison within one run on one card) and
times its wrappers and SDPA at the B = 4 shapes of step 3 as step 3 does,
printing one JSON line; it checks nothing against the twins.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
VITL_CONFIG = ("configs/patchfusion_depthanything/"
               "depthanything_vitl_patchfusion_u4k.py")
BASELINE_CONFIG = ("configs/patchfusion_depthanything/"
                   "depthanything_vitl_{}_pretrain_u4k.py")
ZOE_CONFIG = "configs/patchfusion_zoedepth/zoedepth_patchfusion_u4k.py"
ZOE_BASELINE_CONFIG = ("configs/patchfusion_zoedepth/"
                       "zoedepth_{}_pretrain_u4k.py")
RAW_SHAPE = (2160, 3840)
PROCESS_NUM = 4
KERNEL_SOURCES = {
    "clb_pt": "patchfusion_tpu_torch/csrc/clb_pt.cu",
    "logbinomial_depth": "patchfusion_tpu_torch/csrc/logbinomial_depth.cu",
    "vit_attention": "patchfusion_tpu_torch/csrc/vit_attention.cu",
    "clb_logbinomial_depth": "patchfusion_tpu_torch/csrc/clb_depth.cu"}
REPLACES = {
    "clb_pt": "patchfusion_tpu/ops/pallas_head.py:490",
    "logbinomial_depth": "patchfusion_tpu/ops/pallas_head.py:119",
    "vit_attention": "patchfusion_tpu/ops/pallas_attention.py:285; "
                     "patchfusion_tpu/ops/pallas_attention.py:258; "
                     "patchfusion_tpu/ops/pallas_attention.py:230",
    "clb_logbinomial_depth": "patchfusion_tpu/ops/pallas_head.py:278"}
# kernel vs plain twin: (tolerance on p and t, absolute; on depth, relative
# to max |depth|). f32 differs only by float reassociation; bf16 also by the
# kernel's bf16 rounding of the bottleneck and GELU (the twin is f32 inside).
TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)}
# logbinomial_depth vs its twin in both dtypes, relative to max |depth|: it
# reads the bf16 centers exactly; only the order of its sums and
# ex2.approx part it from the twin
DEPTH_TOL = 2e-4
# pf_logbinomial_depth's two kernels, by their LAUNCHES names
DEPTH_VARIANTS = {"logbinomial_depth": "tiled",
                  "logbinomial_depth_pixel": "per-pixel"}
# attention kernel vs twin, absolute on outputs of |o| <~ 1: the two round
# P to bf16 against different maxima (running vs whole-row) and sum in
# another order; a wrong key, row or column moves o by ~|o|
ATTN_TOL = 1e-2
# depth_fused vs the head's clb_pt + logbinomial_depth launches: the same
# per-pixel arithmetic (the tiled depth kernel stages and sums as the fused
# epilogue does, to float rounding), relative to max |depth|
FUSED_TOL = 1e-4
PATH_TOL = 3e-2   # pallas vs einsum attention path, relative to max |depth|
TINY_TOL = 3e-2   # bf16 card vs f32 CPU, relative to max |depth|
SNAPSHOT_TOL = 1e-6  # from_pretrained vs the seeded model, rel. to max
# one BEiT-L block (B = 4, 769 tokens, width 1024, 16 heads) in bf16 against
# the same block in f32 on the card, relative to max |output|: the bf16
# contract rounds the residual stream, q, k, v and the probabilities
BLOCK_TOL = 3e-2
BEIT_BLOCK = (4, (24, 32), 1024, 16)  # B, grid, width, heads
# NVIDIA H100 SXM data-sheet peaks (dense): the least time a kernel's work
# could take is the largest of its bytes, tensor-core FLOPs and other f32
# operations over these rates
HBM_BYTES_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12


def tiny_config():
    """The structurally complete toy PatchFusion config of
    __graft_entry__._tiny_config (vitmicro, 42x56 tiles of an 84x112
    image); the tests check that the two agree."""
    sizes = [(2, 2), (3, 4), (6, 8), (12, 16), (24, 32), (42, 56)]
    c = 32
    zoe = dict(
        type="DA-ZoeDepth", midas_model_type="vitmicro", img_size=[42, 56],
        n_bins=64, bin_centers_type="softplus", bin_embedding_dim=128,
        n_attractors=[16, 8, 4, 1], attractor_alpha=1000, attractor_gamma=2,
        attractor_kind="mean", attractor_type="inv", min_temp=0.0212,
        max_temp=50.0)
    return dict(
        image_raw_shape=(84, 112), patch_split_num=(2, 2),
        patch_process_shape=(42, 56), min_depth=1e-3, max_depth=80,
        coarse_branch=dict(zoe), fine_branch=dict(zoe),
        guided_fusion=dict(
            type="GuidedFusionPatchFusion", patch_process_shape=(42, 56),
            in_channels=[32, c, c, c, c, c], depth=[1, 1, 1, 1, 1, 1],
            num_heads=[2, 2, 2, 2, 2, 2],
            num_patches=[h * w for (h, w) in sizes[::-1]], n_channels=5,
            g2l=True),
        sigloss=dict(type="SILogLoss"))


def tiny_zoe_config():
    """The toy zoedepth PatchFusion config of tests/test_beit.py
    (toy_zoe_config: BEiT_tiny branches, 64x96 tiles of a 128x192 image,
    the fusion stage at its published widths), read with the port's
    config loader; the tests check that the two agree."""
    from patchfusion_tpu_torch.config import Config

    mc = Config.fromfile(str(ROOT / ZOE_CONFIG)).model.config.to_dict()
    for b in ("coarse_branch", "fine_branch"):
        mc[b] = dict(mc[b], midas_model_type="BEiT_tiny", img_size=[64, 96])
    mc.update(image_raw_shape=(128, 192), patch_split_num=(2, 2),
              patch_process_shape=(64, 96))
    sizes = [(2, 3), (4, 6), (8, 12), (16, 24), (32, 48), (64, 96)]
    mc["guided_fusion"] = dict(
        mc["guided_fusion"], patch_process_shape=(64, 96),
        in_channels=[32, 256, 256, 256, 256, 256],
        num_patches=[h * w for (h, w) in sizes[::-1]])
    return mc


def write_u4k_split(root, n_scenes: int = 2, shape=RAW_SHAPE,
                    seed: int = 0) -> str:
    """A synthetic UnrealStereo4K val split in the on-disk layout
    patchfusion_tpu_torch/data/u4k.py reads, written with numpy alone: per
    scene `Image0/00000.raw` (uint8 BGR), `Disp0/00000.npy` (float32
    disparity of a smooth positive depth field, 4-64, with one nearer
    rectangle whose edges are disparity boundaries), `Extrinsics0/1`
    (focal 100, baseline 0.5: depth = 50 / disparity), and `val.txt`.
    Returns the split file's path."""
    rng = np.random.default_rng(seed)
    h, w = shape
    focal, base = 100.0, 0.5
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    lines = []
    for i in range(n_scenes):
        a, b, c = rng.uniform(0.5, 2.0, 3).astype(np.float32)
        depth = (4.0 + 20.0 * (1.0 + np.sin(3.0 * a * y + c))
                 + 10.0 * (1.0 + np.cos(4.0 * b * x))).astype(np.float32)
        depth[h // 4:h // 2, w // 4:w // 2] = rng.uniform(2.0, 3.0)
        shade = 1.0 / (1.0 + 0.05 * depth)
        bgr = np.stack([shade * (0.3 + 0.7 * x), shade * (0.5 + 0.5 * y),
                        shade], axis=-1)
        scene = Path(root) / f"scene_{i:02d}"
        for sub in ("Image0", "Disp0", "Extrinsics0", "Extrinsics1"):
            (scene / sub).mkdir(parents=True, exist_ok=True)
        (bgr * 255.0).astype(np.uint8).tofile(scene / "Image0" / "00000.raw")
        np.save(scene / "Disp0" / "00000.npy",
                (np.float32(focal * base) / depth).astype(np.float32))
        (scene / "Extrinsics0" / "00000.txt").write_text(
            f"{focal} 0 0\n0 0 0 0.0\n")
        (scene / "Extrinsics1" / "00000.txt").write_text(
            f"{focal} 0 0\n0 0 0 {base}\n")
        rel = f"scene_{i:02d}"
        lines.append(f"{rel}/Image0/00000.png {rel}/Image1/00000.png "
                     f"{rel}/Disp0/00000.npy {rel}/Disp1/00000.npy\n")
    split = Path(root) / "val.txt"
    split.write_text("".join(lines))
    return str(split)


def say(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# launch counts and bounds
# ---------------------------------------------------------------------------

def _count_dicts():
    from patchfusion_tpu_torch.ops import fused_head, vit_attention
    return (fused_head.LAUNCHES, vit_attention.LAUNCHES)


def reset_counts() -> None:
    for d in _count_dicts():
        for name in d:
            d[name] = 0


def counts() -> dict:
    out = {}
    for d in _count_dicts():
        out.update(d)
    return out


@contextlib.contextmanager
def attn_impl(impl: str):
    """PF_ATTN_IMPL set in this process for the block, restored after."""
    old = os.environ.get("PF_ATTN_IMPL")
    os.environ["PF_ATTN_IMPL"] = impl
    try:
        yield
    finally:
        if old is None:
            del os.environ["PF_ATTN_IMPL"]
        else:
            os.environ["PF_ATTN_IMPL"] = old


def bound(nbytes: float, tc_flops: float = 0.0, f32_ops: float = 0.0):
    """(bound_ms, bound_by): the largest of the bytes over HBM bandwidth,
    the tensor-core FLOPs over the bf16 tensor-core peak and the other f32
    operations over the f32 peak."""
    times = {"bytes": nbytes / HBM_BYTES_S,
             "operations": max(tc_flops / BF16_TC_FLOPS, f32_ops / F32_FLOPS)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def head_bounds(b, oh, ow, ih, iw, k, cin, cc, hid, itemsize):
    """Bounds of the three head kernels for one input shape. Bytes: each
    input read once, each output written once. Operations: the MLP's
    products at the tensor-core rate with the condition projected at its
    low resolution (the cheaper order), and per (pixel, bin) ~16 f32
    operations of the log-binomial softmax, the centers' bilinear taps and
    the weighted sum."""
    hi, lo = b * oh * ow, b * ih * iw
    mlp = 2 * hid * (cin * hi + cc * lo) + 2 * hid * 4 * hi
    lb_ops = 16 * k * hi
    return {
        "clb_pt": bound(itemsize * (cin * hi + cc * lo) + 8 * hi, mlp),
        "logbinomial_depth": bound(8 * hi + itemsize * k * lo + 4 * hi, 0,
                                   lb_ops),
        "clb_logbinomial_depth": bound(
            itemsize * (cin * hi + (cc + k) * lo) + 4 * hi, mlp, lb_ops)}


def attention_bound(b, n, h, dh):
    """q, k, v read and o written in bf16; QK^T and PV at the tensor-core
    rate; ~6 f32 operations per score (round, max, subtract, exp, round,
    sum)."""
    return bound(4 * b * n * h * dh * 2, 4 * b * h * n * n * dh,
                 6 * b * h * n * n)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    say(smi.splitlines()[0] if smi else "nvidia-smi: no card listed")
    say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from patchfusion_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    lib = cuda_lib.build_kernels()
    cuda_lib.load_kernels()
    secs = time.perf_counter() - t0
    say(f"build: {secs:.1f} s -> {lib.relative_to(ROOT)}")
    log = (lib.parent / "nvcc.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("  ptxas:", line.split("ptxas info    :")[-1].strip())
    return secs


def _time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median over `reps` single calls, CUDA events around each: the
    call's host work (argument checks, tensor maps, the launch) counts
    where the card would otherwise wait for it."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _time_batched_ms(fn, calls: int = 20, reps: int = 7) -> float:
    """Median over `reps` of the mean time of `calls` back-to-back calls,
    CUDA events around each run: a call's host work is hidden behind the
    card's queue unless it is slower than the kernel."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def _host_us(fn, calls: int = 20, reps: int = 5) -> float:
    """Median over `reps` of the host's time per call to issue `calls`
    back-to-back calls (the card is idle at the start and never waited
    for), in microseconds."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


# substrings of the port's kernels' names in a profile
PORT_KERNEL_NAMES = ("vit_attention_kernel", "clb_", "logbinomial_depth")


def _device_ms(fn, calls: int = 20, attempts: int = 3):
    """-> (kernel time per call on the card, profiling windows used, device
    events recorded): the sum of the durations of the device events
    torch.profiler records over `calls` calls, divided by `calls`. A
    window is profiled again, up to `attempts` windows, where the profiler
    delivered no device event at all (it has happened once in this
    script's runs, on an SDPA row that other runs recorded), or fewer
    events of the port's kernels than the wrappers launched (late in a
    full run it has recorded 6 of a row's 20 launches, and all of the
    other kernels); none complete fails."""
    import torch

    for window in range(1, attempts + 1):
        torch.cuda.synchronize()
        before = sum(counts().values())
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = sum(counts().values()) - before
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        ours = sum(any(k in e.name for k in PORT_KERNEL_NAMES)
                   for e in events)
        us = sum(e.time_range.end - e.time_range.start for e in events)
        if us > 0 and ours == launched:
            return us / calls / 1e3, window, len(events)
        say(f"the profiler recorded {len(events)} device events, {ours} of "
            f"the {launched} launches of the port's kernels; profiling "
            "again")
    check(False, f"the profiler lost device events in {attempts} windows")


def _timings(fn, prefix: str = "") -> dict:
    """The four times of fn (see the module note), keys prefixed."""
    out = {"ms": _time_ms(fn)}
    out["ms_batched"] = _time_batched_ms(fn)
    out["device_ms"], out["device_windows"], out["device_events"] = \
        _device_ms(fn)
    out["host_us"] = _host_us(fn)
    return {prefix + k: v for k, v in out.items()}


def _nchw_view(x_nhwc_np, dtype, device):
    """A channels-last view of an NCHW tensor: the layout the model feeds."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x_nhwc_np, -1, 1))).to(device=device, dtype=dtype)
    return t.permute(0, 2, 3, 1)


HEAD_SHAPE = (392, 518, 224, 296, 64, 33, 128, 80)  # oh ow ih iw k cin cc hid
# the BEiT head's: 384x512 from the attractors' 192x256, a 2x upsample
BEIT_HEAD_SHAPE = (384, 512, 192, 256, 64, 33, 128, 80)


def _head_inputs(b, dtype, layout, dev, shape=HEAD_SHAPE):
    """Seeded inputs of the head kernels at a head's shapes (default the
    DA head's): p, t, centers, last_cat, cond_lo and the four MLP weights
    in `dtype`."""
    import torch

    oh, ow, ih, iw, k, cin, cc, hid = shape
    rng = np.random.default_rng(b)
    p = rng.random((b, oh, ow), dtype=np.float32) * 0.98 + 0.01
    t = rng.random((b, oh, ow), dtype=np.float32)
    cent = rng.random((b, ih, iw, k), dtype=np.float32) * 70 + 1
    last = rng.standard_normal((b, oh, ow, cin), dtype=np.float32)
    cond = rng.standard_normal((b, ih, iw, cc), dtype=np.float32)
    ws = [rng.standard_normal(shape, dtype=np.float32) * 0.1
          for shape in ((cin + cc, hid), (hid,), (hid, 4), (4,))]
    if layout == "nhwc":
        maps = [torch.from_numpy(a).to(dev, dtype) for a in (cent, last, cond)]
    else:
        maps = [_nchw_view(a, dtype, dev) for a in (cent, last, cond)]
    return (torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev), *maps,
            [torch.from_numpy(w).to(dev, dtype) for w in ws])


def _head_kernels(results, shape=HEAD_SHAPE, family=None):
    """The three head kernels against their twins at a head's shapes
    (default the DA head's; family names another head's rows: their keys
    start with it)."""
    import torch
    from patchfusion_tpu_torch.ops import fused_head as fh

    dev = torch.device("cuda")
    oh, ow, ih, iw = shape[:4]
    for b in (1, 4):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            tol_pt, tol_depth = TOL[dname]
            bounds = head_bounds(b, *shape, dtype.itemsize)
            for layout in ("nchw-view", "nhwc"):
                pt, tt, ct, lt, cdt, wl = _head_inputs(b, dtype, layout, dev,
                                                       shape)
                # logbinomial_depth, and which of its kernels ran
                before = counts()
                got = fh.logbinomial_depth(pt, tt, ct)
                ran = [DEPTH_VARIANTS[n] for n in DEPTH_VARIANTS
                       if counts()[n] > before[n]]
                ref = fh.logbinomial_depth_plain(pt, tt, ct)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                rel = err / ref.abs().max().item()
                check(bool(torch.isfinite(got).all()),
                      "logbinomial_depth: non-finite output")
                check(rel <= DEPTH_TOL,
                      f"logbinomial_depth {dname} B={b} {layout}: rel err "
                      f"{rel:.3g} > {DEPTH_TOL}")
                check(ran == ["tiled"], f"logbinomial_depth {dname} B={b} "
                      f"{layout}: ran {ran}, not the tiled kernel")
                row = {"max_abs_err": err, "rel_err": rel,
                       "variant": ran[0]}
                # clb_pt
                gp, gt = fh.clb_pt(lt, cdt, *wl)
                rp, rt = fh.clb_pt_plain(lt, cdt, *wl)
                torch.cuda.synchronize()
                e_clb = max((gp - rp).abs().max().item(),
                            (gt - rt).abs().max().item())
                check(bool(torch.isfinite(gp).all()
                           and torch.isfinite(gt).all()),
                      "clb_pt: non-finite output")
                check(e_clb <= tol_pt,
                      f"clb_pt {dname} B={b} {layout}: abs err {e_clb:.3g} "
                      f"> {tol_pt}")
                # its route: the bf16 tensor-core kernel, whose tile
                # footprint must fit in shared memory (else the wrapper
                # raises), or the f32 kernel
                crow = {"max_abs_err": e_clb,
                        "variant": "tensor-core" if dtype == torch.bfloat16
                        else "f32"}
                if dtype == torch.bfloat16:
                    crow["tile_smem_bytes"] = fh.load_kernels() \
                        .pf_clb_tc_smem(oh, ow, ih, iw, 0)
                # clb_logbinomial_depth, against its twin and against the
                # two-kernel route it fuses
                gd = fh.clb_logbinomial_depth(lt, cdt, ct, *wl)
                rd = fh.clb_logbinomial_depth_plain(lt, cdt, ct, *wl)
                two = fh.logbinomial_depth(*fh.clb_pt(lt, cdt, *wl), ct)
                torch.cuda.synchronize()
                e_d = (gd - rd).abs().max().item()
                rel_d = e_d / rd.abs().max().item()
                rel_two = ((gd - two).abs().max() / two.abs().max()).item()
                check(bool(torch.isfinite(gd).all()),
                      "clb_logbinomial_depth: non-finite output")
                check(rel_d <= tol_depth,
                      f"clb_logbinomial_depth {dname} B={b} {layout}: rel "
                      f"err {rel_d:.3g} > {tol_depth}")
                check(rel_two <= FUSED_TOL,
                      f"clb_logbinomial_depth {dname} B={b} {layout}: "
                      f"{rel_two:.3g} from clb_pt + logbinomial_depth")
                frow = {"max_abs_err": e_d, "rel_err": rel_d,
                        "rel_to_two_kernels": rel_two}
                if layout == "nchw-view":
                    row.update(_timings(
                        lambda: fh.logbinomial_depth(pt, tt, ct)))
                    row["plain_ms"] = _time_ms(
                        lambda: fh.logbinomial_depth_plain(pt, tt, ct))
                    crow.update(_timings(lambda: fh.clb_pt(lt, cdt, *wl)))
                    crow["plain_ms"] = _time_ms(
                        lambda: fh.clb_pt_plain(lt, cdt, *wl))
                    frow.update(_timings(
                        lambda: fh.clb_logbinomial_depth(lt, cdt, ct, *wl)))
                    frow["plain_ms"] = _time_ms(
                        lambda: fh.clb_logbinomial_depth_plain(lt, cdt, ct,
                                                               *wl))
                    frow["two_kernels_ms"] = _time_ms(
                        lambda: fh.logbinomial_depth(
                            *fh.clb_pt(lt, cdt, *wl), ct))
                for name, r in (("logbinomial_depth", row), ("clb_pt", crow),
                                ("clb_logbinomial_depth", frow)):
                    r["bound_ms"], r["bound_by"] = bounds[name]
                    if "ms" in r:
                        r["bound_share"] = r["bound_ms"] / r["ms"]
                        r["bound_share_device"] = (r["bound_ms"]
                                                   / r["device_ms"])
                    r["library_ms"] = None
                    key = (name, dname, b, layout)
                    results[(family, *key) if family else key] = r
                    say(f"kernel {name} {dname} B={b} {layout}"
                        f"{f' ({family} head)' if family else ''}: "
                        + json.dumps(r))


# (B, N, H, Dh): the vitl fine and coarse passes, and the vitmicro width
# the tiny config runs (42x56 tiles: 12 patches and the class token)
ATTN_SHAPES = [(4, 1037, 16, 64), (1, 1037, 16, 64), (2, 13, 2, 32)]


def _attention_wrappers():
    """label -> (wrapper, the twin's rounding (round_logits, round_diff))."""
    from patchfusion_tpu_torch.ops import vit_attention as va

    return {
        "vit_attention": (va.vit_attention, (True, True)),
        "vit_attention_blocked": (va.vit_attention_blocked, (False, False)),
        "vit_attention_mxsum(bf16_exp=True)": (
            lambda q, k, v: va.vit_attention_mxsum(q, k, v, bf16_exp=True),
            (False, True)),
    }


def _qkv(b, n, h, dh, max_first=False):
    """Seeded q, k, v as the model hands them: views qkv[:, :, i] of a
    (B, N, 3, H, Dh) bf16 tensor on the card. max_first: every row's
    largest logit lies at key 0, ~6 above the rest, so the kernel's running
    max is the row max from its first key tile on and each rounding's twin
    is the kernel's up to the order of its sums."""
    import torch

    rng = np.random.default_rng(10 + b + dh)
    qkv = rng.standard_normal((b, n, 3, h, dh), dtype=np.float32)
    if max_first:
        qkv[:, :, :2] *= 0.6
        qkv[:, :, 0, :, 0] = 1.0
        qkv[:, :, 1, :, 0] = 0.0
        qkv[:, 0, 1, :, 0] = round(6.0 * math.sqrt(dh))
    qkv = torch.from_numpy(qkv).to("cuda", torch.bfloat16)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _rounding_apart(b, n, h, dh):
    """Each wrapper against the three twins on max_first inputs: the mean
    |o - twin| to its own rounding's twin must be under a quarter of that
    to each other rounding's. The roundings part by ~1e-4 to 1e-3 in the
    mean there, the kernel and its own twin by the order of f32 sums; a
    wrapper that launched another rounding, or a kernel that ignored a
    flag, sits at 0 from that rounding's twin."""
    import torch
    from patchfusion_tpu_torch.ops import vit_attention as va

    q, k, v = _qkv(b, n, h, dh, max_first=True)
    wrappers = _attention_wrappers()
    twins = {label: va.vit_attention_plain(q, k, v, *rounding).float()
             for label, (_, rounding) in wrappers.items()}
    out = {}
    for label, (fn, _) in wrappers.items():
        got = fn(q, k, v).float()
        dist = {other: (got - twin).abs().mean().item()
                for other, twin in twins.items()}
        nearest = min(d for other, d in dist.items() if other != label)
        check(dist[label] <= 0.25 * nearest,
              f"{label} B={b} N={n} Dh={dh}: mean |o - twin| {dist[label]:.3g}"
              f" to its rounding, {nearest:.3g} to the nearest other")
        out[label] = (dist[label], nearest)
    torch.cuda.synchronize()
    return out


def _attention_kernel(results):
    """The attention kernel against its twin on strided qkv views, for all
    three roundings, with scaled_dot_product_attention timed beside it as
    the yardstick."""
    import torch
    import torch.nn.functional as F
    from patchfusion_tpu_torch.ops import vit_attention as va

    for b, n, h, dh in ATTN_SHAPES:
        q, k, v = _qkv(b, n, h, dh)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = _timings(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                        "library_")
        apart = _rounding_apart(b, n, h, dh)
        for label, (fn, rounding) in _attention_wrappers().items():
            def kernel(fn=fn):
                return fn(q, k, v)

            got = kernel()
            ref = va.vit_attention_plain(q, k, v, *rounding)
            torch.cuda.synchronize()
            check(got.shape == ref.shape and got.dtype == torch.bfloat16,
                  f"{label}: {got.shape} {got.dtype}")
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
            err = (got.float() - ref.float()).abs().max().item()
            check(err <= ATTN_TOL, f"{label} B={b} N={n} Dh={dh}: abs err "
                  f"{err:.3g} > {ATTN_TOL}")
            row = {"max_abs_err": err,
                   "max_abs_out": ref.float().abs().max().item(),
                   "mean_err_own_rounding": apart[label][0],
                   "mean_err_nearest_other_rounding": apart[label][1],
                   **_timings(kernel),
                   "plain_ms": _time_ms(
                       lambda: va.vit_attention_plain(q, k, v, *rounding)),
                   **sdpa}
            row["bound_ms"], row["bound_by"] = attention_bound(b, n, h, dh)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["bound_share_device"] = row["bound_ms"] / row["device_ms"]
            results[("vit_attention", label, b, dh)] = row
            say(f"kernel {label} B={b} N={n} H={h} Dh={dh}: "
                + json.dumps(row))


def phase_kernels():
    """Each kernel against its plain twin at the main-path shapes, and the
    head kernels at the BEiT head's (phase beit's (a), run here, early:
    late in a full run the profiler has lost launches of the port's
    kernels)."""
    results = {}
    _head_kernels(results)
    _head_kernels(results, BEIT_HEAD_SHAPE, "beit")
    _attention_kernel(results)
    return results


def phase_time_only(root: Path) -> dict:
    """The B = 4 timings of step 3 for the kernels of the checkout at root
    (whose package is the one imported): bf16 nchw-view head kernels (and
    logbinomial_depth at B = 1), the three attention wrappers at the vitl
    fine shape, and SDPA."""
    import torch
    import torch.nn.functional as F
    from patchfusion_tpu_torch.ops import cuda_lib
    from patchfusion_tpu_torch.ops import fused_head as fh
    from patchfusion_tpu_torch.ops import vit_attention as va

    check(Path(fh.__file__).resolve().is_relative_to(root.resolve()),
          f"imported {fh.__file__}, not the package under {root}")
    cuda_lib.build_kernels()
    cuda_lib.load_kernels()
    dev = torch.device("cuda")
    pt, tt, ct, lt, cdt, wl = _head_inputs(4, torch.bfloat16, "nchw-view",
                                           dev)
    q, k, v = _qkv(*ATTN_SHAPES[0])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    p1, t1, c1, *_ = _head_inputs(1, torch.bfloat16, "nchw-view", dev)
    fns = {
        "clb_pt": lambda: fh.clb_pt(lt, cdt, *wl),
        "logbinomial_depth": lambda: fh.logbinomial_depth(pt, tt, ct),
        "logbinomial_depth(B=1)": lambda: fh.logbinomial_depth(p1, t1, c1),
        "clb_logbinomial_depth":
            lambda: fh.clb_logbinomial_depth(lt, cdt, ct, *wl),
        "vit_attention": lambda: va.vit_attention(q, k, v),
        "vit_attention_blocked": lambda: va.vit_attention_blocked(q, k, v),
        "vit_attention_mxsum(bf16_exp=True)":
            lambda: va.vit_attention_mxsum(q, k, v, bf16_exp=True),
        "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt),
    }
    rows = {name: _timings(fn) for name, fn in fns.items()}
    for name, row in rows.items():
        say(f"time-only {name}: " + json.dumps(row))
    return rows


def build_vitl():
    """DA-vitl PatchFusion at full width in bf16, seeded random weights."""
    import torch
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.config import Config

    cfg = Config.fromfile(str(ROOT / VITL_CONFIG)).model.config.to_dict()
    t0 = time.perf_counter()
    model = PatchFusion.from_config(cfg, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    say(f"vitl build + seeded init: {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.net.parameters()) / 1e6:.1f} M "
        "params")
    check(next(model.net.parameters()).is_cuda,
          "from_config did not build on the card by default")
    check(tuple(model.tile_cfg.image_raw_shape) == RAW_SHAPE,
          "config raw shape")
    return model


def _tiles(tc):
    ph, pw = tc.patch_raw_shape
    shifted = [(0, pw // 2), (ph // 2, 0), (ph // 2, pw // 2)]
    return {mode: sum(len(a) * len(b) for a, b in (
        tc.regular_origins(o) for o in [(0, 0)] + extra))
        for mode, extra in (("m1", []), ("m2", shifted))}


def _images(model, seed):
    """The seeded raw image and its process-resolution copy."""
    import torch
    from patchfusion_tpu_torch.ops.resize import interpolate

    rng = np.random.default_rng(100 + seed)
    hr = rng.random((*RAW_SHAPE, 3), dtype=np.float32)
    with torch.no_grad():
        lr = interpolate(torch.from_numpy(hr)[None],
                         model.tile_cfg.patch_process_shape, mode="bilinear",
                         align_corners=True).numpy()
    return lr, hr


def _request(model, mode, seed, want):
    """One request; checks the depth and that each kernel launched `want`
    times (dict name -> count). Returns (ms, depth)."""
    import torch

    lr, hr = _images(model, seed)
    before = counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    depth = model.infer(lr, hr, cai_mode=mode, process_num=PROCESS_NUM)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    after = counts()
    for name, n in want.items():
        got = after[name] - before[name]
        check(got == n, f"{mode}: {name} launched {got} times, expected {n}")
    check(depth.shape == model.tile_cfg.patch_reensemble_shape,
          f"{mode}: shape {depth.shape}")
    check(bool(np.isfinite(depth).all()), f"{mode}: non-finite depth")
    check(bool((depth > 0).all()), f"{mode}: non-positive depth")
    say(f"request {mode} #{seed}: {ms:.1f} ms, shape {depth.shape}, "
        f"range [{depth.min():.4g}, {depth.max():.4g}], launches {want}")
    return ms, depth


def _want(n_tiles, vit_blocks=(0, 0)):
    """Launches per request: the head kernels once per metric-bins head
    (the coarse head, then the fine and PF heads of every chunk;
    logbinomial_depth's tiled kernel, never its per-pixel one), the
    attention kernel once per ViT block of the coarse pass and of each
    chunk's fine pass (vit_blocks: the two branches' depths, 0 with the
    einsum attention), nothing else."""
    chunks = math.ceil(n_tiles / PROCESS_NUM)
    heads = 1 + 2 * chunks
    return {"clb_pt": heads, "logbinomial_depth": heads,
            "logbinomial_depth_pixel": 0, "clb_logbinomial_depth": 0,
            "vit_attention": vit_blocks[0] + chunks * vit_blocks[1]}


def phase_full_width(model):
    """DA-vitl at 2160x3840 in bf16, einsum attention: three m1, one m2."""
    import torch

    n_tiles = _tiles(model.tile_cfg)
    say(f"tiles per image: {n_tiles}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with attn_impl("einsum"):
        m1 = [_request(model, "m1", i, _want(n_tiles["m1"]))
              for i in range(3)]
        m2, _ = _request(model, "m2", 3, _want(n_tiles["m2"]))
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    say(f"m1 latency: cold {m1[0][0]:.1f} ms, warm {m1[1][0]:.1f} / "
        f"{m1[2][0]:.1f} ms; m2 latency {m2:.1f} ms; peak allocated "
        f"{peak / 2**30:.2f} GiB")
    return launches, [d for _, d in m1]


def phase_pallas_path(model, einsum_depths):
    """The same model and images with PF_ATTN_IMPL=pallas: every bf16
    DINOv2 attention of both branches through the attention kernel."""
    n_tiles = _tiles(model.tile_cfg)
    blocks = [len(branch.core.core.pretrained.blocks)
              for branch in (model.net.coarse_branch, model.net.fine_branch)]
    want = _want(n_tiles["m1"], blocks)
    reset_counts()
    with attn_impl("pallas"):
        runs = [_request(model, "m1", i, want) for i in range(3)]
        m2, _ = _request(model, "m2", 3, _want(n_tiles["m2"], blocks))
    launches = counts()
    for (ms, depth), ref in zip(runs, einsum_depths):
        rel = float(np.abs(depth - ref).max() / np.abs(ref).max())
        say(f"pallas vs einsum attention m1: max|diff|/max|einsum| = "
            f"{rel:.3g} (tolerance {PATH_TOL})")
        check(rel <= PATH_TOL, f"pallas path differs by {rel:.3g}")
    say(f"m1 latency with PF_ATTN_IMPL=pallas: first {runs[0][0]:.1f} ms, "
        f"then {runs[1][0]:.1f} / {runs[2][0]:.1f} ms; m2 {m2:.1f} ms; "
        f"{want['vit_attention']} attention launches per m1 image")
    return launches


def phase_depth_fused(model):
    """depth_fused on the PF head's own module and inputs (the last chunk
    of one m1 request), against the head's clb_pt + logbinomial_depth
    output and against the plain twin."""
    import torch
    from patchfusion_tpu_torch.ops import fused_head as fh

    net = model.net
    seen = {}
    head_forward = net.head_forward

    def spy(x, x_blocks, last, rel_cond):
        out = head_forward(x, x_blocks, last, rel_cond)
        seen.update(last_cat=torch.cat([last, rel_cond.to(last.dtype)], 1),
                    cond=out["b_embedding"], centers=out["bin_centers"],
                    depth=out["metric_depth"])
        return out

    net.head_forward = spy
    try:
        with attn_impl("einsum"):
            lr, hr = _images(model, 0)
            model.infer(lr, hr, cai_mode="m1", process_num=PROCESS_NUM)
    finally:
        del net.head_forward
    x_hi, cond, centers = seen["last_cat"], seen["cond"], seen["centers"]
    say(f"PF head inputs: last_cat {tuple(x_hi.shape)}, b_embedding "
        f"{tuple(cond.shape)}, bin_centers {tuple(centers.shape)}, "
        f"{x_hi.dtype}")
    clb = net.conditional_log_binomial
    reset_counts()
    with torch.no_grad():
        got = clb.depth_fused(x_hi, cond, centers)
    launches = counts()
    check(launches["clb_logbinomial_depth"] == 1,
          f"depth_fused launched {launches}")
    with torch.no_grad():
        w = clb.mlp_weights()
        plain = fh.clb_logbinomial_depth_plain(
            x_hi.permute(0, 2, 3, 1), cond.permute(0, 2, 3, 1),
            centers.permute(0, 2, 3, 1), *w, clb.min_temp, clb.max_temp,
            clb.p_eps)[:, None]
    torch.cuda.synchronize()
    two = seen["depth"]
    check(got.shape == two.shape, f"depth_fused shape {got.shape}")
    check(bool(torch.isfinite(got).all()), "depth_fused: non-finite")
    rel_two = ((got - two).abs().max() / two.abs().max()).item()
    rel_plain = ((got - plain).abs().max() / plain.abs().max()).item()
    say(f"depth_fused on the vitl PF head: {rel_two:.3g} from its clb_pt + "
        f"logbinomial_depth output (tolerance {FUSED_TOL}), {rel_plain:.3g} "
        f"from the plain twin (tolerance {TOL['bfloat16'][1]})")
    check(rel_two <= FUSED_TOL, f"depth_fused vs two kernels {rel_two:.3g}")
    check(rel_plain <= TOL["bfloat16"][1],
          f"depth_fused vs plain twin {rel_plain:.3g}")
    return launches


def _write_triple(net, root: Path):
    """The reference's three files of a PatchFusionNet: the two branch
    state dicts without their prefix and the fusion-only rest."""
    import torch

    sd = net.state_dict()
    paths = []
    for name in ("coarse_branch", "fine_branch", None):
        if name is None:
            part = {k: v for k, v in sd.items() if not k.startswith(
                ("coarse_branch.", "fine_branch."))}
        else:
            part = {k[len(name) + 1:]: v for k, v in sd.items()
                    if k.startswith(name + ".")}
        path = root / f"{name or 'fusion'}.pth"
        torch.save(part, path)
        paths.append(str(path))
    return tuple(paths)


def _eval_snapshot(model, snap: Path):
    """(a): the model's weights, in f32, as a snapshot directory, loaded back
    with from_pretrained; the m1 depth against the seeded model's."""
    import torch
    from patchfusion_tpu_torch.api import PatchFusion

    snap.mkdir()
    t = time.perf_counter()
    # bf16 -> f32 is exact, so the load's bf16 cast gives the same weights;
    # integer buffers (Swin's relative_position_index) keep their type
    torch.save({k: (v.float() if v.is_floating_point() else v).cpu()
                for k, v in model.net.state_dict().items()},
               snap / "pytorch_model.bin")
    (snap / "config.json").write_text(json.dumps({"config": model.config}))
    write_s = time.perf_counter() - t
    size = (snap / "pytorch_model.bin").stat().st_size
    t = time.perf_counter()
    loaded = PatchFusion.from_pretrained(str(snap), device="cuda",
                                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    ref_sd = model.net.state_dict()
    same = all(torch.equal(v, ref_sd[k])
               for k, v in loaded.net.state_dict().items())
    check(same, "from_pretrained weights differ from the seeded model's")
    want = _want(_tiles(model.tile_cfg)["m1"])
    with attn_impl("einsum"):
        reset_counts()
        _, ref = _request(model, "m1", 0, want)
        reset_counts()
        _, got = _request(loaded, "m1", 0, want)
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    say(f"eval: snapshot {size / 2**30:.2f} GiB written in {write_s:.1f} s, "
        f"loaded by from_pretrained (bf16, card) in {load_s:.1f} s; m1 "
        f"depth {'bitwise equal to' if rel == 0 else f'{rel:.3g} from'} "
        f"the seeded model's (tolerance {SNAPSHOT_TOL}: the same kernels "
        "on the same weights; cuDNN may pick another algorithm)")
    check(rel <= SNAPSHOT_TOL, f"snapshot model differs by {rel:.3g}")
    del loaded
    torch.cuda.empty_cache()
    return {"write_s": write_s, "load_s": load_s, "gib": size / 2**30,
            "rel": rel}


def _eval_triple(root: Path):
    """(b): the tiny config's .pth triple on the card (bf16) and the CPU."""
    import torch
    from patchfusion_tpu_torch.api import PatchFusion

    cfg = tiny_config()
    root.mkdir()
    ckpts = _write_triple(PatchFusion.from_config(
        cfg, device="cpu", seed=5).net, root)
    cpu = PatchFusion.from_config(cfg, device="cpu", seed=6, ckpts=ckpts)
    gpu = PatchFusion.from_config(cfg, device="cuda", dtype=torch.bfloat16,
                                  seed=7, ckpts=ckpts)
    rng = np.random.default_rng(8)
    hr = rng.random((84, 112, 3), dtype=np.float32)
    lr = rng.random((1, 42, 56, 3), dtype=np.float32)
    ref = cpu.infer(lr, hr, cai_mode="m1", process_num=2)
    got = gpu.infer(lr, hr, cai_mode="m1", process_num=2)
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    say(f"eval: tiny .pth triple, card bf16 vs cpu f32 m1: {rel:.3g} of max "
        f"(tolerance {TINY_TOL})")
    check(rel <= TINY_TOL, f"tiny triple differs by {rel:.3g}")


def _eval_cli(tile_cfg, snap: Path, data: Path):
    """(c): the eval CLI over a synthetic 2-scene U4K val split."""
    from patchfusion_tpu_torch.data import native
    from patchfusion_tpu_torch.tools import test as test_cli

    t = time.perf_counter()
    split = write_u4k_split(data, 2, RAW_SHAPE, seed=0)
    say(f"eval: synthetic U4K split, 2 scenes at {RAW_SHAPE[0]}x"
        f"{RAW_SHAPE[1]}, written in {time.perf_counter() - t:.1f} s")
    n_heads = _want(_tiles(tile_cfg)["m1"])["clb_pt"]
    argv = [str(ROOT / VITL_CONFIG), "--ckp-path", str(snap),
            "--cai-mode", "m1", "--image-raw-shape", *map(str, RAW_SHAPE),
            "--work-dir", str(data / "work"), "--cfg-options",
            f"val_dataloader.dataset.data_root={data}",
            f"val_dataloader.dataset.split={split}"]
    with attn_impl("einsum"):
        reset_counts()
        t = time.perf_counter()
        tester = test_cli.evaluate(argv)
        cli_s = time.perf_counter() - t
        launches = counts()
    metrics = tester.metrics
    n_images = len(tester.image_seconds)
    check(n_images == 2, f"the CLI tested {n_images} images, not 2")
    check(bool(metrics) and all(math.isfinite(v) for v in metrics.values()),
          f"eval metrics not finite: {metrics}")
    for name in ("clb_pt", "logbinomial_depth"):
        check(launches[name] == n_heads * n_images,
              f"eval CLI: {name} launched {launches[name]} times, expected "
              f"{n_heads} per image")
    for i, sec in enumerate(tester.image_seconds):
        say(f"eval CLI image {i}: load {sec['load']:.3f} s, inference "
            f"{sec['inference']:.3f} s, metrics {sec['metrics']:.3f} s")
    say(f"eval CLI: {cli_s:.1f} s in all (model load included), host IO "
        f"{native.backend()}, head launches {launches['clb_pt']} + "
        f"{launches['logbinomial_depth']}, metrics "
        + json.dumps({k: round(v, 4) for k, v in metrics.items()}))
    return {"image_seconds": tester.image_seconds, "cli_s": cli_s,
            "host_io": native.backend(), "launches": launches}


def _eval_baseline(model):
    """(d): BaselinePretrain coarse and fine from the vitl pretrain
    configs, seeded, bf16, one image each."""
    import torch
    from patchfusion_tpu_torch.api import BaselinePretrain
    from patchfusion_tpu_torch.config import Config

    lr, hr = _images(model, 0)
    for target in ("coarse", "fine"):
        cfg = Config.fromfile(str(ROOT / BASELINE_CONFIG.format(target)))
        mcfg = cfg.model
        pps = tuple(cfg.train_dataloader.dataset.transform_cfg
                    .network_process_size)
        bp = BaselinePretrain(
            mcfg[f"{target}_branch"].to_dict(), mcfg.min_depth,
            mcfg.max_depth, target=mcfg.target,
            image_raw_shape=model.tile_cfg.image_raw_shape,
            patch_split_num=model.tile_cfg.patch_split_num,
            patch_process_shape=pps,
            dtype=torch.bfloat16, seed=0)
        want = 1 if target == "coarse" else math.ceil(
            _tiles(bp.tile_cfg)["m1"] / PROCESS_NUM)
        reset_counts()
        t = time.perf_counter()
        depth = bp.infer(image_lr=lr, image_hr=hr, cai_mode="m1",
                         process_num=PROCESS_NUM)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = counts()
        check(bool(np.isfinite(depth).all()) and bool((depth > 0).all()),
              f"BaselinePretrain {target}: depth not finite and positive")
        for name in ("clb_pt", "logbinomial_depth"):
            check(launches[name] == want,
                  f"BaselinePretrain {target}: {name} launched "
                  f"{launches[name]} times, expected {want}")
        say(f"eval: BaselinePretrain {target} m1: {ms:.1f} ms (first call), "
            f"depth {depth.shape} in [{depth.min():.4g}, {depth.max():.4g}],"
            f" head kernels {want} + {want}")
        del bp
        torch.cuda.empty_cache()


def phase_eval(model):
    """Step 7: the checkpoint and eval path at DA-vitl 2160x3840 bf16."""
    import tempfile

    import torch

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="pf_eval_") as tmp:
        root = Path(tmp)
        snap = _eval_snapshot(model, root / "snapshot")
        _eval_triple(root / "triple")
        cli = _eval_cli(model.tile_cfg, root / "snapshot", root / "u4k")
    _eval_baseline(model)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = {**snap, **cli, "peak_gib": peak}
    say("eval summary: " + json.dumps(out))
    return out


def phase_tiny():
    """bf16 on the card (kernels; einsum and pallas attention) vs float32
    on the CPU (plain twins)."""
    import torch
    from patchfusion_tpu_torch.api import PatchFusion

    cfg = tiny_config()
    cpu = PatchFusion.from_config(cfg, device="cpu", dtype=torch.float32,
                                  seed=1)
    gpu = PatchFusion.from_config(cfg, device="cuda", dtype=torch.bfloat16,
                                  seed=1)
    gpu.net.load_state_dict(cpu.net.state_dict())
    rng = np.random.default_rng(7)
    hr = rng.random((84, 112, 3), dtype=np.float32)
    lr = rng.random((1, 42, 56, 3), dtype=np.float32)
    ref = cpu.infer(lr, hr, cai_mode="m1", process_num=2)
    for impl in ("einsum", "pallas"):
        before = counts()["vit_attention"]
        with attn_impl(impl):
            got = gpu.infer(lr, hr, cai_mode="m1", process_num=2)
        ran = counts()["vit_attention"] - before
        check((ran > 0) == (impl == "pallas"),
              f"tiny {impl}: {ran} attention launches")
        check(got.shape == ref.shape,
              f"tiny: shape {got.shape} vs {ref.shape}")
        rel = float(np.abs(got - ref).max() / np.abs(ref).max())
        say(f"tiny m1 bf16 card ({impl} attention) vs f32 cpu: "
            f"max|diff|/max|ref| = {rel:.3g} (tolerance {TINY_TOL})")
        check(rel <= TINY_TOL, f"tiny config ({impl}) differs by {rel:.3g}")
    _tiny_zoe()


def _tiny_zoe():
    """The toy zoedepth config (BEiT_tiny) in bf16 on the card against the
    same seeded weights in float32 on the CPU, m1 at 128x192, with the head
    kernels launched once per metric-bins head."""
    import torch
    from patchfusion_tpu_torch.api import PatchFusion

    cfg = tiny_zoe_config()
    cpu = PatchFusion.from_config(cfg, device="cpu", dtype=torch.float32,
                                  seed=1)
    gpu = PatchFusion.from_config(cfg, device="cuda", dtype=torch.bfloat16,
                                  seed=1)
    gpu.net.load_state_dict(cpu.net.state_dict())
    rng = np.random.default_rng(9)
    hr = rng.random((128, 192, 3), dtype=np.float32)
    lr = rng.random((1, 64, 96, 3), dtype=np.float32)
    ref = cpu.infer(lr, hr, cai_mode="m1", process_num=2)
    reset_counts()
    got = gpu.infer(lr, hr, cai_mode="m1", process_num=2)
    launches = counts()
    check(got.shape == ref.shape, f"tiny zoe: shape {got.shape}")
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    say(f"tiny zoedepth m1 bf16 card vs f32 cpu: max|diff|/max|ref| = "
        f"{rel:.3g} (tolerance {TINY_TOL}); head launches "
        f"{launches['clb_pt']} + {launches['logbinomial_depth']}")
    check(rel <= TINY_TOL, f"tiny zoedepth config differs by {rel:.3g}")
    check(launches["clb_pt"] == launches["logbinomial_depth"] == 5
          and launches["logbinomial_depth_pixel"] == 0,
          f"tiny zoedepth launches {launches}")


# ---------------------------------------------------------------------------
# phase train: the fusion-stage training path
# ---------------------------------------------------------------------------

# the recompute backward's gradients against autograd through the twin on
# the same inputs, relative to each gradient's max: f32 sums in another
# order (the resizes' backward uses atomics); a bf16 input's gradient is
# rounded to bf16 last, where such a difference may reach the neighbouring
# bf16 value
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
TRAIN_STEPS_PER_EPOCH = 5  # 20 crops of 4 synthetic 4K scenes, batch 4
# a resumed state against the live one on the same batch, relative loss:
# the first forward reads the same weights (cuDNN's and the resizes'
# atomics aside); the second follows one optimizer step on each side,
# whose backward sums with atomics in any order
RESUME_TOL = (1e-5, 1e-3)
REMAT_TOL = 1e-5   # remat vs not: the same forward, relative loss
# the tiny config's train step on the card against the f32 CPU port:
# f32 (TF32 off) loss relative; each gradient relative to its max, the
# U-Net encoder's apart (its BatchNorms see few values: on these weights
# the CPU's own f32 gradient there sits 3.0e-3 of max from float64, the
# rest within 5e-5); --amp (bf16 autocast, the head kernels) loss
TINY_TRAIN_TOL = (1e-5, 1e-3, 1e-2, 5e-2)
# and the --amp gradients' cosine to the f32 CPU's outside the encoder
# (with the CPU's autocast 0.999 on these weights and this batch, 0.72
# with the encoder; a permuted or wrong gradient sits near 0)
AMP_COS = 0.95
ENCODER = ("guided_fusion.inc.", "guided_fusion.down_conv_list.")


def _grad_leaves(b, dev):
    """The head's inputs at B = b (bf16 maps as permuted views of NCHW
    leaves, as the model passes them; f32 weights, as the --amp masters),
    each a leaf that requires grad: (p, t, centers, last_cat, cond_lo,
    w1, b1, w2, b2) as (leaf, argument) pairs."""
    import torch

    pt, tt, ct, lt, cdt, wl = _head_inputs(b, torch.bfloat16, "nchw-view",
                                           dev)
    out = [(x.detach().clone().requires_grad_(),) * 2 for x in (pt, tt)]
    for view in (ct, lt, cdt):
        leaf = view.permute(0, 3, 1, 2).detach().clone().requires_grad_()
        out.append((leaf, leaf.permute(0, 2, 3, 1)))
    out += [(w.float().detach().clone().requires_grad_(),) * 2 for w in wl]
    return out


HEAD_ARGS = {"clb_pt": (3, 4, 5, 6, 7, 8), "logbinomial_depth": (0, 1, 2),
             "clb_logbinomial_depth": (3, 4, 2, 5, 6, 7, 8)}


def _head_gradients():
    """Each head wrapper with inputs that require grad, at B = 4 on the
    head's shapes: one kernel launch forward, none backward; the recompute
    backward's gradients against autograd through the twin (GRAD_TOL), and
    the backward's time against the kernel forward's and the twin's own
    backward."""
    import torch
    from patchfusion_tpu_torch.ops import fused_head as fh

    dev = torch.device("cuda")
    rows = {}
    for name, idx in HEAD_ARGS.items():
        wrapper, plain = getattr(fh, name), getattr(fh, name + "_plain")
        got = [_grad_leaves(4, dev)[i] for i in idx]
        want = [_grad_leaves(4, dev)[i] for i in idx]
        before = counts()[name]
        out = wrapper(*(a for _, a in got))
        check(counts()[name] == before + 1, f"{name}: forward launches")
        out = out if isinstance(out, tuple) else (out,)
        ref = plain(*(a for _, a in want))
        ref = ref if isinstance(ref, tuple) else (ref,)
        gen = torch.Generator(dev).manual_seed(5)
        cot = [torch.randn(o.shape, device=dev, generator=gen) for o in out]
        leaves = [leaf for leaf, _ in got]
        g = torch.autograd.grad(out, leaves, cot, retain_graph=True)
        w = torch.autograd.grad(ref, [leaf for leaf, _ in want], cot,
                                retain_graph=True)
        torch.cuda.synchronize()
        check(counts()[name] == before + 1, f"{name}: backward launched")
        errs = []
        for leaf, gi, wi in zip(leaves, g, w):
            check(gi.shape == leaf.shape and gi.dtype == leaf.dtype,
                  f"{name}: gradient {gi.shape} {gi.dtype}")
            check(bool(torch.isfinite(gi).all()), f"{name}: gradient nan")
            rel = ((gi.float() - wi.float()).abs().max()
                   / wi.float().abs().max()).item()
            tol = GRAD_TOL[str(leaf.dtype).split(".")[-1]]
            check(rel <= tol, f"{name}: gradient {rel:.3g} from the "
                  f"twin's (tolerance {tol})")
            errs.append(rel)
        args = [a.detach() for _, a in got]
        device_ms, windows, _ = _device_ms(lambda: torch.autograd.grad(
            out, leaves, cot, retain_graph=True))
        row = {"max_grad_rel_err": max(errs),
               "forward_ms": _time_ms(lambda: wrapper(*args)),
               "backward_ms": _time_ms(lambda: torch.autograd.grad(
                   out, leaves, cot, retain_graph=True)),
               "backward_device_ms": device_ms,
               "backward_device_windows": windows,
               "twin_backward_ms": _time_ms(lambda: torch.autograd.grad(
                   ref, [leaf for leaf, _ in want], cot,
                   retain_graph=True))}
        rows[name] = row
        say(f"train: {name} gradients (B=4, bf16 maps, f32 weights): "
            + json.dumps(row))
        del out, ref, g, w
    torch.cuda.empty_cache()
    return rows


def _train_data(root: Path):
    """4 synthetic 4K U4K scenes: a train split of 20 crops (each scene 5
    times) and a val split of one scene."""
    split = Path(write_u4k_split(root, 4, RAW_SHAPE, seed=3))
    lines = split.read_text().splitlines(keepends=True)
    train = root / "train.txt"
    train.write_text("".join(lines * TRAIN_STEPS_PER_EPOCH))
    val = root / "val1.txt"
    val.write_text(lines[0])
    return str(train), str(val)


def _train_options(root: Path, train: str, val: str, epochs: int):
    return [f"model.config.load_branch=False",
            f"train_dataloader.dataset.data_root={root}",
            f"train_dataloader.dataset.split={train}",
            "train_dataloader.num_workers=6",
            f"val_dataloader.dataset.data_root={root}",
            f"val_dataloader.dataset.split={val}",
            f"train_cfg.max_epochs={epochs}", "train_cfg.val_interval=2",
            "train_cfg.save_checkpoint_interval=1",
            "train_cfg.log_interval=1",
            "train_cfg.train_log_img_interval=100000"]


@contextlib.contextmanager
def _spy_training(per_step: list, created: list):
    """Counts each train step's kernel launches into per_step and keeps
    a CPU copy of the weights as create_train_state leaves them in
    created."""
    from patchfusion_tpu_torch.engine import training

    make_step, create = training.make_train_step, training.create_train_state

    def counted_make(*a, **k):
        step = make_step(*a, **k)

        def counted(state, batch):
            before = counts()
            logs = step(state, batch)
            after = counts()
            per_step.append({n: after[n] - before[n] for n in after})
            return logs
        return counted

    def snap_create(*a, **k):
        state = create(*a, **k)
        created.append({
            "trainable": {n: p.detach().cpu().clone()
                          for n, p in state.trainable.items()},
            "frozen": {n: p.detach().cpu().clone()
                       for n, p in state.frozen.items()},
            "batch_stats": {n: b.cpu().clone()
                            for n, b in state.batch_stats.items()}})
        return state

    training.make_train_step, training.create_train_state = \
        counted_make, snap_create
    try:
        yield
    finally:
        training.make_train_step, training.create_train_state = \
            make_step, create


def _train_cli(root: Path, train: str, val: str):
    """The vitl fusion stage through tools.train (in-process: its main is
    what `python -m` runs) with --amp at batch 4: 2 epochs of 5 steps, m1
    validation after epoch 2, a checkpoint per epoch."""
    from patchfusion_tpu_torch.tools import train as train_cli

    per_step, created = [], []
    argv = [str(ROOT / VITL_CONFIG), "--amp", "--seed", "0", "--work-dir",
            str(root / "work"), "--cfg-options",
            *_train_options(root, train, val, 2)]
    reset_counts()
    t = time.perf_counter()
    with attn_impl("einsum"), _spy_training(per_step, created):
        trainer = train_cli.main(argv)
    wall = time.perf_counter() - t
    state, start = trainer.state, created[0]
    steps = 2 * TRAIN_STEPS_PER_EPOCH
    check(state.step == steps, f"train: {state.step} steps, not {steps}")
    losses = [x for e in trainer.epoch_stats for x in e["losses"]]
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"train: losses {losses}")
    for i, n in enumerate(per_step):
        check(n["clb_pt"] == 3 and n["logbinomial_depth"] == 3
              and n["vit_attention"] == 0
              and n["clb_logbinomial_depth"] == 0,
              f"train step {i}: launches {n}")
    moved = sum(not torch_equal(p, start["trainable"][n])
                for n, p in state.trainable.items())
    check(moved >= len(start["trainable"]) - 2 * 6,
          f"train: only {moved} of {len(start['trainable'])} trainable "
          "tensors moved")
    check(all(torch_equal(p, start["frozen"][n])
              for n, p in state.frozen.items()),
          "train: a frozen weight moved")
    stats = {n: b for n, b in state.batch_stats.items()
             if n.endswith("running_var")}
    check(all(not torch_equal(b, start["batch_stats"][n])
              for n, b in stats.items()), "train: BN statistics did not move")
    metrics = trainer.val_metrics.get(2, {})
    check(bool(metrics) and all(map(math.isfinite, metrics.values())),
          f"train: val metrics {metrics}")
    for e in (1, 2):
        check((root / "work" / f"checkpoint_{e:02d}.ckpt").exists(),
              f"train: no checkpoint for epoch {e}")
    # one train sample (4K decode, rotation, colour, crop) on one thread
    t = time.perf_counter()
    trainer.train_loader.dataset[0]
    sample_s = time.perf_counter() - t
    epochs = trainer.epoch_stats
    step_s = [x for e in epochs for x in e["step_seconds"]]
    waits = [x for e in epochs for x in e["data_wait_seconds"]]
    warm = step_s[1:]
    seconds = [e["seconds"] for e in epochs]
    out = {"steps": steps, "losses": losses,
           # the end-to-end rate: every image over the epochs' wall time
           # (loader waits, the first step and any slow step included)
           "images_per_s": 4 * steps / sum(seconds),
           "epoch_seconds": seconds,
           "epoch_images_per_s": [4 * e["steps"] / e["seconds"]
                                  for e in epochs],
           # the step alone, between CUDA events once the batch is there
           "first_step_s": step_s[0],
           "warm_step_s_median": float(np.median(warm)),
           "warm_step_s": warm,
           "data_wait_s": [e["data_wait_seconds"] for e in epochs],
           "data_wait_s_median": float(np.median(waits)),
           "data_wait_s_max": max(waits),
           "loader_sample_s": sample_s,
           "peak_gib": max(e["peak_allocated_bytes"]
                           for e in epochs) / 2**30,
           "launches_per_step": per_step,
           "launches": {name: sum(n[name] for n in per_step)
                        for name in per_step[0]},
           "wall_s": wall, "val_metrics": metrics}
    say(f"train: vitl fusion, batch 4, --amp: {steps} steps in "
        f"{sum(seconds):.3f} s of epochs ({out['images_per_s']:.3f} "
        f"images/s; per epoch {[round(x, 3) for x in seconds]} s), warm "
        f"step median {out['warm_step_s_median']:.3f} s, first step "
        f"{step_s[0]:.3f} s, loader wait median "
        f"{out['data_wait_s_median']:.4f} s and max "
        f"{out['data_wait_s_max']:.3f} s (per epoch, the first batch: "
        f"{[round(e['data_wait_seconds'][0], 3) for e in epochs]} s; one "
        f"sample alone {sample_s:.3f} s), "
        f"peak allocated {out['peak_gib']:.2f} GiB, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, launches "
        f"{out['launches']}, wall {wall:.1f} s")
    return trainer, out


def torch_equal(a, b) -> bool:
    """Bitwise equality of a tensor on any device with a CPU copy."""
    import torch

    return bool(torch.equal(a.detach().cpu(), b))


def _fixed_batch(trainer):
    from patchfusion_tpu_torch.engine.trainer import STEP_KEYS, collect_input
    from patchfusion_tpu_torch.engine.training import to_device_batch

    batch = next(iter(trainer.train_loader))
    return to_device_batch(collect_input(batch, STEP_KEYS), "cuda",
                           STEP_KEYS)


def _vitl_state(remat: bool = False):
    """A fresh seeded vitl fusion-stage state (seed 0, --amp)."""
    import torch
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.config import Config
    from patchfusion_tpu_torch.engine import training

    cfg = Config.fromfile(str(ROOT / VITL_CONFIG)).model.config.to_dict()
    cfg.update(load_branch=False, train_remat=remat)
    net = PatchFusion.from_config(cfg, device="cuda", seed=0).net
    return training.create_train_state(
        net, training.make_onecycle_optimizer(1e-4, 10),
        frozen_dtype=torch.bfloat16, amp=True)


def _resume(root: Path, batch):
    """Save and resume at vitl width: a fresh seeded state takes 3 steps on
    one batch and is saved (save_checkpoint); a second fresh model
    restored from that file (restore_train_state, as --resume does) holds
    the same weights, and the two then take two more steps each on the
    batch with the same losses (RESUME_TOL), at the schedule's peak: the
    weights, BN statistics, Adam moments and schedule position came
    back."""
    from patchfusion_tpu_torch.engine import checkpoint, training

    ckpt = root / "resume.ckpt"
    step = training.make_train_step()
    live = _vitl_state()
    for _ in range(3):
        step(live, batch)
    checkpoint.save_checkpoint(str(ckpt), live, epoch=1)
    state = _vitl_state()
    epoch = checkpoint.restore_train_state(
        state, checkpoint.load_checkpoint(str(ckpt)))
    check(epoch == 1 and state.step == live.step == 3,
          f"resume: epoch {epoch}, step {state.step}")
    check(all(torch_equal(p, live.trainable[n].detach().cpu())
              for n, p in state.trainable.items()),
          "resume: restored weights differ from the live ones")
    losses = []
    for _ in range(2):
        a = float(step(live, batch)["total_loss"])
        b = float(step(state, batch)["total_loss"])
        losses.append((a, b))
    for (a, b), tol in zip(losses, RESUME_TOL):
        check(abs(a - b) <= tol * abs(a),
              f"resume: loss {b} against the live {a} (tolerance {tol})")
    say(f"train: save at step 3 and resume: losses (live, restored) "
        f"{losses} (tolerance {RESUME_TOL}), "
        f"{ckpt.stat().st_size / 2**20:.1f} MiB checkpoint, lr "
        f"{live.tx.lr(3):.3g} at step 3")
    return {"losses": losses, "ckpt_mib": ckpt.stat().st_size / 2**20}


def _remat(batch):
    """One step with and without train_remat from the same seeded weights
    on the same batch: the same loss (REMAT_TOL), the peaks of each, and
    the PF head's kernels launched again in the recompute."""
    import torch
    from patchfusion_tpu_torch.engine import training

    out = {}
    for remat in (False, True):
        torch.cuda.empty_cache()
        state = _vitl_state(remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        loss = float(training.make_train_step()(state, batch)["total_loss"])
        torch.cuda.synchronize()
        launches = counts()
        out[remat] = {"loss": loss, "launches": launches,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "state_gib": base / 2**30}
        del state
    torch.cuda.empty_cache()
    rel = abs(out[True]["loss"] - out[False]["loss"]) / abs(
        out[False]["loss"])
    check(rel <= REMAT_TOL, f"remat loss differs by {rel:.3g}")
    check(out[True]["launches"]["clb_pt"] == 4
          and out[False]["launches"]["clb_pt"] == 3,
          f"remat launches {out[True]['launches']} vs "
          f"{out[False]['launches']}")
    say(f"train: one step, remat off / on: loss {out[False]['loss']:.6f} / "
        f"{out[True]['loss']:.6f} ({rel:.3g}, tolerance {REMAT_TOL}); peak "
        f"allocated {out[False]['peak_gib']:.2f} / {out[True]['peak_gib']:.2f}"
        f" GiB (state before the step {out[False]['state_gib']:.2f} GiB); "
        f"clb_pt launches {out[False]['launches']['clb_pt']} / "
        f"{out[True]['launches']['clb_pt']}")
    return {str(k): v for k, v in out.items()}


def _branch(root: Path, train: str):
    """Two steps of tools.train_branch for vitl coarse (f32, batch 4)."""
    import torch
    from patchfusion_tpu_torch.tools import train_branch

    eight = root / "train8.txt"
    eight.write_text("".join(Path(train).read_text().splitlines(
        keepends=True)[:8]))
    argv = [str(ROOT / BASELINE_CONFIG.format("coarse")), "--seed", "0",
            "--work-dir", str(root / "branch"), "--cfg-options",
            f"train_dataloader.dataset.data_root={root}",
            f"train_dataloader.dataset.split={eight}",
            "train_dataloader.num_workers=6", "train_cfg.max_epochs=1",
            "train_cfg.log_interval=1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    with attn_impl("einsum"):
        state, losses = train_branch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(state.step == 2 and all(map(math.isfinite, losses)),
          f"branch: {state.step} steps, losses {losses}")
    check((root / "branch" / "checkpoint_01.ckpt").exists(),
          "branch: no weights file")
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = counts()
    say(f"train: tools.train_branch vitl coarse, batch 4, f32: 2 steps, "
        f"losses {losses}, peak allocated {peak:.2f} GiB, {wall:.1f} s; "
        f"head kernels {launches['clb_pt']} (the f32 head is unfused)")
    del state
    torch.cuda.empty_cache()
    return {"losses": losses, "peak_gib": peak, "wall_s": wall}


def _tiny_train():
    """The tiny config's train step on the card, f32 and --amp, against the
    f32 CPU port on the same seeded weights and batch (TINY_TRAIN_TOL)."""
    import torch
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.engine import training
    from patchfusion_tpu_torch.models.losses import SILogLoss

    rng = np.random.default_rng(12)
    batch = {"image_lr": rng.random((4, 42, 56, 3), dtype=np.float32),
             "crops_image_hr": rng.random((4, 42, 56, 3), dtype=np.float32),
             "crop_depths": rng.random((4, 42, 56, 1), dtype=np.float32)
             * 40 + 1,
             "bboxs": np.array([[0, 0, 960, 540], [960, 540, 1920, 1080],
                                [2880, 0, 3840, 540],
                                [1920, 1620, 2880, 2160]], np.float32)}
    out = {}
    # seeded on the CPU, and the same weights on the card (the two devices'
    # generators draw other numbers from one seed)
    weights = PatchFusion.from_config(tiny_config(), device="cpu",
                                      seed=4).net.state_dict()
    for name, dev, amp in (("cpu", "cpu", False), ("card", "cuda", False),
                           ("card_amp", "cuda", True)):
        model = PatchFusion.from_config(tiny_config(), device=dev, seed=4)
        model.net.load_state_dict(weights)
        state = training.create_train_state(
            model.net, training.make_onecycle_optimizer(1e-4, 10),
            frozen_dtype=torch.bfloat16 if amp else None, amp=amp)
        reset_counts()
        loss, _ = training.fusion_loss(
            state, training.to_device_batch(batch, dev, batch.keys()),
            SILogLoss(), 1e-3, 80.0)
        out[name] = (float(loss), {n: p.grad.detach().double().cpu()
                                   for n, p in state.trainable.items()},
                     counts())
    lf, gf, _ = out["cpu"]
    loss_tol, grad_tol, enc_tol, amp_tol = TINY_TRAIN_TOL
    rel = abs(out["card"][0] - lf) / abs(lf)
    check(rel <= loss_tol, f"tiny train f32 loss {rel:.3g} from the CPU")
    errs = {n: ((g - gf[n]).abs().max() / gf[n].abs().max()).item()
            for n, g in out["card"][1].items() if gf[n].abs().max() > 0}
    worst = max(e for n, e in errs.items() if not n.startswith(ENCODER))
    worst_enc = max(e for n, e in errs.items() if n.startswith(ENCODER))
    check(worst <= grad_tol and worst_enc <= enc_tol,
          f"tiny train f32 gradients {worst:.3g} (encoder {worst_enc:.3g}) "
          "from the CPU")
    la, ga, launches = out["card_amp"]
    amp_rel = abs(la - lf) / abs(lf)
    check(amp_rel <= amp_tol, f"tiny train --amp loss {amp_rel:.3g} from "
          "the f32 CPU")
    check(launches["clb_pt"] == 3 and launches["logbinomial_depth"] == 3,
          f"tiny train --amp launches {launches}")
    def cosine(names):
        a, b = (torch.cat([g[n].flatten() for n in names]) for g in (gf, ga))
        return torch.nn.functional.cosine_similarity(a, b, dim=0).item()

    cos = cosine(sorted(gf))
    cos_rest = cosine([n for n in sorted(gf) if not n.startswith(ENCODER)])
    check(cos_rest >= AMP_COS, f"tiny train --amp gradients: cosine "
          f"{cos_rest:.4f} to the f32 CPU's outside the encoder")
    say(f"train: tiny config, card vs f32 CPU: f32 loss {rel:.3g}, "
        f"gradients {worst:.3g} of max, the U-Net encoder's {worst_enc:.3g} "
        f"(tolerances {loss_tol}, {grad_tol}, {enc_tol}); "
        f"--amp loss {amp_rel:.3g} (tolerance {amp_tol}), gradient cosine "
        f"{cos_rest:.4f} outside the encoder (at least {AMP_COS}), "
        f"{cos:.4f} with it, head launches {launches['clb_pt']} + "
        f"{launches['logbinomial_depth']}")
    return {"f32_loss_rel": rel, "f32_grad_rel": worst,
            "f32_encoder_grad_rel": worst_enc, "amp_loss_rel": amp_rel,
            "amp_grad_cos": cos, "amp_grad_cos_outside_encoder": cos_rest}


def phase_train():
    """Step 9: the fusion-stage training path on the card."""
    import tempfile

    import torch

    out = {"heads": _head_gradients(), "tiny": _tiny_train()}
    with tempfile.TemporaryDirectory(prefix="pf_train_") as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        train, val = _train_data(root)
        say(f"train: synthetic U4K train split, 4 scenes at {RAW_SHAPE[0]}x"
            f"{RAW_SHAPE[1]}, written in {time.perf_counter() - t:.1f} s")
        trainer, out["fusion"] = _train_cli(root, train, val)
        batch = _fixed_batch(trainer)
        del trainer
        torch.cuda.empty_cache()
        out["resume"] = _resume(root, batch)
        torch.cuda.empty_cache()
        out["remat"] = _remat(batch)
        out["branch"] = _branch(root, train)
    say("train summary: " + json.dumps(
        {k: v for k, v in out.items() if k != "heads"}))
    return out


# ---------------------------------------------------------------------------
# phase surface: the research losses, export / convert, synthetic data and
# the demo recipe, profiling, the call shim
# ---------------------------------------------------------------------------

DEMO_CONFIG = "configs/demo/train_fusion_synth_vitl.py"
LOSS_TOL = 1e-4  # each research loss, card against CPU, relative


def _synth_data(root: Path) -> dict:
    """(d): 2 train and 1 val synthetic U4K scenes at 2160x3840 from the
    port's make_synth_u4k (its main, what `python -m` runs), --oversample
    2; the seconds per scene."""
    from patchfusion_tpu_torch.tools import make_synth_u4k

    t = time.perf_counter()
    lines = make_synth_u4k.main([
        "--root", str(root), "--n-train", "2", "--n-val", "1",
        "--oversample", "2", "--seed", "0", "--height", str(RAW_SHAPE[0]),
        "--width", str(RAW_SHAPE[1])])
    per_scene = (time.perf_counter() - t) / len(lines)
    check(len(lines) == 3 and (root / "train_x2.txt").exists(),
          "make_synth_u4k: split files")
    say(f"surface: make_synth_u4k (no OpenCV) wrote 3 scenes at "
        f"{RAW_SHAPE[0]}x{RAW_SHAPE[1]}, {per_scene:.2f} s per scene")
    return {"synth_s_per_scene": per_scene}


def _demo_options(root: Path):
    """The demo config pointed at the synthetic scenes, one epoch."""
    return [f"train_dataloader.dataset.data_root={root}",
            f"train_dataloader.dataset.split={root / 'train_x2.txt'}",
            f"val_dataloader.dataset.data_root={root}",
            f"val_dataloader.dataset.split={root / 'val.txt'}",
            "train_cfg.max_epochs=1", "train_cfg.log_interval=1"]


def _loss_batch(root: Path):
    """4 train crops (392x518 of the synthetic 4K scenes, the demo
    config's train loader at batch 4) as NCHW tensors on the card."""
    from patchfusion_tpu_torch.engine.trainer import STEP_KEYS, collect_input
    from patchfusion_tpu_torch.engine.training import to_device_batch
    from patchfusion_tpu_torch.models.patchfusion import TileConfig
    from patchfusion_tpu_torch.tools import train as train_cli

    cfg = train_cli.load_config(str(ROOT / DEMO_CONFIG),
                                [*_demo_options(root),
                                 "train_dataloader.batch_size=4"])
    mc = cfg.model.config
    tc = TileConfig(tuple(mc.image_raw_shape), tuple(mc.patch_split_num),
                    tuple(mc.patch_process_shape))
    loader = train_cli.build_loader(cfg.train_dataloader, True, 0,
                                    patch_raw_shape=tc.patch_raw_shape)
    batch = next(iter(loader))
    return to_device_batch(collect_input(batch, STEP_KEYS), "cuda",
                           STEP_KEYS)


def _research_losses(pred, coarse, batch, probs, gen=None, draws=None):
    """({name: loss}, the ranking loss's draws) of SILog and the research
    losses on one prediction, float32 tensors on one device: SSI and
    Exist on the prediction and the coarse depth brought to the crops'
    depth size (bilinear, align_corners=True, as SILog does), ErrorLoss
    and EdgeClsLoss over the class probabilities `probs` (EdgeClsLoss on
    ErrorLoss's labels). gen: the ranking loss's generator; or draws: its
    samples, injected."""
    from patchfusion_tpu_torch.models import losses as L
    from patchfusion_tpu_torch.ops.resize import interpolate_nchw

    gt = batch["crop_depths"]
    mask = (gt > 1e-3) & (gt < 80.0)
    pred_up, coarse_up = (
        interpolate_nchw(x, tuple(gt.shape[-2:]), align_corners=True)
        for x in (pred, coarse))
    rank = L.EdgeguidedRankingLoss()
    if draws is None:
        sample, drawn = rank.sample, []

        def spy(ok, g):  # keeps the draws for the CPU's run
            drawn.append(sample(ok, g))
            return drawn[-1]

        rank.sample = spy
        ranking = rank(pred, gt, batch["crops_image_hr"], gt, generator=gen)
        draws = drawn[0]
    else:
        ranking = rank(pred, gt, batch["crops_image_hr"], gt,
                       anchor_rc=draws[0], dist=draws[1], direct_p=draws[2])
    e_dice, e_focal, labels = L.ErrorLoss("incoh_grad_depth")(
        probs, gt, coarse, 1e-3, 80.0)
    c_dice, c_focal = L.EdgeClsLoss()(probs, labels)
    out = {"silog": L.SILogLoss()(pred, gt, 1e-3, 80.0),
           "ssi": L.ScaleAndShiftInvariantLoss()(pred_up, gt, mask),
           "exist": L.ExistLoss()(L._sobel_grad_map(pred_up),
                                  L._sobel_grad_map(coarse_up), mask),
           "ranking": ranking,
           "error_dice": e_dice, "error_focal": e_focal,
           "edge_dice": c_dice, "edge_focal": c_focal}
    return out, draws


def _surface_losses(root: Path) -> dict:
    """(a): one DA-vitl fusion train_forward at batch 4 with --amp; SILog
    and each research loss on its prediction (the coarse prediction: the
    ROI of the coarse depth the fusion stage reads), finite and within
    LOSS_TOL of the port's CPU values on the same tensors; the sum's
    backward finite on the fusion parameters; head launches 3 + 3 forward,
    none in the recompute backward; each loss's time on CUDA events."""
    import torch
    from patchfusion_tpu_torch.models import losses as L
    from patchfusion_tpu_torch.ops.resize import interpolate_nchw

    batch = _loss_batch(root)
    state = _vitl_state()
    net = state.net
    seen = {}
    post = net.coarse_postprocess

    def spy(*a, **k):
        out = post(*a, **k)
        seen["coarse"] = out[0]
        return out

    net.coarse_postprocess = spy
    reset_counts()
    try:
        with attn_impl("einsum"), torch.autocast("cuda",
                                                 dtype=torch.bfloat16):
            pred = net.train_forward(batch["image_lr"],
                                     batch["crops_image_hr"],
                                     batch["bboxs"])
    finally:
        del net.coarse_postprocess
    torch.cuda.synchronize()
    forward = counts()
    pred = pred.float()
    coarse = seen["coarse"].float()
    hw = tuple(net.patch_process_shape)
    check(tuple(pred.shape) == (4, 1, *hw), f"losses: pred {pred.shape}")
    gen = torch.Generator("cuda").manual_seed(0)
    probs = torch.softmax(torch.randn((4, 3, *hw), generator=gen,
                                      device="cuda"), 1)
    card, draws = _research_losses(pred, coarse, batch, probs, gen=gen)
    anchors, dist, _ = draws
    check(anchors.shape == (4, 10000, 2) and int(dist.min()) >= 2
          and int(dist.max()) <= 30, "losses: ranking draws")
    cpu, _ = _research_losses(
        pred.detach().cpu(), coarse.cpu(),
        {k: v.cpu() for k, v in batch.items()}, probs.cpu(),
        draws=[d.cpu() for d in draws])
    rels = {}
    for name, v in card.items():
        a, b = v.item(), cpu[name].item()
        check(math.isfinite(a), f"losses: {name} = {a}")
        rels[name] = abs(a - b) / max(abs(b), 1e-12)
        check(rels[name] <= LOSS_TOL, f"losses: {name} {a} on the card, "
              f"{b} on the CPU ({rels[name]:.3g}, tolerance {LOSS_TOL})")
    reset_counts()
    sum(card.values()).backward()
    torch.cuda.synchronize()
    backward = counts()
    grads = [p.grad for p in state.trainable.values() if p.grad is not None]
    check(len(grads) > 0.8 * len(state.trainable)
          and all(bool(torch.isfinite(g).all()) for g in grads),
          f"losses: {len(grads)} of {len(state.trainable)} fusion "
          "parameters got a finite gradient")
    for name in ("clb_pt", "logbinomial_depth"):
        check(forward[name] == 3 and backward[name] == 0,
              f"losses: {name} launched {forward[name]} times forward and "
              f"{backward[name]} in the backward, expected 3 and 0")
    p = pred.detach()
    c = coarse.detach()
    gt, images = batch["crop_depths"], batch["crops_image_hr"]
    mask = (gt > 1e-3) & (gt < 80.0)
    p_up, c_up = (interpolate_nchw(x, tuple(gt.shape[-2:]),
                                   align_corners=True) for x in (p, c))
    labels = L.get_incoherent_mask(gt, hw, 1e-3, 80.0, c, True, True)
    fns = {"silog": lambda: L.SILogLoss()(p, gt, 1e-3, 80.0),
           "ssi": lambda: L.ScaleAndShiftInvariantLoss()(p_up, gt, mask),
           "exist": lambda: L.ExistLoss()(L._sobel_grad_map(p_up),
                                          L._sobel_grad_map(c_up), mask),
           "ranking": lambda: L.EdgeguidedRankingLoss()(
               p, gt, images, gt, generator=gen),
           "error": lambda: L.ErrorLoss("incoh_grad_depth")(
               probs, gt, c, 1e-3, 80.0),
           "edge_cls": lambda: L.EdgeClsLoss()(probs, labels)}
    ms = {name: _time_ms(fn, reps=10) for name, fn in fns.items()}
    out = {"values": {k: v.item() for k, v in card.items()},
           "card_vs_cpu_rel": rels, "ms": ms,
           "launches_forward": {k: forward[k] for k in
                                ("clb_pt", "logbinomial_depth")},
           "launches_backward": {k: backward[k] for k in
                                 ("clb_pt", "logbinomial_depth")}}
    say(f"surface: research losses on a vitl --amp prediction (B=4, "
        f"{hw[0]}x{hw[1]}): values {json.dumps(out['values'])}; card vs CPU "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in rels.items()})} "
        f"(tolerance {LOSS_TOL}); {len(grads)} finite gradients; one call "
        f"on CUDA events {json.dumps({k: round(v, 4) for k, v in ms.items()})}"
        " ms; head launches 3 + 3 forward, 0 backward")
    del state, net, pred, card
    torch.cuda.empty_cache()
    return out


def _demo_train(root: Path) -> dict:
    """(d): configs/demo/train_fusion_synth_vitl.py through tools.train
    (its main, in-process: what `python -m` runs) on the synthetic scenes,
    one epoch at the config's batch of 2 with train_remat: finite losses,
    images/s over the epoch's wall, the peak."""
    import torch
    from patchfusion_tpu_torch.tools import train as train_cli

    torch.cuda.empty_cache()
    argv = [str(ROOT / DEMO_CONFIG), "--seed", "0", "--work-dir",
            str(root / "demo"), "--cfg-options", *_demo_options(root)]
    t = time.perf_counter()
    with attn_impl("einsum"):
        trainer = train_cli.main(argv)
    wall = time.perf_counter() - t
    (epoch,) = trainer.epoch_stats
    losses = epoch["losses"]
    check(trainer.state.step == 2 and len(losses) == 2
          and all(map(math.isfinite, losses)),
          f"demo: {trainer.state.step} steps, losses {losses}")
    out = {"losses": losses, "epoch_s": epoch["seconds"],
           "images_per_s": 2 * epoch["steps"] / epoch["seconds"],
           "peak_gib": epoch["peak_allocated_bytes"] / 2**30,
           "step_s": epoch["step_seconds"], "wall_s": wall}
    say(f"surface: demo recipe (vitl, batch 2, train_remat, f32) on the "
        f"synthetic scenes: 2 steps, losses {losses}, "
        f"{out['images_per_s']:.3f} images/s over the epoch's "
        f"{epoch['seconds']:.2f} s, peak allocated {out['peak_gib']:.2f} "
        f"GiB, {wall:.1f} s with the build")
    del trainer
    torch.cuda.empty_cache()
    return out


def _module(name: str, *args: str) -> float:
    """`python -m patchfusion_tpu_torch.tools.<name> ARGS` from the
    repository's root; returns its seconds."""
    t = time.perf_counter()
    subprocess.run([sys.executable, "-m",
                    f"patchfusion_tpu_torch.tools.{name}", *args],
                   cwd=ROOT, check=True, timeout=600)
    return time.perf_counter() - t


def _m1(model):
    """The m1 depth of image 0 with the einsum attention."""
    lr, hr = _images(model, 0)
    with attn_impl("einsum"):
        return model.infer(lr, hr, cai_mode="m1", process_num=PROCESS_NUM)


def _export(model, root: Path, ref) -> dict:
    """(b): the seeded vitl model's weights (a full weights file, bf16)
    through tools.export_hub and PatchFusion.from_pretrained on the card:
    the m1 depth bitwise equal; a fusion-only export (from save) holds
    exactly the fusion keys."""
    import torch
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.engine.checkpoint import save_weights
    from patchfusion_tpu_torch.models.patchfusion import FROZEN_KEYS

    cfg_file = str(ROOT / VITL_CONFIG)
    weights, snap = root / "vitl_weights.pt", root / "snapshot"
    t = time.perf_counter()
    save_weights(str(weights), model.net)
    save_s = time.perf_counter() - t
    export_s = _module("export_hub", cfg_file, "--weights", str(weights),
                       "--out-dir", str(snap))
    size = (snap / "pytorch_model.bin").stat().st_size
    weights.unlink()
    t = time.perf_counter()
    loaded = PatchFusion.from_pretrained(str(snap), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    got = _m1(loaded)
    check(np.array_equal(got, ref), "export: from_pretrained m1 differs "
          "from the live model's")
    del loaded
    torch.cuda.empty_cache()
    shutil.rmtree(snap)
    fusion, fsnap = root / "fusion.pt", root / "fusion_snapshot"
    model.save(str(fusion))
    fusion_s = _module("export_hub", cfg_file, "--weights", str(fusion),
                       "--out-dir", str(fsnap))
    keys = set(torch.load(fsnap / "pytorch_model.bin", weights_only=True))
    want = {k for k in model.net.state_dict()
            if k.split(".")[0] not in FROZEN_KEYS}
    check(keys == want, f"export: the fusion-only snapshot holds "
          f"{len(keys)} keys, not the {len(want)} fusion keys")
    out = {"weights_write_s": save_s, "export_s": export_s,
           "snapshot_bytes": size, "from_pretrained_s": load_s,
           "fusion_export_s": fusion_s, "fusion_keys": len(keys)}
    say(f"surface: export_hub: weights file written in {save_s:.1f} s, "
        f"snapshot {size} bytes written by `python -m ...export_hub` in "
        f"{export_s:.1f} s, from_pretrained (bf16, card) in {load_s:.1f} s, "
        f"m1 bitwise equal to the live model's; fusion-only export "
        f"{len(keys)} keys in {fusion_s:.1f} s")
    return out


def _convert(model, root: Path) -> dict:
    """(c): the vitl model's published-layout .pth triple through
    tools.convert_checkpoint; the model loaded from that one file (the
    CLIs' loader, load_dict) gives the m1 depth of
    from_config(ckpts=triple), bitwise."""
    import torch
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.tools.test import load_patchfusion

    triple = _write_triple(model.net, root)
    path = root / "converted.pt"
    convert_s = _module("convert_checkpoint", str(ROOT / VITL_CONFIG),
                        "--coarse", triple[0], "--fine", triple[1],
                        "--fusion", triple[2], "--save-path", str(path))
    t = time.perf_counter()
    # the vitl config sets load_branch with pretrain_model paths that do
    # not exist here: a full file must not need them
    one = load_patchfusion(model.config, str(path), "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    got = _m1(one)
    del one
    t = time.perf_counter()
    three = PatchFusion.from_config(model.config, dtype=torch.bfloat16,
                                    ckpts=triple)
    triple_s = time.perf_counter() - t
    want = _m1(three)
    del three
    torch.cuda.empty_cache()
    check(np.array_equal(got, want), "convert: the converted file's m1 "
          "differs from from_config(ckpts=triple)'s")
    size = path.stat().st_size
    for p in (path, *map(Path, triple)):
        p.unlink()
    out = {"convert_s": convert_s, "file_bytes": size, "load_s": load_s,
           "from_config_triple_s": triple_s}
    say(f"surface: convert_checkpoint of the vitl .pth triple in "
        f"{convert_s:.1f} s ({size} bytes), loaded by the CLIs' loader in "
        f"{load_s:.1f} s; m1 bitwise equal to from_config(ckpts=triple) "
        f"(built in {triple_s:.1f} s)")
    return out


def _trace_launches(trace_dir: Path) -> dict:
    """Kernel events in the directory's one Chrome trace, by port kernel."""
    (path,) = trace_dir.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {"clb_pt": sum("clb_" in n for n in kernels),
            "logbinomial_depth": sum("logbinomial_depth" in n
                                     for n in kernels),
            "kernels": len(kernels), "trace_bytes": path.stat().st_size}


def _profiling(model, root: Path, attempts: int = 3) -> dict:
    """(e): 3 warm m1 requests under SectionTimer, synchronised on the
    card; one under trace(dir): the Chrome trace names 9 clb_pt and 9
    logbinomial_depth launches (traced again, up to `attempts` times,
    where the profiler lost launches, as _device_ms does)."""
    import torch
    from patchfusion_tpu_torch.utils.profiling import SectionTimer, trace

    lr, hr = _images(model, 1)
    engine = model.engine(PROCESS_NUM)
    want = _want(_tiles(model.tile_cfg)["m1"])["clb_pt"]
    timer = SectionTimer()
    with attn_impl("einsum"):
        engine.infer(lr, hr, cai_mode="m1")
        for _ in range(3):
            with timer.section("m1", sync=torch.device("cuda")):
                engine.infer(lr, hr, cai_mode="m1")
        for attempt in range(1, attempts + 1):
            tdir = root / f"trace{attempt}"
            reset_counts()
            with trace(str(tdir)):
                engine.infer(lr, hr, cai_mode="m1")
                torch.cuda.synchronize()
            launched = counts()
            seen = _trace_launches(tdir)
            if all(seen[k] == launched[k] for k in
                   ("clb_pt", "logbinomial_depth")):
                break
            say(f"surface: the trace recorded {seen}, the wrappers "
                f"launched {launched}; tracing again")
    for name in ("clb_pt", "logbinomial_depth"):
        check(launched[name] == want and seen[name] == want,
              f"profiling: {name} launched {launched[name]} times, "
              f"{seen[name]} in the trace, expected {want}")
    out = {"sections": timer.summary(), "m1_s": timer.totals["m1"] / 3,
           "trace": seen, "trace_attempts": attempt}
    say(f"surface: SectionTimer over 3 warm m1:\n{timer.summary()}\n"
        f"surface: trace of one m1: {json.dumps(seen)} (attempt {attempt})")
    return out


def _call_shim(model, ref) -> dict:
    """(f): model("infer", image_lr=..., image_hr=...) on NCHW tensors on
    the card: infer's m1 depth (its reensemble size, 1568x2072 for a
    2160x3840 image), bitwise, as (1, 1, H, W) on the card."""
    import torch

    lr, hr = _images(model, 0)
    lr_t = torch.from_numpy(lr).cuda().permute(0, 3, 1, 2)
    hr_t = torch.from_numpy(hr).cuda().permute(2, 0, 1)[None]
    with attn_impl("einsum"):
        depth, log = model("infer", image_lr=lr_t, image_hr=hr_t,
                           cai_mode="m1", process_num=PROCESS_NUM)
    check(tuple(depth.shape) == (1, 1, *ref.shape) and depth.is_cuda,
          f"call shim: depth {tuple(depth.shape)} on {depth.device}")
    check(set(log) == {"rgb", "depth_pred"} and log["rgb"].is_cuda,
          "call shim: log dict")
    check(np.array_equal(depth[0, 0].cpu().numpy(), ref),
          "call shim: depth differs from infer's")
    say(f"surface: model('infer', ...) on NCHW card tensors: "
        f"{tuple(depth.shape)} on the card, bitwise equal to infer's m1")
    return {"shape": list(depth.shape)}


def phase_surface() -> dict:
    """Phase surface: the rest of the JAX package's surface on the card."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="pf_surface_") as tmp:
        root = Path(tmp)
        data = root / "u4k_synth"
        out.update(_synth_data(data))
        out["losses"] = _surface_losses(data)
        out["demo"] = _demo_train(data)
        model = build_vitl()
        ref = _m1(model)
        out["export"] = _export(model, root, ref)
        out["convert"] = _convert(model, root)
        out["profiling"] = _profiling(model, root)
        out["call"] = _call_shim(model, ref)
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    say("surface summary: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase beit: the BEiT ZoeDepth family (configs/patchfusion_zoedepth)
# ---------------------------------------------------------------------------

def _beit_block():
    """(b): one BEiT-L block at full width, seeded (LayerScale gammas
    U(0.5, 1.5), q/v biases and the table N(0, 0.5), so the attention
    counts), in bf16 against the same block in f32 on the card."""
    import copy

    import torch
    from patchfusion_tpu_torch.api import init_weights
    from patchfusion_tpu_torch.models.beit import BeitBlock

    b, grid, d, h = BEIT_BLOCK
    with torch.device("cuda"):
        blk = BeitBlock(d, h, grid)
    init_weights(blk, 0)
    rng = np.random.default_rng(0)

    def draw(p, fn):
        p.copy_(torch.from_numpy(fn(p.shape).astype(np.float32)))

    with torch.no_grad():
        for p in (blk.gamma_1, blk.gamma_2):
            draw(p, lambda s: rng.uniform(0.5, 1.5, s))
        for p in (blk.attn.q_bias, blk.attn.v_bias,
                  blk.attn.relative_position_bias_table):
            draw(p, lambda s: 0.5 * rng.standard_normal(s))
        x = torch.from_numpy(rng.standard_normal(
            (b, grid[0] * grid[1] + 1, d), dtype=np.float32)).cuda()
        ref = blk(x)
        blk16 = copy.deepcopy(blk).to(torch.bfloat16)
        x16 = x.to(torch.bfloat16)
        got = blk16(x16).float()
        torch.cuda.synchronize()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        moved = ((ref - x).abs().max() / x.abs().max()).item()
        ms16 = _time_ms(lambda: blk16(x16))
        ms32 = _time_ms(lambda: blk(x))
    say(f"beit: one BEiT-L block (B={b}, N={grid[0] * grid[1] + 1}, D={d}, "
        f"H={h}) bf16 vs f32 on the card: max|diff|/max|f32| = {rel:.3g} "
        f"(tolerance {BLOCK_TOL}); the block moves its input by {moved:.3g} "
        f"of max; {ms16:.3f} ms bf16, {ms32:.3f} ms f32 (one call)")
    check(bool(torch.isfinite(got).all()), "beit block: non-finite output")
    check(moved > 0.1, f"beit block: the residual branches moved the input "
          f"by only {moved:.3g}")
    check(rel <= BLOCK_TOL, f"beit block bf16 differs by {rel:.3g}")
    return {"rel_err": rel, "ms_bf16": ms16, "ms_f32": ms32}


def _zoe_config():
    """zoedepth_patchfusion_u4k.py's model config without branch
    checkpoints, as zoedepth_general.py sets it (load_branch=False,
    pretrain_model=None)."""
    from patchfusion_tpu_torch.config import Config

    cfg = Config.fromfile(str(ROOT / ZOE_CONFIG)).model.config.to_dict()
    cfg.update(load_branch=False, pretrain_model=None)
    return cfg


def build_zoe():
    """BEiT ZoeDepth PatchFusion at full width in bf16, seeded weights."""
    import torch
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.models.zoedepth import ZoeDepthBEiT

    t0 = time.perf_counter()
    model = PatchFusion.from_config(_zoe_config(), dtype=torch.bfloat16,
                                    seed=0)
    torch.cuda.synchronize()
    say(f"beit: zoedepth build + seeded init: "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.net.parameters()) / 1e6:.1f} M "
        "params")
    check(isinstance(model.net.coarse_branch, ZoeDepthBEiT)
          and isinstance(model.net.fine_branch, ZoeDepthBEiT),
          "the zoedepth config did not build BEiT branches")
    check(tuple(model.tile_cfg.patch_process_shape) == (384, 512),
          "zoedepth process shape")
    check(model.resizer.multiple_of == 32, "zoedepth resizer")
    return model


def _beit_requests(model):
    """(c): four m1 requests (the first warms up) and one m2 at 2160x3840,
    each checked for depth and launches (9 / 27 per image of each head
    kernel, the tiled logbinomial_depth only); then one m1 with
    PF_ATTN_IMPL=pallas, which reaches no BEiT attention (0 attention
    launches, the same depth)."""
    import torch

    n_tiles = _tiles(model.tile_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with attn_impl("einsum"):
        m1 = [_request(model, "m1", i, _want(n_tiles["m1"]))
              for i in range(4)]
        m2, _ = _request(model, "m2", 4, _want(n_tiles["m2"]))
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with attn_impl("pallas"):
        _, depth = _request(model, "m1", 1, _want(n_tiles["m1"]))
    check(np.array_equal(depth, m1[1][1]),
          "PF_ATTN_IMPL=pallas changed the BEiT model's depth")
    warm = [ms for ms, _ in m1[1:]]
    say(f"beit: zoedepth m1 latency: first {m1[0][0]:.1f} ms, warm "
        f"{' / '.join(f'{ms:.1f}' for ms in warm)} ms; m2 {m2:.1f} ms; "
        f"peak allocated {peak:.2f} GiB; launches {launches}")
    return {"m1_first_ms": m1[0][0], "m1_warm_ms": warm, "m2_ms": m2,
            "peak_gib": peak}, launches


def _published_branch_sd(branch_cfg, min_depth, max_depth, seed=0):
    """A reference coarse-branch state dict in the published layout: the
    BEiT-L branch at the 24x24 grid of beit_large_patch16_384 (tables of
    47 * 47 + 3 rows, 577 x 577 index buffers), values drawn with numpy:
    weights N(0, 1 / fan_in), norm scales 1 + N(0, 0.1), biases, q/v
    biases and the cls token N(0, 0.02), tables N(0, 0.1), LayerScale
    gammas U(0.5, 1.5); buffers as built."""
    import torch
    from patchfusion_tpu_torch.models.builder import build_zoedepth_branch

    net = build_zoedepth_branch(branch_cfg, min_depth, max_depth,
                                device="cpu", process_shape=(384, 384))
    rng = np.random.default_rng(seed)
    params = dict(net.named_parameters())
    sd = {}
    for k, v in net.state_dict().items():
        if k not in params:
            sd[k] = v
            continue
        leaf = k.rsplit(".", 1)[-1]
        shape = tuple(v.shape)
        if leaf == "relative_position_bias_table":
            a = 0.1 * rng.standard_normal(shape, dtype=np.float32)
        elif leaf in ("gamma_1", "gamma_2"):
            a = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif leaf == "weight" and len(shape) >= 2:
            a = rng.standard_normal(shape, dtype=np.float32) / np.float32(
                np.sqrt(np.prod(shape[1:])))
        elif leaf == "weight":
            a = 1 + 0.1 * rng.standard_normal(shape, dtype=np.float32)
        else:
            a = 0.02 * rng.standard_normal(shape, dtype=np.float32)
        sd[k] = torch.from_numpy(a)
    return sd


def _beit_reference(model):
    """(d): a synthetic reference coarse-branch .pth in the published
    layout, loaded through BaselinePretrain.from_torch on the coarse
    pretrain config at 384x512: the tables resampled to 24x32 and the
    index buffers rebuilt; one request."""
    import tempfile

    import torch
    from patchfusion_tpu_torch.api import BaselinePretrain
    from patchfusion_tpu_torch.config import Config
    from patchfusion_tpu_torch.models.beit import table_rows

    cfg = Config.fromfile(str(ROOT / ZOE_BASELINE_CONFIG.format("coarse")))
    mcfg = cfg.model
    branch_cfg = mcfg.coarse_branch.to_dict()
    pps = tuple(cfg.train_dataloader.dataset.transform_cfg
                .network_process_size)
    key = "core.core.pretrained.model.blocks.{}.attn.{}"
    with tempfile.TemporaryDirectory(prefix="pf_beit_") as tmp:
        path = Path(tmp) / "coarse.pth"
        t = time.perf_counter()
        sd = _published_branch_sd(branch_cfg, mcfg.min_depth, mcfg.max_depth)
        check(tuple(sd[key.format(0, "relative_position_bias_table")].shape)
              == (47 * 47 + 3, 16)
              and tuple(sd[key.format(23, "relative_position_index")].shape)
              == (577, 577), "the published layout's table or index")
        torch.save({"model_state_dict": sd}, path)
        write_s = time.perf_counter() - t
        size = path.stat().st_size
        del sd
        t = time.perf_counter()
        bp = BaselinePretrain.from_torch(
            branch_cfg, mcfg.min_depth, mcfg.max_depth, str(path),
            target="coarse", patch_process_shape=pps, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    blocks = bp.net.core.core.pretrained.model.blocks
    check(all(tuple(b.attn.relative_position_bias_table.shape)
              == (table_rows((24, 32)), 16)
              and tuple(b.attn.relative_position_index.shape) == (769, 769)
              for b in blocks), "the tables were not fitted to 24x32")
    lr, _ = _images(model, 0)
    reset_counts()
    depth = bp.infer(image_lr=lr)
    launches = counts()
    check(depth.shape == pps, f"reference coarse depth {depth.shape}")
    check(bool(np.isfinite(depth).all()) and bool((depth > 0).all()),
          "reference coarse depth not finite and positive")
    check(launches["clb_pt"] == launches["logbinomial_depth"] == 1,
          f"reference coarse launches {launches}")
    say(f"beit: published-layout coarse .pth ({size / 2**30:.2f} GiB, 24x24 "
        f"tables) written in {write_s:.1f} s, loaded by "
        f"BaselinePretrain.from_torch (tables resampled to 24x32, bf16, "
        f"card) in {load_s:.1f} s; depth {depth.shape} in "
        f"[{depth.min():.4g}, {depth.max():.4g}]")
    del bp
    torch.cuda.empty_cache()
    return {"write_s": write_s, "load_s": load_s, "gib": size / 2**30}


def _beit_train():
    """(e): two fusion-stage steps at batch 4 with --amp (bf16 autocast
    over f32 masters, the frozen BEiT branches in bf16) on one fixed batch
    of 384x512 crops: finite losses, 3 + 3 head launches a step, each
    step's time on the device's clock, the peak."""
    import torch
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.engine import training

    net = PatchFusion.from_config(_zoe_config(), device="cuda", seed=0).net
    state = training.create_train_state(
        net, training.make_onecycle_optimizer(1e-4, 10),
        frozen_dtype=torch.bfloat16, amp=True)
    rng = np.random.default_rng(13)
    batch = {"image_lr": rng.random((4, 384, 512, 3), dtype=np.float32),
             "crops_image_hr": rng.random((4, 384, 512, 3),
                                          dtype=np.float32),
             "crop_depths": rng.random((4, 384, 512, 1), dtype=np.float32)
             * 40 + 1,
             "bboxs": np.array([[0, 0, 960, 540], [960, 540, 1920, 1080],
                                [2880, 0, 3840, 540],
                                [1920, 1620, 2880, 2160]], np.float32)}
    batch = training.to_device_batch(batch, "cuda", batch.keys())
    step = training.make_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    for _ in range(2):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logs = step(state, batch)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        losses.append(float(logs["total_loss"]))
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(map(math.isfinite, losses)), f"beit train losses {losses}")
    check(launches["clb_pt"] == launches["logbinomial_depth"] == 6,
          f"beit train launches {launches}")
    say(f"beit: zoedepth fusion stage, batch 4, --amp: 2 steps, losses "
        f"{losses}, {times[0]:.1f} / {times[1]:.1f} ms on the device's "
        f"clock, peak allocated {peak:.2f} GiB, head launches "
        f"{launches['clb_pt']} + {launches['logbinomial_depth']}")
    del state, net
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": times, "peak_gib": peak,
            "launches": launches}


def phase_beit():
    """Step 10: the BEiT ZoeDepth family ((a), the head kernels at the
    BEiT head's shapes, runs in phase_kernels). (b) one BEiT-L block, (c)
    the zoedepth model's requests, (d) reference weights in the published
    layout, (e) two fusion-stage steps. Returns (the path's launches, the
    phase's figures)."""
    import torch

    out = {"block": _beit_block()}
    model = build_zoe()
    out["requests"], launches = _beit_requests(model)
    out["reference"] = _beit_reference(model)
    del model
    torch.cuda.empty_cache()
    out["train"] = _beit_train()
    say("beit summary: " + json.dumps(out))
    return launches, out


# ---------------------------------------------------------------------------
# phase dist: scale-out over torch.distributed (parallel/, the tile split,
# data-parallel training, the metrics gather)
# ---------------------------------------------------------------------------

# the 2-rank tile split against one process's depth on the same seeded
# model and image, relative to max |depth|: every tile runs the same
# arithmetic. m1's 9 tiles split 5 + 4, so each rank's chunks of 4 are
# one process's chunks and m1 is held bitwise; m2's rank 1 groups other
# tiles in its chunks, which cuDNN and cuBLAS may serve with other
# algorithms (1.12e-3 read on the H100)
DIST_M2_TOL = 5e-3
# the 2-rank Tester's metrics against one process's, relative: the same
# per-image depth, gathered in sample order
DIST_METRIC_TOL = 1e-4
# the 2-rank --amp step (batch 2 per rank) against one process's at batch
# 4 on the same samples: the loss, relative (5.6e-5 read on the H100; a
# per-rank SILog misses it by 5e-2), and the cosine of the averaged
# gradients (0.987 read) and of the weight updates (0.950 read; Adam's
# first update is ~lr times each gradient's sign, so a bf16 difference in
# a small component flips it)
DIST_LOSS_TOL = 1e-3
DIST_GRAD_COS = 0.98
DIST_UPDATE_COS = 0.8
DIST_SCENES = 3  # uneven over 2 ranks: 2 + 1 and the sampler's pad
DIST_CHILD_TIMEOUT = {"nccl1": 300, "gloo2": 600}


def _dist_launch(part: str, world: int, tmp: Path):
    """`world` processes of `chip_smoke.py --dist-child part` with
    torchrun's variables; returns them."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=port, PF_ATTN_IMPL="einsum")
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-child",
             part, str(tmp)], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _dist_join(part: str, procs, tmp: Path):
    """Waits for every child within its part's limit (killing all of them
    on expiry), prints their output, fails on any failure; returns each
    rank's JSON result."""
    deadline = time.monotonic() + DIST_CHILD_TIMEOUT[part]
    failed = []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} timed out")
                break
            for line in out.splitlines():
                say(f"  [{part} rank {r}] {line}")
            for line in err.splitlines()[-40:]:
                say(f"  [{part} rank {r} stderr] {line}")
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check(not failed, f"dist {part}: " + "; ".join(failed))
    return [json.loads((tmp / f"{part}-{r}.json").read_text())
            for r in range(len(procs))]


def _dist_batch(n: int = 4, shape=(392, 518), seed: int = 11):
    """A synthetic fusion-stage batch (vitl's 392x518 crops by default;
    boxes of 540x960 in the 3840x2160 frame), some depths invalid. Its
    second half (the second rank's share in phase dist) is darker and
    nearer, so that a reduction over one rank's share gives other
    statistics than the batch's."""
    rng = np.random.default_rng(seed)
    h, w = shape
    depth = rng.random((n, h, w, 1), dtype=np.float32) * 40 + 1
    depth[0, :h // 4] = 0.0
    depth[n // 2:] /= 8
    images = rng.random((2, n, h, w, 3), dtype=np.float32)
    images[:, n // 2:] *= 0.25
    boxes = np.array([[0, 0, 960, 540], [960, 540, 1920, 1080],
                      [2880, 0, 3840, 540], [1920, 1620, 2880, 2160]],
                     np.float32)[:n]
    return {"image_lr": images[0], "crops_image_hr": images[1],
            "crop_depths": depth, "bboxs": boxes}


def _flat_trainable(state, grads: bool = False):
    import torch

    return torch.cat([(p.grad if grads else p.detach()).float().reshape(-1)
                      for p in state.trainable.values()])


def _dist_step(state, batch, loss_fn=None):
    """One fusion step timed on CUDA events: (logs, seconds)."""
    import torch
    from patchfusion_tpu_torch.engine import training

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    logs = training.make_train_step(loss_fn)(state, batch)
    end.record()
    torch.cuda.synchronize()
    return logs, start.elapsed_time(end) / 1e3


def _dist_reference(tmp: Path):
    """One process's side of phase dist: the seeded vitl model's m1 (seed
    0) and m2 (seed 3) requests (the depth written to tmp/ref_*.npy), the
    Tester's metrics over the 3-scene split, and one --amp fusion step at
    batch 4 (its gradients and update saved for the ranks), beside its
    two halves' SILog (what each rank would reduce alone)."""
    import torch
    from patchfusion_tpu_torch.data import u4k
    from patchfusion_tpu_torch.data.loader import DataLoader
    from patchfusion_tpu_torch.engine.tester import Tester
    from patchfusion_tpu_torch.engine.training import to_device_batch
    from patchfusion_tpu_torch.models.losses import SILogLoss

    split = write_u4k_split(tmp / "u4k", DIST_SCENES, RAW_SHAPE, seed=5)
    model = build_vitl()
    out = {"n_tiles": _tiles(model.tile_cfg),
           "requests": _requests(model, None, tmp, "ref")}
    ds = u4k.UnrealStereo4kDataset(
        mode="infer", data_root=str(tmp / "u4k"), split=split,
        min_depth=1e-3, max_depth=80, resize_mode="depth-anything",
        transform_cfg=dict(network_process_size=[392, 518]))
    with attn_impl("einsum"):
        out["tester"] = Tester(model.engine(PROCESS_NUM),
                               DataLoader(ds, num_workers=2)).run("m1")
    del model
    torch.cuda.empty_cache()
    batch = _dist_batch()
    np.savez(tmp / "batch.npz", **batch)
    state = _vitl_state()
    before = _flat_trainable(state).cpu()
    sig, halves = SILogLoss(), []

    def loss_fn(pred, target, lo, hi, global_batch):
        halves.extend(sig(pred[i:i + 2].detach(), target[i:i + 2], lo, hi)
                      for i in (0, 2))
        return sig(pred, target, lo, hi, global_batch=global_batch)

    logs, secs = _dist_step(state, to_device_batch(batch, "cuda",
                                                   batch.keys()), loss_fn)
    out["per_rank_loss"] = [float(x) for x in halves]
    torch.save({"grad": _flat_trainable(state, grads=True).cpu(),
                "update": _flat_trainable(state).cpu() - before},
               tmp / "step_ref.pt")
    out["loss"] = float(logs["total_loss"])
    out["step_s"] = secs
    del state
    torch.cuda.empty_cache()
    return out


def _cos(a, b) -> float:
    return float((a.double() @ b.double())
                 / (a.double().norm() * b.double().norm()))


def dist_child(part: str, tmp: Path) -> None:
    """One rank of phase dist (torchrun's variables in its environment);
    writes its figures to tmp/<part>-<rank>.json."""
    import torch
    from patchfusion_tpu_torch.parallel import dist

    if part == "gloo2":
        dist.init_distributed(device="cuda", backend="gloo")
        out = _dist_ranks(tmp)
    else:
        dist.init_distributed(device="cuda")
        check(torch.distributed.get_backend() == "nccl",
              f"{part}: not on nccl")
        out = _dist_nccl1()
    out.update(rank=dist.rank(), world=dist.world_size(),
               backend=torch.distributed.get_backend(),
               device=str(torch.cuda.current_device()))
    (tmp / f"{part}-{dist.rank()}.json").write_text(
        json.dumps(out, default=float))
    dist.barrier()
    dist.shutdown()


def _dist_nccl1() -> dict:
    """(a) at world 1 over nccl: the tiny config's m1 with the tile split
    on cuda:0 bitwise equal to the engine without it; one fusion step."""
    import torch
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.engine import training
    from patchfusion_tpu_torch.parallel import dist

    device = dist.device_for_rank("cuda")
    model = PatchFusion.from_config(tiny_config(), device=device,
                                    dtype=torch.bfloat16, seed=1)
    rng = np.random.default_rng(7)
    hr = rng.random((84, 112, 3), dtype=np.float32)
    lr = rng.random((1, 42, 56, 3), dtype=np.float32)
    plain = model.infer(lr, hr, cai_mode="m1", process_num=2)
    split = model.infer(lr, hr, cai_mode="m1", process_num=2,
                        mesh=dist.make_patch_mesh())
    check(np.array_equal(plain, split),
          "nccl1: the tile split at world 1 differs from the engine")
    net = PatchFusion.from_config(tiny_config(), device=device, seed=1).net
    state = training.create_train_state(
        net, training.make_onecycle_optimizer(1e-4, 10))
    b = _dist_batch(2, (42, 56))
    loss = float(training.make_train_step()(
        state, training.to_device_batch(b, device, b.keys()))["total_loss"])
    check(math.isfinite(loss), f"nccl1: loss {loss}")
    say(f"nccl1: tile-split m1 bitwise equal at world 1, step loss {loss}")
    return {"bitwise": True, "loss": loss}


def _dist_ranks(tmp: Path) -> dict:
    """One rank of (b) the tile split of vitl m1 and m2, (d) the Tester
    sharding 3 scenes, (c) one --amp fusion step on this rank's share of
    the batch of 4; on this rank's card (cuda:0 for every gloo rank of
    phase dist)."""
    import torch
    from patchfusion_tpu_torch.data import u4k
    from patchfusion_tpu_torch.data.loader import DataLoader, ShardedSampler
    from patchfusion_tpu_torch.engine.tester import Tester
    from patchfusion_tpu_torch.engine.training import to_device_batch
    from patchfusion_tpu_torch.parallel import dist

    r, world = dist.rank(), dist.world_size()
    dist.device_for_rank("cuda")
    model = build_vitl()
    out = {"requests": _requests(model, dist.make_patch_mesh(), tmp,
                                 "dist" if r == 0 else None)}
    out["infer_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ds = u4k.UnrealStereo4kDataset(
        mode="infer", data_root=str(tmp / "u4k"),
        split=str(tmp / "u4k" / "val.txt"), min_depth=1e-3, max_depth=80,
        resize_mode="depth-anything",
        transform_cfg=dict(network_process_size=[392, 518]))
    tester = Tester(model.engine(PROCESS_NUM), DataLoader(
        ds, num_workers=2, sampler=ShardedSampler(len(ds), world, r)))
    out["tester"] = tester.run("m1")
    out["tester_images"] = len(tester.image_seconds)
    del model, tester
    torch.cuda.empty_cache()

    data = np.load(tmp / "batch.npz")
    per = len(data["bboxs"]) // world
    share = {k: data[k][r * per:(r + 1) * per] for k in data.files}
    state = _vitl_state()
    torch.cuda.reset_peak_memory_stats()
    batch = to_device_batch(share, "cuda", share.keys())
    before = _flat_trainable(state)
    logs, secs = _dist_step(state, batch)
    grad = _flat_trainable(state, grads=True)
    update = _flat_trainable(state) - before
    ref = torch.load(tmp / "step_ref.pt")
    out["step"] = {
        "batch": per, "loss": float(logs["total_loss"]), "first_s": secs,
        "grad_cos": _cos(grad.cpu(), ref["grad"]),
        "update_cos": _cos(update.cpu(), ref["update"])}
    del before, grad, update, ref
    _, out["step"]["warm_s"] = _dist_step(state, batch)
    out["step"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _requests(model, mesh, tmp: Path, prefix=None) -> dict:
    """Three m1 (seed 0) and two m2 (seed 3) requests: each one's wall on
    the host's clock, the last one's head launches; with a `prefix` the
    last depth of each mode written to tmp/<prefix>_<mode>.npy."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    out = {}
    with attn_impl("einsum"):
        for mode, seed, reps in (("m1", 0, 3), ("m2", 3, 2)):
            lr, hr = _images(model, seed)
            walls = []
            for _ in range(reps):
                reset_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                depth = model.infer(lr, hr, cai_mode=mode,
                                    process_num=PROCESS_NUM, mesh=mesh)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            launches = counts()
            if prefix:
                np.save(tmp / f"{prefix}_{mode}.npy", depth)
            out[mode] = {"wall_ms": walls, "launches": {
                n: launches[n] for n in ("clb_pt", "logbinomial_depth",
                                         "logbinomial_depth_pixel")}}
    return out


def _dist_report(ref: dict, ranks: list, tmp: Path) -> dict:
    """Holds the ranks' (b)-(d) against this process's reference and
    prints their figures."""
    world = len(ranks)
    out = {"reference": {k: ref[k] for k in (
        "tester", "loss", "per_rank_loss", "step_s", "requests")},
        "ranks": []}
    n_tiles = ref["n_tiles"]
    for mode in ("m1", "m2"):
        got = np.load(tmp / f"dist_{mode}.npy")
        want = np.load(tmp / f"ref_{mode}.npy")
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        tol = 0.0 if mode == "m1" else DIST_M2_TOL
        say(f"dist (b): vitl {mode} split over {world} ranks vs one "
            f"process: max|diff|/max|depth| = {rel:.3g} (tolerance {tol})")
        check(rel <= tol, f"dist {mode} differs by {rel:.3g}")
        out[f"{mode}_rel"] = rel
        heads = _want(-(-n_tiles[mode] // world))
        for rk in ranks:
            got_l = rk["requests"][mode]["launches"]
            for name in got_l:
                check(got_l[name] == heads[name],
                      f"dist {mode} rank {rk['rank']}: {name} launched "
                      f"{got_l[name]} times, expected {heads[name]}")
    for k, v in ref["tester"].items():
        for rk in ranks:
            got = rk["tester"][k]
            check(abs(got - v) <= DIST_METRIC_TOL * abs(v) + 1e-7,
                  f"dist (d): {k} {got} against {v}")
    say(f"dist (d): Tester over {DIST_SCENES} scenes sharded "
        f"{[rk['tester_images'] for rk in ranks]}: metrics within "
        f"{DIST_METRIC_TOL} of one process's "
        + json.dumps({k: round(v, 4) for k, v in ref["tester"].items()}))
    one = ref["requests"]
    say(f"dist one process: m1 wall "
        f"{[round(x, 1) for x in one['m1']['wall_ms']]} ms, m2 "
        f"{[round(x, 1) for x in one['m2']['wall_ms']]} ms; --amp step at "
        f"batch 4 {ref['step_s']:.3f} s (first), loss {ref['loss']:.6f}")
    naive = min(abs(x - ref["loss"]) for x in ref["per_rank_loss"]) \
        / ref["loss"]
    say(f"dist (c): the halves' SILog {ref['per_rank_loss']}, at least "
        f"{naive:.3g} from the batch's {ref['loss']:.6f} (the loss "
        f"tolerance {DIST_LOSS_TOL} tells a per-rank reduction apart)")
    check(naive > DIST_LOSS_TOL, "dist (c): a per-rank SILog would pass "
          f"the loss tolerance ({naive:.3g})")
    for rk in ranks:
        st = rk["step"]
        rel = abs(st["loss"] - ref["loss"]) / ref["loss"]
        check(rel <= DIST_LOSS_TOL, f"dist (c) rank {rk['rank']}: loss "
              f"{st['loss']} against {ref['loss']} ({rel:.3g})")
        check(st["grad_cos"] >= DIST_GRAD_COS
              and st["update_cos"] >= DIST_UPDATE_COS,
              f"dist (c) rank {rk['rank']}: {st}")
        reqs = rk["requests"]
        say(f"dist rank {rk['rank']} ({rk['backend']}, cuda:"
            f"{rk['device']}): m1 wall "
            f"{[round(x, 1) for x in reqs['m1']['wall_ms']]} ms, m2 "
            f"{[round(x, 1) for x in reqs['m2']['wall_ms']]} ms (the "
            f"first of each cold), head launches per request m1 "
            f"{reqs['m1']['launches']['clb_pt']} + "
            f"{reqs['m1']['launches']['logbinomial_depth']}, m2 "
            f"{reqs['m2']['launches']['clb_pt']} + "
            f"{reqs['m2']['launches']['logbinomial_depth']} (one process: "
            f"{one['m1']['launches']['clb_pt']} + "
            f"{one['m1']['launches']['logbinomial_depth']}, "
            f"{one['m2']['launches']['clb_pt']} + "
            f"{one['m2']['launches']['logbinomial_depth']}); inference "
            f"peak {rk['infer_peak_gib']:.2f} GiB; --amp step at batch "
            f"{st['batch']}: loss {st['loss']:.6f}, gradient cosine "
            f"{st['grad_cos']:.6f}, update cosine {st['update_cos']:.6f}, "
            f"first {st['first_s']:.3f} s, warm {st['warm_s']:.3f} s on "
            f"CUDA events, peak {st['peak_gib']:.2f} GiB")
        out["ranks"].append({k: rk[k] for k in (
            "rank", "backend", "requests", "infer_peak_gib", "step",
            "tester_images")})
    return out


def phase_dist() -> dict:
    """Step 11: scale-out. (a) a child at world 1 over nccl (torchrun's
    variables); (b)-(d) two ranks over gloo on cuda:0 against this
    process's reference: vitl tile split, one --amp step, Tester."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="pf_dist_") as name:
        tmp = Path(name)
        nccl = _dist_launch("nccl1", 1, tmp)
        ref = _dist_reference(tmp)
        (a,) = _dist_join("nccl1", nccl, tmp)
        check(a["backend"] == "nccl" and a["bitwise"], f"dist (a): {a}")
        ranks = _dist_join("gloo2", _dist_launch("gloo2", 2, tmp), tmp)
        out = {"nccl1": a, **_dist_report(ref, ranks, tmp)}
    say("dist (b)/(c): the two ranks share one card, so their walls and "
        "peaks show the collectives and each rank's share, not a speed-up")
    out["seconds"] = time.perf_counter() - t0
    say(f"phase dist: {out['seconds']:.1f} s")
    say("dist summary: " + json.dumps(out, default=float))
    return out


def main(argv) -> int:
    root = ROOT
    child = argv[:1] == ["--dist-child"] and len(argv) == 3
    if argv[:1] == ["--time-only"] and len(argv) == 2:
        root = Path(argv[1]).resolve()
    elif argv and not child:
        raise SystemExit("usage: chip_smoke.py [--time-only DIR]")
    if not (root / "patchfusion_tpu_torch").is_dir():
        raise SystemExit("chip_smoke.py needs the repository around it "
                         f"(patchfusion_tpu_torch/ not found in {root})")
    sys.path.insert(0, str(root))
    import torch

    if child:
        dist_child(argv[1], Path(argv[2]))
        return 0

    t0 = time.perf_counter()
    card = phase_card()
    if argv:
        rows = phase_time_only(root)
        say(f"total: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"time_only": str(root), "kernels": rows}),
              flush=True)
        return 0
    phase_build()
    kres = phase_kernels()
    model = build_vitl()
    main_launches, einsum_depths = phase_full_width(model)
    pallas_launches = phase_pallas_path(model, einsum_depths)
    fused_launches = phase_depth_fused(model)
    ev = phase_eval(model)
    del model
    torch.cuda.empty_cache()
    phase_tiny()
    tr = phase_train()
    surface = phase_surface()
    beit_launches, _ = phase_beit()
    torch.cuda.empty_cache()
    dist_out = phase_dist()
    launches = {"clb_pt": main_launches["clb_pt"],
                "logbinomial_depth": main_launches["logbinomial_depth"],
                "vit_attention": pallas_launches["vit_attention"],
                "clb_logbinomial_depth":
                    fused_launches["clb_logbinomial_depth"]}
    for name, n in launches.items():
        check(n > 0, f"{name} never ran on its path")
    for name in ("clb_pt", "logbinomial_depth"):
        check(beit_launches[name] > 0, f"{name} never ran on the BEiT path")
    kernels = []
    for name in ("clb_pt", "logbinomial_depth", "vit_attention",
                 "clb_logbinomial_depth"):
        if name == "vit_attention":
            r = kres[("vit_attention", "vit_attention", 4, 64)]
        else:
            r = kres[(name, "bfloat16", 4, "nchw-view")]
        kernels.append({"name": name, "route": "cuda",
                        "source": KERNEL_SOURCES[name],
                        "replaces": REPLACES[name],
                        "launches": launches[name],
                        **({"launches_eval": ev["launches"][name],
                            "launches_train":
                                tr["fusion"]["launches"][name],
                            "launches_surface": {
                                "losses_forward": surface["losses"][
                                    "launches_forward"][name],
                                "losses_backward": surface["losses"][
                                    "launches_backward"][name],
                                "traced_m1": surface["profiling"]["trace"][
                                    name]}}
                           if name in ("clb_pt", "logbinomial_depth")
                           else {}),
                        **({"launches_dist": {
                            mode: [rk["requests"][mode]["launches"][name]
                                   for rk in dist_out["ranks"]]
                            for mode in ("m1", "m2")}}
                           if name in ("clb_pt", "logbinomial_depth")
                           else {}),
                        **({"launches_beit": beit_launches[name],
                            "beit": {key: kres[(
                                "beit", name, "bfloat16", 4, "nchw-view")]
                                .get(key) for key in (
                                "variant", "tile_smem_bytes", "max_abs_err",
                                "ms", "ms_batched", "device_ms",
                                "device_events", "plain_ms", "bound_ms",
                                "bound_by", "bound_share_device")}}
                           if name in ("clb_pt", "logbinomial_depth")
                           else {}),
                        **({"backward_ms": tr["heads"][name]["backward_ms"],
                            "backward_device_ms":
                                tr["heads"][name]["backward_device_ms"],
                            "backward_device_windows":
                                tr["heads"][name]["backward_device_windows"],
                            "twin_backward_ms":
                                tr["heads"][name]["twin_backward_ms"]}
                           if name in tr["heads"] else {}),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "ms_batched": r["ms_batched"],
                        "device_ms": r["device_ms"],
                        "device_windows": r["device_windows"],
                        "device_events": r["device_events"],
                        "host_us": r["host_us"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "bound_share": r["bound_share"],
                        "bound_share_device": r["bound_share_device"],
                        "library_ms": r["library_ms"],
                        **{key: r[key] for key in (
                            "variant", "library_ms_batched",
                            "library_device_ms", "library_device_windows",
                            "library_host_us")
                           if key in r}})
    say(f"total: {time.perf_counter() - t0:.1f} s")
    # the card again, so that the end of a long run's output holds it
    say(card.splitlines()[0] if card else "nvidia-smi: no card listed")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
