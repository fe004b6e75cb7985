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
   back-to-back calls; device_ms, the profiler's kernel time per call;
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
7. Runs the tiny config in bf16 on the card (with the kernels, einsum and
   pallas attention) against the same weights in float32 on the CPU.
8. Prints one JSON line with the kernels' launches, errors, times and
   bounds, then {"ok": true, "device": {...}} as the last line.

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
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
VITL_CONFIG = ("configs/patchfusion_depthanything/"
               "depthanything_vitl_patchfusion_u4k.py")
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


def _device_ms(fn, calls: int = 20) -> float:
    """Kernel time per call on the card: the sum of the durations of the
    device events torch.profiler records over `calls` calls, divided by
    `calls`."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    check(us > 0, "the profiler recorded no device time")
    return us / calls / 1e3


def _timings(fn, prefix: str = "") -> dict:
    """The four times of fn (see the module note), keys prefixed."""
    out = {"ms": _time_ms(fn)}
    out["ms_batched"] = _time_batched_ms(fn)
    out["device_ms"] = _device_ms(fn)
    out["host_us"] = _host_us(fn)
    return {prefix + k: v for k, v in out.items()}


def _nchw_view(x_nhwc_np, dtype, device):
    """A channels-last view of an NCHW tensor: the layout the model feeds."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x_nhwc_np, -1, 1))).to(device=device, dtype=dtype)
    return t.permute(0, 2, 3, 1)


HEAD_SHAPE = (392, 518, 224, 296, 64, 33, 128, 80)  # oh ow ih iw k cin cc hid


def _head_inputs(b, dtype, layout, dev):
    """Seeded inputs of the head kernels at the head's shapes: p, t,
    centers, last_cat, cond_lo and the four MLP weights in `dtype`."""
    import torch

    oh, ow, ih, iw, k, cin, cc, hid = HEAD_SHAPE
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


def _head_kernels(results):
    """The three head kernels against their twins."""
    import torch
    from patchfusion_tpu_torch.ops import fused_head as fh

    dev = torch.device("cuda")
    for b in (1, 4):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            tol_pt, tol_depth = TOL[dname]
            bounds = head_bounds(b, *HEAD_SHAPE, dtype.itemsize)
            for layout in ("nchw-view", "nhwc"):
                pt, tt, ct, lt, cdt, wl = _head_inputs(b, dtype, layout, dev)
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
                crow = {"max_abs_err": e_clb}
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
                    results[(name, dname, b, layout)] = r
                    say(f"kernel {name} {dname} B={b} {layout}: "
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
    """Each kernel against its plain twin at the main-path shapes."""
    results = {}
    _head_kernels(results)
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


def main(argv) -> int:
    root = ROOT
    if argv[:1] == ["--time-only"] and len(argv) == 2:
        root = Path(argv[1]).resolve()
    elif argv:
        raise SystemExit("usage: chip_smoke.py [--time-only DIR]")
    if not (root / "patchfusion_tpu_torch").is_dir():
        raise SystemExit("chip_smoke.py needs the repository around it "
                         f"(patchfusion_tpu_torch/ not found in {root})")
    sys.path.insert(0, str(root))
    import torch

    t0 = time.perf_counter()
    phase_card()
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
    del model
    torch.cuda.empty_cache()
    phase_tiny()
    launches = {"clb_pt": main_launches["clb_pt"],
                "logbinomial_depth": main_launches["logbinomial_depth"],
                "vit_attention": pallas_launches["vit_attention"],
                "clb_logbinomial_depth":
                    fused_launches["clb_logbinomial_depth"]}
    for name, n in launches.items():
        check(n > 0, f"{name} never ran on its path")
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
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "ms_batched": r["ms_batched"],
                        "device_ms": r["device_ms"], "host_us": r["host_us"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "bound_share": r["bound_share"],
                        "bound_share_device": r["bound_share_device"],
                        "library_ms": r["library_ms"],
                        **{key: r[key] for key in (
                            "variant", "library_ms_batched",
                            "library_device_ms", "library_host_us")
                           if key in r}})
    say(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
