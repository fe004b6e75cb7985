"""Timers, FLOP counts, peaks and bounds for the port's stage profilers
(`patchfusion_tpu_torch/tools/profile_*.py`; the port of the JAX package's
tools/_bench_util.py) and for chip_smoke.py's kernel rows.

`device_time` is the profilers' timer: a warm-up call, then the median over
`repeats` of the time of `inner` back-to-back calls between two CUDA events
(perf_counter on the CPU), fenced by `torch.cuda.synchronize`. Eager torch
issues each call as the host reaches it, so the time includes the host's
gaps between launches: the time a user waits. The JAX tool's devices
(a lax.scan chain over a loop-carried dependency, optimization_barrier)
keep XLA from hoisting or fusing loop-invariant work out of one compiled
program; eager torch compiles nothing and runs every call, so none of them
is needed here.

`count_flops` counts the matmul and convolution FLOPs of one call with
torch.utils.flop_counter.FlopCounterMode. It does not see the port's CUDA
kernels (they launch through ctypes) and does not count interpolation or
elementwise work, so a stage's count is taken with the einsum attention
(`PF_ATTN_IMPL=einsum`), whatever the caller's setting, and each head
kernel wrapper the stage calls is credited with its analytic tensor-core
FLOPs (`clb_mlp_flops`: the MLP with the condition projected at its low
resolution) in place of whatever its body showed the counter (the plain
twin on the CPU, nothing on the card). The same count then divides the
einsum time and the kernel path's time. Never time under the counter.
These are "matmul+conv FLOPs": XLA's cost_analysis counts other work
too, so no FLOP figure compares across the two packages.

This module imports the package only inside its functions: chip_smoke.py
loads it by its path, and with `chip_smoke.py --time-only DIR` the
package (the kernels and their launch counts) comes from DIR.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

# NVIDIA H100 SXM data-sheet peaks (dense)
HBM_BYTES_S = 3.35e12
BF16_TC_FLOPS = 989e12
TF32_TC_FLOPS = 494.7e12
F32_FLOPS = 67e12

CONFIGS = Path(__file__).resolve().parents[2] / "configs" / \
    "patchfusion_depthanything"
ZOE_CONFIG = CONFIGS.parent / "patchfusion_zoedepth" / \
    "zoedepth_patchfusion_u4k.py"

# substrings of the port's kernels' names in a profile
PORT_KERNEL_NAMES = ("vit_attention_kernel", "clb_", "logbinomial_depth",
                     "resize_")


def say(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# devices, launch counts, the attention switch
# ---------------------------------------------------------------------------

def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counts (ops/fused_head.LAUNCHES,
    ops/vit_attention.LAUNCHES and ops/resize.LAUNCHES) as one dict."""
    from patchfusion_tpu_torch.ops import fused_head, resize, vit_attention

    return {**fused_head.LAUNCHES, **vit_attention.LAUNCHES,
            **resize.LAUNCHES}


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


def card_line(device: torch.device) -> Optional[str]:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line (None on
    the CPU)."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return out[index] if index < len(out) else out[0]


# ---------------------------------------------------------------------------
# the profilers' timer and FLOP count
# ---------------------------------------------------------------------------

def device_time(fn: Callable, *args, device, inner: int = 10,
                repeats: int = 3) -> float:
    """Seconds per call of fn(*args) on `device`: one warm-up call, then
    the median over `repeats` of (time of `inner` back-to-back calls) /
    inner, between CUDA events fenced by torch.cuda.synchronize on a CUDA
    device, by perf_counter on the CPU."""
    device = torch.device(device)
    fn(*args)
    sync(device)
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3 / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn(*args)
            times.append((time.perf_counter() - t0) / inner)
    return float(np.median(times))


def clb_mlp_flops(b: int, oh: int, ow: int, ih: int, iw: int, cin: int,
                  cc: int, hid: int) -> int:
    """Tensor-core FLOPs of the ConditionalLogBinomial MLP as the clb
    kernels compute it: the (Cin + Cc) -> hid layer with the condition
    projected at its low resolution, then hid -> 4."""
    hi, lo = b * oh * ow, b * ih * iw
    return 2 * hid * (cin * hi + cc * lo) + 2 * hid * 4 * hi


def _clb_flops(last_cat, cond_lo, w1, *_args, **_kw) -> int:
    b, oh, ow, cin = last_cat.shape
    _, ih, iw, cc = cond_lo.shape
    return clb_mlp_flops(b, oh, ow, ih, iw, cin, cc, w1.shape[1])


# each head kernel wrapper -> its analytic tensor-core FLOPs from its
# arguments (logbinomial_depth has none: its work is f32 softmax ops)
HEAD_FLOPS = {
    "clb_pt": _clb_flops,
    "logbinomial_depth": lambda *args, **kw: 0,
    "clb_logbinomial_depth": lambda last_cat, cond_lo, centers, w1, *a,
    **kw: _clb_flops(last_cat, cond_lo, w1),
}


def _bmm_any(a_shape, b_shape, *_args, out_shape=None, **_kw) -> int:
    """bmm's FLOPs for every overload: FlopCounterMode's own formula takes
    the out_dtype overload's third argument as the output shape and
    raises."""
    from torch.utils.flop_counter import bmm_flop

    return bmm_flop(a_shape, b_shape)


def count_flops(fn: Callable, *args, **kwargs) -> int:
    """Matmul + convolution FLOPs of one call fn(*args, **kwargs) (forward,
    and backward where fn runs one), on the einsum attention path, with
    each head kernel wrapper credited its analytic FLOPs (module note).
    The call runs once, under the counter: state it changes (a train
    step's weights) changes. On the card it raises where a kernel launched
    that the count did not credit: an attention kernel (the einsum switch
    did not reach it) or a head kernel reached through another name than
    the fused_head module's attribute (its work would drop out of the
    count)."""
    from torch.utils.flop_counter import FlopCounterMode

    from patchfusion_tpu_torch.ops import fused_head

    counter = FlopCounterMode(display=False,
                              custom_mapping={torch.ops.aten.bmm: _bmm_any})
    seen_in_heads = [0]
    credited = [0]
    credited_on_card = [0]
    originals = {name: getattr(fused_head, name) for name in HEAD_FLOPS}

    # credited before the call: a remat recompute (non-reentrant
    # torch.utils.checkpoint) stops by raising from inside the wrapper
    # once its kernel has run, when the wrapper's inputs are saved
    def credit(name, real):
        def call(*a, **kw):
            credited[0] += HEAD_FLOPS[name](*a, **kw)
            credited_on_card[0] += a[0].is_cuda
            before = counter.get_total_flops()
            try:
                return real(*a, **kw)
            finally:
                seen_in_heads[0] += counter.get_total_flops() - before
        return call

    launched = launch_counts()
    try:
        for name, real in originals.items():
            setattr(fused_head, name, credit(name, real))
        with attn_impl("einsum"), counter:
            fn(*args, **kwargs)
    finally:
        for name, real in originals.items():
            setattr(fused_head, name, real)
    launched = {k: v - launched[k] for k, v in launch_counts().items()}
    heads = sum(launched[k] for k in fused_head.LAUNCHES)
    if launched["vit_attention"] or heads != credited_on_card[0]:
        raise RuntimeError(
            f"count_flops: the call launched {launched} and the count "
            f"credited {credited_on_card[0]} head kernel calls on the card")
    return int(counter.get_total_flops() - seen_in_heads[0] + credited[0])


def dinovit_flops(b: int, n: int, d: int, depth: int,
                  patch_in: int = 0) -> int:
    """Analytic matmul FLOPs of a DINOv2 trunk over (B, N) tokens of width
    D: 24 B N D^2 per block (qkv 6, proj 2, fc1 8, fc2 8) and 4 B N^2 D of
    attention (QK^T and PV); patch_in: the patch embedding's input width
    (3 p^2), whose conv adds 2 B (N - 1) D 3 p^2."""
    per_block = 24 * b * n * d * d + 4 * b * n * n * d
    return depth * per_block + 2 * b * (n - 1) * d * patch_in


def peak_flops(dtype: torch.dtype, device: torch.device
               ) -> Tuple[Optional[float], str]:
    """(FLOP/s, label) of the peak for matmuls and convolutions in `dtype`
    on `device`: bf16 dense tensor cores; for f32 the TF32 tensor cores
    where torch lets cuBLAS or cuDNN use them (cuDNN's convolutions do by
    default), else the f32 units; no peak on the CPU."""
    if device.type != "cuda":
        return None, "no peak (cpu)"
    if dtype in (torch.bfloat16, torch.float16):
        return BF16_TC_FLOPS, "bf16 dense 989 TFLOP/s"
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        return TF32_TC_FLOPS, "tf32 dense 494.7 TFLOP/s"
    return F32_FLOPS, "f32 67 TFLOP/s"


def peak_share(flops: float, seconds: float, peak: float) -> float:
    """flops / seconds as a share of `peak`; over 1 raises: a reading over
    the peak is a broken fence, not a fast stage."""
    share = flops / seconds / peak
    if share > 1.0:
        raise RuntimeError(
            f"{flops / seconds / 1e12:.1f} TFLOP/s is {share:.0%} of the "
            f"{peak / 1e12:.1f} TFLOP/s peak: the timer's fence is broken")
    return share


def stage_row(name: str, seconds: float, flops: Optional[float] = None,
              peak: Optional[float] = None, **extra) -> dict:
    """One profiler row: its time, and with a FLOP count (not 0) its
    matmul+conv GFLOP, TFLOP/s and share of the peak; printed as it is
    made."""
    row = {"name": name, "ms": seconds * 1e3}
    line = f"{name:32s} {seconds * 1e3:9.3f} ms"
    if flops:
        row["gflop"] = flops / 1e9
        row["tflops"] = flops / seconds / 1e12
        line += (f"  {flops / 1e9:9.1f} matmul+conv GFLOP  "
                 f"{row['tflops']:7.2f} TFLOP/s")
        if peak:
            row["peak_share"] = peak_share(flops, seconds, peak)
            line += f"  {row['peak_share'] * 100:5.1f}% of peak"
    row.update(extra)
    say(line + "".join(f"  {k} {v}" for k, v in extra.items()))
    return row


def emit(tool: str, device: torch.device, rows: list, **extra) -> dict:
    """Prints and returns the profiler's JSON line: its rows, the card's
    nvidia-smi name and power limit, and the torch version."""
    out = {"tool": tool, "device": str(device), "card": card_line(device),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           **extra, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="where to run (default cuda; raises without a "
                             "card)")


# ---------------------------------------------------------------------------
# chip_smoke.py's kernel timings
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median over `reps` single calls, CUDA events around each: the
    call's host work (argument checks, tensor maps, the launch) counts
    where the card would otherwise wait for it."""
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


def host_us(fn, calls: int = 20, reps: int = 5) -> float:
    """Median over `reps` of the host's time per call to issue `calls`
    back-to-back calls (the card is idle at the start and never waited
    for), in microseconds."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


# the name of torch.cuda._sleep's kernel, device_ms's window end
SENTINEL_KERNEL = "spin_kernel"


def device_ms(fn, calls: int = 20, attempts: int = 3):
    """-> (kernel time per call on the card, profiling windows used, device
    events recorded): the sum of the durations of the device events
    torch.profiler records over `calls` calls, divided by `calls`. A
    window is profiled again, up to `attempts` windows, where the profiler
    delivered no device event at all (it has happened once in
    chip_smoke.py's runs, on an SDPA row that other runs recorded), or
    fewer events of the port's kernels than the wrappers launched (late in
    a full run it has recorded 6 of a row's 20 launches, and all of the
    other kernels); none complete raises. Each window ends with one short
    sentinel kernel (torch.cuda._sleep), left out of the sums: without it
    the profiler on the H100 dropped the window's last kernel record in
    about half the windows after the first of a process (measured: 19 of
    20 launches, window after window; with it, 20 of 20)."""
    for window in range(1, attempts + 1):
        torch.cuda.synchronize()
        before = sum(launch_counts().values())
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        launched = sum(launch_counts().values()) - before
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and SENTINEL_KERNEL not in e.name]
        ours = sum(any(k in e.name for k in PORT_KERNEL_NAMES)
                   for e in events)
        us = sum(e.time_range.end - e.time_range.start for e in events)
        if us > 0 and ours == launched:
            return us / calls / 1e3, window, len(events)
        say(f"the profiler recorded {len(events)} device events, {ours} of "
            f"the {launched} launches of the port's kernels; profiling "
            "again")
    raise RuntimeError(f"the profiler lost device events in {attempts} "
                       "windows")


def timings(fn, prefix: str = "") -> dict:
    """Four times of fn, keys prefixed: ms (time_ms), ms_batched (the
    mean of 20 back-to-back calls, median of 7: device_time, where a
    call's host work is hidden behind the card's queue unless it is slower
    than the kernel), device_ms / device_windows / device_events
    (device_ms) and host_us (host_us)."""
    out = {"ms": time_ms(fn)}
    out["ms_batched"] = device_time(fn, device="cuda", inner=20,
                                    repeats=7) * 1e3
    out["device_ms"], out["device_windows"], out["device_events"] = \
        device_ms(fn)
    out["host_us"] = host_us(fn)
    return {prefix + k: v for k, v in out.items()}


def library_resize(x: torch.Tensor, size, mode: str, align_corners: bool,
                   scale, h_axis: int, w_axis: int) -> torch.Tensor:
    """`interpolate_plain` of a contiguous (N, C, H, W) copy of x (the axes
    before H as N, those after W as C), returned in x's layout: PyTorch's
    NCHW kernels, whose arithmetic the resize kernel computes."""
    from patchfusion_tpu_torch.ops.resize import interpolate_plain

    ha, wa = h_axis % x.ndim, w_axis % x.ndim
    lead, trail = x.shape[:ha], x.shape[wa + 1:]
    nchw = x.reshape(math.prod(lead), x.shape[ha], x.shape[wa],
                     math.prod(trail)).permute(0, 3, 1, 2).contiguous()
    y = interpolate_plain(nchw, size, mode, align_corners, scale, -2, -1)
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[-2:], *trail)


def ulp_stats(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, float]:
    """(largest |a - b| in units in the last place of their dtype, float32
    or bfloat16; the share of elements that are bit-equal): the distance
    of their bit patterns, ordered so that -0 and +0 are one value, taken
    in chunks so that a call's output of gigabytes fits beside it."""
    itype, mag = {torch.float32: (torch.int32, 0x7fffffff),
                  torch.bfloat16: (torch.int16, 0x7fff)}[a.dtype]

    def ordered(t):
        i = t.view(itype).to(torch.int64)
        return torch.where(i < 0, -(i & mag), i)

    fa, fb = a.contiguous().view(-1), b.contiguous().view(-1)
    worst, equal, step = 0, 0, 1 << 26
    for i in range(0, fa.numel(), step):
        d = (ordered(fa[i:i + step]) - ordered(fb[i:i + step])).abs()
        worst = max(worst, int(d.max()))
        equal += int((d == 0).sum())
    return worst, equal / max(fa.numel(), 1)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a function's work
# ---------------------------------------------------------------------------

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
    low resolution (clb_mlp_flops), and per (pixel, bin) ~16 f32
    operations of the log-binomial softmax, the centers' bilinear taps and
    the weighted sum."""
    hi, lo = b * oh * ow, b * ih * iw
    mlp = clb_mlp_flops(b, oh, ow, ih, iw, cin, cc, hid)
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
# the profilers' and the benchmark's configurations
# ---------------------------------------------------------------------------

def published_config(core: str = "vitl") -> dict:
    """The `model.config` of configs/patchfusion_depthanything/
    depthanything_{core}_patchfusion_u4k.py (core: vits, vitb or vitl),
    the DA-ZoeDepth PatchFusion the JAX profilers build inline, or for
    core "beit" of configs/patchfusion_zoedepth/zoedepth_patchfusion_u4k.py
    (MiDaS DPT_BEiT_L_384 branches at 384x512), without branch
    checkpoints."""
    from patchfusion_tpu_torch.config import Config

    path = ZOE_CONFIG if core == "beit" else \
        CONFIGS / f"depthanything_{core}_patchfusion_u4k.py"
    cfg = Config.fromfile(str(path)).model.config.to_dict()
    cfg.update(load_branch=False, pretrain_model=None)
    return cfg


def tiny_config() -> dict:
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


DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def seeded_input(shape, device, seed: int, dtype=torch.float32,
                 normal: bool = False) -> torch.Tensor:
    """A numpy-seeded tensor on `device`: uniform [0, 1), or normal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32) if normal else \
        rng.random(shape, dtype=np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)
