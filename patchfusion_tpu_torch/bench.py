"""Throughput benchmark: 4K images/sec/chip for PatchFusion tiled inference
on one CUDA card (the port of the JAX package's bench.py).

    python -m patchfusion_tpu_torch.bench
    BENCH_CORE=vits BENCH_MODE=m1 python -m patchfusion_tpu_torch.bench
    BENCH_MESH=patch python -m patchfusion_tpu_torch.bench   # CPU parity

Target metric: DA-vitl, p49 (= cai_mode m2 on a 4x4 split) on 2160x3840
input. The `vs_baseline` ratio is against A100_P49_IMG_PER_S below.

Env overrides, as bench.py's: BENCH_CORE (vitl|vitb|vits|beit; beit
selects the ZoeDepth / MiDaS DPT_BEiT_L_384 variant at 384x512),
BENCH_MODE (m1|m2|rN), BENCH_DTYPE (bf16|f32), BENCH_ITERS,
BENCH_PROCESS_NUM (tiles per chunk; 0 is one whole pass; default 16, or 0
for vits). The bf16 DINOv2 attention runs on the attention kernel;
PF_ATTN_IMPL=einsum routes it through the einsum path instead.

The model is the published config of the core (`bench_config`) with
seeded random weights (`PatchFusion.from_config(seed=0)`); the input is
numpy's default_rng(0) 2160x3840 image, and its low-resolution copy comes
from the port's bilinear resize. `run` times, through the engine
(engine/inference.py; its depth stays on the device): one fenced first
request, `iters` requests each fenced by a host readback of the depth's
mean (their median is `latency_ms`), and `iters` requests queued back to
back and fenced once at the end (images/s, the reported `value`). The
engine takes the image from the host, so every request includes its
copy to the card.

Two of bench.py's keys change meaning in eager PyTorch, which compiles no
graph: `compile_first_s` is the kernels' build (or their load from
`_build/`) plus the first request, in a fresh process; `cache_new_entries`
counts the kernel libraries `ops/cuda_lib.build_kernels` compiled during
the run (0 when `_build/` was warm). Diagnostics (init seconds, per-image
latency, launches per request, peak allocated memory) go to stderr before
the JSON line on stdout.

BENCH_MESH=patch runs the parity check of the tile split instead: the
tiny config's m2 through the engine in this process against the same
request split over 8 gloo ranks on the CPU (parallel/dist.PatchMesh),
within 2e-4 absolute; it exits 1 above the limit.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from patchfusion_tpu_torch.tools import _bench_util as bu

# A100 80GB PyTorch 2.1 estimate for DA-vitl p49 4K inference, img/s.
# FLOPs-grounded (see BASELINE.md "A100 baseline derivation"): XLA cost
# analysis counts 198.0 TFLOP per p49 4K image (1.39T coarse+G2L +
# 49 x 4.02T fine+fusion tiles); 0.33 img/s corresponds to the reference
# eager-PyTorch pipeline sustaining 65 TFLOP/s = 21% MFU of A100 fp16 peak
# (312 TFLOP/s) — a realistic rate for its per-tile Python loops,
# process_num=2 micro-batches, and unfused interpolate/attention mix.
# Kept fixed across rounds so the ratio is comparable.
A100_P49_IMG_PER_S = 0.33

CORES = ("vitl", "vitb", "vits", "beit")
RAW_SHAPE = (2160, 3840)
MESH_TOL = 2e-4  # tile split vs one process, absolute (bench.py:87)
MESH_WORLD = 8
MESH_PROCESS_NUM = 2
MESH_TIMEOUT = 600.0  # seconds for every rank to finish
REPO = Path(__file__).resolve().parents[1]


def bench_config(core: str) -> dict:
    """The model config bench.py builds for `core` (bench.py:120-157),
    read from the published config file: configs/patchfusion_depthanything/
    depthanything_{core}_patchfusion_u4k.py for vits / vitb / vitl,
    configs/patchfusion_zoedepth/zoedepth_patchfusion_u4k.py for beit;
    without branch checkpoints."""
    if core not in CORES:
        raise ValueError(f"BENCH_CORE {core!r} is not one of {CORES}")
    return bu.published_config(core)


def bench_env(env: Mapping[str, str]) -> dict:
    """bench.py's environment contract (bench.py:103-116): core, mode,
    dtype label, iters and process_num (None: one whole pass)."""
    core = env.get("BENCH_CORE", "vitl")
    default_pn = "0" if core == "vits" else "16"
    return {"core": core,
            "mode": env.get("BENCH_MODE", "m2"),
            "dtype": env.get("BENCH_DTYPE", "bf16"),
            "iters": int(env.get("BENCH_ITERS", "5")),
            "process_num": int(env.get("BENCH_PROCESS_NUM", default_pn))
            or None}


def say_err(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _built_libraries() -> int:
    from patchfusion_tpu_torch.ops import cuda_lib

    return len(list(cuda_lib.BUILD_DIR.glob(f"*/{cuda_lib.LIB_NAME}")))


def _core_label(config: dict) -> str:
    core = config["coarse_branch"]["midas_model_type"]
    return "beit" if core == "DPT_BEiT_L_384" else core


def _fence(depth: torch.Tensor) -> float:
    """A host readback of a value that depends on the whole depth map."""
    return float(depth.mean())


def run(model, mode: str, iters: int, process_num: Optional[int],
        image_hr: np.ndarray, image_lr: np.ndarray,
        dtype_label: Optional[str] = None) -> dict:
    """bench.py's measurements (bench.py:192-246) of the PatchFusion
    `model` (api.PatchFusion) through its engine at `process_num` tiles per
    chunk (None: one whole pass): the first request, `iters` fenced
    requests, then `iters` queued ones. image_hr (H, W, 3) and image_lr
    (1, h, w, 3), NHWC float32 numpy. dtype_label: the metric's dtype
    (BENCH_DTYPE as given; default bf16 or f32 from the weights). Returns
    bench.py's JSON line as a dict; the diagnostics go to stderr."""
    from patchfusion_tpu_torch.engine.inference import PatchFusionInference

    engine = PatchFusionInference(model.net, model.tile_cfg,
                                  process_num=process_num)
    dtype_s = dtype_label or (
        "bf16" if model.net.dtype == torch.bfloat16 else "f32")
    cuda = model.net.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(model.net.device)
    libs_before = _built_libraries()
    t0 = time.perf_counter()
    _fence(engine.infer(image_lr, image_hr, cai_mode=mode))
    first_s = time.perf_counter() - t0
    new_entries = _built_libraries() - libs_before
    say_err(f"compile+first: {first_s:.1f}s ({new_entries} new kernel "
            "libraries)")

    # latency: fence every image (includes the host round trip)
    times = []
    for i in range(iters):
        before = bu.launch_counts()
        t0 = time.perf_counter()
        _fence(engine.infer(image_lr, image_hr, cai_mode=mode))
        times.append(time.perf_counter() - t0)
        if i == 0:
            after = bu.launch_counts()
            say_err("launches per request: " + json.dumps(
                {k: v - before[k] for k, v in after.items()}))
    lat = float(np.median(times))
    say_err(f"per-image latency: {lat * 1e3:.0f} ms (each: "
            + ", ".join(f"{t * 1e3:.1f}" for t in times) + ")")
    # throughput (the reported metric): queue every request, fence once
    # at the end; the device's work is serial, this hides only what the
    # host does between requests while the card still runs
    t0 = time.perf_counter()
    outs = [engine.infer(image_lr, image_hr, cai_mode=mode)
            for _ in range(iters)]
    for d in outs:
        _fence(d)
    dt = (time.perf_counter() - t0) / iters
    # the ratio of the printed value, so that the line agrees with itself
    img_per_s = round(1.0 / dt, 4)
    if cuda:
        peak = torch.cuda.max_memory_allocated(model.net.device)
        say_err(f"peak allocated: {peak / 2**30:.2f} GiB")
    paper_mode = {"m1": "p16", "m2": "p49"}.get(mode, mode)
    return {
        "metric": f"4K images/sec/chip (DA-{_core_label(model.config)}, "
                  f"{paper_mode}, {dtype_s})",
        "value": img_per_s,
        "unit": "img/s",
        "vs_baseline": round(img_per_s / A100_P49_IMG_PER_S, 3),
        "latency_ms": round(lat * 1e3, 1),
        "compile_first_s": round(first_s, 1),
        "cache_new_entries": new_entries,
    }


def bench_images(process_shape, raw_shape=RAW_SHAPE, seed: int = 0):
    """(image_hr (H, W, 3), image_lr (1, h, w, 3)): numpy's seeded uniform
    image and its copy at the process shape, bilinear with
    align_corners=True (the reference's Resize transform)."""
    from patchfusion_tpu_torch.ops.resize import interpolate

    hr = np.random.default_rng(seed).random((*raw_shape, 3), np.float32)
    with torch.no_grad():
        lr = interpolate(torch.from_numpy(hr)[None], tuple(process_shape),
                         mode="bilinear", align_corners=True).numpy()
    return hr, lr


def main(env: Mapping[str, str] = os.environ) -> dict:
    """bench.py's main on the card: builds the core's model, runs `run`
    and prints its JSON line. Raises where CUDA is missing."""
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.models.builder import check_device

    device = check_device("cuda")
    args = bench_env(env)
    dtype = torch.bfloat16 if args["dtype"] == "bf16" else torch.float32
    config = bench_config(args["core"])
    t0 = time.perf_counter()
    model = PatchFusion.from_config(config, device=device, dtype=dtype,
                                    seed=0)
    torch.cuda.synchronize(device)
    say_err(f"init: {time.perf_counter() - t0:.1f}s")
    hr, lr = bench_images(model.tile_cfg.patch_process_shape,
                          tuple(model.tile_cfg.image_raw_shape))
    line = run(model, args["mode"], args["iters"], args["process_num"], hr,
               lr, dtype_label=args["dtype"])
    print(json.dumps(line), flush=True)
    return line


# ---------------------------------------------------------------------------
# BENCH_MESH=patch: the tile split's parity over gloo ranks on the CPU
# ---------------------------------------------------------------------------

def _mesh_images():
    """bench.py:76-78's input at the tiny config's sizes: an 84x112 seeded
    image and its 42x56 copy."""
    return bench_images((42, 56), (84, 112))


def mesh_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of main_mesh_parity: the tiny config's m2 with its tiles
    split over the `world` gloo ranks; rank 0 writes the depth to
    out_dir/depth.npy."""
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.engine.inference import PatchFusionInference
    from patchfusion_tpu_torch.parallel import dist

    torch.set_num_threads(1)
    dist.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    try:
        model = PatchFusion.from_config(bu.tiny_config(), device="cpu",
                                        seed=0)
        engine = PatchFusionInference(model.net, model.tile_cfg,
                                      process_num=MESH_PROCESS_NUM,
                                      mesh=dist.make_patch_mesh())
        hr, lr = _mesh_images()
        depth = engine.infer(lr, hr, cai_mode="m2").numpy()
        if rank == 0:
            np.save(Path(out_dir) / "depth.npy", depth)
    finally:
        dist.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ranks(world: int, out_dir: str):
    """`world` processes of this module, each one rank of mesh_rank over
    gloo on one CPU thread."""
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "patchfusion_tpu_torch.bench", "--mesh-rank",
         str(r), str(world), port, out_dir], env=env, cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _join_ranks(procs, deadline: float) -> None:
    """Every rank's exit by the deadline; on expiry or a failed rank every
    process is killed and the ranks' stderr raised."""
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            errs.append(err)
            if p.returncode != 0:
                raise RuntimeError(f"mesh rank {len(errs) - 1} exited "
                                   f"{p.returncode}:\n{err[-4000:]}")
    except subprocess.TimeoutExpired:
        raise RuntimeError("mesh ranks timed out:\n"
                           + "\n".join(e[-2000:] for e in errs)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def main_mesh_parity() -> dict:
    """bench.py's BENCH_MESH=patch (bench.py:52-93) over torch.distributed:
    the tiny config (seeded weights) through the engine at process_num 2
    in this process, against the same m2 request with its tiles split over
    MESH_WORLD gloo ranks (child processes of this module; NCCL refuses two
    ranks on one card, so this stays on the CPU). Prints bench.py's parity
    line; exits 1 where the max |difference| reaches MESH_TOL."""
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.engine.inference import PatchFusionInference

    with tempfile.TemporaryDirectory(prefix="pf_mesh_") as out_dir:
        procs = _spawn_ranks(MESH_WORLD, out_dir)
        deadline = time.monotonic() + MESH_TIMEOUT
        try:
            model = PatchFusion.from_config(bu.tiny_config(), device="cpu",
                                            seed=0)
            single = PatchFusionInference(model.net, model.tile_cfg,
                                          process_num=MESH_PROCESS_NUM)
            hr, lr = _mesh_images()
            d_single = single.infer(lr, hr, cai_mode="m2").numpy()
        finally:
            _join_ranks(procs, deadline)
        d_sharded = np.load(Path(out_dir) / "depth.npy")
    diff = float(np.max(np.abs(d_single - d_sharded)))
    ok = diff < MESH_TOL
    line = {"metric": f"p49 patch-sharded parity ({MESH_WORLD} gloo ranks "
                      "on the CPU)",
            "value": diff, "unit": "max_abs_diff",
            "vs_baseline": 1.0 if ok else 0.0}
    print(json.dumps(line), flush=True)
    if not ok:
        raise SystemExit(1)
    return line


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"] and len(sys.argv) == 6:
        mesh_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
    elif len(sys.argv) > 1:
        raise SystemExit("usage: python -m patchfusion_tpu_torch.bench "
                         "(BENCH_* in the environment)")
    elif os.environ.get("BENCH_MESH") == "patch":
        main_mesh_parity()
    else:
        main()
