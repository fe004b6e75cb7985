"""Write a small synthetic dataset in the UnrealStereo4K layout for smoke
and demo training runs (the port of tools/make_synth_u4k.py, without
OpenCV):

    python -m patchfusion_tpu_torch.tools.make_synth_u4k --root DIR \
        [--n-train 8] [--n-val 2] [--oversample 16] [--seed 0] \
        [--height 2160] [--width 3840]

Per scene `scene_XX/Image0/00000.raw` (uint8 BGR), `Disp0/00000.npy`
(float32 disparity), `Extrinsics0/1/00000.txt` (focal 100, baseline 0.5:
depth = 50 / disparity), as data/u4k.py reads them (reference
estimator/datasets/u4k_dataset.py:118-137); `train.txt`, `val.txt` and
`train_x{N}.txt` (the train list N times, the split
configs/demo/train_fusion_synth_vitl.py trains on).

The scenes are procedural but learnable: depth is a smooth low-frequency
field with a few planar rectangles, and the image a function of depth
(shading and albedo bands), so the fusion stage can lower its loss. The
draws come from np.random.default_rng(seed) in the JAX tool's order, and
the smooth fields are enlarged as cv2.resize's INTER_LINEAR enlarges
(half-pixel centres, edges clamped: F.interpolate bilinear with
align_corners=False), so the two tools write the same scenes up to float
rounding. The full-resolution work runs as a few whole-array passes into
preallocated buffers: per-pixel Python at 4K takes minutes.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple

import numpy as np

FOCAL, BASELINE = 100.0, 0.5  # depth_factor = 50


def lowfreq(rng: np.random.Generator, shape: Tuple[int, int],
            cells=(6, 10), lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """A smooth random float32 field in [lo, hi]: `cells` uniform draws
    enlarged bilinearly to `shape` (half-pixel centres, edges clamped)."""
    import torch
    import torch.nn.functional as F

    coarse = rng.random((cells[0], cells[1])).astype(np.float32)
    coarse = np.float32(lo) + np.float32(hi - lo) * coarse
    out = F.interpolate(torch.from_numpy(coarse)[None, None],
                        size=tuple(shape), mode="bilinear",
                        align_corners=False)
    return out[0, 0].numpy()


def make_scene(rng: np.random.Generator, h: int = 2160, w: int = 3840
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(image (h, w, 3) uint8 RGB, depth (h, w) float32)."""
    depth = lowfreq(rng, (h, w), cells=(5, 8), lo=4.0, hi=60.0)
    # planar rectangles at distinct depths: sharp boundaries for the
    # boundary and SEE metrics
    for _ in range(rng.integers(3, 7)):
        rh, rw = rng.integers(h // 10, h // 3), rng.integers(w // 10, w // 3)
        y, x = rng.integers(0, h - rh), rng.integers(0, w - rw)
        depth[y:y + rh, x:x + rw] = np.float32(rng.uniform(2.0, 30.0))
    # image = shading from depth and albedo stripes, one channel at a time
    # into a preallocated uint8 buffer (the float -> uint8 cast truncates;
    # the range is [0, 255])
    shade = np.float32(1.0) / (np.float32(1.0) + depth * np.float32(0.05))
    albedo = np.float32(0.25) + np.float32(0.75) * lowfreq(
        rng, (h, w), cells=(8, 14))
    img8 = np.empty((h, w, 3), np.uint8)
    np.multiply(shade, albedo * np.float32(255.0), out=albedo)
    img8[..., 0] = albedo
    np.subtract(np.float32(255.0), albedo * np.float32(0.5), out=albedo)
    np.multiply(shade, albedo, out=albedo)
    img8[..., 1] = albedo
    np.multiply(shade, np.float32(0.7 * 255.0), out=shade)
    np.add(shade, np.float32(0.3 * 255.0), out=shade)
    np.clip(shade, 0, 255, out=shade)
    img8[..., 2] = shade
    return img8, depth


def write_scene(root: str, i: int, img8: np.ndarray,
                depth: np.ndarray) -> str:
    """Scene i's files under root; returns its split line."""
    scene = os.path.join(root, f"scene_{i:02d}")
    for sub in ("Image0", "Disp0", "Extrinsics0", "Extrinsics1"):
        os.makedirs(os.path.join(scene, sub), exist_ok=True)
    # the loader reads BGR raw (data/u4k.py)
    img8[..., ::-1].tofile(os.path.join(scene, "Image0", "00000.raw"))
    np.save(os.path.join(scene, "Disp0", "00000.npy"),
            (FOCAL * BASELINE) / depth)
    with open(os.path.join(scene, "Extrinsics0", "00000.txt"), "w") as f:
        f.write(f"{FOCAL} 0 0\n0 0 0 0.0\n")
    with open(os.path.join(scene, "Extrinsics1", "00000.txt"), "w") as f:
        f.write(f"{FOCAL} 0 0\n0 0 0 {BASELINE}\n")
    rel = f"scene_{i:02d}"
    return f"{rel}/Image0/00000.png x {rel}/Disp0/00000.npy y\n"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="synthetic U4K-layout scenes")
    ap.add_argument("--root", required=True)
    ap.add_argument("--n-train", type=int, default=8)
    ap.add_argument("--n-val", type=int, default=2)
    ap.add_argument("--oversample", type=int, default=16,
                    help="also write train_x{N}.txt with the train list "
                         "repeated N times (gives the demo training config "
                         "enough steps per epoch from few 4K scenes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--width", type=int, default=3840)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Returns the scenes' split lines, train first."""
    args = parse_args(argv)
    rng = np.random.default_rng(args.seed)
    lines = [write_scene(args.root, i,
                         *make_scene(rng, args.height, args.width))
             for i in range(args.n_train + args.n_val)]
    with open(os.path.join(args.root, "train.txt"), "w") as f:
        f.writelines(lines[:args.n_train])
    with open(os.path.join(args.root, "val.txt"), "w") as f:
        f.writelines(lines[args.n_train:])
    if args.oversample > 1:
        # each epoch visits every train scene N times, other random crops
        # each time (the dataset's augmentations)
        name = f"train_x{args.oversample}.txt"
        with open(os.path.join(args.root, name), "w") as f:
            f.writelines(lines[:args.n_train] * args.oversample)
    print(f"wrote {args.n_train} train + {args.n_val} val scenes under "
          f"{args.root}")
    return lines


if __name__ == "__main__":
    main()
