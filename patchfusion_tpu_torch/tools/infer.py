"""Single-image inference (the port of tools/infer.py; the reference
tools/test_single_forward.py example): load a model, resize an image, run
tiled inference, save colorized and uint16 depth PNGs.

    python -m patchfusion_tpu_torch.tools.infer IMAGE [--ckp-path CKP] \
        [--config CFG] [--cai-mode m1] [--out depth.png]

--ckp-path: a local snapshot directory or 'coarse.pth,fine.pth[,fusion.pth]'
(random seeded weights without). As tools/infer.py, less --mesh and
--chunk-policy, plus --device (default cuda) and --dtype (default
bfloat16), as in patchfusion_tpu_torch.tools.test.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from patchfusion_tpu_torch.tools.test import DTYPES, load_patchfusion


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="PatchFusion on one image")
    p.add_argument("image")
    p.add_argument("--ckp-path", default=None,
                   help="snapshot dir or coarse,fine,fusion .pth triple")
    p.add_argument("--config",
                   default="configs/patchfusion_depthanything/"
                           "depthanything_vitl_patchfusion_u4k.py")
    p.add_argument("--cai-mode", default="m1")
    p.add_argument("--process-num", type=int, default=4)
    p.add_argument("--image-raw-shape", nargs="+", type=int,
                   default=[2160, 3840])
    p.add_argument("--out", default="depth.png")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Returns the depth map it saved."""
    args = parse_args(argv)

    from PIL import Image

    from patchfusion_tpu_torch.config import Config
    from patchfusion_tpu_torch.data.general import _resize_bicubic_ac
    from patchfusion_tpu_torch.utils.colorize import save_depth_png

    config = Config.fromfile(args.config).model["config"].to_dict()
    model = load_patchfusion(config, args.ckp_path, args.device,
                             DTYPES[args.dtype])

    raw_shape = tuple(args.image_raw_shape)
    img = np.asarray(Image.open(args.image).convert("RGB"),
                     np.float32) / 255.0
    if img.shape[:2] != raw_shape:
        img = np.clip(_resize_bicubic_ac(img, raw_shape), 0, 1)
    with torch.no_grad():
        image_lr = model.resizer(torch.from_numpy(img)[None]).numpy()
    depth = model.infer(image_lr, img, cai_mode=args.cai_mode,
                        process_num=args.process_num,
                        image_raw_shape=raw_shape)
    base, _ = os.path.splitext(args.out)
    save_depth_png(depth, args.out, base + "_uint16.png")
    print(f"depth: {depth.shape}, range [{depth.min():.3f}, "
          f"{depth.max():.3f}] -> {args.out}")
    return depth


if __name__ == "__main__":
    main()
