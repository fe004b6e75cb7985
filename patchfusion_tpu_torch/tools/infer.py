"""Single-image inference (the port of tools/infer.py; the reference
tools/test_single_forward.py example): load a model, resize an image, run
tiled inference, save colorized and uint16 depth PNGs.

    python -m patchfusion_tpu_torch.tools.infer IMAGE [--ckp-path CKP] \
        [--config CFG] [--cai-mode m1] [--out depth.png]

--ckp-path: a local snapshot directory, 'coarse.pth,fine.pth[,fusion.pth]' or
one of the port's weights files (tools.convert_checkpoint, PatchFusion.save)
(random seeded weights without). As tools/infer.py, less --chunk-policy,
plus --device (default cuda) and --dtype (default bfloat16), as in
patchfusion_tpu_torch.tools.test.

Several ranks (torchrun --nproc-per-node N -m
patchfusion_tpu_torch.tools.infer IMAGE ...), one device each; --mesh
maps the JAX package's local-device mesh onto them: patch (auto's choice
where there is more than one rank) splits the image's tiles across the
ranks and rank 0 writes the PNGs; none lets rank 0 answer alone; patch
errors in a world of 1.
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
    p.add_argument("--mesh", default="auto",
                   choices=["auto", "patch", "none"],
                   help="several ranks: split the tiles across them "
                        "(patch, auto) or let rank 0 answer (none)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Optional[np.ndarray]:
    """Returns the depth map (on a rank that computed it; None on the
    others under --mesh none)."""
    args = parse_args(argv)

    from PIL import Image

    from patchfusion_tpu_torch.config import Config
    from patchfusion_tpu_torch.data.general import _resize_bicubic_ac
    from patchfusion_tpu_torch.parallel.dist import (init_rank, is_main,
                                                     resolve_cli_mesh)
    from patchfusion_tpu_torch.utils.colorize import save_depth_png

    device = init_rank(args.device)
    mesh = resolve_cli_mesh(args.mesh)
    if mesh is None and not is_main():
        return None
    config = Config.fromfile(args.config).model["config"].to_dict()
    model = load_patchfusion(config, args.ckp_path, device,
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
                        image_raw_shape=raw_shape, mesh=mesh)
    if not is_main():
        return depth
    base, _ = os.path.splitext(args.out)
    save_depth_png(depth, args.out, base + "_uint16.png")
    print(f"depth: {depth.shape}, range [{depth.min():.3f}, "
          f"{depth.max():.3f}] -> {args.out}")
    return depth


if __name__ == "__main__":
    from patchfusion_tpu_torch.parallel.dist import shutdown

    main()
    shutdown()
