"""Turn the reference's `.pth` checkpoints into one weights file of the
port (the port of tools/convert_checkpoint.py; the reference's
tools/convert_huggingface.py analogue):

    python -m patchfusion_tpu_torch.tools.convert_checkpoint CONFIG \
        --coarse coarse.pth --fine fine.pth [--fusion fusion.pth] \
        --save-path weights.pt

The files are read as PatchFusion.from_config(ckpts=) reads them
(engine/checkpoint.py: each branch strictly, its BEiT tables fitted to the
config's grid; the fusion-only file strict=False) into the config's net
built on the meta device, and what they hold is written as one weights
file (engine/checkpoint.save_weights): both branches and, with --fusion,
the fusion part, every key of the net where the fusion file is the
reference's. The tensors keep the files' dtypes; nothing runs on a device.
PatchFusion.load_dict and the test / infer CLIs' --ckp-path read the file.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="reference .pth files -> one "
                                "weights file of the port")
    p.add_argument("config")
    p.add_argument("--coarse", required=True, help="coarse branch .pth")
    p.add_argument("--fine", required=True, help="fine branch .pth")
    p.add_argument("--fusion", default=None, help="fusion-only .pth")
    p.add_argument("--save-path", required=True, help="output weights file")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> str:
    """Returns the written path."""
    args = parse_args(argv)

    from patchfusion_tpu_torch.config import Config
    from patchfusion_tpu_torch.engine.checkpoint import (
        load_patchfusion_from_torch, save_weights)
    from patchfusion_tpu_torch.models.builder import build_patchfusion

    config = Config.fromfile(args.config).model["config"].to_dict()
    net, _ = build_patchfusion(config, device="meta")
    load_patchfusion_from_torch(net, args.coarse, args.fine, args.fusion,
                                assign=True)
    save_weights(args.save_path, net)
    print(f"wrote {args.save_path} (fusion part "
          f"{'from ' + args.fusion if args.fusion else 'not included'})")
    return args.save_path


if __name__ == "__main__":
    main()
