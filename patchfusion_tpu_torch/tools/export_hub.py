"""Write the port's weights in the reference's snapshot layout (the port of
tools/export_hub.py; the reference's tools/convert_huggingface.py in
reverse):

    python -m patchfusion_tpu_torch.tools.export_hub CONFIG \
        --weights WEIGHTS --out-dir SNAPSHOT_DIR

WEIGHTS is one of the port's files (engine/checkpoint.py): a full weights
file (tools/convert_checkpoint.py) or a fusion-only one (PatchFusion.save,
a training checkpoint). SNAPSHOT_DIR gets `config.json` ({"config": the
model config}) and `pytorch_model.bin`, the reference-layout state dict
(the port's modules keep the reference's names) with floating tensors in
float32: every key of the net from a full file, loaded strictly, or the
fusion part's keys from a fusion-only one (its buffers, which a save file
leaves out, from the net built on the CPU). PatchFusion.from_pretrained
reads a full snapshot.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="the port's weights -> a "
                                "reference snapshot directory")
    p.add_argument("config")
    p.add_argument("--weights", required=True,
                   help="weights file (tools/convert_checkpoint, "
                        "PatchFusion.save) or training checkpoint")
    p.add_argument("--out-dir", required=True)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> bool:
    """Returns whether the export was fusion-only."""
    args = parse_args(argv)

    import torch

    from patchfusion_tpu_torch.config import Config
    from patchfusion_tpu_torch.engine.checkpoint import (
        fit_rel_pos_tables, load_fusion_state_dict, read_weights)
    from patchfusion_tpu_torch.models.builder import build_patchfusion
    from patchfusion_tpu_torch.models.patchfusion import FROZEN_KEYS

    config = Config.fromfile(args.config).model["config"].to_dict()
    params, stats = read_weights(args.weights)
    sd = {**params, **stats}
    fusion_only = not any(k.split(".")[0] in FROZEN_KEYS for k in sd)
    if fusion_only:
        net, _ = build_patchfusion(config, device="cpu")
        load_fusion_state_dict(net, sd)
        out = {k: v for k, v in net.state_dict().items()
               if k.split(".")[0] not in FROZEN_KEYS}
    else:
        net, _ = build_patchfusion(config, device="meta")
        net.load_state_dict(fit_rel_pos_tables(net, sd), strict=True,
                            assign=True)
        out = net.state_dict()
    out = {k: v.float() if v.is_floating_point() else v
           for k, v in out.items()}
    os.makedirs(args.out_dir, exist_ok=True)
    torch.save(out, os.path.join(args.out_dir, "pytorch_model.bin"))
    with open(os.path.join(args.out_dir, "config.json"), "w") as f:
        json.dump({"config": config}, f, indent=2, default=str)
    print(f"exported {len(out)} tensors to {args.out_dir} "
          f"(fusion_only={fusion_only})")
    return fusion_only


if __name__ == "__main__":
    main()
