"""Reference checkpoint import (patchfusion_tpu/engine/checkpoint.py:82-142).

The reference ships PatchFusion as three files, or as one HF snapshot
directory:

  * a coarse and a fine branch checkpoint (`.pth`, {'model_state_dict': ...}
    as the reference's tools/train.py saves it), each loaded strictly into
    its branch; their keys carry no prefix;
  * a fusion-only checkpoint (the reference's get_save_dict strips the
    frozen branches, patchfusion.py:179-187): `fusion_conv_list.*`,
    `guided_fusion.*` and the PF metric-bins head, merged with
    strict=False semantics, so a key the file lacks keeps its current
    value; a key the net does not have raises;
  * a snapshot directory (`config.json` + `pytorch_model.bin` or
    `model.safetensors`, reference tools/convert_huggingface.py) holding
    the full state dict, loaded strictly.

The port's modules keep the reference's state_dict names, so the files load
without a key mapping. Loading happens wherever the net's parameters lie;
the callers in api.py load on the CPU before moving and casting the net.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.nn as nn


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pth` checkpoint's model_state_dict (or a bare state
    dict), on the CPU. weights_only=False: the reference's files pickle
    more than tensors, so only files from a trusted source may be read."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    return blob.get("model_state_dict", blob)


def load_fusion_state_dict(net: nn.Module, sd: Dict[str, torch.Tensor]
                           ) -> None:
    """Merge a fusion-only state dict over `net` (strict=False): missing
    keys keep their values; keys that are not the net's raise."""
    res = net.load_state_dict(sd, strict=False)
    if res.unexpected_keys:
        raise ValueError(f"fusion checkpoint has {len(res.unexpected_keys)} "
                         f"unexpected keys, e.g. {res.unexpected_keys[:3]}")


def load_patchfusion_from_torch(net: nn.Module, coarse_path: str,
                                fine_path: str,
                                fusion_path: Optional[str] = None) -> None:
    """Load the reference's three checkpoints into a PatchFusionNet: each
    branch file strictly into its branch (reference patchfusion.py:105-109),
    then the fusion-only file, where one is given (load_dict strict=False);
    without one the fusion part keeps its current weights."""
    net.coarse_branch.load_state_dict(load_torch_state_dict(coarse_path),
                                      strict=True)
    net.fine_branch.load_state_dict(load_torch_state_dict(fine_path),
                                    strict=True)
    if fusion_path:
        load_fusion_state_dict(net, load_torch_state_dict(fusion_path))


def read_hub_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The full state dict of a snapshot directory: pytorch_model.bin, or
    else model.safetensors (which needs the `safetensors` package)."""
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(bin_path):
        return load_torch_state_dict(bin_path)
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"{st_path} needs the `safetensors` package, "
                              "which is not installed") from e
        return load_file(st_path, device="cpu")
    raise FileNotFoundError(f"no pytorch_model.bin or model.safetensors "
                            f"under {path}")


def load_patchfusion_hub_dir(net: nn.Module, path: str) -> None:
    """Load a snapshot directory's full state dict into a PatchFusionNet,
    strictly, taking the file's tensors as the net's parameters and buffers
    (assign=True: the net may be built on the meta device, and nothing is
    copied twice)."""
    net.load_state_dict(read_hub_state_dict(path), strict=True, assign=True)
