"""Checkpoint IO (patchfusion_tpu/engine/checkpoint.py): the port's own
training checkpoints and weight files, and the reference's checkpoints.

The port's own format is a `torch.save` of plain dicts of tensors (read
back with weights_only=True), written to `path + ".tmp"` and then
os.replace'd, as the JAX package writes its files:

  * `save_checkpoint` (a training checkpoint, fusion-only like the
    reference's get_save_dict, patchfusion.py:179-187): epoch, step,
    the trainable parameters, the BatchNorm statistics and the optimizer
    state (with the schedule's position, `step`), by state_dict names;
  * `save_params` (weights only: params and, where given, batch_stats).

It reads no flax msgpack file (the JAX package's `.ckpt` and params
files): those raise, saying so.

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
import pickle
import zipfile
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

FORMAT = "patchfusion_tpu_torch"  # the "format" entry of the port's files


def _cpu(tree):
    """A copy of a nested dict / list of tensors on the CPU, detached."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _write(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    torch.save({"format": FORMAT, **payload}, tmp)
    os.replace(tmp, path)


def _read(path: str) -> Dict[str, Any]:
    """One of the port's files, on the CPU; anything else raises."""
    if not zipfile.is_zipfile(path):  # torch.save writes a zip archive
        raise ValueError(
            f"{path} is not a checkpoint of patchfusion_tpu_torch (a "
            "torch.save of plain dicts of tensors); the port reads no flax "
            "msgpack file of the JAX package")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of "
                         "patchfusion_tpu_torch (no format entry)")
    return blob


def save_checkpoint(path: str, state, epoch: int) -> None:
    """Save a TrainState (engine/training.py): epoch, step, the trainable
    parameters, the BN statistics and the optimizer state. Fusion-only (the
    reference's get_save_dict): the frozen branches are not written; they
    load from their own stage-1/2 checkpoints."""
    _write(path, {"epoch": int(epoch), "step": int(state.step),
                  "trainable": _cpu(state.trainable),
                  "batch_stats": _cpu(state.batch_stats),
                  "opt_state": _cpu(state.optimizer.state_dict())})


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A save_checkpoint file as its dict (tensors on the CPU)."""
    blob = _read(path)
    if "trainable" not in blob:
        raise ValueError(f"{path} is a weights file, not a training "
                         "checkpoint (load it with load_params)")
    return blob


def restore_train_state(state, blob: Dict[str, Any]) -> int:
    """Load a load_checkpoint dict into a TrainState in place: the trainable
    weights and BN statistics, the optimizer state and the step. Returns
    the checkpoint's epoch."""
    load_fusion_state_dict(state.net, {**blob["trainable"],
                                       **blob["batch_stats"]})
    state.optimizer.load_state_dict(blob["opt_state"])
    state.step = int(blob["step"])
    return int(blob.get("epoch", 0))


def save_params(path: str, params: Dict[str, torch.Tensor],
                batch_stats: Optional[Dict[str, torch.Tensor]] = None
                ) -> None:
    """Weights only (the JAX package's inference-weights export): params
    and, where given, the BN statistics, by state_dict names."""
    payload = {"params": _cpu(params)}
    if batch_stats is not None:
        payload["batch_stats"] = _cpu(batch_stats)
    _write(path, payload)


def load_params(path: str) -> Dict[str, Any]:
    """A save_params file as its dict (tensors on the CPU)."""
    blob = _read(path)
    if "params" not in blob:
        raise ValueError(f"{path} is a training checkpoint, not a weights "
                         "file (read it with load_checkpoint)")
    return blob


def read_weights(path: str) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """(params, batch_stats) of either of the port's files: a weights file
    or a training checkpoint (its trainable part)."""
    blob = _read(path)
    if "params" in blob:
        return blob["params"], blob.get("batch_stats", {})
    return blob["trainable"], blob["batch_stats"]


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pth` checkpoint's model_state_dict (or a bare state
    dict), on the CPU; a weights file of the port's own (save_params, as
    tools/train_branch.py writes a branch) gives its params and batch
    statistics. weights_only=False: the reference's files pickle more than
    tensors, so only files from a trusted source may be read."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=False)
    except (pickle.UnpicklingError, ValueError, EOFError) as e:
        raise ValueError(f"{path} is not a torch checkpoint; the port reads "
                         "no flax msgpack file of the JAX package") from e
    if blob.get("format") == FORMAT:
        return {**blob["params"], **blob.get("batch_stats", {})}
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
