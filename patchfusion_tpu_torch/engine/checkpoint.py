"""Checkpoint IO (patchfusion_tpu/engine/checkpoint.py): the port's own
training checkpoints and weight files, and the reference's checkpoints.

The port's own format is a `torch.save` of plain dicts of tensors (read
back with weights_only=True), written to `path + ".tmp"` and then
os.replace'd, as the JAX package writes its files:

  * `save_checkpoint` (a training checkpoint, fusion-only like the
    reference's get_save_dict, patchfusion.py:179-187): epoch, step,
    the trainable parameters, the BatchNorm statistics and the optimizer
    state (with the schedule's position, `step`), by state_dict names;
  * `save_params` (weights only: params and, where given, batch_stats);
    `save_weights` writes a whole net's state dict so (the output of
    tools/convert_checkpoint.py, every key of the net).

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
without a key mapping. One thing is adapted: a BEiT branch's
relative-position tables were trained at the published 24x24 grid
(beit_large_patch16_384), and the port sizes them for its process shape's
grid (24x32 at 384x512), as the JAX importer does
(patchfusion_tpu/convert/torch2jax.py:288-376): `fit_rel_pos_tables`
resamples each table to its module's grid and rebuilds the index buffer
there; every other key loads strictly. Loading happens wherever the net's
parameters lie; the callers in api.py load on the CPU before moving and
casting the net.
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from patchfusion_tpu_torch.models.beit import (BeitAttention,
                                               relative_position_index,
                                               table_rows)

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


def save_weights(path: str, net: nn.Module) -> None:
    """Every entry of net.state_dict() that holds values (a net built on
    the meta device and loaded with assign=True may hold some) as a weights
    file (save_params): the fusion BatchNorms' statistics as batch_stats,
    the rest (parameters and buffers) as params, in their own dtypes."""
    from patchfusion_tpu_torch.engine.training import batch_stats

    stat_names = set(batch_stats(net))
    params, stats = {}, {}
    for k, v in net.state_dict().items():
        if not v.is_meta:
            (stats if k in stat_names else params)[k] = v
    save_params(path, params, stats)


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


def beit_grid_from(nrel: int, n_tokens: int) -> Tuple[int, int]:
    """The grid (h, w) with (2h-1)(2w-1) == nrel and h*w == n_tokens."""
    for h in range(1, n_tokens + 1):
        if n_tokens % h:
            continue
        w = n_tokens // h
        if (2 * h - 1) * (2 * w - 1) == nrel:
            return (h, w)
    raise ValueError(f"inconsistent BEiT table: nrel={nrel}, "
                     f"tokens={n_tokens}")


def resample_beit_rel_pos_table(table: torch.Tensor,
                                old_grid: Tuple[int, int],
                                new_grid: Tuple[int, int]) -> torch.Tensor:
    """A BEiT relative-position-bias table ((2h0-1)(2w0-1)+3, heads) ->
    ((2h1-1)(2w1-1)+3, heads): the h-major offset grid resampled bilinear
    with align_corners=False (what MiDaS v3.1 applies at runtime for
    non-384 inputs), in float32, the three cls rows passed through; the
    same table when the grids match. Returns the table's dtype."""
    if tuple(old_grid) == tuple(new_grid):
        return table
    oh, ow = 2 * old_grid[0] - 1, 2 * old_grid[1] - 1
    nh, nw = 2 * new_grid[0] - 1, 2 * new_grid[1] - 1
    if table.shape[0] != oh * ow + 3:
        raise ValueError(f"table of {table.shape[0]} rows is not of the "
                         f"{tuple(old_grid)} grid")
    heads = table.shape[1]
    sub = table[:oh * ow].float().reshape(oh, ow, heads).permute(2, 0, 1)
    sub = F.interpolate(sub[None], size=(nh, nw), mode="bilinear",
                        align_corners=False)[0]
    sub = sub.permute(1, 2, 0).reshape(nh * nw, heads)
    return torch.cat([sub, table[oh * ow:].float()]).to(table.dtype)


def fit_rel_pos_tables(net: nn.Module, sd: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """`sd` with each BEiT attention's table resampled to the grid of its
    module in `net` and its relative_position_index rebuilt at that grid
    (the state dict's keys as `net.state_dict()` names them). The stored
    grid comes from the state dict's index buffer (its N+1 rows), or from
    a square table where there is none. Other keys are untouched."""
    out = dict(sd)
    for name, mod in net.named_modules():
        if not isinstance(mod, BeitAttention):
            continue
        prefix = f"{name}." if name else ""
        tkey = prefix + "relative_position_bias_table"
        ikey = prefix + "relative_position_index"
        if tkey not in out:
            continue
        table = torch.as_tensor(out[tkey])
        if table.shape[0] != table_rows(mod.grid):
            nrel = table.shape[0] - 3
            if ikey in out:
                old = beit_grid_from(nrel, int(out[ikey].shape[0]) - 1)
            else:
                side = int(round(np.sqrt(nrel)))
                if side * side != nrel:
                    raise ValueError(
                        f"{tkey}: cannot infer the grid of a non-square "
                        f"table of {table.shape[0]} rows without its "
                        "relative_position_index")
                old = ((side + 1) // 2, (side + 1) // 2)
            out[tkey] = resample_beit_rel_pos_table(table, old, mod.grid)
        out[ikey] = torch.tensor(relative_position_index(*mod.grid))
    return out


def load_branch_state_dict(branch: nn.Module,
                           sd: Dict[str, torch.Tensor],
                           assign: bool = False) -> None:
    """A reference branch checkpoint into a ZoeDepth branch, strictly,
    its BEiT tables fitted to the branch's grid (fit_rel_pos_tables).
    assign: take the dict's tensors as the branch's (a branch on the meta
    device)."""
    branch.load_state_dict(fit_rel_pos_tables(branch, sd), strict=True,
                           assign=assign)


def load_fusion_state_dict(net: nn.Module, sd: Dict[str, torch.Tensor],
                           assign: bool = False) -> None:
    """Merge a fusion-only state dict over `net` (strict=False): missing
    keys keep their values; keys that are not the net's raise. assign: as
    load_branch_state_dict."""
    res = net.load_state_dict(sd, strict=False, assign=assign)
    if res.unexpected_keys:
        raise ValueError(f"fusion checkpoint has {len(res.unexpected_keys)} "
                         f"unexpected keys, e.g. {res.unexpected_keys[:3]}")


def load_patchfusion_from_torch(net: nn.Module, coarse_path: str,
                                fine_path: str,
                                fusion_path: Optional[str] = None,
                                assign: bool = False) -> None:
    """Load the reference's three checkpoints into a PatchFusionNet: each
    branch file strictly into its branch (reference patchfusion.py:105-109),
    then the fusion-only file, where one is given (load_dict strict=False);
    without one the fusion part keeps its current weights. assign: take
    the files' tensors as the net's (a net on the meta device; what no
    file holds stays there)."""
    load_branch_state_dict(net.coarse_branch,
                           load_torch_state_dict(coarse_path), assign)
    load_branch_state_dict(net.fine_branch, load_torch_state_dict(fine_path),
                           assign)
    if fusion_path:
        load_fusion_state_dict(net, load_torch_state_dict(fusion_path),
                               assign)


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
    copied twice), BEiT tables fitted to the net's grid
    (fit_rel_pos_tables)."""
    net.load_state_dict(fit_rel_pos_tables(net, read_hub_state_dict(path)),
                        strict=True, assign=True)
