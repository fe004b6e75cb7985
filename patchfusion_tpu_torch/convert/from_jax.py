"""JAX package parameters -> this port's state_dict.

`state_dict_from_flax(params, batch_stats, config)` takes patchfusion_tpu's
parameter tree (nested dicts of numpy arrays, as `jax.device_get` returns
them) and gives the reference-layout state_dict that the port's
PatchFusionNet loads with strict=True. It is a numpy-only copy of
patchfusion_tpu/convert/jax2torch.py::patchfusion_state_dict with
fusion_only=False, for the DA (DINOv2) family and the BEiT (MiDaS) one
(jax2torch.py:140-210); the original imports flax modules, so the port
cannot call it. Keys that the flax tree lacks but the reference layout
holds (mask_token, the dead G2L embed_proj, the Swin and BEiT
relative_position_index buffers and the log-binomial buffers) are
synthesized.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from patchfusion_tpu_torch.convert import branch_conversion_spec
from patchfusion_tpu_torch.models import beit
from patchfusion_tpu_torch.models.swin import relative_position_index

SD = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    return np.asarray(x)


def inv_linear(out: SD, prefix: str, p: Mapping) -> None:
    out[prefix + ".weight"] = _np(p["kernel"]).T
    if "bias" in p:
        out[prefix + ".bias"] = _np(p["bias"])


def inv_conv(out: SD, prefix: str, p: Mapping) -> None:
    """flax (kh, kw, in, out) -> torch (out, in, kh, kw); for flax
    ConvTranspose(transpose_kernel=True), (kh, kw, out, in) -> torch
    ConvTranspose2d's (in, out, kh, kw) is the same transpose."""
    out[prefix + ".weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        out[prefix + ".bias"] = _np(p["bias"])


def inv_layernorm(out: SD, prefix: str, p: Mapping) -> None:
    out[prefix + ".weight"] = _np(p["scale"])
    out[prefix + ".bias"] = _np(p["bias"])


def inv_batchnorm(out: SD, prefix: str, p: Mapping, stats: Mapping) -> None:
    out[prefix + ".weight"] = _np(p["scale"])
    out[prefix + ".bias"] = _np(p["bias"])
    out[prefix + ".running_mean"] = _np(stats["mean"])
    out[prefix + ".running_var"] = _np(stats["var"])
    out[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)


def dinovit_state_dict(p: Mapping, depth: int, prefix: str) -> SD:
    sd: SD = {}
    sd[prefix + "cls_token"] = _np(p["cls_token"])
    sd[prefix + "pos_embed"] = _np(p["pos_embed"])
    dim = _np(p["cls_token"]).shape[-1]
    sd[prefix + "mask_token"] = np.zeros((1, dim), np.float32)
    inv_conv(sd, prefix + "patch_embed.proj", p["patch_embed"])
    inv_layernorm(sd, prefix + "norm", p["norm"])
    for i in range(depth):
        b = p[f"blocks_{i}"]
        bp = f"{prefix}blocks.{i}"
        inv_layernorm(sd, bp + ".norm1", b["norm1"])
        inv_linear(sd, bp + ".attn.qkv", b["attn"]["qkv"])
        inv_linear(sd, bp + ".attn.proj", b["attn"]["proj"])
        sd[bp + ".ls1.gamma"] = _np(b["ls1_gamma"])
        inv_layernorm(sd, bp + ".norm2", b["norm2"])
        inv_linear(sd, bp + ".mlp.fc1", b["mlp"]["fc1"])
        inv_linear(sd, bp + ".mlp.fc2", b["mlp"]["fc2"])
        sd[bp + ".ls2.gamma"] = _np(b["ls2_gamma"])
    return sd


def dpt_head_state_dict(p: Mapping, prefix: str) -> SD:
    sd: SD = {}
    for i in range(4):
        inv_conv(sd, f"{prefix}projects.{i}", p[f"project_{i}"])
    inv_conv(sd, prefix + "resize_layers.0", p["resize_0"])
    inv_conv(sd, prefix + "resize_layers.1", p["resize_1"])
    inv_conv(sd, prefix + "resize_layers.3", p["resize_3"])
    for i in range(4):
        inv_conv(sd, f"{prefix}scratch.layer{i + 1}_rn",
                 p[f"layer{i + 1}_rn"])
        rp = f"{prefix}scratch.refinenet{i + 1}"
        ffb = p[f"refinenet{i + 1}"]
        inv_conv(sd, rp + ".resConfUnit1.conv1", ffb["rcu1"]["conv1"])
        inv_conv(sd, rp + ".resConfUnit1.conv2", ffb["rcu1"]["conv2"])
        inv_conv(sd, rp + ".resConfUnit2.conv1", ffb["rcu2"]["conv1"])
        inv_conv(sd, rp + ".resConfUnit2.conv2", ffb["rcu2"]["conv2"])
        inv_conv(sd, rp + ".out_conv", ffb["out_conv"])
    inv_conv(sd, prefix + "scratch.output_conv1", p["output_conv1"])
    inv_conv(sd, prefix + "scratch.output_conv2.0", p["output_conv2_0"])
    inv_conv(sd, prefix + "scratch.output_conv2.2", p["output_conv2_2"])
    return sd


def metric_bins_state_dict(p: Mapping, prefix: str = "") -> SD:
    sd: SD = {}

    def net2(name, q):
        inv_conv(sd, f"{prefix}{name}._net.0", q["net_0"])
        inv_conv(sd, f"{prefix}{name}._net.2", q["net_2"])

    net2("seed_bin_regressor", p["seed_bin_regressor"])
    net2("seed_projector", p["seed_projector"])
    for i in range(4):
        net2(f"projectors.{i}", p[f"projector_{i}"])
        net2(f"attractors.{i}", p[f"attractor_{i}"])
    inv_conv(sd, prefix + "conditional_log_binomial.mlp.0",
             p["conditional_log_binomial"]["mlp_0"])
    inv_conv(sd, prefix + "conditional_log_binomial.mlp.2",
             p["conditional_log_binomial"]["mlp_2"])
    n_bins = sd[prefix + "seed_bin_regressor._net.2.bias"].shape[0]
    lbt = prefix + "conditional_log_binomial.log_binomial_transform."
    sd[lbt + "k_idx"] = np.arange(n_bins, dtype=np.float32).reshape(
        1, -1, 1, 1)
    sd[lbt + "K_minus_1"] = np.asarray([n_bins - 1], np.float32).reshape(
        1, -1, 1, 1)
    return sd


def zoedepth_state_dict(p: Mapping, depth: int, prefix: str) -> SD:
    sd = dinovit_state_dict(p["core"]["pretrained"], depth,
                            prefix + "core.core.pretrained.")
    sd.update(dpt_head_state_dict(p["core"]["depth_head"],
                                  prefix + "core.core.depth_head."))
    inv_conv(sd, prefix + "conv2", p["conv2"])
    sd.update(metric_bins_state_dict(p["head"], prefix))
    return sd


def _swin_block_sd(sd: SD, prefix: str, b: Mapping, window: int) -> None:
    inv_layernorm(sd, prefix + ".norm1", b["norm1"])
    inv_linear(sd, prefix + ".attn.qkv", b["attn"]["qkv"])
    inv_linear(sd, prefix + ".attn.proj", b["attn"]["proj"])
    sd[prefix + ".attn.relative_position_bias_table"] = _np(
        b["attn"]["relative_position_bias_table"])
    sd[prefix + ".attn.relative_position_index"] = \
        relative_position_index(window).astype(np.int64)
    inv_layernorm(sd, prefix + ".norm2", b["norm2"])
    inv_linear(sd, prefix + ".mlp.fc1", b["mlp_fc1"])
    inv_linear(sd, prefix + ".mlp.fc2", b["mlp_fc2"])


def guided_fusion_state_dict(p: Mapping, stats: Mapping, depths,
                             prefix: str = "guided_fusion.",
                             window: int = 12) -> SD:
    sd: SD = {}

    def dconv_bn(name, q, s):
        inv_conv(sd, f"{prefix}{name}.0", q["conv1"])
        inv_batchnorm(sd, f"{prefix}{name}.1", q["bn1"], s["bn1"])
        inv_conv(sd, f"{prefix}{name}.3", q["conv2"])
        inv_batchnorm(sd, f"{prefix}{name}.4", q["bn2"], s["bn2"])

    def dconv(name, q):
        inv_conv(sd, f"{prefix}{name}.0", q["conv1"])
        inv_conv(sd, f"{prefix}{name}.2", q["conv2"])

    dconv_bn("inc.double_conv", p["inc"], stats["inc"])
    n = len(depths)
    for i in range(n - 1):
        dconv_bn(f"down_conv_list.{i}.maxpool_conv.1.double_conv",
                 p[f"down_{i}"], stats[f"down_{i}"])
        dconv(f"up_conv_list.{i}.conv.double_conv", p[f"up_{i}"])
    depths_inv = list(depths)[::-1]
    for i in range(n):
        g = p[f"g2l_{i}"]
        gp = f"{prefix}g2l_list.{i}"
        sd[gp + ".absolute_pos_embed"] = _np(g["absolute_pos_embed"])
        inv_layernorm(sd, gp + ".g2l_layer_norm", g["norm"])
        embed_dim = _np(g["absolute_pos_embed"]).shape[-1]
        sd[gp + ".embed_proj.weight"] = np.zeros((embed_dim, 1, 1, 1),
                                                 np.float32)
        sd[gp + ".embed_proj.bias"] = np.zeros((embed_dim,), np.float32)
        for j in range(depths_inv[i]):
            _swin_block_sd(sd, f"{gp}.g2l_layer.blocks.{j}",
                           g[f"block_{j}"], window)
        dconv(f"convs.{i}.double_conv", p[f"fuse_{i}"])
    return sd


def beit_backbone_state_dict(p: Mapping, depth: int, prefix: str,
                             grid) -> SD:
    """flax BeitBackbone -> timm's BEiT naming (pretrained.model.*), with
    the relative_position_index buffers of `grid`."""
    sd: SD = {}
    sd[prefix + "cls_token"] = _np(p["cls_token"])
    inv_conv(sd, prefix + "patch_embed.proj", p["patch_embed"])
    idx = beit.relative_position_index(*grid)
    for i in range(depth):
        b = p[f"blocks_{i}"]
        bp = f"{prefix}blocks.{i}"
        inv_layernorm(sd, bp + ".norm1", b["norm1"])
        sd[bp + ".attn.qkv.weight"] = _np(b["attn"]["qkv_kernel"]).T
        sd[bp + ".attn.q_bias"] = _np(b["attn"]["q_bias"])
        sd[bp + ".attn.v_bias"] = _np(b["attn"]["v_bias"])
        sd[bp + ".attn.relative_position_bias_table"] = _np(
            b["attn"]["relative_position_bias_table"])
        sd[bp + ".attn.relative_position_index"] = idx
        inv_linear(sd, bp + ".attn.proj", b["attn"]["proj"])
        sd[bp + ".gamma_1"] = _np(b["gamma_1"])
        sd[bp + ".gamma_2"] = _np(b["gamma_2"])
        inv_layernorm(sd, bp + ".norm2", b["norm2"])
        inv_linear(sd, bp + ".mlp.fc1", b["mlp_fc1"])
        inv_linear(sd, bp + ".mlp.fc2", b["mlp_fc2"])
    return sd


def midas_scratch_state_dict(p: Mapping, pre_prefix: str,
                             scratch_prefix: str) -> SD:
    """flax MidasDPTHead -> MiDaS's act_postprocessN (under pretrained.)
    and scratch.* naming."""
    sd: SD = {}
    for i in range(4):
        ap = f"{pre_prefix}act_postprocess{i + 1}"
        inv_linear(sd, ap + ".0.project.0", p[f"readout_{i}"])
        inv_conv(sd, ap + ".3", p[f"project_{i}"])
    # ConvTranspose(transpose_kernel=True): see inv_conv
    inv_conv(sd, pre_prefix + "act_postprocess1.4", p["resize_0"])
    inv_conv(sd, pre_prefix + "act_postprocess2.4", p["resize_1"])
    inv_conv(sd, pre_prefix + "act_postprocess4.4", p["resize_3"])
    sp = scratch_prefix
    for i in range(4):
        inv_conv(sd, f"{sp}layer{i + 1}_rn", p[f"layer{i + 1}_rn"])
        rp = f"{sp}refinenet{i + 1}"
        ffb = p[f"refinenet{i + 1}"]
        inv_conv(sd, rp + ".resConfUnit1.conv1", ffb["rcu1"]["conv1"])
        inv_conv(sd, rp + ".resConfUnit1.conv2", ffb["rcu1"]["conv2"])
        inv_conv(sd, rp + ".resConfUnit2.conv1", ffb["rcu2"]["conv1"])
        inv_conv(sd, rp + ".resConfUnit2.conv2", ffb["rcu2"]["conv2"])
        inv_conv(sd, rp + ".out_conv", ffb["out_conv"])
    inv_conv(sd, sp + "output_conv.0", p["output_conv_0"])
    inv_conv(sd, sp + "output_conv.2", p["output_conv_2"])
    inv_conv(sd, sp + "output_conv.4", p["output_conv_4"])
    return sd


def zoedepth_beit_state_dict(p: Mapping, depth: int, grid,
                             prefix: str) -> SD:
    """flax ZoeDepthBEiT -> the reference ZoeDepth(MidasCore) naming
    (core.core.pretrained.*, core.core.scratch.*, conv2.*, the head)."""
    sd = beit_backbone_state_dict(p["core"]["pretrained"], depth,
                                  prefix + "core.core.pretrained.model.",
                                  grid)
    sd.update(midas_scratch_state_dict(p["core"]["scratch"],
                                       prefix + "core.core.pretrained.",
                                       prefix + "core.core.scratch."))
    inv_conv(sd, prefix + "conv2", p["conv2"])
    sd.update(metric_bins_state_dict(p["head"], prefix))
    return sd


def branch_state_dict(p: Mapping, config: Mapping[str, Any],
                      prefix: str = "") -> SD:
    """One branch's flax params -> its state_dict, by the config's family
    (branch_conversion_spec)."""
    family, depth, grid = branch_conversion_spec(config)
    if family == "midas":
        return zoedepth_beit_state_dict(p, depth, grid, prefix)
    return zoedepth_state_dict(p, depth, prefix)


def state_dict_from_flax(params: Mapping, batch_stats: Mapping,
                         config: Mapping[str, Any]) -> SD:
    """The JAX package's PatchFusionNet params/batch_stats -> the port's
    PatchFusionNet state_dict (numpy arrays; `to_torch` converts).
    config: the reference `model.config` dict the nets were built from."""
    sd: SD = {}
    sd.update(branch_state_dict(params["coarse_branch"], config,
                                "coarse_branch."))
    sd.update(branch_state_dict(params["fine_branch"], config,
                                "fine_branch."))
    for i in range(6):
        inv_conv(sd, f"fusion_conv_list.{i}", params[f"fusion_conv_{i}"])
    depths = tuple(config["guided_fusion"].get("depth", (2, 2, 3, 3, 4, 4)))
    sd.update(guided_fusion_state_dict(params["fusion"],
                                       batch_stats["fusion"], depths))
    sd.update(metric_bins_state_dict(params["head"]))
    return sd


def to_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """numpy state_dict -> torch tensors (for load_state_dict)."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in sd.items()}
