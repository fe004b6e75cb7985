"""A tiny cell for the CPU tests: the structurally complete toy PatchFusion
(DINOv2 `vitmicro`, 42x56 tiles of an 84x112 image) under a cell's
traffic mix, check and metrics, at chunks of two tiles."""

from __future__ import annotations

import copy

from pfbench import spec

SIZES = [(2, 2), (3, 4), (6, 8), (12, 16), (24, 32), (42, 56)]


def tiny_model() -> dict:
    zoe = dict(
        type="DA-ZoeDepth", midas_model_type="vitmicro", n_bins=64,
        bin_centers_type="softplus", bin_embedding_dim=128,
        n_attractors=[16, 8, 4, 1], attractor_alpha=1000, attractor_gamma=2,
        attractor_kind="mean", attractor_type="inv", min_temp=0.0212,
        max_temp=50.0)
    return dict(
        image_raw_shape=[84, 112], patch_split_num=[2, 2],
        patch_process_shape=[42, 56], min_depth=1e-3, max_depth=80,
        coarse_branch=dict(zoe), fine_branch=dict(zoe),
        guided_fusion=dict(
            type="GuidedFusionPatchFusion", in_channels=[32] * 6,
            depth=[1] * 6, num_heads=[2] * 6,
            num_patches=[h * w for (h, w) in SIZES[::-1]], n_channels=5,
            g2l=True))


def tiny_cell(name: str = "davitl-p49") -> spec.Cell:
    """The cell `name` of BENCHMARK.json with the tiny model and images."""
    cell = copy.deepcopy(spec.load_cell(name))
    cell.config["model"] = tiny_model()
    cell.traffic.update(process_num=2, image_shape=[84, 112])
    return cell
