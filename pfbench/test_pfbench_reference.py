"""The frozen reference against the program's float32 path on the tiny
configuration (CPU): the same seeded weights and images give the same
depth to float32 rounding, in m1 and m2."""

import numpy as np
import pytest
import torch

from pfbench import images, weights
from pfbench.reference import engine
from pfbench.tiny import tiny_cell, tiny_model

SEED = 2 ** 31 + 7


@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_reference_matches_program_f32(mode):
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.models.builder import build_patchfusion

    cfg = tiny_model()
    net, tile_cfg = build_patchfusion(cfg, dtype=torch.float32, device="meta")
    wspec = weights.spec(net)
    net.load_state_dict(weights.make(wspec, SEED, "cpu"), strict=True,
                        assign=True)
    program = PatchFusion(net.eval(), tile_cfg, cfg, process_num=2)
    tiles = engine.Tiles(cfg)
    ref = engine.build(tiny_cell().config, weights.make(wspec, SEED, "cpu"),
                       "cpu")
    for lr, hr in images.pool(SEED, 2, tiles.raw, tiles.process, "cpu"):
        depth = program.infer(lr, hr, cai_mode=mode, process_num=2)
        want = engine.infer(ref, tiles, torch.from_numpy(lr),
                            torch.from_numpy(hr), mode, block=3)
        gap = np.abs(depth - want.numpy())
        assert gap.max() < 1e-5 * np.abs(depth).max()


def test_weights_same_from_same_seed_and_differ_across_seeds():
    from patchfusion_tpu_torch.models.builder import build_patchfusion

    net, _ = build_patchfusion(tiny_model(), dtype=torch.bfloat16,
                               device="meta")
    wspec = weights.spec(net)
    a = weights.make(wspec, SEED, "cpu")
    b = weights.make(wspec, SEED, "cpu")
    c = weights.make(wspec, SEED + 1, "cpu")
    assert a.keys() == b.keys() == {k for k, _, _ in wspec}
    assert all(torch.equal(a[k], b[k]) for k in a)
    drawn = [k for k in a if a[k].is_floating_point()
             and not k.endswith(("k_idx", "K_minus_1"))]
    assert all(not torch.equal(a[k], c[k]) for k in drawn)
    assert all(a[k].dtype == dt for k, _, dt in wspec)
    # every slice starts on a 256-element boundary of its buffer, which
    # the card's allocator aligns to 512 bytes (the kernels' loads need 16)
    assert all(a[k].storage_offset() % weights.ALIGN == 0 for k in drawn)


def test_tile_counts():
    tiles = engine.Tiles({"image_raw_shape": [2160, 3840],
                          "patch_split_num": [4, 4],
                          "patch_process_shape": [392, 518]})
    assert tiles.count("m1") == 16 and tiles.count("m2") == 49
