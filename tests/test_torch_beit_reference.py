"""The port's BEiT ZoeDepth PatchFusion against the benchmark's plain float32
BEiT reference (pfbench/reference/beit.py) on the CPU, at the toy zoedepth
config (chip_smoke.tiny_zoe_config: BEiT_tiny branches, width 64, 4
blocks, 4 heads, 64x96 tiles, the fusion stage at [32, 256x5]), with one
weights dict from pfbench.weights drawn by the reference module's own
rules and loaded strictly into both.

Tolerances, relative to the reference's largest magnitude:
  * float32, F32_TOL: the port's f32 path is the reference's arithmetic in
    another order of sums (measured 2-7e-7 on these weights);
  * bfloat16, BF16_TOL: the port's other bf16 parity tests' bound
    (tests/test_torch_models.py, test_torch_cores.py): bf16 weights,
    activations and linear layers, the tanh GELU and the fused head
    (measured 3-5e-3 for the depth here).
Dropping the relative-position bias from the reference's logits moves the
depth by more than BF16_TOL and by over five times the port's bf16 gap:
the seeded tables (std 1.0) make the bias matter, so the benchmark's check
can see a program that leaves it out."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from patchfusion_tpu_torch.api import PatchFusion
from patchfusion_tpu_torch.models.builder import build_patchfusion
from pfbench import images, weights
from pfbench.reference import beit as ref_beit
from pfbench.reference import engine as ref_engine

from .torch_parity import rel_err

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 21
F32_TOL = 1e-5
BF16_TOL = 3e-2
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}


@pytest.fixture(scope="module")
def nets():
    """(config, {dtype name: the port's net}, the reference net, the tile
    config), the weights drawn in bf16 as the benchmark draws them."""
    cfg = chip_smoke.tiny_zoe_config()
    meta, tile_cfg = build_patchfusion(cfg, dtype=torch.bfloat16,
                                       device="meta")
    drawn = weights.make(weights.spec(meta), SEED, "cpu", ref_beit, cfg)
    port = {}
    for name, dtype in DTYPES.items():
        net, _ = build_patchfusion(cfg, dtype=dtype, device="cpu")
        net.load_state_dict(drawn, strict=True)
        port[name] = net
    ref = ref_beit.PatchFusionNet(cfg).eval()
    ref.load_state_dict(drawn, strict=True)
    return cfg, port, ref, tile_cfg


def _err(got, want):
    return rel_err(got.float().numpy(), want.float().numpy())


def _block(net, i=1):
    return net.fine_branch.core.core.pretrained.model.blocks[i]


def _tokens(n):
    return torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, n, 64)).astype(np.float32))


def _crops_boxes(cfg):
    """Two tiles of an image at the process shape and their boxes in
    process coordinates (the tiny config's raw image is twice its tiles'
    process shape, so the boxes are the raw ones halved)."""
    rng = np.random.default_rng(6)
    h, w = cfg["patch_process_shape"]
    crops = torch.from_numpy(rng.random((2, 3, h, w), dtype=np.float32))
    boxes = torch.tensor([[0, 0, w / 2, h / 2], [w / 4, h / 4, 3 * w / 4,
                                                 3 * h / 4]])
    lr = torch.from_numpy(rng.random((1, 3, h, w), dtype=np.float32))
    return lr, crops, boxes


@pytest.mark.parametrize("dtype", list(DTYPES))
@torch.no_grad()
def test_attention_and_block_match_the_reference(nets, dtype):
    _, port, ref, _ = nets
    n = ref_beit.grid_index(4, 6).shape[0]
    x = _tokens(n)
    pb, rb = _block(port[dtype]), _block(ref)
    assert _err(pb.attn(x.to(DTYPES[dtype])), rb.attn(x)) <= TOL[dtype]
    assert _err(pb(x.to(DTYPES[dtype])), rb(x)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", list(DTYPES))
@torch.no_grad()
def test_branch_matches_the_reference(nets, dtype):
    cfg, port, ref, _ = nets
    _, crops, _ = _crops_boxes(cfg)
    out = port[dtype].fine_branch(crops.to(DTYPES[dtype]))
    depth, feats = ref.fine_branch(crops)
    tol = 10 * F32_TOL if dtype == "float32" else BF16_TOL
    assert _err(out["metric_depth"], depth) <= tol
    assert _err(out["rel_depth"], ref.fine_branch.core.core(
        (crops - 0.5) / 0.5)[0]) <= tol
    keys = ["x_d0", "x_blocks_feat_0", "x_blocks_feat_1", "x_blocks_feat_2",
            "x_blocks_feat_3", "midas_final_feat"]
    for k, want in zip(keys, feats):
        assert _err(out["temp_features"][k], want) <= tol, k


@pytest.mark.parametrize("dtype", list(DTYPES))
@torch.no_grad()
def test_network_coarse_and_tiles_match_the_reference(nets, dtype):
    cfg, port, ref, _ = nets
    net = port[dtype]
    lr, crops, boxes = _crops_boxes(cfg)
    tol = 10 * F32_TOL if dtype == "float32" else BF16_TOL
    depth, feats = net.coarse_forward(lr)
    g2l = net.attend_coarse(feats)
    ctx = ref.coarse(lr)
    assert _err(depth, ctx[0]) <= tol
    for got, want in zip(feats + g2l, ctx[1] + ctx[2]):
        assert _err(got, want) <= tol
    rois = net.coarse_postprocess(depth, feats, g2l, boxes)
    tiles = net.infer_tiles(crops.to(DTYPES[dtype]), rois[1], rois[2],
                            rois[0])
    assert _err(tiles, ref.tiles(crops, boxes, ctx)) <= tol


def test_bias_left_out_moves_the_depth_beyond_the_bf16_gap(nets,
                                                           monkeypatch):
    """The reference's m1 depth of a pool image against the bf16 port's,
    and against the reference's own with the bias left out of its
    logits."""
    cfg, port, ref, tile_cfg = nets
    tiles = ref_engine.Tiles(cfg)
    lr, hr = (torch.from_numpy(a) for a in
              images.pool(SEED, 1, tiles.raw, tiles.process, "cpu")[0])
    want = ref_engine.infer(ref, tiles, lr, hr, "m1", block=4)
    model = PatchFusion(port["bfloat16"], tile_cfg, cfg, process_num=4)
    gap = _err(torch.from_numpy(model.infer(lr.numpy(), hr.numpy(),
                                            cai_mode="m1", process_num=4)),
               want)
    with_bias = ref_beit.BeitAttention.rel_bias
    monkeypatch.setattr(ref_beit.BeitAttention, "rel_bias",
                        lambda self: torch.zeros_like(with_bias(self)))
    moved = _err(ref_engine.infer(ref, tiles, lr, hr, "m1", block=4), want)
    assert gap <= BF16_TOL
    assert moved > BF16_TOL and moved > 5 * gap, (moved, gap)


def test_reference_module_imports_neither_jax_nor_the_program():
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location("
            "'beit_reference', 'pfbench/reference/beit.py')\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=ROOT)
    tops = set(out.stdout.split())
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "patchfusion_tpu",
                       "patchfusion_tpu_torch"}
