"""The port's BEiT ZoeDepth family as a whole against the JAX package on the
CPU: the tiled engine (PatchFusion.infer, m1 / m2 / r4 with the same
rand_origins), reference weights at another grid (the relative-position
tables resampled and the index buffers rebuilt by engine/checkpoint.py,
against the JAX importer), BaselinePretrain, and the zoedepth configs at
full size (built on the meta device); training and the CLIs are in
tests/test_torch_beit_train.py. The toy config is tests/test_beit.py's
(BEiT_tiny, 64x96 tiles of 128x192), every JAX leaf drawn by
torch_parity.redraw_beit. float32 throughout; 1e-4 of max unless a test
says otherwise."""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from patchfusion_tpu.api import BaselinePretrain as JaxBaselinePretrain
from patchfusion_tpu.convert import torch2jax
from patchfusion_tpu.engine.inference import PatchFusionInference
from patchfusion_tpu.models.beit import \
    relative_position_index as jax_rel_index
from patchfusion_tpu_torch.api import (BaselinePretrain, PatchFusion,
                                       init_weights)
from patchfusion_tpu_torch.config import Config
from patchfusion_tpu_torch.convert import from_jax
from patchfusion_tpu_torch.engine import checkpoint
from patchfusion_tpu_torch.models import beit
from patchfusion_tpu_torch.models.builder import (build_patchfusion,
                                                  build_zoedepth_branch)

from .torch_parity import port_net, rel_err, toy_zoe_jax

torch.set_num_threads(2)

TOL = 1e-4
PROCESS_NUM = 2
MIN_D, MAX_D = 1e-3, 80.0
ZOE_CONFIGS = "configs/patchfusion_zoedepth/"


@pytest.fixture(scope="module")
def toy():
    cfg, jnet, tile_cfg, var = toy_zoe_jax(0)
    net, port_tile_cfg = port_net(cfg, var)
    return cfg, jnet, tile_cfg, var, PatchFusion(net, port_tile_cfg, cfg)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    return (rng.random((1, 64, 96, 3), dtype=np.float32),
            rng.random((128, 192, 3), dtype=np.float32))


@pytest.fixture(scope="module")
def outputs(toy, images):
    """Both engines' depth for m1, m2 and r4 (same rand_origins)."""
    _, jnet, tile_cfg, var, port = toy
    jax_engine = PatchFusionInference(jnet, var, tile_cfg,
                                      process_num=PROCESS_NUM)
    lr, hr = images
    rand = jax_engine.random_origins(4, np.random.default_rng(5))
    out = {}
    for mode in ("m1", "m2", "r4"):
        ro = rand if mode == "r4" else None
        out[mode] = (
            np.asarray(jax_engine.infer(lr, hr, cai_mode=mode,
                                        rand_origins=ro)),
            port.infer(lr, hr, cai_mode=mode, process_num=PROCESS_NUM,
                       rand_origins=ro))
    return out


@pytest.mark.parametrize("mode", ["m1", "m2", "r4"])
def test_infer_matches_jax(outputs, toy, mode):
    want, got = outputs[mode]
    tc = toy[4].tile_cfg
    shape = tc.image_raw_shape if mode == "r4" else tc.patch_reensemble_shape
    assert got.shape == want.shape == tuple(shape)
    assert np.isfinite(got).all()
    assert rel_err(got, want) <= TOL


def test_the_zoedepth_resizer_rounds_to_32(toy):
    """The BEiT branch's network-input resize takes multiples of 32."""
    port = toy[4]
    assert port.resizer.multiple_of == 32
    assert port.resizer.get_size(130, 200) == (64, 96)


# -- reference weights at another grid ------------------------------------

@pytest.mark.parametrize("old,new", [((24, 24), (24, 32)), ((4, 4), (4, 6)),
                                     ((4, 6), (4, 6)), ((3, 5), (2, 2))])
def test_table_resample_matches_jax(old, new):
    """The port's resample equals torch2jax.resample_beit_rel_pos_table
    (within 1e-6; the same bilinear, align_corners=False, cls rows kept)."""
    table = np.random.default_rng(sum(old)).standard_normal(
        (beit.table_rows(old), 16)).astype(np.float32)
    want = torch2jax.resample_beit_rel_pos_table(table, old, new)
    got = checkpoint.resample_beit_rel_pos_table(torch.from_numpy(table),
                                                 old, new)
    assert got.shape == want.shape == (beit.table_rows(new), 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[-3:].numpy(), table[-3:])
    assert checkpoint.beit_grid_from(beit.table_rows(old) - 3,
                                     old[0] * old[1]) == old


def test_published_layout_loads_into_the_24x32_grid():
    """A block's attention as the published beit_large_patch16_384 stores
    it (a 24x24 table of 47 * 47 + 3 = 2212 rows and a 577 x 577 index)
    loads strictly into the 24x32 grid of 384x512: the table resampled as
    the JAX importer does, the index rebuilt (769 x 769); with the index
    missing, the square table alone gives the grid. The other keys load
    as they are."""
    attn = beit.BeitAttention(64, 16, (24, 32))
    rng = np.random.default_rng(0)
    sd = {k: torch.from_numpy(rng.standard_normal(v.shape)
                              .astype(np.float32))
          for k, v in attn.state_dict().items()
          if k != "relative_position_index"}
    table = rng.standard_normal((47 * 47 + 3, 16)).astype(np.float32)
    sd["relative_position_bias_table"] = torch.from_numpy(table)
    want = torch2jax.resample_beit_rel_pos_table(table, (24, 24), (24, 32))
    for with_index in (True, False):
        fitted = dict(sd)
        if with_index:
            fitted["relative_position_index"] = torch.from_numpy(
                jax_rel_index(24, 24).astype(np.int64))
            assert fitted["relative_position_index"].shape == (577, 577)
        fitted = checkpoint.fit_rel_pos_tables(attn, fitted)
        attn.load_state_dict(fitted, strict=True)
        np.testing.assert_allclose(
            attn.relative_position_bias_table.detach().numpy(), want,
            rtol=0, atol=1e-6)
        assert attn.relative_position_index.shape == (769, 769)
        np.testing.assert_array_equal(attn.relative_position_index.numpy(),
                                      jax_rel_index(24, 32))
        torch.testing.assert_close(attn.proj.weight, sd["proj.weight"],
                                   rtol=0, atol=0)


def _old_grid_branch(seed=2):
    """A reference-layout BEiT branch state dict at the 4x4 grid (a 64x64
    process shape), with tables and q/v biases that count."""
    net = build_zoedepth_branch(_toy_branch_cfg(), MIN_D, MAX_D,
                                device="cpu", process_shape=(64, 64))
    init_weights(net, seed)
    sd = net.state_dict()
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        if k.endswith(("relative_position_bias_table", "q_bias", "v_bias",
                       "cls_token")):
            sd[k] = torch.from_numpy(
                0.5 * rng.standard_normal(v.shape).astype(np.float32))
        elif k.endswith(("gamma_1", "gamma_2")):
            sd[k] = torch.from_numpy(
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
    assert sd["core.core.pretrained.model.blocks.0.attn."
              "relative_position_index"].shape == (17, 17)
    return sd


def _toy_branch_cfg():
    from .test_beit import toy_zoe_config
    return dict(toy_zoe_config()["coarse_branch"])


def test_old_grid_branch_matches_the_jax_importer(tmp_path, images):
    """A branch `.pth` at the 4x4 grid loads strictly into the port's
    BaselinePretrain at 64x96 (4x6) and gives the JAX package's
    BaselinePretrain.from_torch on the same file (its importer resamples
    the tables the same way): coarse depth within 1e-4 of max."""
    path = tmp_path / "coarse.pth"
    torch.save({"model_state_dict": _old_grid_branch()}, path)
    kw = dict(target="coarse", image_raw_shape=(128, 192),
              patch_split_num=(2, 2), patch_process_shape=(64, 96))
    port = BaselinePretrain.from_torch(_toy_branch_cfg(), MIN_D, MAX_D,
                                       str(path), device="cpu", **kw)
    jax_bp = JaxBaselinePretrain.from_torch(_toy_branch_cfg(), MIN_D, MAX_D,
                                            str(path), **kw)
    attn = port.net.core.core.pretrained.model.blocks[0].attn
    assert attn.relative_position_bias_table.shape == (
        beit.table_rows((4, 6)), 4)
    assert attn.relative_position_index.shape == (25, 25)
    lr = images[0]
    got = port.infer(image_lr=lr)
    want = np.asarray(jax_bp.infer(image_lr=lr))
    assert got.shape == (64, 96)
    assert rel_err(got, np.squeeze(want)) <= TOL


def test_triple_and_snapshot_fit_the_tables(toy, tmp_path, images):
    """The reference `.pth` triple (branches at the 4x4 grid) through
    from_config(ckpts=) and the same weights as a snapshot directory
    (zoedepth config.json, the dict-valued fields as strings as the hub
    export writes them) through from_pretrained: both fit the tables and
    give the same m1 depth."""
    cfg = toy[0]
    branch = _old_grid_branch()
    fusion = {k: v for k, v in toy[4].net.state_dict().items()
              if not k.startswith(("coarse_branch.", "fine_branch."))}
    paths = []
    for name, part in (("coarse", branch), ("fine", branch),
                       ("fusion", fusion)):
        paths.append(str(tmp_path / f"{name}.pth"))
        torch.save(part, paths[-1])
    triple = PatchFusion.from_config(cfg, device="cpu", ckpts=tuple(paths))
    snap = tmp_path / "snapshot"
    snap.mkdir()
    full = {**{f"coarse_branch.{k}": v for k, v in branch.items()},
            **{f"fine_branch.{k}": v for k, v in branch.items()}, **fusion}
    torch.save(full, snap / "pytorch_model.bin")
    hub = {k: (repr(v) if isinstance(v, dict) else v)
           for k, v in cfg.items()}
    (snap / "config.json").write_text(json.dumps({"config": hub}))
    loaded = PatchFusion.from_pretrained(str(snap), device="cpu")
    assert loaded.resizer.multiple_of == 32
    for m in (triple, loaded):
        attn = m.net.fine_branch.core.core.pretrained.model.blocks[1].attn
        assert attn.relative_position_index.shape == (25, 25)
    lr, hr = images
    a = triple.infer(lr, hr, cai_mode="m1", process_num=PROCESS_NUM)
    b = loaded.infer(lr, hr, cai_mode="m1", process_num=PROCESS_NUM)
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


# -- the full-size configs ---------------------------------------------------

def _cfg(name):
    return Config.fromfile(str(chip_smoke.ROOT / ZOE_CONFIGS / name))


def test_zoedepth_configs_build_at_full_size():
    """zoedepth_patchfusion_u4k.py builds (on the meta device: no weights
    drawn) with DPT_BEiT_L_384 branches on the 24x32 grid of 384x512, and
    the coarse and fine pretrain configs build their BaselinePretrain
    branch."""
    net, tile_cfg = build_patchfusion(
        _cfg("zoedepth_patchfusion_u4k.py").model.config.to_dict(),
        device="meta")
    assert tile_cfg.patch_process_shape == (384, 512)
    blocks = net.coarse_branch.core.core.pretrained.model.blocks
    assert len(blocks) == 24 and blocks[0].attn.num_heads == 16
    assert blocks[0].attn.relative_position_bias_table.shape == (
        47 * 63 + 3, 16)
    n = sum(p.numel() for p in net.coarse_branch.parameters())
    assert 340e6 < n < 360e6, n
    for target in ("coarse", "fine"):
        cfg = _cfg(f"zoedepth_{target}_pretrain_u4k.py")
        pps = tuple(cfg.train_dataloader.dataset.transform_cfg
                    .network_process_size)
        assert pps == (384, 512)
        branch = build_zoedepth_branch(
            cfg.model[f"{target}_branch"].to_dict(), cfg.model.min_depth,
            cfg.model.max_depth, device="meta", process_shape=pps)
        assert branch.core.core.grid == (24, 32)
        assert cfg.model.target == target


def test_init_weights_draws_every_beit_leaf():
    """Seeded weights for a BEiT branch: the qkv weight LeCun, q/v biases 0,
    LayerScale gammas 1 (so every block attends; the JAX package's name
    rule would zero qkv and the gammas), tables normal(0.02)."""
    net = build_zoedepth_branch(_toy_branch_cfg(), MIN_D, MAX_D,
                                device="cpu")
    init_weights(net, 0)
    attn = net.core.core.pretrained.model.blocks[0].attn
    std = attn.qkv.weight.std().item() * 64 ** 0.5
    assert 0.85 < std < 1.15
    assert not attn.q_bias.any() and not attn.v_bias.any()
    blk = net.core.core.pretrained.model.blocks[2]
    assert (blk.gamma_1 == 1).all() and (blk.gamma_2 == 1).all()
    assert 0.015 < attn.relative_position_bias_table.std().item() < 0.025


# -- BaselinePretrain --------------------------------------------------------

def test_baseline_pretrain_coarse_matches_jax(toy, images):
    """The coarse target on the JAX branch weights, against the JAX
    package's BaselinePretrain."""
    cfg, _, _, var, _ = toy
    p = var["params"]["coarse_branch"]
    sd = from_jax.to_torch(from_jax.zoedepth_beit_state_dict(
        p, 4, (4, 6), ""))
    kw = dict(target="coarse", image_raw_shape=(128, 192),
              patch_split_num=(2, 2), patch_process_shape=(64, 96))
    port = BaselinePretrain(cfg["coarse_branch"], MIN_D, MAX_D,
                            device="cpu", state_dict=sd, **kw)
    jax_bp = JaxBaselinePretrain(cfg["coarse_branch"], MIN_D, MAX_D,
                                 params=p, **kw)
    lr = images[0]
    assert rel_err(port.infer(image_lr=lr),
                   np.squeeze(np.asarray(jax_bp.infer(image_lr=lr)))) <= TOL
