"""The port's tiled-inference slice as a whole against the JAX package:
PatchFusion.infer (patchfusion_tpu_torch.api) vs
PatchFusionInference.infer (patchfusion_tpu.engine.inference) on the tiny
config with the same weights, images and random tile origins; float32, at
1e-3 relative to max (measured ~1e-6). Plus the port's import boundary."""

import inspect
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import chip_smoke
from patchfusion_tpu.engine.inference import PatchFusionInference
from patchfusion_tpu.models.patchfusion import TileConfig
from patchfusion_tpu_torch.api import BaselinePretrain, PatchFusion
from patchfusion_tpu_torch.engine.inference import _parse_mode
from patchfusion_tpu_torch.models.builder import (build_patchfusion,
                                                  build_zoedepth_branch)
from patchfusion_tpu_torch.tools import infer as infer_cli
from patchfusion_tpu_torch.tools import test as test_cli

from .torch_parity import port_net, rel_err, tiny_jax

torch.set_num_threads(2)

TOL = 1e-3
PROCESS_NUM = 2


@pytest.fixture(scope="module")
def engines():
    cfg, jnet, tile_cfg, var = tiny_jax(0)
    net, port_tile_cfg = port_net(cfg, var)
    assert (port_tile_cfg.patch_raw_shape, port_tile_cfg.process_origins(
        (21, 28))) == (tile_cfg.patch_raw_shape,
                       tile_cfg.process_origins((21, 28)))
    jax_engine = PatchFusionInference(jnet, var, tile_cfg,
                                      process_num=PROCESS_NUM)
    return jax_engine, PatchFusion(net, port_tile_cfg, cfg)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    return (rng.random((1, 42, 56, 3), dtype=np.float32),
            rng.random((84, 112, 3), dtype=np.float32))


@pytest.fixture(scope="module")
def outputs(engines, images):
    """Both sides' depth for m1, m2 and r4 (same rand_origins)."""
    jax_engine, port = engines
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
def test_infer_matches_jax(outputs, engines, mode):
    want, got = outputs[mode]
    tc = engines[1].tile_cfg
    shape = tc.image_raw_shape if mode == "r4" else tc.patch_reensemble_shape
    assert got.shape == want.shape == tuple(shape)
    assert got.dtype == np.float32
    assert rel_err(got, want) <= TOL


def test_modes_differ(outputs):
    """m2's shifted passes and r4's random tiles change the blend."""
    m1, m2, r4 = (outputs[m][1] for m in ("m1", "m2", "r4"))
    assert np.abs(m2 - m1).max() > 1e-4
    assert np.abs(r4 - m2).max() > 1e-4


def test_rn_at_a_raw_shape_with_a_nearest_resize_matches_jax(engines):
    """r4 at image_raw_shape (100, 140): the 84x112 reensemble canvas and
    the 42x56 tiles are moved to raw size with 'nearest' (84 -> 100 is a
    ratio where F.interpolate's float32 rule reads another row)."""
    jax_engine, port = engines
    tc = TileConfig((100, 140), (2, 2),
                    jax_engine.tile_cfg.patch_process_shape)
    jeng = PatchFusionInference(jax_engine.net, jax_engine.variables, tc,
                                process_num=PROCESS_NUM)
    rng = np.random.default_rng(11)
    lr = rng.random((1, 42, 56, 3), dtype=np.float32)
    hr = rng.random((100, 140, 3), dtype=np.float32)
    rand = jeng.random_origins(4, np.random.default_rng(5))
    want = np.asarray(jeng.infer(lr, hr, cai_mode="r4", rand_origins=rand))
    got = port.infer(lr, hr, cai_mode="r4", process_num=PROCESS_NUM,
                     image_raw_shape=(100, 140), rand_origins=rand)
    assert got.shape == want.shape == (100, 140)
    assert rel_err(got, want) <= TOL


def test_random_origins_match_jax(engines):
    jax_engine, port = engines
    a = jax_engine.random_origins(8, np.random.default_rng(9))
    b = port.engine(PROCESS_NUM).random_origins(8, np.random.default_rng(9))
    np.testing.assert_array_equal(a, b)


def test_infer_batch_matches_per_image(engines):
    """infer_batch (one coarse pass over the batch) equals per-image
    infer, for a regular and a random mode."""
    port = engines[1]
    rng = np.random.default_rng(4)
    lrs = rng.random((2, 42, 56, 3), dtype=np.float32)
    hrs = rng.random((2, 84, 112, 3), dtype=np.float32)
    eng = port.engine(PROCESS_NUM)
    rand = np.stack([eng.random_origins(2, rng) for _ in range(2)])
    for mode, ro in (("m1", None), ("r2", rand)):
        batch = eng.infer_batch(lrs, hrs, cai_mode=mode,
                                rand_origins=ro).numpy()
        for i in range(2):
            one = port.infer(lrs[i:i + 1], hrs[i], cai_mode=mode,
                             process_num=PROCESS_NUM,
                             rand_origins=None if ro is None else ro[i])
            np.testing.assert_allclose(batch[i], one, rtol=1e-5, atol=1e-5)


def test_chip_smoke_tiny_config_is_the_graft_config():
    assert chip_smoke.tiny_config() == graft._tiny_config()


def test_entry_points_default_to_the_card():
    """PatchFusion.from_config and build_patchfusion run on the card unless
    the caller asks for the CPU; without CUDA the default raises instead of
    falling back."""
    for fn in (PatchFusion.from_config, PatchFusion.from_pretrained,
               BaselinePretrain, build_patchfusion, build_zoedepth_branch):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert test_cli.parse_args(["cfg.py"]).device == "cuda"
    assert infer_cli.parse_args(["image.png"]).device == "cuda"
    cfg = chip_smoke.tiny_config()
    if torch.cuda.is_available():
        model = PatchFusion.from_config(cfg)
        assert next(model.net.parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PatchFusion.from_config(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_patchfusion(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BaselinePretrain(cfg["fine_branch"], 1e-3, 80)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PatchFusion.from_pretrained(str(chip_smoke.ROOT))
    net, _ = build_patchfusion(cfg, device="cpu")
    assert next(net.parameters()).device.type == "cpu"


def test_chip_smoke_bounds():
    """The least times chip_smoke.py reports beside the kernels, at the
    main-path shapes (B=4, 392x518 out, 224x296 in, bf16): bytes / 3.35
    TB/s for the head kernels, tensor-core FLOPs / 989 TFLOP/s for the
    attention."""
    heads = chip_smoke.head_bounds(4, 392, 518, 224, 296, 64, 33, 128, 80, 2)
    ms = {name: round(t * 1e3, 1) for name, (t, _) in heads.items()}
    assert ms == {"clb_pt": 38.2, "logbinomial_depth": 13.0,
                  "clb_logbinomial_depth": 47.4}  # microseconds
    assert {by for _, by in heads.values()} == {"bytes"}
    t, by = chip_smoke.attention_bound(4, 1037, 16, 64)
    assert (round(t * 1e3, 1), by) == (17.8, "operations")


def test_profile_busy_time_is_the_union_of_intervals():
    from patchfusion_tpu_torch.profile_request import _busy_us
    assert _busy_us([(5, 6), (0, 2), (1, 3), (2.5, 2.8)]) == 4
    assert _busy_us([]) == 0


def test_import_pulls_in_no_jax_or_triton():
    """No module of the port (every module of every subpackage: data,
    utils and tools included) imports JAX, flax, the JAX package or
    triton."""
    code = ("import importlib, pkgutil, sys, patchfusion_tpu_torch as p; "
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'patchfusion_tpu', 'triton')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(chip_smoke.ROOT))
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("cai_mode,times,want", [
    ("r5", False, ("r", 4)),   # PatchFusion: N // process_num groups
    ("r5", True, ("r", 10)),   # BaselinePretrain: N groups
    ("m2", False, ("m2", 0)),
    ("p16", False, ("m1", 0)),  # unknown modes run as m1 (reference quirk)
])
def test_mode_parsing_quirks(cai_mode, times, want):
    """The random-tile count rules of
    patchfusion_tpu/engine/inference.py:472-494."""
    assert _parse_mode(cai_mode, PROCESS_NUM, times) == want
