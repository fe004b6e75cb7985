"""The port's eval path against the JAX package's on the tiny config:
metrics (utils/metrics.py), the U4K and folder datasets, the Tester, the
test and infer CLIs and the TTA. A tiny U4K val split (84x112, written with
numpy by chip_smoke.write_u4k_split) stands in for the dataset. float32;
tolerances stated per test."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from patchfusion_tpu.data import general as jgeneral
from patchfusion_tpu.data import loader as jloader
from patchfusion_tpu.data import u4k as ju4k
from patchfusion_tpu.engine.inference import PatchFusionInference
from patchfusion_tpu.engine.tester import Tester as JaxTester
from patchfusion_tpu.engine.tta import zoe_infer as jax_zoe_infer
from patchfusion_tpu.models.builder import build_zoedepth_branch
from patchfusion_tpu.utils import metrics as jmetrics
from patchfusion_tpu_torch.api import PatchFusion
from patchfusion_tpu_torch.data import general, loader, native, u4k
from patchfusion_tpu_torch.engine import tta
from patchfusion_tpu_torch.engine.tester import Tester
from patchfusion_tpu_torch.tools import infer as infer_cli
from patchfusion_tpu_torch.tools import test as test_cli
from patchfusion_tpu_torch.utils import metrics

from .torch_parity import port_net, rel_err, tiny_jax

torch.set_num_threads(2)

PROCESS_NUM = 2
RAW = (84, 112)
U4K_KW = dict(mode="infer", min_depth=1e-3, max_depth=80,
              resize_mode="depth-anything",
              transform_cfg=dict(network_process_size=[42, 56]))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("u4k")
    return str(root), chip_smoke.write_u4k_split(root, 2, RAW, seed=1)


@pytest.fixture(scope="module")
def models():
    cfg, jnet, tile_cfg, var = tiny_jax(0)
    net, port_tile_cfg = port_net(cfg, var)
    return cfg, (jnet, tile_cfg, var), PatchFusion(net, port_tile_cfg, cfg)


# -- metrics --------------------------------------------------------------

def _depth_pair(seed, shape=(37, 53)):
    rng = np.random.default_rng(seed)
    gt = (1 + 20 * rng.random(shape)).astype(np.float32)
    gt[rng.random(shape) < 0.1] = 0.0  # invalid pixels
    pred = (gt + rng.standard_normal(shape)).astype(np.float32)
    return gt, pred


@pytest.mark.parametrize("dilation", [0, 10])
def test_get_boundaries_matches_jax(dilation):
    disp = _depth_pair(0)[0]
    np.testing.assert_array_equal(
        metrics.get_boundaries(disp, th=1, dilation=dilation),
        jmetrics.get_boundaries(disp, th=1, dilation=dilation))


def test_resize_pred_to_gt_matches_jax():
    pred = _depth_pair(1, (21, 28))[1]
    np.testing.assert_allclose(metrics.resize_pred_to_gt(pred, (37, 53)),
                               jmetrics.resize_pred_to_gt(pred, (37, 53)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pred_shape", [(37, 53), (20, 30)])
def test_compute_metrics_matches_jax(pred_shape):
    gt, _ = _depth_pair(2)
    pred = _depth_pair(3, pred_shape)[1]
    edges = metrics.get_boundaries(gt, th=1, dilation=0)
    kw = dict(disp_gt_edges=edges, min_depth_eval=1e-3, max_depth_eval=80,
              garg_crop=False, eigen_crop=False, dataset="")
    want = jmetrics.compute_metrics(gt, pred, **kw)
    got = metrics.compute_metrics(gt, pred, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k


def test_colorize_matches_jax():
    """The Tester's PNG rendering: percentile range over the valid pixels,
    invalid ones gray, as the JAX package renders it."""
    from patchfusion_tpu.utils import colorize as jcolorize
    from patchfusion_tpu_torch.utils import colorize

    depth = _depth_pair(4)[1]
    depth[:3, :5] = -99
    np.testing.assert_array_equal(colorize.colorize(depth),
                                  jcolorize.colorize(depth))
    np.testing.assert_array_equal(
        colorize.colorize(depth, vmin=2.0, vmax=9.0, cmap="magma_r"),
        jcolorize.colorize(depth, vmin=2.0, vmax=9.0, cmap="magma_r"))


# -- datasets -------------------------------------------------------------

@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_u4k_items_match_jax(split, backend, monkeypatch):
    """Each val item of the port's dataset holds the JAX dataset's arrays,
    through the native host IO and through its numpy fallback."""
    root, split_file = split
    if backend == "numpy":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    assert native.backend() == backend
    kw = dict(U4K_KW, data_root=root, split=split_file)
    port_ds = u4k.UnrealStereo4kDataset(**kw)
    jax_ds = ju4k.UnrealStereo4kDataset(**kw)
    assert len(port_ds) == len(jax_ds) == 2
    for i in range(2):
        got, want = port_ds[i], jax_ds[i]
        assert got.keys() == want.keys()
        assert got["img_file_basename"] == want["img_file_basename"]
        for k in ("image_lr", "image_hr", "depth_gt", "boundary"):
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    assert port_ds[0]["boundary"].sum() > 0


def test_image_dataset_items_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    for i in range(2):
        Image.fromarray((rng.random((60, 80, 3)) * 255).astype(
            np.uint8)).save(tmp_path / f"img{i}.png")
    kw = dict(rgb_image_dir=str(tmp_path), network_process_size=(42, 56),
              resize_mode="depth-anything", image_resolution=RAW)
    port_ds, jax_ds = general.ImageDataset(**kw), jgeneral.ImageDataset(**kw)
    for i in range(2):
        got, want = port_ds[i], jax_ds[i]
        assert got["img_file_basename"] == want["img_file_basename"]
        for k in ("image_lr", "image_hr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6)


# -- Tester and CLIs --------------------------------------------------------

def test_tester_matches_jax(split, models):
    """The Tester's metrics on the tiny split, m1, against the JAX Tester's
    with the same weights: within 1e-4 relative per key."""
    root, split_file = split
    _, (jnet, tile_cfg, var), port = models
    kw = dict(U4K_KW, data_root=root, split=split_file)
    want = JaxTester(
        PatchFusionInference(jnet, var, tile_cfg, process_num=PROCESS_NUM),
        jloader.DataLoader(ju4k.UnrealStereo4kDataset(**kw),
                           num_workers=1)).run(cai_mode="m1")
    tester = Tester(port.engine(PROCESS_NUM),
                    loader.DataLoader(u4k.UnrealStereo4kDataset(**kw),
                                      num_workers=1))
    got = tester.run(cai_mode="m1")
    assert got.keys() == want.keys() == set(u4k.METRIC_ORDER)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-7), k
    assert [set(s) for s in tester.image_seconds] == \
        [{"load", "inference", "metrics"}] * 2


def test_tester_refuses_several_processes(split, models, monkeypatch):
    """Several ranks with neither a sharded loader nor a tile-split engine
    raise rather than gather every image once per rank (the 2-rank Tester
    itself: tests/test_torch_dist.py)."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    root, split_file = split
    tester = Tester(models[2].engine(PROCESS_NUM), loader.DataLoader(
        u4k.UnrealStereo4kDataset(**U4K_KW, data_root=root,
                                  split=split_file), num_workers=1))
    with pytest.raises(ValueError, match="gather"):
        tester.run()


def _tiny_config_file(path, models, split=None):
    """A config file holding the tiny model config and, given a split, a
    val loader over it."""
    text = f"model = dict(type='PatchFusion', config={models[0]!r})\n"
    if split is not None:
        root, split_file = split
        ds = dict(U4K_KW, type="UnrealStereo4kDataset", data_root=root,
                  split=split_file)
        text += f"val_dataloader = dict(num_workers=1, dataset={ds!r})\n"
    path.write_text(text)
    return str(path)


def test_test_cli_returns_finite_metrics(split, models, tmp_path):
    cfg_file = _tiny_config_file(tmp_path / "tiny.py", models, split)
    got = test_cli.main([cfg_file, "--device", "cpu", "--dtype", "float32",
                         "--image-raw-shape", "84", "112",
                         "--patch-split-num", "2", "2",
                         "--process-num", str(PROCESS_NUM),
                         "--work-dir", str(tmp_path / "out"), "--save"])
    assert set(got) == set(u4k.METRIC_ORDER)
    assert all(np.isfinite(v) for v in got.values())
    saved = sorted(os.listdir(tmp_path / "out"))
    assert len(saved) == 4 and saved[0].endswith(".png")


def test_test_cli_rejects_the_jax_checkpoint(models, tmp_path):
    """The port reads its own `.ckpt` (tests/test_torch_trainer.py); the
    JAX package's msgpack checkpoint raises, saying so."""
    from patchfusion_tpu.engine.checkpoint import save_params as jax_save

    cfg_file = _tiny_config_file(tmp_path / "tiny.py", models)
    ckpt = tmp_path / "checkpoint_24.ckpt"
    jax_save(str(ckpt), models[1][2]["params"]["head"])
    with pytest.raises(ValueError, match="no flax msgpack"):
        test_cli.main([cfg_file, "--device", "cpu",
                       "--ckp-path", str(ckpt)])


def test_infer_cli_writes_both_pngs(models, tmp_path):
    cfg_file = _tiny_config_file(tmp_path / "tiny.py", models)
    out = tmp_path / "depth.png"
    depth = infer_cli.main([
        str(chip_smoke.ROOT / "examples" / "example_1.jpeg"), "--config",
        cfg_file, "--device", "cpu", "--image-raw-shape", "84", "112",
        "--process-num", str(PROCESS_NUM), "--out", str(out)])
    assert depth.shape == (84, 112) and np.isfinite(depth).all()
    assert np.asarray(Image.open(out)).shape[:2] == (84, 112)
    assert np.asarray(Image.open(tmp_path / "depth_uint16.png")).dtype \
        == np.uint16


# -- TTA -------------------------------------------------------------------

def test_zoe_infer_matches_jax(models):
    """Reflect pad to 68x86, resize to 70x84, the branch, bicubic back and
    the flip average, against the JAX zoe_infer on the same branch weights
    (1e-3 of max)."""
    cfg, (_, _, var), port = models
    jbranch = build_zoedepth_branch(cfg["coarse_branch"], 1e-3, 80)
    params = {"params": var["params"]["coarse_branch"]}
    x = np.random.default_rng(8).random((1, 42, 56, 3), dtype=np.float32)
    apply_jit = jax.jit(lambda v: jbranch.apply(params, v))
    want = np.asarray(jax_zoe_infer(apply_jit, x))

    def apply_fn(v):
        out = port.net.coarse_branch(v.movedim(-1, 1))
        return {"metric_depth": out["metric_depth"].movedim(1, -1)}

    with torch.no_grad():
        got = tta.zoe_infer(apply_fn, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 42, 56, 1)
    assert rel_err(got, want) <= 1e-3
