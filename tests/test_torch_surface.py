"""The rest of the port's surface against the JAX package on the CPU:
roi_align at sampling ratios above 1, the colorize renderers, the scipy
Canny, the profiling hooks, the reference call shim, and the convert /
export / synthetic-data tools against the JAX package's tools/ on the
same inputs."""

import importlib.util
import json
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from patchfusion_tpu.engine.checkpoint import load_params as jax_load_params
from patchfusion_tpu.engine.checkpoint import save_params as jax_save_params
from patchfusion_tpu.ops import roi_align as jroi
from patchfusion_tpu.utils import colorize as jcolorize
from patchfusion_tpu.utils import metrics as jmetrics
from patchfusion_tpu.utils import profiling as jprofiling
from patchfusion_tpu_torch.api import PatchFusion
from patchfusion_tpu_torch.convert.from_jax import (state_dict_from_flax,
                                                    to_torch)
from patchfusion_tpu_torch.data import u4k
from patchfusion_tpu_torch.engine import checkpoint
from patchfusion_tpu_torch.ops import roi_align
from patchfusion_tpu_torch.tools import (convert_checkpoint, export_hub,
                                         infer, make_synth_u4k,
                                         test_single_forward)
from patchfusion_tpu_torch.tools.test import load_patchfusion
from patchfusion_tpu_torch.utils import colorize, metrics, profiling

from .torch_parity import port_net, tiny_jax

torch.set_num_threads(2)

BRANCHES = ("coarse_branch", "fine_branch")


def _jax_tool(name: str):
    """The JAX package's tools/<name>.py as a module."""
    path = os.path.join(chip_smoke.ROOT, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(monkeypatch, name: str, *args: str) -> None:
    monkeypatch.setattr(sys, "argv", [name, *args])
    _jax_tool(name).main()


# -- roi_align ---------------------------------------------------------------

@pytest.mark.parametrize("ratio", [2, 3])
@pytest.mark.parametrize("batched", [False, True])
def test_roi_align_sampling_ratio_matches_jax(ratio, batched):
    """Boxes inside, across and beyond the map's edge, a scale that is not
    1: within 1e-5 of max of the JAX dense path."""
    rng = np.random.default_rng(ratio)
    n = 6
    xy = rng.uniform(-3, 12, (n, 2))
    wh = rng.uniform(2, 14, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    shape = (n, 10, 12, 3) if batched else (1, 10, 12, 3)
    feat = rng.standard_normal(shape).astype(np.float32)
    fn = "roi_align_batched" if batched else "roi_align_single"
    want = np.asarray(getattr(jroi, fn)(jnp.asarray(feat), jnp.asarray(boxes),
                                        5, 7, 0.75, sampling_ratio=ratio))
    got = getattr(roi_align, fn)(torch.from_numpy(feat),
                                 torch.from_numpy(boxes), 5, 7, 0.75,
                                 sampling_ratio=ratio).numpy()
    assert got.shape == want.shape == (n, 5, 7, 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_adaptive_sampling_ratio_matches_jax():
    for extent in (0.5, 3.0, 7.0, 7.01, 16.0, 100.3):
        for out in (1, 7, 16):
            assert roi_align.adaptive_sampling_ratio(extent, out) == \
                jroi.adaptive_sampling_ratio(extent, out)


# -- colorize and edges ---------------------------------------------------

def _depth_map(rng, shape=(24, 32)):
    d = rng.random(shape) * 20 + 1
    d[4:12, 6:20] = 3.0
    d[15:20, 2:9] = 18.0
    return d


@pytest.mark.parametrize("kw", [
    {},
    dict(vmin=2.0, vmax=9.0, cmap="magma_r"),
    dict(invalid_val=-1.0),
    dict(invalid_mask="mask", background_color=(0, 10, 20, 255)),
    dict(gamma_corrected=True, vminp=10.0, vmaxp=80.0),
    dict(value_transform="square", cmap="viridis"),
])
def test_colorize_matches_jax(kw):
    rng = np.random.default_rng(7)
    depth = _depth_map(rng)
    depth[0, :5] = kw.get("invalid_val", -99)
    kw = dict(kw)
    if kw.get("invalid_mask") == "mask":
        kw["invalid_mask"] = rng.random(depth.shape) < 0.1
    if kw.get("value_transform") == "square":
        kw["value_transform"] = np.square
    got = colorize.colorize(depth, **kw)
    assert got.shape == (*depth.shape, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jcolorize.colorize(depth, **kw))


@pytest.mark.parametrize("kw", [{}, dict(cmap="turbo", vmin=0.0),
                                dict(vmin=5.0, vmax=5.0)])
def test_colorize_infer_pfv1_matches_jax(kw):
    depth = _depth_map(np.random.default_rng(8))
    np.testing.assert_array_equal(colorize.colorize_infer_pfv1(depth, **kw),
                                  jcolorize.colorize_infer_pfv1(depth, **kw))


@pytest.mark.parametrize("kw", [{}, dict(rescale_vmin=2.0, rescale_vmax=10.0),
                                dict(vmin=4.0, vminp=5.0, vmaxp=60.0,
                                     cmap="magma_r")])
def test_colorize_rescale_matches_jax(kw):
    depth = _depth_map(np.random.default_rng(9))
    np.testing.assert_array_equal(colorize.colorize_rescale(depth, **kw),
                                  jcolorize.colorize_rescale(depth, **kw))


@pytest.mark.parametrize("preprocess", [None, "log", "inv"])
@pytest.mark.parametrize("masked", [False, True])
def test_extract_edges_matches_jax(preprocess, masked):
    rng = np.random.default_rng(10)
    depth = _depth_map(rng, (40, 56)) + 0.05 * rng.random((40, 56))
    depth[:3, :3] = 0.0  # non-positive depth maps to 0
    mask = rng.random(depth.shape) > 0.3 if masked else None
    want = jmetrics.extract_edges(depth, preprocess=preprocess, mask=mask)
    got = metrics.extract_edges(depth, preprocess=preprocess, mask=mask)
    assert got.dtype == bool and 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, want)


def test_extract_edges_sobel_raises():
    with pytest.raises(NotImplementedError):
        metrics.extract_edges(np.ones((8, 8)), use_canny=False)


# -- profiling ---------------------------------------------------------------

def test_section_timer_matches_jax_format():
    timer, jtimer = profiling.SectionTimer(), jprofiling.SectionTimer()
    x = torch.ones(3)
    with timer.section("load", sync=x):
        time.sleep(0.01)
    with timer.section("infer", sync="cpu"):
        pass
    with timer.section("infer"):
        pass
    assert timer.counts == {"load": 1, "infer": 2}
    assert timer.totals["load"] >= 0.01
    jtimer.totals, jtimer.counts = dict(timer.totals), dict(timer.counts)
    assert timer.summary() == jtimer.summary()
    assert timer.summary().splitlines()[0].startswith("load")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None):
        torch.ones(4).sum()
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# -- the call shim ---------------------------------------------------------

def test_call_shim_matches_infer():
    """NCHW in, (depth (1, 1, H, W), {"rgb", "depth_pred"}) out, equal to
    infer's depth; tile_cfg's keys; a train call refused."""
    model = PatchFusion.from_config(chip_smoke.tiny_config(), device="cpu",
                                    seed=0)
    rng = np.random.default_rng(11)
    hr = rng.random((84, 112, 3), dtype=np.float32)
    lr = rng.random((1, 42, 56, 3), dtype=np.float32)
    want = model.infer(lr, hr, cai_mode="m2", process_num=2)
    lr_t = torch.from_numpy(lr).permute(0, 3, 1, 2)
    hr_t = torch.from_numpy(hr).permute(2, 0, 1)[None]
    depth, log = model("infer", image_lr=lr_t, image_hr=hr_t,
                       cai_mode="m2", process_num=2)
    assert isinstance(depth, torch.Tensor) and depth.shape == (1, 1, 84, 112)
    np.testing.assert_array_equal(depth[0, 0].numpy(), want)
    assert set(log) == {"rgb", "depth_pred"}
    assert log["depth_pred"] is depth and torch.equal(log["rgb"], lr_t)
    again, _ = model(image_lr=lr_t.numpy(), image_hr=hr_t, cai_mode="m2",
                     process_num=2, tile_cfg={"image_raw_shape": (84, 112),
                                              "patch_split_num": (2, 2)})
    assert torch.equal(again, depth)
    with pytest.raises(AssertionError):
        model("train", image_lr=lr_t, image_hr=hr_t)


def test_test_single_forward_is_the_infer_cli():
    assert test_single_forward.main is infer.main
    assert vars(test_single_forward.parse_args(["x.png"])) == \
        vars(infer.parse_args(["x.png"]))


# -- convert / export ---------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(config, JAX variables, config file, the .pth triple written from
    them through convert/from_jax.py, the port's full state dict)."""
    cfg, _, _, var = tiny_jax(0)
    sd = to_torch(state_dict_from_flax(var["params"], var["batch_stats"],
                                       cfg))
    root = tmp_path_factory.mktemp("surface")
    cfg_file = root / "tiny.py"
    cfg_file.write_text(f"model = dict(type='PatchFusion', config={cfg!r})\n")
    triple = []
    for name in (*BRANCHES, "fusion"):
        if name in BRANCHES:
            part = {k[len(name) + 1:]: v for k, v in sd.items()
                    if k.startswith(name + ".")}
        else:
            part = {k: v for k, v in sd.items()
                    if k.split(".")[0] not in BRANCHES}
        path = root / f"{name}.pth"
        torch.save({"model_state_dict": part}, path)
        triple.append(str(path))
    return cfg, var, str(cfg_file), tuple(triple), sd, root


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = torch.as_tensor(got[k]), torch.as_tensor(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert torch.equal(g, w), k


def test_convert_checkpoint_matches_jax(tiny, monkeypatch):
    """The JAX tool's msgpack through convert/from_jax.py equals the port's
    file, key for key; without --fusion the port's file holds the two
    branches only (as the JAX tool's)."""
    cfg, _, cfg_file, (coarse, fine, fusion), _, root = tiny
    jpath, tpath = str(root / "jax.msgpack"), str(root / "port.pt")
    args = [cfg_file, "--coarse", coarse, "--fine", fine, "--fusion", fusion]
    _run_jax_tool(monkeypatch, "convert_checkpoint", *args, "--save-path",
                  jpath)
    convert_checkpoint.main([*args, "--save-path", tpath])
    blob = jax_load_params(jpath)
    want = to_torch(state_dict_from_flax(blob["params"],
                                         blob["batch_stats"], cfg))
    params, stats = checkpoint.read_weights(tpath)
    _assert_same_state({**params, **stats}, want)
    assert all(k.split(".")[0] not in BRANCHES for k in stats)

    branches = str(root / "branches.pt")
    convert_checkpoint.main([cfg_file, "--coarse", coarse, "--fine", fine,
                             "--save-path", branches])
    params, stats = checkpoint.read_weights(branches)
    assert not stats and {k.split(".")[0] for k in params} == set(BRANCHES)


def test_converted_file_loads_in_the_cli(tiny):
    """The CLIs' loader reads the full file without the config's branch
    files (load_branch set, pretrain_model absent on disk): the weights of
    from_config(ckpts=triple)."""
    cfg, _, cfg_file, triple, _, root = tiny
    path = str(root / "full.pt")
    convert_checkpoint.main([cfg_file, "--coarse", triple[0], "--fine",
                             triple[1], "--fusion", triple[2],
                             "--save-path", path])
    missing = dict(cfg, load_branch=True,
                   pretrain_model=[str(root / "no_coarse.pth"),
                                   str(root / "no_fine.pth")])
    got = load_patchfusion(missing, path, "cpu", torch.float32)
    want = PatchFusion.from_config(cfg, device="cpu", seed=3, ckpts=triple)
    _assert_same_state(got.net.state_dict(), want.net.state_dict())


@pytest.mark.parametrize("fusion_only", [False, True])
def test_export_hub_matches_jax(tiny, monkeypatch, fusion_only):
    """The same weights exported by both tools: the same keys and equal
    tensors in pytorch_model.bin, the same config.json; a full snapshot
    loads with from_pretrained and answers as the net it came from."""
    cfg, var, cfg_file, _, sd, root = tiny
    tag = "fusion" if fusion_only else "full"
    jweights, tweights = root / f"{tag}.msgpack", root / f"{tag}.pt"
    params = dict(var["params"])
    net, tile_cfg = port_net(cfg, var)
    model = PatchFusion(net, tile_cfg, cfg)
    if fusion_only:
        params = {k: v for k, v in params.items() if k not in BRANCHES}
        model.save(str(tweights))
    else:
        checkpoint.save_weights(str(tweights), net)
    jax_save_params(str(jweights), params, var["batch_stats"])
    jdir, tdir = root / f"{tag}_jax", root / f"{tag}_port"
    _run_jax_tool(monkeypatch, "export_hub", cfg_file, "--weights",
                  str(jweights), "--out-dir", str(jdir))
    assert export_hub.main([cfg_file, "--weights", str(tweights),
                            "--out-dir", str(tdir)]) == fusion_only
    got = torch.load(tdir / "pytorch_model.bin", weights_only=True)
    want = torch.load(jdir / "pytorch_model.bin", weights_only=True)
    _assert_same_state(got, want)
    if fusion_only:
        assert {k for k in sd if k.split(".")[0] not in BRANCHES} == set(got)
    assert json.loads((tdir / "config.json").read_text()) == \
        json.loads((jdir / "config.json").read_text())
    if not fusion_only:
        loaded = PatchFusion.from_pretrained(str(tdir), device="cpu")
        rng = np.random.default_rng(12)
        hr = rng.random((84, 112, 3), dtype=np.float32)
        lr = rng.random((1, 42, 56, 3), dtype=np.float32)
        np.testing.assert_array_equal(
            loaded.infer(lr, hr, process_num=2),
            model.infer(lr, hr, process_num=2))


# -- synthetic data ----------------------------------------------------------

def test_make_synth_u4k_matches_jax(tmp_path, monkeypatch):
    """The same seed at 64x96: the same files, equal split files, the
    disparity within 1e-5 relative, the image within 1 uint8 level; the
    port's U4K dataset reads the result."""
    args = ["--n-train", "2", "--n-val", "1", "--oversample", "3",
            "--seed", "5", "--height", "64", "--width", "96"]
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    _run_jax_tool(monkeypatch, "make_synth_u4k", "--root", str(jroot), *args)
    make_synth_u4k.main(["--root", str(troot), *args])

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert tree(troot) == tree(jroot)
    for name in ("train.txt", "val.txt", "train_x3.txt"):
        assert (troot / name).read_text() == (jroot / name).read_text()
    for i in range(3):
        scene = f"scene_{i:02d}"
        want = np.load(jroot / scene / "Disp0" / "00000.npy")
        got = np.load(troot / scene / "Disp0" / "00000.npy")
        assert got.dtype == want.dtype and got.shape == (64, 96)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        img = [np.fromfile(r / scene / "Image0" / "00000.raw",
                           np.uint8).astype(int) for r in (troot, jroot)]
        assert np.abs(img[0] - img[1]).max() <= 1
        for ext in ("Extrinsics0", "Extrinsics1"):
            assert (troot / scene / ext / "00000.txt").read_text() == \
                (jroot / scene / ext / "00000.txt").read_text()
    ds = u4k.UnrealStereo4kDataset(
        mode="infer", data_root=str(troot), split=str(troot / "val.txt"),
        min_depth=1e-3, max_depth=80, resize_mode="depth-anything",
        transform_cfg=dict(network_process_size=[42, 56]))
    sample = ds[0]
    assert sample["image_hr"].shape == (64, 96, 3)
    np.testing.assert_allclose(
        sample["depth_gt"][..., 0],
        50.0 / np.load(troot / "scene_02" / "Disp0" / "00000.npy"),
        rtol=1e-6)
