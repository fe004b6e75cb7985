"""The last pieces of the JAX package's surface in the port, against the
JAX package on the CPU: TileConfig.bboxes_for, build_dinovit,
LinearSplitter (through convert/from_jax.py), infer_pil, the native
crop_resize on both backends, RunnerInfo / log_env, and the port's
dist_train.sh / dist_test.sh launchers at one process. float32;
tolerances stated per test."""

import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from patchfusion_tpu.data import native as jnative
from patchfusion_tpu.engine.tta import infer_pil as jax_infer_pil
from patchfusion_tpu.models import dinov2 as jdinov2
from patchfusion_tpu.models import zoedepth as jzoedepth
from patchfusion_tpu.models.builder import build_zoedepth_branch
from patchfusion_tpu.models.patchfusion import TileConfig as JaxTileConfig
from patchfusion_tpu_torch.convert.from_jax import (dinovit_state_dict,
                                                    linear_splitter_state_dict,
                                                    to_torch)
from patchfusion_tpu_torch.data import native
from patchfusion_tpu_torch.engine import tta
from patchfusion_tpu_torch.models.dinov2 import build_dinovit
from patchfusion_tpu_torch.models.patchfusion import TileConfig
from patchfusion_tpu_torch.models.zoedepth import LinearSplitter
from patchfusion_tpu_torch.utils.misc import RunnerInfo, log_env

from .torch_parity import nchw, nhwc, port_net, rel_err, tiny_jax

torch.set_num_threads(2)

TOOLS = os.path.join(chip_smoke.ROOT, "patchfusion_tpu_torch", "tools")


def _redraw(tree, seed):
    """Biases N(0, 0.1) and norm scales 1 + N(0, 0.1) (the JAX init leaves
    them at 0 and 1), so that every weight the conversion carries counts."""
    rng = np.random.default_rng(seed)

    def redraw(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "bias":
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(redraw, jax.device_get(tree))


# -- TileConfig.bboxes_for --------------------------------------------------

@pytest.mark.parametrize("offset", [(0, 0), (270, 480), (0, 480)])
def test_bboxes_for_matches_jax(offset):
    kw = dict(image_raw_shape=(2160, 3840), patch_split_num=(4, 4),
              patch_process_shape=(392, 518))
    port, ref = TileConfig(**kw), JaxTileConfig(**kw)
    oh, ow = port.regular_origins(offset)
    assert (oh, ow) == ref.regular_origins(offset)
    got, want = port.bboxes_for(oh, ow), ref.bboxes_for(oh, ow)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# -- build_dinovit ------------------------------------------------------------

def test_build_dinovit_loads_jax_vitmicro_strictly():
    """build_dinovit('vitmicro') holds JAX's build_dinovit('vitmicro')
    parameters strictly; the four taps at 42x56 (the pos-embed resampled
    from 37x37 to 3x4) agree within 1e-5 of max."""
    x = np.random.default_rng(3).random((2, 42, 56, 3), dtype=np.float32)
    jnet = jdinov2.build_dinovit("vitmicro")
    params = _redraw(jax.jit(jnet.init)(jax.random.PRNGKey(0), x)["params"],
                     4)
    want = jax.jit(lambda p, y: jnet.apply({"params": p}, y, n_taps=4))(
        params, x)
    net = build_dinovit("vitmicro", device="cpu")
    assert not net.training
    net.load_state_dict(to_torch(dinovit_state_dict(
        params, jdinov2.VIT_CONFIGS["vitmicro"]["depth"], "")), strict=True)
    with torch.no_grad():
        got = net(nchw(x), n_taps=4)
    assert len(got) == len(want) == 4
    for (tok, cls), (wtok, wcls) in zip(got, want):
        assert rel_err(tok.numpy(), wtok) <= 1e-5
        assert rel_err(cls.numpy(), wcls) <= 1e-5


def test_build_dinovit_casts_and_raises_without_a_card():
    net = build_dinovit("vitmicro", dtype=torch.bfloat16, device="cpu")
    assert {p.dtype for p in net.parameters()} == {torch.bfloat16}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_dinovit("vitmicro")


# -- LinearSplitter -----------------------------------------------------------

@pytest.mark.parametrize("with_embedding", [False, True])
def test_linear_splitter_matches_jax(with_embedding):
    """The JAX module's seeded parameters through
    linear_splitter_state_dict load strictly; b and the centers agree
    within 1e-5 of max, with and without prev_b_embedding (upsampled from
    the previous level's 3x4 to 6x8)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 8, 24), dtype=np.float32)
    b_prev = rng.random((2, 3, 4, 16), dtype=np.float32) + 0.1
    emb = rng.standard_normal((2, 3, 4, 24), dtype=np.float32) \
        if with_embedding else None
    jmod = jzoedepth.LinearSplitter(prev_nbins=16, split_factor=2,
                                    mlp_dim=32, min_depth=1e-3,
                                    max_depth=10.0)
    params = _redraw(jmod.init(jax.random.PRNGKey(1), x, b_prev,
                               emb)["params"], 6)
    want_b, want_c = jmod.apply({"params": params}, x, b_prev, emb)
    mod = LinearSplitter(24, 16, split_factor=2, mlp_dim=32,
                         min_depth=1e-3, max_depth=10.0)
    mod.load_state_dict(to_torch(linear_splitter_state_dict(params)),
                        strict=True)
    with torch.no_grad():
        got_b, got_c = mod(nchw(x), nchw(b_prev),
                           None if emb is None else nchw(emb))
    assert got_b.shape == (2, 32, 6, 8) and got_c.shape == (2, 32, 6, 8)
    assert rel_err(nhwc(got_b), want_b) <= 1e-5
    assert rel_err(nhwc(got_c), want_c) <= 1e-5


# -- infer_pil ---------------------------------------------------------------

@pytest.fixture(scope="module")
def zoe_pair():
    """The tiny config's coarse ZoeDepth branch in both packages, on the
    same weights: (JAX apply_fn, port apply_fn)."""
    cfg, _, _, var = tiny_jax(0)
    net, _ = port_net(cfg, var)
    jbranch = build_zoedepth_branch(cfg["coarse_branch"], 1e-3, 80)
    params = {"params": var["params"]["coarse_branch"]}
    japply = jax.jit(lambda v: jbranch.apply(params, v))

    def apply_fn(v):
        out = net.coarse_branch(v.movedim(-1, 1))
        return {"metric_depth": out["metric_depth"].movedim(1, -1)}

    return japply, apply_fn


@pytest.mark.parametrize("flip", [True, False])
def test_infer_pil_matches_jax(zoe_pair, flip):
    """infer_pil on a 42x56 RGB image, every output type, against the JAX
    infer_pil on the same branch weights, within 1e-3 of max (the TTA
    test's tolerance, tests/test_torch_eval.py): numpy (H, W) float32, PIL
    uint16 of depth x 256, a torch tensor on the asked device; another
    output type raises ValueError in both."""
    japply, apply_fn = zoe_pair
    rgb = np.random.default_rng(9).integers(0, 256, (42, 56, 3), np.uint8)
    img = Image.fromarray(rgb)
    kw = dict(with_flip_aug=flip)
    want = jax_infer_pil(japply, img, output_type="numpy", **kw)
    got = tta.infer_pil(apply_fn, img, output_type="numpy", device="cpu",
                        **kw)
    assert got.shape == want.shape == (42, 56) and got.dtype == np.float32
    assert rel_err(got, want) <= 1e-3
    pil = tta.infer_pil(apply_fn, img, output_type="pil", device="cpu", **kw)
    jpil = jax_infer_pil(japply, img, output_type="pil", **kw)
    got16, want16 = np.asarray(pil), np.asarray(jpil)
    assert got16.dtype == want16.dtype == np.uint16
    assert rel_err(got16, want16) <= 1e-3
    ten = tta.infer_pil(apply_fn, img, output_type="tensor", device="cpu",
                        **kw)
    jten = jax_infer_pil(japply, img, output_type="tensor", **kw)
    assert isinstance(ten, torch.Tensor) and ten.device.type == "cpu"
    assert isinstance(jten, jnp.ndarray)
    assert rel_err(ten.numpy(), np.asarray(jten)) <= 1e-3
    for fn, apply in ((tta.infer_pil, apply_fn), (jax_infer_pil, japply)):
        with pytest.raises(ValueError, match="not supported"):
            fn(apply, img, output_type="list")


# -- crop_resize -------------------------------------------------------------

@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_crop_resize_matches_jax(backend, monkeypatch):
    """The fused crop + bilinear align-corners resize against the JAX
    package's, through the native library and through the numpy path
    (PF_DISABLE_NATIVE), within 1e-6; non-contiguous and float64 input take
    the numpy path on either backend."""
    if backend == "numpy":
        monkeypatch.setenv("PF_DISABLE_NATIVE", "1")
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", False)
    assert native.backend() == backend
    rng = np.random.default_rng(2)
    img = rng.random((96, 128, 3), dtype=np.float32)
    for args in ((10, 20, 48, 64, 24, 32), (0, 0, 96, 128, 50, 70),
                 (33, 7, 41, 57, 82, 114)):
        want = jnative.crop_resize(img, *args)
        got = native.crop_resize(img, *args)
        assert got.shape == want.shape == (*args[4:], 3)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for odd in (img[:, ::-1], img.astype(np.float64)):
        got = native.crop_resize(odd, 5, 6, 40, 50, 20, 25)
        want = jnative.crop_resize(odd, 5, 6, 40, 50, 20, 25)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- RunnerInfo and log_env ---------------------------------------------------

def test_runner_info_is_an_attribute_bag():
    info = RunnerInfo(seed=621, work_dir="wd", rank=0)
    assert (info.seed, info.work_dir, info.rank) == (621, "wd", 0)
    info.logger = "x"
    assert info.logger == "x"


def test_log_env_lines(caplog):
    logger = logging.getLogger("pf_test_log_env")
    with caplog.at_level(logging.INFO, logger="pf_test_log_env"):
        log_env(logger, "cpu")
    text = caplog.text
    assert f"python: {sys.version.split()[0]}" in text
    assert f"torch: {torch.__version__}, cuda: {torch.version.cuda}" in text
    assert "device: cpu (cpu)" in text
    assert "rank: 0 / 1" in text


# -- the dist launchers -----------------------------------------------------

@pytest.fixture(scope="module")
def u4k_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("u4k_dist")
    return str(root), chip_smoke.write_u4k_split(root, 2, (84, 112), seed=4)


def _loader(root, kind, split):
    ds = dict(type="UnrealStereo4kDataset", mode=kind, data_root=root,
              split=split, min_depth=1e-3, max_depth=80,
              patch_raw_shape=[42, 56], resize_mode="depth-anything",
              transform_cfg=dict(network_process_size=[42, 56], degree=1.0))
    return dict(batch_size=2 if kind == "train" else 1, num_workers=1,
                dataset=ds)


def _run(script, *args, cwd):
    env = dict(os.environ, PYTHON=sys.executable, OMP_NUM_THREADS="2")
    return subprocess.run(["bash", os.path.join(TOOLS, script), *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_dist_train_sh_trains_at_one_process(u4k_split, tmp_path):
    """dist_train.sh CONFIG 1 0 COORDINATOR --device cpu: the train CLI at
    one process (the JAX launcher's arguments), one epoch of one step and a
    checkpoint; the log holds log_env's lines."""
    root, split = u4k_split
    cfg = tmp_path / "tiny_train.py"
    cfg.write_text(
        f"model = dict(type='PatchFusion', "
        f"config={chip_smoke.tiny_config()!r})\n"
        f"train_dataloader = {_loader(root, 'train', split)!r}\n"
        f"val_dataloader = {_loader(root, 'infer', split)!r}\n"
        "train_cfg = dict(max_epochs=1, val_interval=4, "
        "save_checkpoint_interval=1, log_interval=1)\n"
        "optim_wrapper = dict(optimizer=dict(type='AdamW', lr=1e-4, "
        "weight_decay=1e-3), clip_grad=dict(type='norm', max_norm=0.1))\n"
        "param_scheduler = dict(base_momentum=0.85, max_momentum=0.95, "
        "div_factor=10, final_div_factor=10000, pct_start=0.25)\n")
    wd = tmp_path / "wd"
    res = _run("dist_train.sh", str(cfg), "1", "0", "localhost:29591",
               "--device", "cpu", "--work-dir", str(wd), cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert (wd / "checkpoint_01.ckpt").is_file()
    log = (wd / "train.log").read_text()
    assert f"torch: {torch.__version__}" in log
    assert "device: cpu (cpu)" in log and "rank: 0 / 1" in log


def test_dist_test_sh_evaluates(u4k_split, tmp_path):
    """dist_test.sh CONFIG [extra]: the test CLI over a 2-scene tiny U4K
    split on the CPU, finite metrics in its log."""
    root, split = u4k_split
    cfg = tmp_path / "tiny_test.py"
    cfg.write_text(
        f"model = dict(type='PatchFusion', "
        f"config={chip_smoke.tiny_config()!r})\n"
        f"val_dataloader = {_loader(root, 'infer', split)!r}\n")
    res = _run("dist_test.sh", str(cfg), "--device", "cpu", "--dtype",
               "float32", "--image-raw-shape", "84", "112",
               "--patch-split-num", "2", "2", "--process-num", "2",
               "--work-dir", str(tmp_path / "out"), cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stderr.splitlines() if "metrics: {" in ln]
    assert line and "nan" not in line[-1]
