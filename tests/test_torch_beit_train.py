"""The port's BEiT ZoeDepth family in training and through its CLIs, on
the CPU: one f32 fusion-stage step against the JAX package (the loss
within 1e-5 relative, on tests/test_beit.py's toy zoedepth config with
every JAX leaf drawn by torch_parity.redraw_beit), and the train_branch /
train / test / infer CLIs on toy zoedepth configs (resize_mode 'zoe',
64x96) over a synthetic U4K split, every loss and metric finite."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from patchfusion_tpu.models.losses import SILogLoss as JaxSILogLoss
from patchfusion_tpu.models.patchfusion import PatchFusionNet as JaxNet
from patchfusion_tpu_torch.engine import training
from patchfusion_tpu_torch.models.losses import SILogLoss
from patchfusion_tpu_torch.tools import infer as infer_cli
from patchfusion_tpu_torch.tools import test as test_cli
from patchfusion_tpu_torch.tools import train as train_cli
from patchfusion_tpu_torch.tools import train_branch as train_branch_cli

from .torch_parity import port_net, toy_zoe_jax

torch.set_num_threads(2)

PROCESS_NUM = 2
MIN_D, MAX_D = 1e-3, 80.0


def test_fusion_step_loss_matches_jax():
    """One f32 fusion-stage step on the toy zoedepth config: the port's
    loss within 1e-5 (relative) of the JAX package's train_forward + SILog
    on the same weights and batch (flax's BatchNorm traced with its
    two-pass variance, as tests/test_torch_train.py does)."""
    import flax.linen.normalization as flax_norm

    cfg, jnet, _, var = toy_zoe_jax(0)
    rng = np.random.default_rng(4)
    depth = rng.random((2, 64, 96, 1), dtype=np.float32) * 40 + 1
    depth[0, :5] = 0.0
    batch = {"image_lr": rng.random((2, 64, 96, 3), dtype=np.float32),
             "crops_image_hr": rng.random((2, 64, 96, 3), dtype=np.float32),
             "crop_depths": depth,
             "bboxs": np.array([[0, 0, 1920, 1080],
                                [1920, 1080, 3840, 2160]], np.float32)}

    @jax.jit
    def jax_loss(v, lr, crops, boxes, gt):
        pred, _ = jnet.apply(v, lr, crops, boxes, train=True,
                             mutable=["batch_stats"],
                             method=JaxNet.train_forward)
        return JaxSILogLoss()(pred, gt, MIN_D, MAX_D)

    compute_stats = flax_norm._compute_stats
    flax_norm._compute_stats = lambda *a, **k: compute_stats(
        *a, **{**k, "use_fast_variance": False})
    try:
        want = float(jax_loss(var, *(jnp.asarray(batch[k]) for k in (
            "image_lr", "crops_image_hr", "bboxs", "crop_depths"))))
    finally:
        flax_norm._compute_stats = compute_stats
    net, _ = port_net(cfg, var)
    state = training.create_train_state(
        net, training.make_onecycle_optimizer(1e-4, 7))
    loss, _ = training.fusion_loss(
        state, training.to_device_batch(batch, "cpu", batch.keys()),
        SILogLoss(), MIN_D, MAX_D)
    assert np.isfinite(want)
    assert abs(float(loss) - want) <= 1e-5 * abs(want)


def _u4k(root, kind, split):
    ds = dict(type="UnrealStereo4kDataset", mode=kind, data_root=root,
              split=split, min_depth=MIN_D, max_depth=MAX_D,
              patch_raw_shape=[64, 96], resize_mode="zoe",
              transform_cfg=dict(network_process_size=[64, 96], degree=1.0))
    return dict(batch_size=2 if kind == "train" else 1, num_workers=1,
                dataset=ds)


RUN = ("train_cfg = dict(max_epochs=1, val_interval=1, "
       "save_checkpoint_interval=1, log_interval=1)\n"
       "optim_wrapper = dict(optimizer=dict(type='AdamW', lr=1e-4, "
       "weight_decay=1e-3), clip_grad=dict(type='norm', max_norm=0.1))\n"
       "param_scheduler = dict(base_momentum=0.85, max_momentum=0.95, "
       "div_factor=10, final_div_factor=10000, pct_start=0.25)\n")


def _toy_branch_cfg():
    from .test_beit import toy_zoe_config
    return dict(toy_zoe_config()["coarse_branch"])


def test_clis_run_the_zoedepth_family(tmp_path):
    """On toy zoedepth configs, on the CPU: tools.train_branch takes 2
    steps for coarse and for fine, and tools.test evaluates the coarse
    weights file through BaselinePretrain; tools.train takes 2 fusion
    steps over both branches (pretrain_model) and validates; tools.test
    evaluates the fusion checkpoint; tools.infer writes a depth map. Four
    train scenes, one val scene, at 128x192."""
    from .test_beit import toy_zoe_config

    root = str(tmp_path / "u4k")
    train = chip_smoke.write_u4k_split(root, 4, (128, 192), seed=2)
    val_root = str(tmp_path / "u4k_val")
    val = chip_smoke.write_u4k_split(val_root, 1, (128, 192), seed=3)
    loaders = (f"train_dataloader = {_u4k(root, 'train', train)!r}\n"
               f"val_dataloader = {_u4k(val_root, 'infer', val)!r}\n")
    zoe = _toy_branch_cfg()
    test_args = ["--device", "cpu", "--dtype", "float32",
                 "--image-raw-shape", "128", "192", "--patch-split-num", "2",
                 "2", "--process-num", str(PROCESS_NUM)]
    files = {}
    for target in ("coarse", "fine"):
        cfg_file = tmp_path / f"zoe_{target}.py"
        cfg_file.write_text(
            f"model = dict(type='BaselinePretrain', target={target!r}, "
            f"min_depth={MIN_D}, max_depth={MAX_D}, coarse_branch={zoe!r}, "
            f"fine_branch={zoe!r})\n" + loaders + RUN)
        wd = tmp_path / target
        state, losses = train_branch_cli.main(
            [str(cfg_file), "--device", "cpu", "--work-dir", str(wd)])
        assert state.step == 2 and np.isfinite(losses).all()
        files[target] = str(wd / "checkpoint_01.ckpt")
        if target == "coarse":
            got = test_cli.main([str(cfg_file), "--ckp-path", files[target],
                                 "--work-dir", str(tmp_path / "t_coarse"),
                                 *test_args])
            assert got and all(np.isfinite(v) for v in got.values())
    cfg = dict(toy_zoe_config(), load_branch=True,
               pretrain_model=[files["coarse"], files["fine"]])
    cfg_file = tmp_path / "zoe_fusion.py"
    cfg_file.write_text(
        f"model = dict(type='PatchFusion', config={cfg!r})\n" + loaders + RUN)
    wd = tmp_path / "fusion"
    trainer = train_cli.main([str(cfg_file), "--device", "cpu",
                              "--work-dir", str(wd), "--seed", "3"])
    assert trainer.state.step == 2
    assert all(np.isfinite(v) for v in trainer.val_metrics[1].values())
    got = test_cli.main([str(cfg_file), "--ckp-path",
                         str(wd / "checkpoint_01.ckpt"), "--work-dir",
                         str(tmp_path / "t_fusion"), *test_args])
    assert got and all(np.isfinite(v) for v in got.values())
    out = tmp_path / "depth.png"
    depth = infer_cli.main([
        str(chip_smoke.ROOT / "examples" / "example_1.jpeg"), "--config",
        str(cfg_file), "--device", "cpu", "--image-raw-shape", "128", "192",
        "--process-num", str(PROCESS_NUM), "--out", str(out)])
    assert depth.shape == (128, 192) and np.isfinite(depth).all()
    assert os.path.exists(tmp_path / "depth_uint16.png")
