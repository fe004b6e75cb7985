"""The port's training loop around the step (patchfusion_tpu_torch:
engine/training.py under --amp and remat, the branch step,
engine/trainer.py, engine/checkpoint.py, PatchFusion.save / load_dict and
the train, train_branch and test CLIs) on the tiny config, on the CPU.

The bf16 --amp step and the branch step are held against the JAX package's
(one jitted loss-and-gradient function each, built once per file); the
f32 fusion step's reference is in tests/test_torch_train.py, so that the
two compile on different workers. The loop, checkpoint and CLI cases are
the port's own (no JAX step)."""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from patchfusion_tpu.engine import training as jtrain
from patchfusion_tpu.models.builder import build_patchfusion as jax_build
from patchfusion_tpu.models.builder import \
    build_zoedepth_branch as jax_build_branch
from patchfusion_tpu.models.losses import SILogLoss as JaxSILogLoss
from patchfusion_tpu.models.patchfusion import PatchFusionNet as JaxNet
from patchfusion_tpu_torch.api import PatchFusion
from patchfusion_tpu_torch.convert.from_jax import branch_state_dict
from patchfusion_tpu_torch.data.loader import DataLoader
from patchfusion_tpu_torch.engine import checkpoint, training
from patchfusion_tpu_torch.engine.trainer import Trainer
from patchfusion_tpu_torch.models.builder import build_zoedepth_branch
from patchfusion_tpu_torch.models.losses import SILogLoss
from patchfusion_tpu_torch.tools import test as test_cli
from patchfusion_tpu_torch.tools import train as train_cli
from patchfusion_tpu_torch.tools import train_branch as train_branch_cli

from .torch_parity import (by_port_name, port_net, rel_err, tiny_jax,
                           train_batch)

torch.set_num_threads(2)

MIN_D, MAX_D = 1e-3, 80.0


def _flat(grads: dict, names) -> np.ndarray:
    return np.concatenate([np.asarray(grads[n], np.float64).ravel()
                           for n in names])


# -- the bf16 --amp step against the JAX amp step ---------------------------

def test_amp_step_matches_jax_amp():
    """bf16 autocast over f32 masters with the branches stored in bf16,
    against the JAX package's --amp step (the bf16-built net, frozen
    branches bf16, f32 masters), on tests/test_train_amp.py's weights and
    batch: the loss within 5% and the gradients' cosine above 0.9, as that
    test holds the JAX amp step to its f32 one (measured 0.925 port vs JAX
    amp; 0.99998 port amp vs port f32, where the JAX pair gives 0.925: the
    port's autocast keeps BatchNorm, softmax and the head's twins in f32).
    On tiny_jax's redrawn weights the U-Net encoder's bf16 gradients are
    ill-conditioned in both frameworks (JAX amp vs f32: cosine 0.83; port
    amp vs f32: 0.85), so this case takes the JAX amp test's. The storage
    split and the f32 gradients of the masters are checked too."""
    import __graft_entry__ as graft
    from tests.test_train_amp import _seeded

    cfg = graft._tiny_config()
    jnet32, _ = jax_build(cfg)
    ex = (jnp.zeros((1, 42, 56, 3)), jnp.zeros((1, 42, 56, 3)),
          jnp.asarray([[0., 0., 56., 42.]]))
    var = jax.device_get(_seeded(graft._shape_init(jnet32, *ex)))
    rng = np.random.default_rng(0)
    batch = {"image_lr": rng.random((2, 42, 56, 3), np.float32),
             "crops_image_hr": rng.random((2, 42, 56, 3), np.float32),
             "crop_depths": rng.random((2, 42, 56, 1), np.float32) * 40 + 1,
             "bboxs": np.tile(np.array([[0., 0., 56., 42.]], np.float32),
                              (2, 1))}
    jnet, _ = jax_build(cfg, dtype=jnp.bfloat16)
    tx = jtrain.make_onecycle_optimizer(1e-4, 100)
    st = jtrain.create_train_state(var["params"], var["batch_stats"], tx,
                                   frozen_dtype=jnp.bfloat16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def loss_and_grads(trainable):
        def loss_of(tr):
            pred, _ = jnet.apply(
                {"params": jtrain.merge_params(tr, st.frozen),
                 "batch_stats": st.batch_stats}, jb["image_lr"],
                jb["crops_image_hr"], jb["bboxs"], train=True,
                mutable=["batch_stats"], method=JaxNet.train_forward)
            return JaxSILogLoss()(pred, jb["crop_depths"], MIN_D, MAX_D)
        return jax.value_and_grad(loss_of)(trainable)

    want_loss, jgrads = loss_and_grads(st.trainable)
    jgrads = by_port_name(jgrads, var, cfg)

    grads = {}
    for amp in (True, False):
        net, _ = port_net(cfg, var)
        state = training.create_train_state(
            net, training.make_onecycle_optimizer(1e-4, 100),
            frozen_dtype=torch.bfloat16 if amp else None, amp=amp)
        loss, pred = training.fusion_loss(
            state, training.to_device_batch(batch, "cpu", batch.keys()),
            SILogLoss(), MIN_D, MAX_D)
        grads[amp] = {n: p.grad for n, p in state.trainable.items()}
        if amp:
            assert all(p.dtype == torch.bfloat16
                       for p in state.frozen.values())
            assert all(p.dtype == torch.float32
                       for p in state.trainable.values())
            assert pred.dtype == torch.float32
            assert pred.shape == (2, 1, 42, 56)
            assert all(p.grad.dtype == torch.float32 for p in state.params)
            assert abs(float(loss) - float(want_loss)) <= \
                0.05 * abs(float(want_loss))
    names = [n for n in grads[True] if n in jgrads]
    got = _flat(grads[True], names)
    for want in (_flat(jgrads, names), _flat(grads[False], names)):
        cos = float(np.dot(got, want)
                    / max(np.linalg.norm(got) * np.linalg.norm(want), 1e-30))
        assert cos > 0.9, cos


# -- the branch step against the JAX branch step ---------------------------

def test_branch_step_matches_jax():
    """One coarse pretraining step of the tiny branch (f32): the loss
    within 1e-5 relative and every gradient within 1e-4 of its max against
    the JAX branch loss's gradient (no BatchNorm in a branch); then the
    optimizer moves every parameter the loss reaches."""
    cfg, _, _, var = tiny_jax(0)
    bcfg = cfg["coarse_branch"]
    params = var["params"]["coarse_branch"]
    batch = train_batch(seed=2)
    depth_gt = np.random.default_rng(3).random((4, 42, 56, 1),
                                               dtype=np.float32) * 40 + 1
    jbranch = jax_build_branch(bcfg, MIN_D, MAX_D)

    @jax.jit
    def loss_and_grads(p):
        def loss_of(p):
            out = jbranch.apply({"params": p}, jnp.asarray(batch["image_lr"]))
            return JaxSILogLoss()(out["metric_depth"], jnp.asarray(depth_gt),
                                  MIN_D, MAX_D)
        return jax.value_and_grad(loss_of)(p)

    want_loss, jgrads = loss_and_grads(params)
    jgrads = branch_state_dict(jax.device_get(jgrads), cfg)

    branch = build_zoedepth_branch(bcfg, MIN_D, MAX_D, device="cpu")
    branch.load_state_dict({
        k: torch.from_numpy(np.array(v)) for k, v in branch_state_dict(
            jax.device_get(params), cfg).items()})
    state = training.create_branch_state(
        branch, training.make_onecycle_optimizer(1e-4, 10))
    tb = training.to_device_batch({**batch, "depth_gt": depth_gt}, "cpu",
                                  ("image_lr", "depth_gt"))
    loss = training.branch_loss(state, tb, "coarse", SILogLoss(), MIN_D,
                                MAX_D)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for name, p in branch.named_parameters():
        if not np.any(jgrads[name]):  # unread: mask_token, refinenet4's
            assert not p.grad.any()   # first residual unit
            continue
        assert rel_err(p.grad.numpy(), jgrads[name]) <= 1e-4, name
    before = {n: p.detach().clone() for n, p in branch.named_parameters()}
    step = training.make_branch_train_step("coarse", MIN_D, MAX_D)
    logs = step(state, tb)
    assert state.step == 1 and np.isfinite(float(logs["total_loss"]))
    assert all(not torch.equal(p, before[n])
               for n, p in branch.named_parameters() if np.any(jgrads[n]))


# -- remat -----------------------------------------------------------------

def test_remat_matches_no_remat():
    """train_remat (torch.utils.checkpoint around the blocks flax's nn.remat
    wraps) is a pure memory/compute trade: the same state_dict names, and
    after one f32 step the same loss, gradients and BN statistics, each
    BatchNorm updated once (the recompute leaves the statistics alone)."""
    cfg, _, _, var = tiny_jax(0)
    batch = train_batch(seed=4)
    out = []
    for remat in (False, True):
        net, _ = port_net(dict(cfg, train_remat=remat), var)
        assert net.remat is remat
        state = training.create_train_state(
            net, training.make_onecycle_optimizer(1e-4, 10))
        logs = training.make_train_step(min_depth=MIN_D, max_depth=MAX_D)(
            state, training.to_device_batch(batch, "cpu", batch.keys()))
        out.append((float(logs["total_loss"]), float(logs["grad_norm"]),
                    {n: p.detach().clone()
                     for n, p in state.trainable.items()},
                    {n: b.clone() for n, b in state.batch_stats.items()}))
    (l0, g0, p0, s0), (l1, g1, p1, s1) = out
    assert l0 == l1 and g0 == g1
    assert p0.keys() == p1.keys() and s0.keys() == s1.keys()
    for n in p0:
        torch.testing.assert_close(p1[n], p0[n], rtol=0, atol=0)
    for n in s0:
        torch.testing.assert_close(s1[n], s0[n], rtol=0, atol=0)
        if n.endswith("num_batches_tracked"):
            assert int(s1[n]) == 1


# -- the trainer, checkpoints, save / load_dict -----------------------------

class SyntheticU4K:
    """The U4K train item's keys at the tiny sizes."""

    def __init__(self, n=8):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        b = train_batch(seed=10 + i, n=1)
        return {**{k: v[0] for k, v in b.items()},
                "depth_gt": np.full((84, 112, 1), 10.0, np.float32),
                "img_file_basename": f"img{i}"}


def _trainer(seed, work_dir, max_epochs, start_epoch=0, ckpt=None):
    model = PatchFusion.from_config(chip_smoke.tiny_config(), device="cpu",
                                    seed=seed)
    loader = DataLoader(SyntheticU4K(4), batch_size=2, num_workers=1,
                        shuffle=True, drop_last=True, seed=3)
    tx = training.make_onecycle_optimizer(1e-4, 2 * 3)
    state = training.create_train_state(model.net, tx)
    if ckpt is not None:
        start_epoch = checkpoint.restore_train_state(
            state, checkpoint.load_checkpoint(ckpt))
    return model, Trainer(state, training.make_train_step(), loader,
                          max_epochs=max_epochs, val_interval=10,
                          save_checkpoint_interval=1, log_interval=1,
                          work_dir=str(work_dir), start_epoch=start_epoch)


def test_trainer_runs_resumes_and_round_trips(tmp_path):
    """Trainer.run for 2 epochs of 2 steps: a checkpoint per epoch holding
    epoch, step, the trainable weights (no branch), the BN statistics and
    the optimizer state; trainable weights and BN statistics moved, the
    frozen branches bit-identical. A resume from epoch 2's checkpoint runs
    epoch 3 with the losses of an uninterrupted 3-epoch run (the same
    arithmetic on the CPU: equal). save / load_dict
    carry the fusion weights into a third model and leave its branches."""
    model, trainer = _trainer(0, tmp_path / "a", 2)
    frozen0 = {n: p.clone() for n, p in trainer.state.frozen.items()}
    train0 = {n: p.detach().clone()
              for n, p in trainer.state.trainable.items()}
    stats0 = {n: b.clone() for n, b in trainer.state.batch_stats.items()}
    trainer.run()
    assert trainer.state.step == 4
    assert [s["steps"] for s in trainer.epoch_stats] == [2, 2]
    assert all(np.isfinite(s["losses"]).all() for s in trainer.epoch_stats)
    blob = checkpoint.load_checkpoint(str(tmp_path / "a" /
                                          "checkpoint_02.ckpt"))
    assert blob["epoch"] == 2 and blob["step"] == 4
    assert not any(k.startswith(("coarse_branch", "fine_branch"))
                   for k in blob["trainable"])
    assert "guided_fusion.inc.double_conv.0.weight" in blob["trainable"]
    assert blob["opt_state"]["state"]
    assert all(torch.equal(p, frozen0[n])
               for n, p in trainer.state.frozen.items())
    assert not torch.equal(trainer.state.trainable["fusion_conv_list.0."
                                                   "weight"],
                           train0["fusion_conv_list.0.weight"])
    assert not torch.equal(
        trainer.state.batch_stats["guided_fusion.inc.double_conv.1."
                                  "running_var"],
        stats0["guided_fusion.inc.double_conv.1.running_var"])

    _, straight = _trainer(0, tmp_path / "b", 3)
    straight.run()
    # the same seed: a fusion-only checkpoint resumes over the same
    # branches (in a real run, the stage-1/2 files)
    _, resumed = _trainer(0, tmp_path / "c", 3,
                          ckpt=str(tmp_path / "a" / "checkpoint_02.ckpt"))
    assert resumed.start_epoch == 2 and resumed.state.step == 4
    resumed.run()
    assert resumed.state.step == 6
    assert resumed.epoch_stats[0]["losses"] == \
        straight.epoch_stats[2]["losses"]

    path = str(tmp_path / "fusion.ckpt")
    model.save(path)
    other = PatchFusion.from_config(chip_smoke.tiny_config(), device="cpu",
                                    seed=9)
    branch9 = {n: p.clone() for n, p in other.net.named_parameters()
               if n.startswith("coarse_branch")}
    other.engine(2)
    other.load_dict(path)
    assert not other._engines
    sd, sd_other = model.net.state_dict(), other.net.state_dict()
    for name, value in sd.items():
        if name.startswith(("coarse_branch", "fine_branch")):
            continue
        if name.endswith("num_batches_tracked"):
            continue
        assert torch.equal(sd_other[name], value), name
    assert all(torch.equal(p, branch9[n])
               for n, p in other.net.named_parameters()
               if n.startswith("coarse_branch"))
    other.load_dict(str(tmp_path / "a" / "checkpoint_01.ckpt"))


def test_trainer_refuses_several_processes(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="one process"):
        _trainer(0, tmp_path, 1)


# -- the CLIs ---------------------------------------------------------------

def _u4k(root, kind, split, train_batch_size=2):
    # patch_raw_shape: the fusion CLI sets it from the tile config; the
    # branch CLI reads it from the config (the dataset's default is 4K's)
    ds = dict(type="UnrealStereo4kDataset", mode=kind, data_root=root,
              split=split, min_depth=MIN_D, max_depth=MAX_D,
              patch_raw_shape=[42, 56],
              resize_mode="depth-anything",
              transform_cfg=dict(network_process_size=[42, 56], degree=1.0))
    return dict(batch_size=train_batch_size if kind == "train" else 1,
                num_workers=1, dataset=ds)


RUN = ("train_cfg = dict(max_epochs=2, val_interval=2, "
       "save_checkpoint_interval=1, log_interval=1)\n"
       "optim_wrapper = dict(optimizer=dict(type='AdamW', lr=1e-4, "
       "weight_decay=1e-3), clip_grad=dict(type='norm', max_norm=0.1))\n"
       "param_scheduler = dict(base_momentum=0.85, max_momentum=0.95, "
       "div_factor=10, final_div_factor=10000, pct_start=0.25)\n")


@pytest.fixture(scope="module")
def u4k_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("u4k_train")
    return str(root), chip_smoke.write_u4k_split(root, 4, (84, 112), seed=2)


def test_train_cli_trains_resumes_and_tests(u4k_split, tmp_path):
    """python -m patchfusion_tpu_torch.tools.train over a synthetic U4K
    split (84x112) with --amp on the CPU: 2 epochs of 2 steps, m1
    validation after epoch 2 with finite metrics, a checkpoint per epoch;
    --resume from epoch 1 continues to step 4; the test CLI reads the
    port's .ckpt (fusion-only, over seeded branches) and returns finite
    metrics; the JAX launcher flags raise."""
    root, split = u4k_split
    cfg_file = tmp_path / "tiny_train.py"
    cfg_file.write_text(
        f"model = dict(type='PatchFusion', "
        f"config={chip_smoke.tiny_config()!r})\n"
        f"train_dataloader = {_u4k(root, 'train', split)!r}\n"
        f"val_dataloader = {_u4k(root, 'infer', split)!r}\n" + RUN)
    wd = tmp_path / "wd"
    trainer = train_cli.main([str(cfg_file), "--device", "cpu", "--amp",
                              "--work-dir", str(wd), "--seed", "3"])
    assert trainer.state.step == 4 and trainer.state.amp
    metrics = trainer.val_metrics[2]
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    assert {"checkpoint_01.ckpt", "checkpoint_02.ckpt",
            "config.py"} <= set(os.listdir(wd))
    resumed = train_cli.main([str(cfg_file), "--device", "cpu", "--amp",
                              "--work-dir", str(tmp_path / "wd2"),
                              "--resume", "--ckp-path",
                              str(wd / "checkpoint_01.ckpt")])
    assert resumed.start_epoch == 1 and resumed.state.step == 4
    got = test_cli.main([str(cfg_file), "--device", "cpu", "--dtype",
                         "float32", "--ckp-path",
                         str(wd / "checkpoint_02.ckpt"),
                         "--image-raw-shape", "84", "112",
                         "--patch-split-num", "2", "2", "--process-num", "2",
                         "--work-dir", str(tmp_path / "test")])
    assert got and all(np.isfinite(v) for v in got.values())
    for flag in ("--coordinator", "--num-processes", "--process-id"):
        with pytest.raises(NotImplementedError, match="one process"):
            train_cli.main([str(cfg_file), "--device", "cpu", flag, "1"])


def test_train_branch_cli_feeds_the_fusion_stage(u4k_split, tmp_path):
    """python -m patchfusion_tpu_torch.tools.train_branch for the coarse
    and fine targets of a tiny BaselinePretrain config: finite losses, a
    weights file per target that BaselinePretrain and the test CLI read,
    and that the fusion stage's pretrain_model loads strictly into its
    branches."""
    root, split = u4k_split
    zoe = chip_smoke.tiny_config()["coarse_branch"]
    files = {}
    for target in ("coarse", "fine"):
        cfg_file = tmp_path / f"tiny_{target}.py"
        cfg_file.write_text(
            f"model = dict(type='BaselinePretrain', target={target!r}, "
            f"min_depth={MIN_D}, max_depth={MAX_D}, coarse_branch={zoe!r}, "
            f"fine_branch={zoe!r})\n"
            f"train_dataloader = {_u4k(root, 'train', split)!r}\n"
            f"val_dataloader = {_u4k(root, 'infer', split)!r}\n"
            + RUN.replace("max_epochs=2", "max_epochs=1"))
        wd = tmp_path / target
        state, losses = train_branch_cli.main(
            [str(cfg_file), "--device", "cpu", "--work-dir", str(wd)])
        assert state.step == 2 and np.isfinite(losses).all()
        files[target] = str(wd / "checkpoint_01.ckpt")
        got = test_cli.main([str(cfg_file), "--device", "cpu", "--dtype",
                             "float32", "--ckp-path", files[target],
                             "--image-raw-shape", "84", "112",
                             "--patch-split-num", "2", "2",
                             "--process-num", "2",
                             "--work-dir", str(tmp_path / "t" / target)])
        assert got and all(np.isfinite(v) for v in got.values())
    cfg = dict(chip_smoke.tiny_config(), load_branch=True,
               pretrain_model=[files["coarse"], files["fine"]])
    model = PatchFusion.from_config(cfg, device="cpu",
                                    ckpts=(files["coarse"], files["fine"],
                                           None))
    coarse = checkpoint.load_params(files["coarse"])["params"]
    for name, value in coarse.items():
        assert torch.equal(model.net.coarse_branch.state_dict()[name], value)
    assert Path(files["fine"]).exists()
