"""The port's data-parallel training on the CPU, over gloo: one fusion step
at two ranks against the JAX package's step on the global batch (SILog and
the fusion BatchNorms reduced over the global batch, the gradients averaged
across the ranks), with train_remat, and the train and train_branch CLIs
at two ranks against the same CLIs in one process over the same global
batches. Also the ShardedSampler's split across ranks.

The ranks are processes of tests/torch_dist_worker.py (scenario `train`,
launched with the JAX flags --coordinator / --num-processes /
--process-id), one torch thread each, with a wall-clock limit that kills
them all; they run while this process traces the JAX step and runs the
single-process CLIs. float32 throughout; tolerances per test."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from patchfusion_tpu.engine import training as jtrain
from patchfusion_tpu.models.losses import SILogLoss as JaxSILogLoss
from patchfusion_tpu.models.patchfusion import PatchFusionNet as JaxNet
from patchfusion_tpu_torch.data.loader import ShardedSampler
from patchfusion_tpu_torch.tools import train as train_cli
from patchfusion_tpu_torch.tools import train_branch as branch_cli

from .torch_dist_worker import (MIN_D, MAX_D, fusion_batch, launch,
                                register_synthetic)
from .torch_parity import by_port_name, port_net, rel_err, tiny_jax

torch.set_num_threads(2)

# the U-Net encoder's f32 gradients are good to ~1e-4 of their max in
# either framework (tests/test_torch_train.py ENCODER): 1e-3 there
ENCODER = ("guided_fusion.inc.", "guided_fusion.down_conv_list.")
RUN = ("optim_wrapper = dict(optimizer=dict(type='AdamW', lr=1e-4, "
       "weight_decay=1e-3), clip_grad=dict(type='norm', max_norm=0.1))\n"
       "param_scheduler = dict(base_momentum=0.85, max_momentum=0.95, "
       "div_factor=10, final_div_factor=10000, pct_start=0.25)\n")


def _write_configs(d, root):
    """The train CLI's config (SyntheticTrain, 8 samples, batch 2 per rank;
    m1 validation over a 3-scene U4K split after epoch 2) and the branch
    CLI's (coarse target, 1 epoch)."""
    val = dict(batch_size=1, num_workers=1, dataset=dict(
        type="UnrealStereo4kDataset", mode="infer", data_root=str(root),
        split=str(root / "val.txt"), min_depth=MIN_D, max_depth=MAX_D,
        resize_mode="depth-anything",
        transform_cfg=dict(network_process_size=[42, 56])))
    train = dict(batch_size=2, num_workers=1, dataset=dict(
        type="SyntheticTrain", n=8,
        transform_cfg=dict(network_process_size=[42, 56])))
    (d / "tiny_train.py").write_text(
        f"model = dict(type='PatchFusion', "
        f"config={chip_smoke.tiny_config()!r})\n"
        f"train_dataloader = {train!r}\nval_dataloader = {val!r}\n"
        "train_cfg = dict(max_epochs=2, val_interval=2, "
        "save_checkpoint_interval=1, log_interval=1)\n" + RUN)
    zoe = chip_smoke.tiny_config()["coarse_branch"]
    (d / "tiny_branch.py").write_text(
        f"model = dict(type='BaselinePretrain', target='coarse', "
        f"min_depth={MIN_D}, max_depth={MAX_D}, coarse_branch={zoe!r}, "
        f"fine_branch={zoe!r})\ntrain_dataloader = {train!r}\n"
        "train_cfg = dict(max_epochs=1, save_checkpoint_interval=1, "
        "log_interval=1)\n" + RUN)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' outputs, the JAX step's and the single-process
    CLIs'."""
    d = tmp_path_factory.mktemp("dist_train")
    cfg, jnet, _, var = tiny_jax(0)
    net, _ = port_net(cfg, var)
    torch.save(net.state_dict(), d / "weights.pt")
    root = d / "u4k"
    root.mkdir()
    chip_smoke.write_u4k_split(root, 3, (84, 112), seed=4)
    _write_configs(d, root)
    ranks = launch("train", 2, d, timeout=500)
    try:
        jax_step = _jax_step(cfg, jnet, var)
        single = _single_process_clis(d)
    finally:
        ranks.wait()
    port = [torch.load(d / f"train-{r}.pt", weights_only=False)
            for r in range(2)]
    return {"port": port, "jax": jax_step, "single": single, "dir": d,
            "cfg": cfg, "var": var}


def _jax_step(cfg, jnet, var):
    """The JAX f32 step on the global batch of 4: loss, gradients, BN
    statistics and parameters after one update of a 7-step schedule,
    traced with flax's two-pass batch variance, as torch takes it
    (tests/test_torch_train.py `ref`)."""
    import flax.linen.normalization as flax_norm

    compute_stats = flax_norm._compute_stats

    def two_pass(*a, **k):
        return compute_stats(*a, **{**k, "use_fast_variance": False})

    batch = {k: jnp.asarray(v) for k, v in fusion_batch().items()}
    trainable, frozen = jtrain.split_params(var["params"])
    sig = JaxSILogLoss()

    def loss_of(tr):
        pred, mutated = jnet.apply(
            {"params": jtrain.merge_params(tr, frozen),
             "batch_stats": var["batch_stats"]}, batch["image_lr"],
            batch["crops_image_hr"], batch["bboxs"], train=True,
            mutable=["batch_stats"], method=JaxNet.train_forward)
        return sig(pred, batch["crop_depths"], MIN_D, MAX_D), \
            mutated["batch_stats"]

    flax_norm._compute_stats = two_pass
    try:
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_of, has_aux=True))(trainable)
    finally:
        flax_norm._compute_stats = compute_stats
    tx = jtrain.make_onecycle_optimizer(1e-4, 7)
    updates, _ = tx.update(grads, tx.init(trainable), trainable)
    return {"loss": float(loss), "grads": grads, "stats": stats,
            "params": optax.apply_updates(trainable, updates)}


def _single_process_clis(d):
    """The train CLI at batch 4 and the branch CLI at batch 4 in this
    process: the two ranks' global batches."""
    register_synthetic()
    trainer = train_cli.main([
        str(d / "tiny_train.py"), "--device", "cpu", "--seed", "3",
        "--work-dir", str(d / "wd_single"), "--cfg-options",
        "train_dataloader.batch_size=4"])
    _, branch = branch_cli.main([
        str(d / "tiny_branch.py"), "--device", "cpu", "--seed", "3",
        "--work-dir", str(d / "wd_branch_single"), "--cfg-options",
        "train_dataloader.batch_size=4"])
    return {"losses": [x for e in trainer.epoch_stats for x in e["losses"]],
            "val": trainer.val_metrics, "steps": trainer.state.step,
            "branch_losses": branch}


def _check_step(runs, key):
    """One rank step's loss (1e-5 relative), averaged gradients and weights
    after the update (1e-4 of each tensor's max, the encoder's 1e-3: Adam
    moves a weight by ~lr times the sign of its gradient, which the
    encoder's f32 noise can flip) and BN statistics (1e-5 of max) against
    the JAX global-batch step; both ranks hold the same state."""
    want, cfg, var = runs["jax"], runs["cfg"], runs["var"]
    a, b = (out[key] for out in runs["port"])
    assert a["loss"] == b["loss"]
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
    assert abs(a["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    jgrads = by_port_name(want["grads"], var, cfg)
    jparams = by_port_name(want["params"], var, cfg, want["stats"])
    for name, g in a["grads"].items():
        if not np.any(jgrads[name]):
            assert not g.any(), name
            continue
        tol = 1e-3 if name.startswith(ENCODER) else 1e-4
        assert rel_err(g.numpy(), jgrads[name]) <= tol, name
        assert rel_err(a["params"][name].numpy(), jparams[name]) <= tol, \
            name
    stats = {k: v for k, v in a["stats"].items()
             if not k.endswith("num_batches_tracked")}
    assert stats
    for name, buf in stats.items():
        assert rel_err(buf.numpy(), jparams[name]) <= 1e-5, name


def test_ddp_fusion_step_matches_jax_global_batch(runs):
    """Two ranks of two crops each, whose valid-pixel counts differ (3024
    against 4704), against the JAX step on the four: within
    the tolerances of _check_step. Averaging each rank's own SILog (plain
    DDP) misses them: its loss and gradients are another function's."""
    _check_step(runs, "step")
    want, cfg, var = runs["jax"], runs["cfg"], runs["var"]
    naive = runs["port"][0]["per_rank_silog"]
    assert abs(naive["loss"] - want["loss"]) > 1e-5 * abs(want["loss"])
    jgrads = by_port_name(want["grads"], var, cfg)
    worst = max(rel_err(g.numpy(), jgrads[n])
                for n, g in naive["grads"].items()
                if np.any(jgrads[n]) and not n.startswith(ENCODER))
    assert worst > 1e-4


def test_ddp_fusion_step_with_remat(runs):
    """train_remat=True: the BatchNorms' collectives run again in the
    recompute, on both ranks, and the step is the same."""
    _check_step(runs, "remat")


def test_train_cli_two_ranks_matches_one_process(runs):
    """tools.train --num-processes 2 with batch 2 per rank: the same 4
    optimizer steps as one process at batch 4 over the same global
    batches, each step's loss within 1e-5 relative, on both ranks; the
    ranks end with the same weights."""
    a, b = (out["trainer"] for out in runs["port"])
    want = runs["single"]["losses"]
    assert a["steps"] == b["steps"] == runs["single"]["steps"] == 4
    assert a["losses"] == b["losses"]
    np.testing.assert_allclose(a["losses"], want, rtol=1e-5)
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name


def test_train_cli_two_ranks_rank0_writes(runs):
    """Only rank 0 writes the work dir: config, log and a checkpoint per
    epoch; rank 1's work dir is never made."""
    d = runs["dir"]
    assert {"checkpoint_01.ckpt", "checkpoint_02.ckpt", "config.py",
            "train.log"} <= set(os.listdir(d / "wd0"))
    assert not (d / "wd1").exists()
    assert (d / "wd_branch0" / "checkpoint_01.ckpt").exists()
    assert not (d / "wd_branch1").exists()


def test_train_cli_two_ranks_gathers_val_metrics(runs):
    """Epoch 2's validation over 3 scenes sharded 2 + 1 (+ the pad): the
    gathered metrics are the same on both ranks and within 1e-4 relative
    of the single-process run's."""
    a, b = (out["trainer"]["val"] for out in runs["port"])
    want = runs["single"]["val"]
    assert a == b and a.keys() == want.keys() == {2}
    for k, v in want[2].items():
        assert a[2][k] == pytest.approx(v, rel=1e-4, abs=1e-7), k


def test_train_branch_cli_two_ranks_matches_one_process(runs):
    """tools.train_branch --num-processes 2 (coarse, batch 2 per rank):
    each step's loss within 1e-5 relative of one process at batch 4."""
    a, b = (out["branch_losses"] for out in runs["port"])
    assert a == b and len(a) == 2
    np.testing.assert_allclose(a, runs["single"]["branch_losses"],
                               rtol=1e-5)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_sampler_splits_across_ranks(world):
    """Every rank's shuffle is the same seeded permutation, its shard its
    own stride of it, and the shards cover the data (10 samples, padded by
    wraparound); each epoch reshuffles."""
    shards = []
    for r in range(world):
        s = ShardedSampler(10, world, r, shuffle=True, seed=7)
        s.set_epoch(1)
        shards.append(s.indices())
    assert len({len(x) for x in shards}) == 1
    assert set().union(*map(set, shards)) == set(range(10))
    whole = ShardedSampler(10, 1, 0, shuffle=True, seed=7)
    whole.set_epoch(1)
    per = len(shards[0])
    padded = (whole.indices() * 2)[:per * world]
    assert [x for i in range(per) for x in
            (shards[r][i] for r in range(world))] == padded
    whole.set_epoch(2)
    assert whole.indices() != padded[:10]
