"""One rank of the port's multi-process CPU tests (tests/test_torch_dist*.py),
over torch.distributed's gloo backend:

    python tests/torch_dist_worker.py SCENARIO RANK WORLD PORT DIR

The parent test (`launch`) starts WORLD of these and waits for all of them
with a wall-clock limit, killing every one on expiry: a rank that skips a
collective deadlocks the others. A rank imports torch, numpy and the port,
never JAX or the JAX package (checked at its end): the parent holds the JAX
oracle and passes weights and inputs through files in DIR, where each rank
writes its outputs as `SCENARIO-RANK.pt`.

Scenarios: `infer` (torchrun's environment: the metric gather, the tile
split, the Tester and the test CLI), `train` (the JAX launcher flags: one
data-parallel fusion step, the train and train_branch CLIs).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_D, MAX_D = 1e-3, 80.0
# a box per sample in the 3840x2160 frame the train step scales by
BOXES = np.array([[0, 0, 960, 540], [960, 540, 1920, 1080],
                  [2880, 0, 3840, 540], [1920, 1620, 2880, 2160]],
                 np.float32)


# -- the parent's side ------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """WORLD worker processes of one scenario; `wait` joins them."""

    def __init__(self, procs, timeout: float):
        self.procs = procs
        self.deadline = time.monotonic() + timeout

    def wait(self) -> None:
        """Every rank's exit, within the limit; on expiry or a failed rank
        every process is killed and the ranks' stderr raised."""
        errs = []
        try:
            for p in self.procs:
                left = max(1.0, self.deadline - time.monotonic())
                _, err = p.communicate(timeout=left)
                errs.append(err)
                if p.returncode != 0:
                    raise AssertionError(
                        f"rank {len(errs) - 1} exited {p.returncode}:\n"
                        + err[-4000:])
        except subprocess.TimeoutExpired:
            raise AssertionError("ranks timed out:\n" + "\n".join(
                e[-2000:] for e in errs)) from None
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


def launch(scenario: str, world: int, out_dir, timeout: float = 300.0,
           torchrun_env: bool = False) -> Ranks:
    """Start `world` ranks of `scenario`, one thread each; with
    torchrun_env, each gets torchrun's variables (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT)."""
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        if torchrun_env:
            env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario, str(r),
             str(world), port, str(out_dir)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return Ranks(procs, timeout)


def fusion_batch(n: int = 4, seed: int = 0):
    """A fusion-stage batch at the tiny sizes (NHWC numpy) whose ranks'
    valid-pixel counts differ: the first two crops lose 20 and 10 rows."""
    rng = np.random.default_rng(seed)
    depth = rng.random((n, 42, 56, 1), dtype=np.float32) * 40 + 1
    depth[0, :20] = 0.0
    depth[1, :10] = 0.0
    return {"image_lr": rng.random((n, 42, 56, 3), dtype=np.float32),
            "crops_image_hr": rng.random((n, 42, 56, 3), dtype=np.float32),
            "crop_depths": depth, "bboxs": BOXES[:n].copy()}


class SyntheticTrain:
    """A train item of the U4K keys at the tiny sizes, drawn from the
    index alone (the U4K train set draws its crops from one generator,
    in load order, which differs between one process and several)."""

    def __init__(self, n: int = 8, **_):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        rng = np.random.default_rng(100 + i)
        return {"image_lr": rng.random((42, 56, 3), dtype=np.float32),
                "crops_image_hr": rng.random((42, 56, 3), dtype=np.float32),
                "crop_depths": rng.random((42, 56, 1), dtype=np.float32)
                * 40 + 1,
                "depth_gt": rng.random((84, 112, 1), dtype=np.float32)
                * 40 + 1,
                "bboxs": BOXES[i % 4].copy(),
                "img_file_basename": f"img{i}"}


def register_synthetic() -> None:
    from patchfusion_tpu_torch.config.registry import DATASETS

    DATASETS.register_module(SyntheticTrain)


# -- a rank's side ----------------------------------------------------------

def _tiny_net(out_dir, remat: bool = False):
    """The port's tiny PatchFusionNet with the parent's weights."""
    import chip_smoke
    from patchfusion_tpu_torch.models.builder import build_patchfusion

    cfg = dict(chip_smoke.tiny_config(), train_remat=remat)
    net, tile_cfg = build_patchfusion(cfg, device="cpu")
    net.load_state_dict(torch.load(os.path.join(out_dir, "weights.pt")),
                        strict=True)
    return net, tile_cfg, cfg


def _gather(r: int):
    from patchfusion_tpu_torch.parallel.gather import gather_metric_dicts

    keys = ["a1", "abs_rel", "rmse", "see"]

    def mk(i):
        d = {k: float(i * 10 + j) for j, k in enumerate(keys)}
        if i == 4:
            del d["see"]
        return d

    local = [mk(i) for i in ([0, 1, 2] if r == 0 else [3, 4])]
    # rank r's i-th item is sample i * 2 + r; 5 samples padded to 6
    strided = [{"i": float(i)} for i in (range(0, 6, 2) if r == 0
                                         else range(1, 6, 2))]
    return {"fixed": gather_metric_dicts(local, keys=keys),
            "auto": gather_metric_dicts(local if r == 0 else []),
            "sized": gather_metric_dicts(strided, size=5)}


def _infer(r: int, world: int, out_dir):
    """The tile split (m1, m2, r8 injected and drawn, infer_batch m2) and,
    at world 2, the metric gather, the Tester and the test CLI."""
    from patchfusion_tpu_torch.api import PatchFusion
    from patchfusion_tpu_torch.parallel import dist

    world_ = dist.init_distributed(device="cpu")
    assert world_ == world == dist.world_size() and dist.rank() == r
    net, tile_cfg, cfg = _tiny_net(out_dir)
    model = PatchFusion(net, tile_cfg, cfg)
    data = np.load(os.path.join(out_dir, "images.npz"))
    mesh = dist.make_patch_mesh()
    out = {}
    for mode in ("m1", "m2"):
        out[mode] = model.infer(data["lr"], data["hr"], cai_mode=mode,
                                process_num=2, mesh=mesh)
    out["r8"] = model.infer(data["lr"], data["hr"], cai_mode="r8",
                            process_num=2, mesh=mesh,
                            rand_origins=data["origins"])
    out["r8_drawn"] = model.infer(data["lr"], data["hr"], cai_mode="r8",
                                  process_num=2, mesh=mesh)
    engine = model.engine(2, mesh=mesh)
    out["drawn_origins"] = engine.random_origins(
        (8 // world) * world, np.random.default_rng(0))
    out["batch_m2"] = engine.infer_batch(
        np.concatenate([data["lr"], data["lr2"]]),
        np.stack([data["hr"], data["hr2"]]), cai_mode="m2").numpy()
    if world == 2:
        out["gather"] = _gather(r)
        out.update(_tester(out_dir, model))
    return out


def _tester(out_dir, model):
    """The Tester over the 3-scene split with the ranks sharding the
    scenes, and the test CLI with --mesh patch."""
    from patchfusion_tpu_torch.data import u4k
    from patchfusion_tpu_torch.data.loader import DataLoader, ShardedSampler
    from patchfusion_tpu_torch.engine.tester import Tester
    from patchfusion_tpu_torch.parallel import dist
    from patchfusion_tpu_torch.tools import test as test_cli

    root = os.path.join(out_dir, "u4k")
    ds = u4k.UnrealStereo4kDataset(
        mode="infer", data_root=root, split=os.path.join(root, "val.txt"),
        min_depth=MIN_D, max_depth=MAX_D, resize_mode="depth-anything",
        transform_cfg=dict(network_process_size=[42, 56]))
    loader = DataLoader(ds, num_workers=1, sampler=ShardedSampler(
        len(ds), dist.world_size(), dist.rank()))
    tester = Tester(model.engine(2), loader)
    metrics = tester.run(cai_mode="m1")
    cli = test_cli.main([
        os.path.join(out_dir, "tiny_test.py"), "--device", "cpu", "--dtype",
        "float32", "--mesh", "patch", "--image-raw-shape", "84", "112",
        "--patch-split-num", "2", "2", "--process-num", "2",
        "--work-dir", os.path.join(out_dir, "cli_test"), "--save"])
    return {"tester": metrics, "images_tested": len(tester.image_seconds),
            "cli": cli}


def _fusion_step(out_dir, r: int, remat: bool = False,
                 per_rank_silog: bool = False):
    """One fusion step on rank r's half of fusion_batch(): the loss, the
    averaged gradients, then the updated weights and BN statistics."""
    from patchfusion_tpu_torch.engine import training
    from patchfusion_tpu_torch.models import losses

    net, _, _ = _tiny_net(out_dir, remat)
    state = training.create_train_state(
        net, training.make_onecycle_optimizer(1e-4, 7))
    batch = {k: v[2 * r:2 * r + 2] for k, v in fusion_batch().items()}
    batch = training.to_device_batch(batch, "cpu", batch.keys())
    loss_fn = losses.SILogLoss()
    if per_rank_silog:
        # each rank's SILog on its own shard, then the gradients averaged:
        # what plain DDP would compute
        sig = loss_fn

        def loss_fn(*args, global_batch):
            return sig(*args)
    loss, _ = training.fusion_loss(state, batch, loss_fn, MIN_D, MAX_D)
    grads = {n: p.grad.clone() for n, p in state.trainable.items()}
    state.tx.update(state.optimizer, state.params, state.step)
    return {"loss": float(loss), "grads": grads,
            "params": {n: p.detach().clone()
                       for n, p in state.trainable.items()},
            "stats": {n: b.clone() for n, b in state.batch_stats.items()}}


def _train(r: int, world: int, port: str, out_dir):
    """One data-parallel fusion step (plain, remat, per-rank SILog), then
    the train and train_branch CLIs on SyntheticTrain."""
    from patchfusion_tpu_torch.parallel import dist
    from patchfusion_tpu_torch.tools import train as train_cli
    from patchfusion_tpu_torch.tools import train_branch as branch_cli

    flags = ["--coordinator", f"localhost:{port}", "--num-processes",
             str(world), "--process-id", str(r)]
    assert dist.init_distributed(f"localhost:{port}", world, r,
                                 device="cpu") == world
    out = {"step": _fusion_step(out_dir, r),
           "remat": _fusion_step(out_dir, r, remat=True),
           "per_rank_silog": _fusion_step(out_dir, r, per_rank_silog=True)}
    register_synthetic()
    # a work dir per rank, so that the parent sees which rank wrote
    trainer = train_cli.main([
        os.path.join(out_dir, "tiny_train.py"), "--device", "cpu",
        "--work-dir", os.path.join(out_dir, f"wd{r}"), "--seed", "3",
        *flags])
    out["trainer"] = {
        "losses": [x for e in trainer.epoch_stats for x in e["losses"]],
        "steps": trainer.state.step, "val": trainer.val_metrics,
        "params": {n: p.detach().clone()
                   for n, p in trainer.state.trainable.items()}}
    _, branch_losses = branch_cli.main([
        os.path.join(out_dir, "tiny_branch.py"), "--device", "cpu",
        "--work-dir", os.path.join(out_dir, f"wd_branch{r}"), "--seed",
        "3", *flags])
    out["branch_losses"] = branch_losses
    return out


def main(argv) -> None:
    scenario, r, world, port, out_dir = argv
    r, world = int(r), int(world)
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from patchfusion_tpu_torch.parallel import dist

    if scenario == "infer":
        out = _infer(r, world, out_dir)
    elif scenario == "train":
        out = _train(r, world, port, out_dir)
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    jax_like = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "patchfusion_tpu")]
    assert not jax_like, jax_like
    torch.save(out, os.path.join(out_dir, f"{scenario}-{r}.pt"))
    dist.barrier()
    dist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
