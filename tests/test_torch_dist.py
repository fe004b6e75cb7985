"""The port's scale-out on the CPU, over gloo, against the JAX package:
the metric gather (parallel/gather.py), the tile split of the inference
engine at 2 and 3 ranks (engine/inference.py `mesh=`), its shard report,
the Tester with the ranks sharding the scenes, and the test CLI's --mesh.

The ranks are processes of tests/torch_dist_worker.py (scenario `infer`,
launched with torchrun's environment), one torch thread each, with a
wall-clock limit that kills them all; they start first and run while this
process builds the JAX oracle: the single-device engine and the `mesh=`
engine on the 8-device virtual CPU mesh, on the same weights
(tests/torch_parity.py::tiny_jax) and images. float32 throughout; the
depth within 1e-4 of max, the metrics within 1e-4 relative."""

import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from patchfusion_tpu.data import loader as jloader
from patchfusion_tpu.data import u4k as ju4k
from patchfusion_tpu.engine.inference import PatchFusionInference
from patchfusion_tpu.engine.tester import Tester as JaxTester
from patchfusion_tpu.models.patchfusion import TileConfig as JaxTileConfig
from patchfusion_tpu.parallel.gather import \
    gather_metric_dicts as jax_gather
from patchfusion_tpu.parallel.mesh import make_mesh
from patchfusion_tpu_torch.engine.inference import \
    PatchFusionInference as PortEngine
from patchfusion_tpu_torch.models.patchfusion import TileConfig
from patchfusion_tpu_torch.parallel import dist
from patchfusion_tpu_torch.parallel.gather import gather_metric_dicts
from patchfusion_tpu_torch.tools import test as test_cli

from .torch_dist_worker import launch
from .torch_parity import port_net, rel_err, tiny_jax

torch.set_num_threads(2)

TOL = 1e-4
WORLDS = (2, 3)
U4K_KW = dict(mode="infer", min_depth=1e-3, max_depth=80,
              resize_mode="depth-anything",
              transform_cfg=dict(network_process_size=[42, 56]))
CLI_ARGS = ["--device", "cpu", "--dtype", "float32", "--image-raw-shape",
            "84", "112", "--patch-split-num", "2", "2", "--process-num",
            "2"]


def _write_inputs(d, state_dict, images, root, cfg):
    d.mkdir(parents=True, exist_ok=True)
    torch.save(state_dict, d / "weights.pt")
    np.savez(d / "images.npz", **images)
    ds = dict(U4K_KW, type="UnrealStereo4kDataset", data_root=str(root),
              split=str(root / "val.txt"))
    (d / "tiny_test.py").write_text(
        f"model = dict(type='PatchFusion', config={cfg!r})\n"
        f"val_dataloader = dict(num_workers=1, dataset={ds!r})\n")
    (d / "u4k").symlink_to(root, target_is_directory=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"port": {world: [each rank's outputs]}, "jax": oracle outputs,
    ...}: the ranks of both worlds started, the JAX oracle built, the
    ranks joined."""
    base = tmp_path_factory.mktemp("dist_infer")
    cfg, jnet, tile_cfg, var = tiny_jax(0)
    net, _ = port_net(cfg, var)
    rng = np.random.default_rng(3)
    images = {"lr": rng.random((1, 42, 56, 3), dtype=np.float32),
              "hr": rng.random((84, 112, 3), dtype=np.float32),
              "lr2": rng.random((1, 42, 56, 3), dtype=np.float32),
              "hr2": rng.random((84, 112, 3), dtype=np.float32),
              "origins": np.stack([rng.integers(0, 84 - 42, 8),
                                   rng.integers(0, 112 - 56, 8)],
                                  -1).astype(np.int32)}
    root = base / "u4k"
    root.mkdir()
    chip_smoke.write_u4k_split(root, 3, (84, 112), seed=4)
    ranks = {}
    for w in WORLDS:
        _write_inputs(base / f"w{w}", net.state_dict(), images, root,
                      chip_smoke.tiny_config())
        ranks[w] = launch("infer", w, base / f"w{w}", timeout=400,
                          torchrun_env=True)
    try:
        jax_out = _jax_oracle(jnet, tile_cfg, var, images, root)
    finally:
        for r in ranks.values():
            r.wait()
    port = {w: [torch.load(base / f"w{w}" / f"infer-{r}.pt",
                           weights_only=False) for r in range(w)]
            for w in WORLDS}
    return {"port": port, "jax": jax_out, "base": base}


def _jax_oracle(jnet, tile_cfg, var, images, root):
    lr, hr, ro = images["lr"], images["hr"], images["origins"]
    single = PatchFusionInference(jnet, var, tile_cfg, process_num=2)
    mesh2 = PatchFusionInference(jnet, var, tile_cfg,
                                 mesh=make_mesh(jax.devices()[:2], "patch"))
    out = {"single": {}, "mesh2": {}}
    for eng, key in ((single, "single"), (mesh2, "mesh2")):
        for mode in ("m1", "m2"):
            out[key][mode] = np.asarray(eng.infer(lr, hr, cai_mode=mode))
        out[key]["r8"] = np.asarray(eng.infer(lr, hr, cai_mode="r8",
                                              rand_origins=ro))
    out["mesh2"]["r8_drawn"] = np.asarray(mesh2.infer(lr, hr, cai_mode="r8"))
    out["single"]["m2_image2"] = np.asarray(single.infer(
        images["lr2"], images["hr2"], cai_mode="m2"))
    out["drawn_origins"] = {w: PatchFusionInference(
        jnet, var, tile_cfg, mesh=make_mesh(jax.devices()[:w], "patch"))
        .random_origins((8 // w) * w, np.random.default_rng(0))
        for w in WORLDS}
    kw = dict(U4K_KW, data_root=str(root), split=str(root / "val.txt"))
    out["tester"] = JaxTester(single, jloader.DataLoader(
        ju4k.UnrealStereo4kDataset(**kw), num_workers=1)).run(cai_mode="m1")
    return out


# -- the metric gather -------------------------------------------------------

def test_gather_ragged_ranks_rank_major(runs):
    """Two ranks holding 3 and 2 results (one missing a metric): every
    rank gets the 5, rank-major, the missing metric NaN (JAX:
    tests/test_multihost_gather.py)."""
    for out in runs["port"][2]:
        got = out["gather"]["fixed"]
        assert [g["a1"] for g in got] == [0.0, 10.0, 20.0, 30.0, 40.0]
        assert np.isnan(got[4]["see"]) and got[3]["see"] == 33.0
        assert sorted(got[0]) == ["a1", "abs_rel", "rmse", "see"]


def test_gather_key_union_with_an_empty_rank(runs):
    """keys=None and a rank with no results: the union of the ranks' keys,
    sorted, and rank 0's results; the JAX gather's packing of the same
    list agrees."""
    want = jax_gather([{"a1": 0.0}, {"a1": 10.0}, {"a1": 20.0}])
    for out in runs["port"][2]:
        got = out["gather"]["auto"]
        assert len(got) == 3 and sorted(got[0]) == sorted(
            ["a1", "abs_rel", "rmse", "see"])
        assert [g["a1"] for g in got] == [w["a1"] for w in want]


def test_gather_sample_major_trims_the_pad(runs):
    """size=5 over ShardedSampler's strided split of 5 samples padded to
    6: sample-major order, the wraparound duplicate dropped."""
    for out in runs["port"][2]:
        assert [g["i"] for g in out["gather"]["sized"]] == [0, 1, 2, 3, 4]


def test_gather_single_process_passes_through():
    res = [{"a1": 1.0, "rmse": 2.0}, {"a1": 3.0}]
    assert gather_metric_dicts(res) is res
    assert gather_metric_dicts(res, size=1) == res[:1]


# -- the tile split -----------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["m1", "m2", "r8"])
def test_tile_split_matches_jax(runs, world, mode):
    """Every rank's depth (m2: 9 tiles, padded to 10 or 12; r8 with
    injected origins) within 1e-4 of max of the JAX single-device engine
    and of the JAX mesh engine, and the ranks' depth equal."""
    outs = runs["port"][world]
    for out in outs:
        np.testing.assert_array_equal(out[mode], outs[0][mode])
    assert rel_err(outs[0][mode], runs["jax"]["single"][mode]) <= TOL
    assert rel_err(outs[0][mode], runs["jax"]["mesh2"][mode]) <= TOL


@pytest.mark.parametrize("world", WORLDS)
def test_tile_split_draws_rn_in_groups_of_the_world(runs, world):
    """rN without origins: drawn from the same seed in groups of the
    world's size (one shared column per group), as the JAX mesh engine
    draws at that device count; at 2 ranks the depth within 1e-4 of max
    of the JAX mesh engine's."""
    out = runs["port"][world][0]
    np.testing.assert_array_equal(out["drawn_origins"],
                                  runs["jax"]["drawn_origins"][world])
    assert len(out["drawn_origins"]) == (8 // world) * world
    assert np.isfinite(out["r8_drawn"]).all()
    if world == 2:
        assert rel_err(out["r8_drawn"], runs["jax"]["mesh2"]["r8_drawn"]) \
            <= TOL


@pytest.mark.parametrize("world", WORLDS)
def test_tile_split_infer_batch(runs, world):
    """infer_batch m2 over two images splits each image's tiles: each
    within 1e-4 of max of the JAX engine's m2 on that image."""
    got = runs["port"][world][0]["batch_m2"]
    assert rel_err(got[0], runs["jax"]["single"]["m2"]) <= TOL
    assert rel_err(got[1], runs["jax"]["single"]["m2_image2"]) <= TOL


@pytest.mark.parametrize("ranks", [4, 8])
@pytest.mark.parametrize("mode", ["m1", "m2", "r16"])
def test_shard_report_matches_jax(ranks, mode):
    """The shard report at (2, 2) tiles of 84x112 and at the canonical
    4x4 of 2160x3840, equal to the JAX mesh engine's at that device count
    (nothing is spawned: the report is arithmetic)."""
    for raw, split, proc in (((84, 112), (2, 2), (42, 56)),
                             ((2160, 3840), (4, 4), (392, 518))):
        tc = TileConfig(raw, split, proc)
        port = PortEngine(None, tc, mesh=dist.PatchMesh(ranks))
        jax_eng = PatchFusionInference(
            None, None, JaxTileConfig(raw, split, proc),
            mesh=make_mesh(jax.devices()[:ranks], "patch"))
        assert port.shard_report(mode) == jax_eng.shard_report(mode)


# -- the Tester and the CLI ---------------------------------------------------

def test_tester_two_ranks_matches_jax(runs):
    """The Tester with two ranks sharding 3 scenes (2 and 1 + the pad):
    each rank's metrics, gathered, within 1e-4 relative of the JAX
    single-process Tester's; the ranks agree."""
    want = runs["jax"]["tester"]
    outs = runs["port"][2]
    assert [o["images_tested"] for o in outs] == [2, 2]
    for out in outs:
        assert out["tester"] == outs[0]["tester"]
    got = outs[0]["tester"]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-7), k


def test_test_cli_mesh_patch_two_ranks(runs):
    """tools.test --mesh patch at two ranks (torchrun's environment):
    every rank the single-process CLI's metrics (within 1e-4 relative),
    rank 0 alone writing the 3 images' PNGs."""
    cfg_file = runs["base"] / "w2" / "tiny_test.py"
    want = test_cli.main([str(cfg_file), *CLI_ARGS, "--work-dir",
                          str(runs["base"] / "single_cli")])
    for out in runs["port"][2]:
        assert out["cli"].keys() == want.keys()
        for k in want:
            assert out["cli"][k] == pytest.approx(want[k], rel=1e-4,
                                                  abs=1e-7), k
    assert len(os.listdir(runs["base"] / "w2" / "cli_test")) == 6


def test_mesh_patch_needs_several_ranks(tmp_path):
    """--mesh patch in a world of one rank errors, as the JAX CLI does
    with one device."""
    cfg_file = tmp_path / "tiny.py"
    cfg_file.write_text(
        f"model = dict(type='PatchFusion', "
        f"config={chip_smoke.tiny_config()!r})\n")
    with pytest.raises(SystemExit, match="more than one rank"):
        test_cli.main([str(cfg_file), *CLI_ARGS, "--mesh", "patch"])
    assert dist.resolve_cli_mesh("auto") is None
    assert dist.resolve_cli_mesh("none") is None


@pytest.mark.parametrize("flags", [
    dict(num_processes=2), dict(num_processes=2, coordinator="h:1"),
    dict(coordinator="h:1"), dict(process_id=1),
    dict(num_processes=2, coordinator="h:1", process_id=2)])
def test_init_distributed_rejects_incomplete_flags(flags):
    """The JAX launcher flags come as a set (a coordinator and a rank in
    [0, world) for a world above 1); an incomplete set raises before any
    rendezvous. A world of 1 creates no group."""
    with pytest.raises(ValueError):
        dist.init_distributed(device="cpu", **flags)
    assert dist.init_distributed(num_processes=1, device="cpu") == 1
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("rank_, world, coordinator, cards, env, want", [
    (5, 8, "host0:1234", 4, None, 1),  # the second host's second card
    (3, 4, "localhost:1234", 4, None, 3),
    (1, 2, "host0:1234", 4, "0", 0),  # LOCAL_RANK wins over the rank
    (1, 2, "localhost:1234", 1, None, None),  # two ranks, one card here
    (4, 8, None, 4, "4", None),  # torchrun: a local rank past the cards
])
def test_nccl_rank_takes_its_hosts_card(monkeypatch, rank_, world,
                                        coordinator, cards, env, want):
    """A rank's card is LOCAL_RANK where it is set, else (the JAX flags)
    the rank modulo the host's cards, so a multi-host launch with one
    rank per card finds its card; where two nccl ranks would share one it
    raises, naming the cause."""
    if env is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", env)
    if want is None:
        with pytest.raises(RuntimeError, match="no card of its own"):
            dist.nccl_card(rank_, world, coordinator, cards)
    else:
        assert dist.nccl_card(rank_, world, coordinator, cards) == want
        assert dist.local_index(rank_, cards) == want
