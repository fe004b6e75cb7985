"""The port's throughput benchmark (patchfusion_tpu_torch/bench.py) against
the JAX package's bench.py: the model config of each core it names, its
environment contract, its JSON line, the refusal to run off the card, and
BENCH_MESH=patch's parity of the tile split over gloo ranks on the CPU.
The card's runs are chip_smoke.py's phase `bench`."""

import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from patchfusion_tpu_torch import bench
from patchfusion_tpu_torch.api import PatchFusion
from patchfusion_tpu_torch.tools import _bench_util as bu

torch.set_num_threads(2)

REPO = str(bench.REPO)
# bench.py:239-245
KEYS = {"metric", "value", "unit", "vs_baseline", "latency_ms",
        "compile_first_s", "cache_new_entries"}
METRIC = re.compile(r"^4K images/sec/chip \(DA-(\w+), (p16|p49|r\d+), "
                    r"(\w+)\)$")

# bench.py:120-157, the literals each core's config is built from
_ZOE = dict(n_bins=64, bin_centers_type="softplus", bin_embedding_dim=128,
            n_attractors=[16, 8, 4, 1], attractor_alpha=1000,
            attractor_gamma=2, attractor_kind="mean", attractor_type="inv",
            min_temp=0.0212, max_temp=50.0)
_DA_SIZES = [(14, 19), (28, 37), (56, 74), (112, 148), (224, 296),
             (392, 518)]
_BEIT_SIZES = [(12, 16), (24, 32), (48, 64), (96, 128), (192, 256),
               (384, 512)]
BENCH_PY = {
    "beit": dict(proc=(384, 512), type="ZoeDepth",
                 midas_model_type="DPT_BEiT_L_384",
                 fusion_in=[32, 256, 256, 256, 256, 256],
                 sizes=_BEIT_SIZES),
    **{core: dict(proc=(392, 518), type="DA-ZoeDepth", midas_model_type=core,
                  fusion_in=[32] + [c] * 5, sizes=_DA_SIZES)
       for core, c in (("vits", 64), ("vitb", 128), ("vitl", 256))},
}


@pytest.mark.parametrize("core", ["vitl", "vitb", "vits", "beit"])
def test_bench_config_is_bench_pys(core):
    want = BENCH_PY[core]
    cfg = bench.bench_config(core)
    assert tuple(cfg["image_raw_shape"]) == (2160, 3840)
    assert tuple(cfg["patch_split_num"]) == (4, 4)
    assert tuple(cfg["patch_process_shape"]) == want["proc"]
    assert (cfg["min_depth"], cfg["max_depth"]) == (1e-3, 80)
    assert not cfg["load_branch"] and cfg["pretrain_model"] is None
    for branch in ("coarse_branch", "fine_branch"):
        b = cfg[branch]
        assert b["type"] == want["type"]
        assert b["midas_model_type"] == want["midas_model_type"]
        assert tuple(b["img_size"]) == want["proc"]
        for key, value in _ZOE.items():
            assert b[key] == value, (branch, key)
    gf = cfg["guided_fusion"]
    assert gf["type"] == "GuidedFusionPatchFusion"
    assert tuple(gf["patch_process_shape"]) == want["proc"]
    assert list(gf["in_channels"]) == want["fusion_in"]
    assert list(gf["num_patches"]) == [h * w for (h, w)
                                       in want["sizes"][::-1]]
    assert (gf["n_channels"], gf["g2l"]) == (5, True)
    assert cfg["sigloss"]["type"] == "SILogLoss"


def test_bench_config_refuses_an_unknown_core():
    with pytest.raises(ValueError, match="vitmicro"):
        bench.bench_config("vitmicro")


def test_the_beit_config_is_chip_smokes():
    import chip_smoke

    assert chip_smoke.bench.published_config("beit") == \
        bench.bench_config("beit")


@pytest.mark.parametrize("env,want", [
    ({}, dict(core="vitl", mode="m2", dtype="bf16", iters=5,
              process_num=16)),
    ({"BENCH_CORE": "vits"}, dict(core="vits", process_num=None)),
    ({"BENCH_CORE": "vits", "BENCH_PROCESS_NUM": "8"},
     dict(process_num=8)),
    ({"BENCH_PROCESS_NUM": "0"}, dict(core="vitl", process_num=None)),
    ({"BENCH_CORE": "beit", "BENCH_MODE": "r16", "BENCH_DTYPE": "f32",
      "BENCH_ITERS": "3"},
     dict(core="beit", mode="r16", dtype="f32", iters=3, process_num=16)),
])
def test_bench_env_is_bench_pys_contract(env, want):
    """bench.py:103-116: BENCH_PROCESS_NUM=0 is one whole pass (None), the
    default is 16 tiles per chunk, or a whole pass for vits."""
    got = bench.bench_env(env)
    for key, value in want.items():
        assert got[key] == value, key


@pytest.fixture(scope="module")
def tiny_model():
    return PatchFusion.from_config(bu.tiny_config(), device="cpu", seed=0)


@pytest.mark.parametrize("mode,paper", [("m1", "p16"), ("m2", "p49"),
                                        ("r4", "r4")])
def test_run_prints_bench_pys_line(tiny_model, mode, paper, capsys):
    hr, lr = bench.bench_images((42, 56), (84, 112))
    line = bench.run(tiny_model, mode, 2, 2, hr, lr)
    assert set(line) == KEYS
    m = METRIC.match(line["metric"])
    assert m and m.groups() == ("vitmicro", paper, "f32"), line["metric"]
    assert line["unit"] == "img/s"
    for key in ("value", "latency_ms", "compile_first_s"):
        assert math.isfinite(line[key]) and line[key] > 0, key
    assert line["vs_baseline"] == round(line["value"] / 0.33, 3)
    assert line["cache_new_entries"] == 0
    json.dumps(line)
    err = capsys.readouterr().err
    for diag in ("compile+first:", "launches per request:",
                 "per-image latency:"):
        assert diag in err


def test_run_labels_the_dtype_it_is_given(tiny_model):
    hr, lr = bench.bench_images((42, 56), (84, 112))
    line = bench.run(tiny_model, "m1", 1, None, hr, lr, dtype_label="fp32")
    assert line["metric"].endswith(", p16, fp32)")


def test_bench_images_are_seeded_numpy():
    hr, lr = bench.bench_images((392, 518))
    np.testing.assert_array_equal(
        hr[:2, :2], np.random.default_rng(0).random(
            (2160, 3840, 3), np.float32)[:2, :2])
    assert hr.shape == (2160, 3840, 3) and lr.shape == (1, 392, 518, 3)
    assert lr.dtype == np.float32
    # align_corners: the corners are the raw image's
    np.testing.assert_allclose(lr[0, 0, 0], hr[0, 0], atol=1e-6)
    np.testing.assert_allclose(lr[0, -1, -1], hr[-1, -1], atol=1e-6)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
def test_main_raises_without_a_card(capsys):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main({"BENCH_CORE": "vits", "BENCH_ITERS": "1"})
    assert capsys.readouterr().out == ""


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
def test_module_exits_nonzero_without_a_card():
    res = subprocess.run([sys.executable, "-m", "patchfusion_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=dict(os.environ, BENCH_CORE="vits"))
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA is not available" in res.stderr


def test_mesh_parity_over_eight_gloo_ranks(capsys):
    line = bench.main_mesh_parity()
    assert line["metric"] == \
        "p49 patch-sharded parity (8 gloo ranks on the CPU)"
    assert line["unit"] == "max_abs_diff"
    assert 0 <= line["value"] < 2e-4 and line["vs_baseline"] == 1.0
    assert json.loads(capsys.readouterr().out.strip()) == line


def test_mesh_parity_from_the_command_line():
    res = subprocess.run([sys.executable, "-m", "patchfusion_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=dict(os.environ, BENCH_MESH="patch"))
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["value"] < 2e-4 and line["vs_baseline"] == 1.0
