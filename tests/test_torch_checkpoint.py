"""The port's checkpoint import (engine/checkpoint.py, api.from_config with
ckpts, api.from_pretrained, api.BaselinePretrain) against the JAX package
loading the same files: the tiny config's JAX variables, written through
convert/from_jax.py as the reference's coarse, fine and fusion-only `.pth`
files and as a snapshot directory. Depth in float32 at 1e-3 of max
(measured ~1e-6)."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from patchfusion_tpu.api import BaselinePretrain as JaxBaselinePretrain
from patchfusion_tpu.api import PatchFusion as JaxPatchFusion
from patchfusion_tpu_torch.api import BaselinePretrain, PatchFusion
from patchfusion_tpu_torch.convert.from_jax import (state_dict_from_flax,
                                                    to_torch)
from patchfusion_tpu_torch.engine import checkpoint

from .torch_parity import rel_err, tiny_jax

torch.set_num_threads(2)

TOL = 1e-3
PROCESS_NUM = 2
BRANCHES = ("coarse_branch", "fine_branch")


def _branch_sd(sd, branch):
    p = branch + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(config, the files' paths): coarse.pth ({'model_state_dict': ...}, as
    the reference trainer saves), fine.pth (a bare state dict), fusion.pth
    (fusion-only, get_save_dict's layout), and snapshot/ (config.json +
    pytorch_model.bin)."""
    cfg, _, _, var = tiny_jax(0)
    sd = to_torch(state_dict_from_flax(var["params"], var["batch_stats"],
                                       cfg))
    root = tmp_path_factory.mktemp("ckpt")
    paths = {name: str(root / f"{name}.pth")
             for name in ("coarse", "fine", "fusion")}
    torch.save({"model_state_dict": _branch_sd(sd, "coarse_branch")},
               paths["coarse"])
    torch.save(_branch_sd(sd, "fine_branch"), paths["fine"])
    torch.save({k: v for k, v in sd.items()
                if k.split(".")[0] not in BRANCHES}, paths["fusion"])
    snap = root / "snapshot"
    snap.mkdir()
    torch.save(sd, snap / "pytorch_model.bin")
    (snap / "config.json").write_text(json.dumps({"config": cfg}))
    paths["snapshot"] = str(snap)
    return cfg, paths


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    return (rng.random((1, 42, 56, 3), dtype=np.float32),
            rng.random((84, 112, 3), dtype=np.float32))


def _triple(paths):
    return paths["coarse"], paths["fine"], paths["fusion"]


@pytest.fixture(scope="module")
def loaded(files):
    """JAX and port models from the triple and from the snapshot."""
    cfg, paths = files
    return {
        "triple": (JaxPatchFusion.from_config(cfg, ckpts=_triple(paths)),
                   PatchFusion.from_config(cfg, device="cpu",
                                           ckpts=_triple(paths))),
        "snapshot": (JaxPatchFusion.from_pretrained(paths["snapshot"]),
                     PatchFusion.from_pretrained(paths["snapshot"],
                                                 device="cpu")),
    }


@pytest.mark.parametrize("mode", ["m1", "m2"])
@pytest.mark.parametrize("source", ["triple", "snapshot"])
def test_loaded_model_matches_jax(loaded, images, source, mode):
    jax_model, port = loaded[source]
    lr, hr = images
    want = jax_model.infer(lr, hr, cai_mode=mode, process_num=PROCESS_NUM)
    got = port.infer(lr, hr, cai_mode=mode, process_num=PROCESS_NUM)
    assert got.shape == want.shape
    assert rel_err(got, want) <= TOL


def test_triple_and_snapshot_load_the_same_weights(loaded):
    a = loaded["triple"][1].net.state_dict()
    b = loaded["snapshot"][1].net.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_without_a_fusion_file_the_fusion_part_keeps_its_seeded_init(files):
    cfg, paths = files
    seeded = PatchFusion.from_config(cfg, device="cpu", seed=4).net
    net = PatchFusion.from_config(
        cfg, device="cpu", seed=4,
        ckpts=(paths["coarse"], paths["fine"], None)).net
    coarse = torch.load(paths["coarse"])["model_state_dict"]
    for k, v in net.state_dict().items():
        if k.startswith("coarse_branch."):
            torch.testing.assert_close(v, coarse[k[len("coarse_branch."):]])
        elif not k.startswith("fine_branch."):
            torch.testing.assert_close(v, seeded.state_dict()[k])


def test_from_pretrained_reads_local_directories_only(files, tmp_path):
    """A path that is not a directory raises, and huggingface_hub is never
    imported: nothing is downloaded."""
    code = (
        "import sys\n"
        "from patchfusion_tpu_torch.api import PatchFusion\n"
        "for path in ('Zhyever/patchfusion_depth_anything_vitl14', "
        f"{str(tmp_path / 'missing')!r}):\n"
        "    try:\n"
        "        PatchFusion.from_pretrained(path, device='cpu')\n"
        "    except FileNotFoundError:\n"
        "        pass\n"
        "    else:\n"
        "        sys.exit('no error for ' + path)\n"
        "sys.exit(1 if 'huggingface_hub' in sys.modules else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(chip_smoke.ROOT))
    assert res.returncode == 0, res.stdout + res.stderr


def test_branch_loads_are_strict(files, tmp_path):
    """A branch file that lacks a key raises, for the triple and for
    BaselinePretrain; so does a snapshot that lacks one."""
    cfg, paths = files
    sd = torch.load(paths["fine"])
    sd.pop(next(iter(sd)))
    torch.save(sd, tmp_path / "fine_missing.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        PatchFusion.from_config(cfg, device="cpu", ckpts=(
            paths["coarse"], str(tmp_path / "fine_missing.pth"), None))
    with pytest.raises(RuntimeError, match="Missing key"):
        BaselinePretrain.from_torch(cfg["fine_branch"], 1e-3, 80,
                                    str(tmp_path / "fine_missing.pth"),
                                    device="cpu")
    full = torch.load(paths["snapshot"] + "/pytorch_model.bin")
    full.pop("fusion_conv_list.0.bias")
    snap = tmp_path / "snap"
    snap.mkdir()
    torch.save(full, snap / "pytorch_model.bin")
    (snap / "config.json").write_text(json.dumps({"config": cfg}))
    with pytest.raises(RuntimeError, match="Missing key"):
        PatchFusion.from_pretrained(str(snap), device="cpu")


def test_fusion_file_with_an_unexpected_key_raises(files, tmp_path):
    cfg, paths = files
    sd = torch.load(paths["fusion"])
    sd["guided_fusion.not_a_weight"] = torch.zeros(3)
    torch.save(sd, tmp_path / "fusion_extra.pth")
    with pytest.raises(ValueError, match="unexpected keys"):
        PatchFusion.from_config(cfg, device="cpu", ckpts=(
            paths["coarse"], paths["fine"],
            str(tmp_path / "fusion_extra.pth")))


def test_state_dict_reader_takes_both_pth_layouts(files):
    _, paths = files
    wrapped = checkpoint.load_torch_state_dict(paths["coarse"])
    bare = checkpoint.load_torch_state_dict(paths["fine"])
    assert wrapped.keys() == bare.keys()
    assert all(isinstance(v, torch.Tensor) for v in wrapped.values())


def test_safetensors_snapshot_matches_the_bin_one(files, tmp_path):
    pytest.importorskip("safetensors")
    from safetensors.torch import save_file
    cfg, paths = files
    sd = torch.load(paths["snapshot"] + "/pytorch_model.bin")
    save_file({k: v.contiguous() for k, v in sd.items()},
              str(tmp_path / "model.safetensors"))
    got = checkpoint.read_hub_state_dict(str(tmp_path))
    assert got.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)


def test_safetensors_snapshot_without_the_package_names_it(tmp_path,
                                                           monkeypatch):
    (tmp_path / "model.safetensors").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="`safetensors` package"):
        checkpoint.read_hub_state_dict(str(tmp_path))


# -- BaselinePretrain ---------------------------------------------------------

def _baseline_kw(target):
    return dict(target=target, image_raw_shape=(84, 112),
                patch_split_num=(2, 2), patch_process_shape=(42, 56))


@pytest.mark.parametrize("target,mode", [("coarse", "m1"), ("fine", "m1"),
                                         ("fine", "r2")])
def test_baseline_pretrain_matches_jax(files, images, target, mode):
    """The coarse target (one branch pass) and the fine target (the
    fusion-less engine; r2 runs 2 groups of process_num tiles, the same
    draws on both sides from the same rng) from the same branch file."""
    cfg, paths = files
    branch_cfg = cfg[f"{target}_branch"]
    jax_model = JaxBaselinePretrain.from_torch(
        branch_cfg, 1e-3, 80, paths[target], **_baseline_kw(target))
    port = BaselinePretrain.from_torch(branch_cfg, 1e-3, 80, paths[target],
                                       device="cpu", **_baseline_kw(target))
    lr, hr = images
    kw = dict(cai_mode=mode, process_num=PROCESS_NUM)
    want = jax_model.infer(image_lr=lr, image_hr=hr,
                           rng=np.random.default_rng(5), **kw)
    got = port.infer(image_lr=lr, image_hr=hr,
                     rng=np.random.default_rng(5), **kw)
    assert got.shape == want.shape
    assert got.shape == ((42, 56) if target == "coarse" else (84, 112))
    assert rel_err(got, want) <= TOL


def test_fine_only_adapter_refuses_other_methods(files):
    cfg, _ = files
    bp = BaselinePretrain(cfg["fine_branch"], 1e-3, 80, device="cpu",
                          **_baseline_kw("fine"))
    net = bp.engine(PROCESS_NUM).net
    with pytest.raises(NotImplementedError, match="only fine_forward"):
        net.coarse_forward
    with pytest.raises(ValueError, match="target"):
        BaselinePretrain(cfg["fine_branch"], 1e-3, 80, target="fusion",
                         device="cpu")
