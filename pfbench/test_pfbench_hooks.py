"""A configuration's own reference module (`spec.reference`): the cells of
the DA configurations draw the same weights and count the same FLOPs as
before the module was looked up per configuration; a configuration whose
module lies outside pfbench/ runs a whole cell on the CPU; a module that
brings BEiT's leaf rules and grid index lets the port's BEiT PatchFusion
draw, and without it its index is refused."""

import hashlib
import json
import math
from collections import defaultdict

import numpy as np
import pytest
import torch

from pfbench import harness, spec, weights
from pfbench.reference.ops import relative_position_index
from pfbench.tiny import tiny_cell

SEED = 2 ** 31 + 31
HERE = spec.HERE

# mfu_pct.flops_per_request of each cell, as the harness counted it before
# a configuration named its reference module
FLOPS = {"davitl-p49": 198803514709504, "davits-p16": 5900157811200,
         "davitl-p16": 65820253307392, "davits-p49": 17781441873408}


# --- weights.py's draw before the hooks, kept as the yardstick -------------

def parent_rule(key, shape):
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) >= 2:
        return (math.prod(shape[1:])) ** -0.5, 0.0, False
    if leaf in ("weight", "gamma"):
        return 0.05, 1.0, False
    if leaf == "running_var":
        return 0.1, 0.0, True
    if leaf in ("bias", "running_mean", "pos_embed", "absolute_pos_embed",
                "relative_position_bias_table", "cls_token", "mask_token"):
        return 0.02, 0.0, False
    raise ValueError(f"no rule for the weight {key!r}")


def parent_computed(key, shapes):
    leaf = key.rsplit(".", 1)[-1]
    shape = shapes[key]
    if leaf == "relative_position_index":
        return torch.from_numpy(relative_position_index(math.isqrt(shape[0])))
    if leaf == "k_idx":
        return torch.arange(shape[1], dtype=torch.float32).reshape(shape)
    if leaf == "K_minus_1":
        bins = shapes[key[:-len(leaf)] + "k_idx"][1]
        return torch.full(shape, float(bins - 1))
    return torch.zeros(shape, dtype=torch.int64)


PARENT_COMPUTED = ("relative_position_index", "k_idx", "K_minus_1",
                   "num_batches_tracked")


def parent_make(weights_spec, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    out = {}
    by_dtype = defaultdict(list)
    for key, shape, dtype in weights_spec:
        if key.rsplit(".", 1)[-1] not in PARENT_COMPUTED:
            by_dtype[dtype].append((key, shape))
    for dtype in sorted(by_dtype, key=str):
        leaves = sorted(by_dtype[dtype])
        sizes = [-(-math.prod(s) // 256) * 256 for _, s in leaves]
        flat = torch.randn(sum(sizes), generator=gen, device=device,
                           dtype=dtype)
        start = 0
        for (key, shape), size in zip(leaves, sizes):
            part = flat[start:start + math.prod(shape)]
            start += size
            std, mean, exp = parent_rule(key, shape)
            part.mul_(std)
            if exp:
                part.exp_()
            else:
                part.add_(mean)
            out[key] = part.view(shape)
    shapes = {key: shape for key, shape, _ in weights_spec}
    for key, _, dtype in weights_spec:
        if key.rsplit(".", 1)[-1] in PARENT_COMPUTED:
            out[key] = parent_computed(key, shapes).to(device=device,
                                                       dtype=dtype)
    return out


def program_spec(model_config, dtype=torch.bfloat16):
    from patchfusion_tpu_torch.models.builder import build_patchfusion

    net, _ = build_patchfusion(model_config, dtype=dtype, device="meta")
    return weights.spec(net)


# --- the DA configurations are as they were --------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seed", [SEED, 7])
def test_tiny_da_weights_bit_equal_to_the_parents_draw(seed, dtype):
    cell = tiny_cell()
    wspec = program_spec(cell.model, dtype)
    got = harness.seeded_weights(cell, wspec, seed, "cpu")
    want = parent_make(wspec, seed, "cpu")
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("config", ["da-vitl", "da-vits"])
def test_every_key_of_the_da_specs_takes_the_parents_rule(config):
    bench = json.loads(spec.BENCHMARK.read_text())
    cell = spec.load_cell(next(w["name"] for w in bench["workloads"]
                               if w["config"] == config))
    assert "reference" not in cell.config
    assert cell.reference.__file__ == str(HERE / "reference" / "model.py")
    wspec = program_spec(cell.model)
    rules, fixed = weights.plan(wspec, cell.reference, cell.model)
    shapes = {key: shape for key, shape, _ in wspec}
    assert len(rules) + len(fixed) == len(wspec)
    for key, shape, dtype in wspec:
        if key.rsplit(".", 1)[-1] in PARENT_COMPUTED:
            want = parent_computed(key, shapes).to(dtype)
            assert torch.equal(fixed[key].to(dtype), want), key
        else:
            assert rules[key] == parent_rule(key, shape), key


@pytest.mark.parametrize("cell", sorted(FLOPS))
def test_flop_count_of_each_cell_is_the_parents(cell):
    c = spec.load_cell(cell)
    got = spec.reader("mfu_pct").flops_per_request(c.config,
                                                   c.traffic["mode"])
    assert got == FLOPS[cell]


# --- a configuration that brings its module as a file ----------------------

OUTSIDE_REFERENCE = '''
import torch

from pfbench.reference.model import PatchFusionNet  # noqa: F401

LEAF_RULES = {"cls_token": (0.5, 0.0, False)}
ASKED = []


def computed(key, shapes, config):
    ASKED.append(key)
    if key.endswith(".mask_token"):
        return torch.zeros(shapes[key])
    return None
'''


def _digest(root):
    h = hashlib.sha256()
    for path in sorted(root.rglob("*")):
        if path.is_file() and "__pycache__" not in path.parts:
            h.update(str(path.relative_to(root)).encode())
            h.update(path.read_bytes())
    return h.hexdigest()


def test_configuration_with_its_reference_outside_pfbench_runs(tmp_path):
    before = _digest(HERE)
    path = tmp_path / "outside_reference.py"
    path.write_text(OUTSIDE_REFERENCE)
    cell = tiny_cell("davits-p16")
    cell.config["reference"] = str(path)
    module = cell.reference
    assert module.__file__ == str(path) and module is spec.reference(
        cell.config)

    result = harness.run_cell(cell, SEED, 1.0, False, "cpu", 0.0)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0

    wspec = program_spec(cell.model)
    assert set(module.ASKED) >= {k for k, _, _ in wspec}
    drawn = harness.seeded_weights(cell, wspec, SEED, "cpu")
    masks = [k for k in drawn if k.endswith(".mask_token")]
    tokens = [k for k in drawn if k.endswith(".cls_token")]
    assert masks and all(not drawn[k].any() for k in masks)
    assert tokens and all(drawn[k].float().std() > 0.2 for k in tokens)
    flops = spec.reader("mfu_pct").flops_per_request(cell.config, "m1")
    assert flops == spec.reader("mfu_pct").flops_per_request(
        tiny_cell("davits-p16").config, "m1") > 0
    assert _digest(HERE) == before


def test_unknown_reference_module_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        spec.reference({"reference": str(tmp_path / "none.py")})


# --- BEiT: its leaves and its grid index from a module of its own ----------

BEIT_REFERENCE = '''
import numpy as np
import torch

LEAF_RULES = {"q_bias": (0.02, 0.0, False), "v_bias": (0.02, 0.0, False),
              "gamma_1": (0.05, 1.0, False), "gamma_2": (0.05, 1.0, False)}
PATCH = 16


def grid_index(gh, gw):
    """BEiT's (1 + gh gw)^2 index into its ((2gh-1)(2gw-1) + 3)-row
    table: 2-D offsets between patches, three rows for the class token."""
    rows = (2 * gh - 1) * (2 * gw - 1)
    yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    y, x = yy.reshape(-1), xx.reshape(-1)
    rel = ((y[:, None] - y[None, :] + gh - 1) * (2 * gw - 1)
           + x[:, None] - x[None, :] + gw - 1)
    idx = np.zeros((gh * gw + 1, gh * gw + 1), np.int64)
    idx[1:, 1:] = rel
    idx[0, :] = rows
    idx[:, 0] = rows + 1
    idx[0, 0] = rows + 2
    return idx


def computed(key, shapes, config):
    if ".pretrained.model.blocks." not in key or not key.endswith(
            ".relative_position_index"):
        return None
    h, w = config[key.split(".")[0]]["img_size"]
    return torch.from_numpy(grid_index(h // PATCH, w // PATCH))
'''


def beit_config(tiny):
    if tiny:
        import chip_smoke
        return chip_smoke.tiny_zoe_config()
    from patchfusion_tpu_torch.config import Config
    from patchfusion_tpu_torch.tools._bench_util import ZOE_CONFIG

    return Config.fromfile(str(ZOE_CONFIG)).model.config.to_dict()


@pytest.fixture
def beit_module(tmp_path):
    path = tmp_path / "beit_reference.py"
    path.write_text(BEIT_REFERENCE)
    return spec.reference({"reference": str(path)})


def test_beit_module_lets_the_tiny_beit_patchfusion_draw(beit_module):
    from patchfusion_tpu_torch.models import beit

    cfg = beit_config(tiny=True)
    wspec = program_spec(cfg)
    with pytest.raises(ValueError, match="q_bias|v_bias|gamma_"):
        weights.make(wspec, SEED, "cpu")
    drawn = weights.make(wspec, SEED, "cpu", beit_module, cfg)
    assert drawn.keys() == {k for k, _, _ in wspec}
    assert all(tuple(drawn[k].shape) == s and drawn[k].dtype == d
               for k, s, d in wspec)
    grid = [k for k in drawn if ".pretrained.model.blocks." in k
            and k.endswith(".relative_position_index")]
    assert len(grid) == 8
    # the program's own index of the 4 x 6 grid of a 64 x 96 tile
    want = torch.from_numpy(beit.relative_position_index(4, 6))
    assert all(torch.equal(drawn[k], want) for k in grid)
    swin = [k for k in drawn if k.startswith("guided_fusion.")
            and k.endswith(".relative_position_index")]
    assert swin and all(torch.equal(drawn[k], torch.from_numpy(
        relative_position_index(12))) for k in swin)


def test_beit_u4k_index_refused_without_its_module(beit_module):
    cfg = beit_config(tiny=False)
    wspec = program_spec(cfg)
    assert sum(math.prod(s) for _, s, _ in wspec) > 800e6
    # the structural buffers alone: none is drawn, so nothing is allocated
    # for the 805 M weights
    buffers = [x for x in wspec if x[0].rsplit(".", 1)[-1] in
               weights.COMPUTED]
    with pytest.raises(ValueError,
                       match=r"relative_position_index.*\(729, 729\).*"
                             r"\(769, 769\)"):
        weights.make(buffers, SEED, "cpu")
    got = weights.make(buffers, SEED, "cpu", beit_module, cfg)
    assert all(tuple(got[k].shape) == s for k, s, _ in buffers)
    rules, _ = weights.plan(wspec, beit_module, cfg)
    assert len(rules) == len(wspec) - len(buffers)
    index = got["fine_branch.core.core.pretrained.model.blocks.23.attn."
                "relative_position_index"]
    assert index.shape == (769, 769) and int(index.max()) == \
        (2 * 24 - 1) * (2 * 32 - 1) + 2
    assert np.array_equal(index[1:, 1:].diagonal().numpy(),
                          np.full(768, 23 * 63 + 31))
