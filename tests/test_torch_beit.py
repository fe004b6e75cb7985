"""The port's BEiT ZoeDepth modules (patchfusion_tpu_torch/models/beit.py,
ZoeDepthBEiT in models/zoedepth.py, the BEiT part of convert/from_jax.py)
against the JAX package on the CPU, on BEiT_tiny (width 64, 4 blocks,
4 heads) and the toy zoedepth config of tests/test_beit.py (64x96 process
shape), with every JAX leaf drawn from numpy (torch_parity.redraw_beit:
LayerScale gammas U(0.5, 1.5), q/v biases and tables N(0, 0.5), so the
attention counts) and carried across by convert/from_jax.py.

float32: the attention and the block within 1e-5 of max, MidasDPTBEiT and
ZoeDepthBEiT within 1e-4 of max. bfloat16 (the JAX package's BEiT
contract: bf16 q * scale, f32 logits, bias and softmax, bf16
probabilities, f32 P.V sums) within BF16_TOL of max of the JAX bf16
output; the two differ by the order of f32 sums and by where LayerNorm
and the linear layers round."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from patchfusion_tpu.convert.jax2torch import zoedepth_beit_state_dict
from patchfusion_tpu.models import beit as jbeit
from patchfusion_tpu.models.zoedepth import ZoeDepthBEiT as JaxZoeBEiT
from patchfusion_tpu_torch.convert import branch_conversion_spec, from_jax
from patchfusion_tpu_torch.models import beit
from patchfusion_tpu_torch.models.zoedepth import ZoeDepthBEiT

from .torch_parity import (nchw, nhwc, port_net, redraw_beit, rel_err,
                           toy_zoe_jax)

torch.set_num_threads(2)

F32_TOL = 1e-4
F32_BLOCK_TOL = 1e-5
# bf16 attention and block against the JAX bf16 ones, relative to max
# (measured 4.1e-3 and 5.5e-3 on these inputs; f32 2.5e-7)
BF16_TOL = 1e-2
DIM, HEADS, GRID = 64, 4, (4, 6)
N = GRID[0] * GRID[1] + 1


def _tokens(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (2, N, DIM)).astype(np.float32)


def _jax_block(seed=3):
    """A JAX BeitBlock at BEiT_tiny's width and its redrawn variables."""
    blk = jbeit.BeitBlock(HEADS, GRID)
    var = blk.init(jax.random.PRNGKey(0), jnp.zeros((1, N, DIM)))
    return blk, redraw_beit(jax.device_get(var), seed)


def _port_block(params, dtype=torch.float32):
    """The port's BeitBlock with the JAX block's parameters, through the
    converter's backbone mapping."""
    tree = {"cls_token": np.zeros((1, 1, DIM), np.float32),
            "patch_embed": {"kernel": np.zeros((16, 16, 3, DIM), np.float32),
                            "bias": np.zeros(DIM, np.float32)},
            "blocks_0": params}
    sd = from_jax.beit_backbone_state_dict(tree, 1, "", GRID)
    sd = {k[len("blocks.0."):]: v for k, v in sd.items()
          if k.startswith("blocks.0.")}
    blk = beit.BeitBlock(DIM, HEADS, GRID)
    blk.load_state_dict(from_jax.to_torch(sd), strict=True)
    return blk.to(dtype).eval()


def _bf16(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)


@pytest.mark.parametrize("grid", [(3, 5), (24, 32)])
def test_relative_position_index_matches_jax(grid):
    got = beit.relative_position_index(*grid)
    want = jbeit.relative_position_index(*grid)
    assert got.shape == want.shape == (grid[0] * grid[1] + 1,) * 2
    np.testing.assert_array_equal(got, want)
    assert got.max() == beit.table_rows(grid) - 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax(dtype):
    """BeitAttention: f32 within 1e-5 of max, bf16 within BF16_TOL of the
    JAX bf16 contract's output."""
    _, var = _jax_block()
    p = var["params"]["attn"]
    x = _tokens()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    attn = jbeit.BeitAttention(HEADS, GRID, dtype=jdt)
    jp = p if dtype == "float32" else _bf16(p)
    want = attn.apply({"params": jp}, jnp.asarray(x, jdt))
    port = _port_block(var["params"], tdt).attn
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    tol = F32_BLOCK_TOL if dtype == "float32" else BF16_TOL
    assert rel_err(got.float().numpy(), np.asarray(want, np.float32)) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matches_jax(dtype):
    """BeitBlock (pre-norm, LayerScale, GELU): f32 within 1e-5 of max,
    bf16 within BF16_TOL."""
    blk, var = _jax_block()
    x = _tokens(1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jblk = jbeit.BeitBlock(HEADS, GRID, dtype=jdt)
    jv = var if dtype == "float32" else {"params": _bf16(var["params"])}
    want = jblk.apply(jv, jnp.asarray(x, jdt))
    with torch.no_grad():
        got = _port_block(var["params"], tdt)(torch.from_numpy(x).to(tdt))
    tol = F32_BLOCK_TOL if dtype == "float32" else BF16_TOL
    assert rel_err(got.float().numpy(), np.asarray(want, np.float32)) <= tol
    # the residual branches count: the block moves its input by O(1)
    assert rel_err(np.asarray(want, np.float32), x) > 0.1


def test_qkv_bias_has_no_k_third():
    """The BEiT quirk: the qkv projection has no bias of its own; its bias
    is [q_bias, 0, v_bias]. (A k-bias would shift each query row's logits
    by one constant and leave the softmax as it is, so the check is the
    structure and the module against attention written out with that
    bias, where a misplaced q or v third would show.)"""
    _, var = _jax_block()
    attn = _port_block(var["params"]).attn
    names = dict(attn.named_parameters())
    assert attn.qkv.bias is None and "qkv.bias" not in names
    assert {"q_bias", "v_bias", "qkv.weight"} <= set(names)
    assert "attn.qkv.bias" not in _port_block(var["params"]).state_dict()
    x = torch.from_numpy(_tokens(2))
    hd = DIM // HEADS
    with torch.no_grad():
        got = attn(x)
        bias = torch.cat([attn.q_bias, torch.zeros(DIM), attn.v_bias])
        q, k, v = (x @ attn.qkv.weight.t() + bias).reshape(
            2, N, 3, HEADS, hd).unbind(2)
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * hd ** -0.5
        table = attn.relative_position_bias_table
        idx = torch.from_numpy(beit.relative_position_index(*GRID))
        logits = logits + table[idx].permute(2, 0, 1)
        o = torch.einsum("bhnm,bmhd->bnhd", logits.softmax(-1), v)
        want = attn.proj(o.reshape(2, N, DIM))
    assert rel_err(got.numpy(), want.numpy()) <= F32_BLOCK_TOL


@pytest.fixture(scope="module")
def toy():
    """The toy zoedepth net in both packages with the same weights."""
    cfg, jnet, tile_cfg, var = toy_zoe_jax(0)
    net, _ = port_net(cfg, var)
    return cfg, var, net


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(10).random((2, 64, 96, 3),
                                            dtype=np.float32)


def test_branch_state_dict_matches_jax2torch(toy):
    """The port's converter gives jax2torch's BEiT branch dict, key for key
    and value for value, and the port's branch holds exactly those keys
    (timm-style BEiT, MiDaS act_postprocess / scratch)."""
    cfg, var, net = toy
    family, depth, grid = branch_conversion_spec(cfg)
    assert (family, depth, grid) == ("midas", 4, (4, 6))
    p = var["params"]["coarse_branch"]
    ours = from_jax.zoedepth_beit_state_dict(p, depth, grid, "")
    ref = zoedepth_beit_state_dict(p, depth, grid)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    assert sorted(net.coarse_branch.state_dict()) == sorted(ours)
    for key in ("core.core.pretrained.model.blocks.3.attn.q_bias",
                "core.core.pretrained.model.blocks.0.gamma_2",
                "core.core.pretrained.act_postprocess1.4.weight",
                "core.core.pretrained.act_postprocess4.4.weight",
                "core.core.scratch.output_conv.4.weight",
                "core.core.scratch.refinenet1.resConfUnit2.conv1.weight"):
        assert key in ours, key


def test_from_jax_loads_a_zoedepth_net_strictly(toy):
    """The JAX PatchFusionNet of a zoedepth config loads into the port with
    strict=True, the resample layers' ConvTranspose weights included."""
    cfg, var, _ = toy
    net, tile_cfg = port_net(cfg, var)
    sd = net.state_dict()
    jres = var["params"]["coarse_branch"]["core"]["scratch"]["resize_0"]
    np.testing.assert_array_equal(
        sd["coarse_branch.core.core.pretrained.act_postprocess1.4.weight"]
        .numpy(), np.asarray(jres["kernel"]).transpose(3, 2, 0, 1))
    assert tile_cfg.patch_process_shape == (64, 96)
    assert isinstance(net.fine_branch, ZoeDepthBEiT)


def test_midas_dpt_beit_matches_jax(toy, image):
    """MidasDPTBEiT: the relative depth and the six taps within 1e-4 of max
    (f32); the ConvTranspose resamples' weights come through inv_conv."""
    _, var, net = toy
    p = var["params"]["coarse_branch"]["core"]
    x = (image - 0.5) / 0.5
    wdepth, wfeats = jbeit.MidasDPTBEiT("BEiT_tiny").apply(
        {"params": p}, jnp.asarray(x))
    with torch.no_grad():
        gdepth, gfeats = net.coarse_branch.core.core(nchw(x))
    assert rel_err(gdepth.numpy(), wdepth) <= F32_TOL
    assert sorted(gfeats) == sorted(wfeats) == sorted(
        ["out_conv", "l4_rn", "r4", "r3", "r2", "r1"])
    for k in wfeats:
        assert rel_err(nhwc(gfeats[k]), wfeats[k]) <= F32_TOL, k


def test_zoedepth_beit_matches_jax(toy, image):
    """ZoeDepthBEiT: metric depth, relative depth and the six
    temp_features within 1e-4 of max (f32). The JAX head runs unfused on
    the CPU, the port's f32 head too."""
    _, var, net = toy
    zoe = JaxZoeBEiT(core_type="BEiT_tiny")
    want = zoe.apply({"params": var["params"]["coarse_branch"]},
                     jnp.asarray(image))
    with torch.no_grad():
        got = net.coarse_branch(nchw(image))
    assert rel_err(nhwc(got["metric_depth"]), want["metric_depth"]) \
        <= F32_TOL
    assert rel_err(got["rel_depth"].numpy(), want["rel_depth"]) <= F32_TOL
    assert sorted(got["temp_features"]) == sorted(want["temp_features"])
    for k, w in want["temp_features"].items():
        assert rel_err(nhwc(got["temp_features"][k]), w) <= F32_TOL, k


def test_zoedepth_beit_bf16_matches_jax_f32(toy, image):
    """bf16 ZoeDepthBEiT (the fused head through the kernels' plain twins)
    against the JAX f32 depth, within chip_smoke's TINY_TOL (3e-2) of max,
    the bound the card's bf16 run is held to (measured 2.5e-3; the JAX
    package's own bf16 path, unfused, sits 1.1e-2 from it)."""
    _, var, net = toy
    zoe = JaxZoeBEiT(core_type="BEiT_tiny")
    want = zoe.apply({"params": var["params"]["coarse_branch"]},
                     jnp.asarray(image))["metric_depth"]
    branch = net.coarse_branch
    try:
        branch.to(torch.bfloat16)
        with torch.no_grad():
            got = branch(nchw(image, torch.bfloat16))["metric_depth"]
    finally:
        branch.to(torch.float32)
    assert rel_err(nhwc(got), want) <= chip_smoke.TINY_TOL


def test_beit_grid_is_fixed_at_build():
    """The table is sized for one grid, as the JAX package sizes it at
    trace time: another input size raises instead of reading the wrong
    offsets; the branch takes multiples of 32 only."""
    m = beit.MidasDPTBEiT("BEiT_tiny", (2, 3))
    assert m.pretrained.model.blocks[0].attn.relative_position_bias_table \
        .shape == (beit.table_rows((2, 3)), 4)
    with pytest.raises(ValueError, match="grid"):
        m(torch.zeros(1, 3, 32, 64))
    with pytest.raises(ValueError, match="multiples of 32"):
        ZoeDepthBEiT("BEiT_tiny", process_shape=(48, 64))


def test_port_beit_modules_import_no_jax():
    """Importing the port's BEiT modules loads neither JAX nor the JAX
    package."""
    code = ("import sys; import patchfusion_tpu_torch.models.beit, "
            "patchfusion_tpu_torch.models.zoedepth, "
            "patchfusion_tpu_torch.convert.from_jax, "
            "patchfusion_tpu_torch.engine.checkpoint; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'patchfusion_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(chip_smoke.ROOT))
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_tiny_zoe_config_is_the_toy_config():
    """chip_smoke.py's toy zoedepth config (read with the port's config
    loader) is tests/test_beit.py's."""
    import json

    from .test_beit import toy_zoe_config

    def plain(cfg):
        return json.loads(json.dumps(cfg, default=dict))

    assert plain(chip_smoke.tiny_zoe_config()) == plain(toy_zoe_config())
