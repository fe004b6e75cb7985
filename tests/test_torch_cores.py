"""The DA-vits and DA-vitb widths of the port against the JAX package: both
branches at the core's published width and depth (DINOv2 ViT-S/14: width
384, 6 heads, 12 blocks; ViT-B/14: 768, 12 heads, 12 blocks; DPT features
64 / 128; the fusion stage's in_channels [32, 64 x 5] / [32, 128 x 5]) at
the tiny spatial size (tests/torch_parity.core_config: 42x56 tiles of an
84x112 image), with the JAX package's seeded weights (biases, norm scales
and BN statistics redrawn) converted strictly into the port.

float32: <= F32_TOL relative to max |value|. bfloat16: <= BF16_TOL, the
bf16 contract; the port's bf16 metric-bins head takes the fused
formulation (plain twins on the CPU), the JAX package on the CPU its
unfused path, so the bf16 depth is held against the JAX f32 depth, the
exact answer at these weights (as tests/test_torch_models.py does).

The whole net (the engine, m1 and m2 with process_num=None: one pass of
every tile, as bench.py runs vits) is held at vits only: at vitb the JAX
engine's CPU compile adds ~45 s, which would take this file past ~90 s on
one worker; vitb's branch is held here, and its fusion stage differs from
vits's only in the six input widths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from patchfusion_tpu.engine.inference import PatchFusionInference as JaxEngine
from patchfusion_tpu.models.builder import zoe_branch_kwargs
from patchfusion_tpu.models.zoedepth import make_zoe_branch
from patchfusion_tpu.ops import pallas_attention as pa
from patchfusion_tpu_torch.convert import from_jax
from patchfusion_tpu_torch.engine.inference import PatchFusionInference
from patchfusion_tpu_torch.ops import vit_attention as va

from .torch_parity import (bf16_params, nchw, nhwc, port_net, rel_err,
                           tiny_jax)

torch.set_num_threads(2)

F32_TOL = 1e-4
BF16_TOL = 3e-2
# the JAX attention tests' bound (tests/test_torch_attention.py)
ATTN_ATOL = 2.5e-2
# core -> (ViT width, heads, blocks, DPT features)
WIDTHS = {"vits": (384, 6, 12, 64), "vitb": (768, 12, 12, 128)}


@pytest.fixture(scope="module")
def cores():
    """core -> (config, JAX net, JAX tile config, variables, port net, port
    tile config), built once per core on first use."""
    cache = {}

    def get(core):
        if core not in cache:
            cfg, jnet, tile_cfg, var = tiny_jax(0, core)
            cache[core] = (cfg, jnet, tile_cfg, var, *port_net(cfg, var))
        return cache[core]

    return get


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(10).random((2, 42, 56, 3),
                                            dtype=np.float32)


@pytest.mark.parametrize("core", ["vits", "vitb"])
def test_strict_load_at_the_cores_widths(cores, core):
    cfg, _, _, var, net, _ = cores(core)
    width, heads, depth, features = WIDTHS[core]
    for branch in (net.coarse_branch, net.fine_branch):
        vit = branch.core.core.pretrained
        assert vit.cls_token.shape[-1] == width
        assert len(vit.blocks) == depth
        assert {b.attn.num_heads for b in vit.blocks} == {heads}
        scratch = branch.core.core.depth_head.scratch
        assert scratch.layer1_rn.out_channels == features
        assert scratch.output_conv1.in_channels == features
    ours = from_jax.state_dict_from_flax(var["params"], var["batch_stats"],
                                         cfg)
    assert sorted(net.state_dict()) == sorted(ours)
    for k, v in net.state_dict().items():
        assert tuple(v.shape) == tuple(ours[k].shape), k
    # the six fusion convs, deepest level first
    assert [c.out_channels for c in net.fusion_conv_list] == \
        [features] * 5 + [32]


def _jax_branch(cfg, params, image, dtype=jnp.float32):
    zoe = make_zoe_branch(zoe_branch_kwargs(cfg["coarse_branch"]),
                          cfg["min_depth"], cfg["max_depth"], dtype=dtype)
    return zoe.apply({"params": params}, jnp.asarray(image))


@pytest.fixture(scope="module")
def exact(cores, image):
    """core -> the JAX f32 coarse branch's outputs on `image`."""
    cache = {}

    def get(core):
        if core not in cache:
            cfg, _, _, var, _, _ = cores(core)
            cache[core] = _jax_branch(cfg, var["params"]["coarse_branch"],
                                      image)
        return cache[core]

    return get


@pytest.mark.parametrize("core", ["vits", "vitb"])
def test_zoedepth_branch_f32(cores, exact, core, image):
    net = cores(core)[4]
    want = exact(core)
    with torch.no_grad():
        got = net.coarse_branch(nchw(image))
    assert rel_err(nhwc(got["metric_depth"]), want["metric_depth"]) \
        <= F32_TOL
    assert rel_err(got["rel_depth"].numpy(), want["rel_depth"]) <= F32_TOL
    assert sorted(got["temp_features"]) == sorted(want["temp_features"])
    for k, w in want["temp_features"].items():
        assert rel_err(nhwc(got["temp_features"][k]), w) <= F32_TOL, k


@pytest.mark.parametrize("core", ["vits", "vitb"])
def test_zoedepth_branch_bf16(cores, exact, core, image):
    """The port's bf16 branch against the JAX f32 branch, the exact answer
    at these weights: each package's bf16 path sits about as far from it
    (measured on the CPU, port / JAX bf16: metric depth 3.9e-3 / 1.2e-2 at
    vits, 1.2e-2 / 1.5e-2 at vitb; the features at most 2.7e-2 / 2.3e-2 at
    vits, 2.1e-2 / 2.2e-2 at vitb, both at midas_final_feat), so the two
    bf16 outputs part by up to the sum of both (3.4e-2 at vits), and the
    JAX bf16 branch's own run is held to the same bound."""
    cfg, _, _, var, _, _ = cores(core)
    net, _ = port_net(cfg, var, torch.bfloat16)
    with torch.no_grad():
        got = net.coarse_branch(nchw(image, torch.bfloat16))
    exact = exact(core)
    jax_bf16 = _jax_branch(cfg, bf16_params(var)["params"]["coarse_branch"],
                           image, jnp.bfloat16)
    assert got["metric_depth"].dtype == torch.float32  # fused head output
    assert rel_err(nhwc(got["metric_depth"]), exact["metric_depth"]) \
        <= BF16_TOL
    assert rel_err(jax_bf16["metric_depth"], exact["metric_depth"]) \
        <= BF16_TOL
    assert sorted(got["temp_features"]) == sorted(exact["temp_features"])
    for k, w in exact["temp_features"].items():
        assert rel_err(nhwc(got["temp_features"][k]), w) <= BF16_TOL, k
        assert rel_err(jax_bf16["temp_features"][k], w) <= BF16_TOL, k


@pytest.mark.parametrize("heads", [6, 12])
def test_attention_twin_at_the_cores_head_counts(heads):
    """The attention kernel's twin against the JAX Pallas kernel (interpret
    mode) at vits's and vitb's head counts, Dh = 64."""
    rng = np.random.default_rng(heads)
    arrays = [np.asarray(jnp.asarray(rng.standard_normal((1, 37, heads, 64)),
                                     jnp.bfloat16), np.float32)
              for _ in range(3)]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pa.vit_attention(jq, jk, jv), np.float32)
    got = va.vit_attention(tq, tk, tv)
    assert got.shape == tq.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATTN_ATOL)


@pytest.fixture(scope="module")
def vits_engines(cores):
    """The vits net through both engines, one pass of every tile."""
    _, jnet, tile_cfg, var, net, port_tile_cfg = cores("vits")
    rng = np.random.default_rng(3)
    lr = rng.random((1, 42, 56, 3), dtype=np.float32)
    hr = rng.random((84, 112, 3), dtype=np.float32)
    jax_engine = JaxEngine(jnet, var, tile_cfg, process_num=None)
    port = PatchFusionInference(net, port_tile_cfg, process_num=None)
    return jax_engine, port, lr, hr


@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_vits_engine_whole_pass_f32(vits_engines, mode):
    jax_engine, port, lr, hr = vits_engines
    want = np.asarray(jax_engine.infer(lr, hr, cai_mode=mode))
    got = port.infer(lr, hr, cai_mode=mode).numpy()
    assert got.shape == want.shape == (84, 112)
    assert np.isfinite(got).all() and (got > 0).all()
    assert rel_err(got, want) <= F32_TOL
