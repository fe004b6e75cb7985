"""Shared setup for the parity tests of the PyTorch port
(tests/test_torch_*.py): seeded JAX variables for the tiny PatchFusion
config, carried into the port through convert/from_jax.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as graft
from patchfusion_tpu.api import _init_variables
from patchfusion_tpu.models.builder import build_patchfusion as jax_build
from patchfusion_tpu_torch.convert.from_jax import (state_dict_from_flax,
                                                    to_torch)
from patchfusion_tpu_torch.models.builder import build_patchfusion


def tiny_jax(seed: int = 0):
    """(config, JAX net, tile config, variables as numpy trees) for
    __graft_entry__._tiny_config. `_init_variables` leaves biases at 0 and
    norm scales and BN statistics at 1/0, so those are redrawn from the
    same seed to exercise every weight the conversion carries."""
    cfg = graft._tiny_config()
    net, tile_cfg = jax_build(cfg)
    var = jax.device_get(_init_variables(net, tile_cfg, seed))
    rng = np.random.default_rng(seed + 1)

    def redraw(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "bias":
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        if name == "var":
            return (1 + 0.5 * rng.random(x.shape)).astype(x.dtype)
        if name == "mean":
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    var = jax.tree_util.tree_map_with_path(redraw, var)
    return cfg, net, tile_cfg, var


def redraw_beit(var, seed: int):
    """The variables with every leaf drawn from numpy so that each term of
    a BEiT branch counts: `_init_variables` leaves the BEiT qkv kernel and
    the LayerScale gammas at 0 (its name rule) and the cls token at 1e-6,
    which would hide an attention error below every tolerance. Kernels
    LeCun (the qkv kernel too), gamma_1 / gamma_2 ~ U(0.5, 1.5), the q and
    v biases, the relative-position tables and the cls token ~ N(0, 0.5),
    other biases ~ N(0, 0.1), norm scales 1 + N(0, 0.1), BN statistics
    as tiny_jax draws them."""
    rng = np.random.default_rng(seed)

    def redraw(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape, dt = x.shape, x.dtype
        if name in ("kernel", "qkv_kernel"):
            fan_in = int(np.prod(shape[:-1]))
            v = np.clip(rng.standard_normal(shape), -2, 2) / np.sqrt(fan_in)
        elif name in ("gamma_1", "gamma_2"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("q_bias", "v_bias", "relative_position_bias_table",
                      "cls_token"):
            v = 0.5 * rng.standard_normal(shape)
        elif name == "bias":
            v = 0.1 * rng.standard_normal(shape)
        elif name == "scale":
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = 1 + 0.5 * rng.random(shape)
        elif name == "mean":
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = x
        return np.asarray(v, dt)

    return jax.tree_util.tree_map_with_path(redraw, var)


def toy_zoe_jax(seed: int = 0):
    """(config, JAX net, tile config, variables) for the toy zoedepth
    config of tests/test_beit.py (BEiT_tiny, 64x96 tiles of 128x192), every
    leaf drawn by redraw_beit."""
    from .test_beit import toy_zoe_config

    cfg = toy_zoe_config()
    net, tile_cfg = jax_build(cfg)
    var = jax.device_get(_init_variables(net, tile_cfg, seed))
    return cfg, net, tile_cfg, redraw_beit(var, seed + 1)


def port_net(cfg, var, dtype=torch.float32):
    """The port's PatchFusionNet with the JAX variables, loaded strictly."""
    net, tile_cfg = build_patchfusion(cfg, device="cpu")
    net.load_state_dict(to_torch(state_dict_from_flax(
        var["params"], var["batch_stats"], cfg)), strict=True)
    return net.to(dtype), tile_cfg


def bf16_params(var):
    """The JAX package's bf16 weights (api.from_config cast_params=True):
    params in bf16, batch statistics kept in f32."""
    out = dict(var)
    out["params"] = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                 var["params"])
    return out


def nchw(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(x, np.float32), -1, 1))).to(dtype)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().movedim(1, -1).numpy()


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def train_batch(seed: int = 0, n: int = 4):
    """A seeded fusion-stage train batch at the tiny sizes, NHWC numpy:
    42x56 crops whose boxes sit in the 3840x2160 frame the JAX step scales
    by, with some invalid (0) depths for the loss's mask."""
    rng = np.random.default_rng(seed)
    depth = rng.random((n, 42, 56, 1), dtype=np.float32) * 40 + 1
    depth[0, :5] = 0.0
    boxes = np.array([[0, 0, 960, 540], [960, 540, 1920, 1080],
                      [2880, 0, 3840, 540], [1920, 1620, 2880, 2160]],
                     np.float32)[:n]
    return {"image_lr": rng.random((n, 42, 56, 3), dtype=np.float32),
            "crops_image_hr": rng.random((n, 42, 56, 3), dtype=np.float32),
            "crop_depths": depth, "bboxs": boxes}


def by_port_name(trainable_tree, var, cfg, batch_stats=None):
    """A JAX tree shaped like the trainable params (gradients, parameters)
    -> the port's state_dict names, through the weight converter (linear,
    so it carries gradients as it carries weights); BN statistics from
    `batch_stats` (default the variables')."""
    full = {**trainable_tree, "coarse_branch": var["params"]["coarse_branch"],
            "fine_branch": var["params"]["fine_branch"]}
    return state_dict_from_flax(
        jax.device_get(full), jax.device_get(
            batch_stats if batch_stats is not None else var["batch_stats"]),
        cfg)
