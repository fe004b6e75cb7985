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
