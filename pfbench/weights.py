"""Seeded weights for a network, keyed by its state_dict names, made on the
device in a few large calls.

`spec(net)` reads the names, shapes and dtypes of a network's state_dict
(a network built on the `meta` device will do). `make(spec, seed, device)`
draws every floating-point tensor from ONE `torch.Generator` on `device`:
one `randn` per dtype over all of them, each key's slice starting on a
256-element boundary, scaled in place by a rule chosen from the key's last
name and its rank, and handed out as views. The structural buffers (the
Swin relative-position index, the log-binomial constants, BatchNorm's
counter) are computed. The same (spec, seed, device) gives the same
values; the benchmark makes them once for the program, and again after the
window for the reference, which casts them to float32.

A configuration's reference module (`spec.reference`) may bring rules of
its own, handed to `make` as `hooks`: `LEAF_RULES`, {leaf: (std, mean,
exp)}, looked up before the built-in rules, and `computed(key, shapes,
model_config)`, the value of a structural buffer that it owns, or None to
leave the key to the built-ins. A buffer so owned is not drawn. Every
computed buffer has to come out at its spec's shape, and an integer one
as integers, a floating one as floats; else `make` raises.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch

from pfbench.reference.ops import relative_position_index

Spec = List[Tuple[str, Tuple[int, ...], torch.dtype]]
Rule = Tuple[float, float, bool]
ALIGN = 256  # elements; every slice starts 512-byte aligned in bf16

# std of the small normal leaves: position embeddings, tables, tokens,
# biases, BatchNorm running means; and of the scales' spread about 1
SMALL = 0.02
SCALE_SPREAD = 0.05
COMPUTED = ("relative_position_index", "k_idx", "K_minus_1",
            "num_batches_tracked")


def spec(net: torch.nn.Module) -> Spec:
    return [(k, tuple(v.shape), v.dtype) for k, v in net.state_dict().items()]


def _rule(key: str, shape: Tuple[int, ...],
          leaf_rules: Dict[str, Rule]) -> Rule:
    """(std, mean, exp) of a drawn leaf: value = mean + std * N(0, 1), or
    exp(std * N(0, 1)) where `exp` is set (positive variances)."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf in leaf_rules:
        return leaf_rules[leaf]
    if leaf == "weight" and len(shape) >= 2:
        # LeCun normal over the fan-in of a conv or linear weight
        return (math.prod(shape[1:])) ** -0.5, 0.0, False
    if leaf in ("weight", "gamma"):
        return SCALE_SPREAD, 1.0, False
    if leaf == "running_var":
        return 0.1, 0.0, True
    if leaf in ("bias", "running_mean", "pos_embed", "absolute_pos_embed",
                "relative_position_bias_table", "cls_token", "mask_token"):
        return SMALL, 0.0, False
    raise ValueError(f"no rule for the weight {key!r}")


def _computed(key: str, shapes: Dict[str, Tuple[int, ...]]) -> torch.Tensor:
    """A structural buffer's value, in float32 or int64."""
    leaf = key.rsplit(".", 1)[-1]
    shape = shapes[key]
    if leaf == "relative_position_index":
        return torch.from_numpy(relative_position_index(math.isqrt(shape[0])))
    if leaf == "k_idx":
        return torch.arange(shape[1], dtype=torch.float32).reshape(shape)
    if leaf == "K_minus_1":
        bins = shapes[key[:-len(leaf)] + "k_idx"][1]
        return torch.full(shape, float(bins - 1))
    return torch.zeros(shape, dtype=torch.int64)   # num_batches_tracked


def _checked(key: str, value: torch.Tensor, shape: Tuple[int, ...],
             dtype: torch.dtype) -> torch.Tensor:
    if (tuple(value.shape) != tuple(shape)
            or value.is_floating_point() != dtype.is_floating_point):
        raise ValueError(
            f"the computed buffer {key!r} is {tuple(value.shape)} "
            f"{value.dtype}; its spec is {tuple(shape)} {dtype}")
    return value


def plan(weights_spec: Spec, hooks=None, config: Optional[Dict[str, Any]]
         = None) -> Tuple[Dict[str, Rule], Dict[str, torch.Tensor]]:
    """(the rule of every drawn leaf, the value of every computed buffer on
    the host) of `weights_spec`, with the `hooks` of a reference module
    (None: the built-ins alone); `config` is the model configuration that
    the module's `computed` reads."""
    leaf_rules = getattr(hooks, "LEAF_RULES", {})
    own = getattr(hooks, "computed", None)
    shapes = {key: shape for key, shape, _ in weights_spec}
    rules: Dict[str, Rule] = {}
    fixed: Dict[str, torch.Tensor] = {}
    for key, shape, dtype in weights_spec:
        value = own(key, shapes, config) if own is not None else None
        if value is None and key.rsplit(".", 1)[-1] in COMPUTED:
            value = _computed(key, shapes)
        if value is not None:
            fixed[key] = _checked(key, value, shape, dtype)
        elif not dtype.is_floating_point:
            raise ValueError(f"no rule for the {dtype} weight {key!r}")
        else:
            rules[key] = _rule(key, shape, leaf_rules)
    return rules, fixed


def make(weights_spec: Spec, seed: int, device, hooks=None,
         config: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """The weights of `weights_spec`, drawn from `seed` on `device`, with
    the `hooks` and model `config` of `plan`."""
    rules, fixed = plan(weights_spec, hooks, config)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    out: Dict[str, torch.Tensor] = {}
    by_dtype = defaultdict(list)
    for key, shape, dtype in weights_spec:
        if key in rules:
            by_dtype[dtype].append((key, shape))
    for dtype in sorted(by_dtype, key=str):
        leaves = sorted(by_dtype[dtype])
        sizes = [-(-math.prod(s) // ALIGN) * ALIGN for _, s in leaves]
        flat = torch.randn(sum(sizes), generator=gen, device=device,
                           dtype=dtype)
        start = 0
        for (key, shape), size in zip(leaves, sizes):
            part = flat[start:start + math.prod(shape)]
            start += size
            std, mean, exp = rules[key]
            part.mul_(std)
            if exp:
                part.exp_()
            else:
                part.add_(mean)
            out[key] = part.view(shape)
    for key, _, dtype in weights_spec:
        if key in fixed:
            out[key] = fixed[key].to(device=device, dtype=dtype)
    return out
