"""The control of the benchmark's comparison: the reference computed one
precision below the configurations' bfloat16, in fp8.

`to_fp8(net)` rounds the weight of every convolution and linear layer of
the reference network to float8 e4m3 in place, and rounds each such
layer's input to e4m3 as it arrives, each tensor with its own scale (its
largest magnitude to e4m3's 448); the products then run in float32. That
is what serving the model with fp8 matrix products would change, the step
below bf16 that would tempt a later change. The comparison that decides
`correct` has to fail this network. `to_fp8(net, per_channel=True)` scales
each output channel of a weight by its own largest magnitude instead, as
an fp8 path tuned for accuracy would (the inputs keep one scale a tensor).
"""

from __future__ import annotations

import torch
import torch.nn as nn

E4M3_MAX = 448.0
LAYERS = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)


def fp8_round(x: torch.Tensor, channel_dim=None) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (or one scale per
    index of `channel_dim`), back in x's dtype."""
    dims = [d for d in range(x.dim()) if d != channel_dim]
    amax = x.detach().abs().amax(dim=dims, keepdim=True).float().clamp(
        min=1e-12)
    scale = E4M3_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float()
            / scale).to(x.dtype)


def _round_input(_module, args):
    return (fp8_round(args[0]),) + tuple(args[1:])


@torch.no_grad()
def to_fp8(net: nn.Module, per_channel: bool = False) -> nn.Module:
    for m in net.modules():
        if isinstance(m, LAYERS):
            # a transposed convolution's weight is (in, out, kh, kw)
            out_dim = 1 if isinstance(m, nn.ConvTranspose2d) else 0
            m.weight.copy_(fp8_round(m.weight,
                                     out_dim if per_channel else None))
            m.register_forward_pre_hook(_round_input)
    return net
