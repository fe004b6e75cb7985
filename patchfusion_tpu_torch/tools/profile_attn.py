"""Attention shoot-out at the fine branch's shapes (the port of the JAX
package's tools/profile_attn.py): the bf16 einsum form
(models/dinov2.fused_attention with PF_ATTN_IMPL=einsum, the route of a
call that carries a gradient), torch's scaled_dot_product_attention as the
library's reference, and the port's attention kernel
(csrc/vit_attention.cu, the model's route without a gradient and the
PF_ATTN_IMPL=pallas route, hence the rows' JAX names) in its three roundings: vit_attention
("whole-row"), vit_attention_blocked and vit_attention_mxsum (with and
without bf16_exp), at (B, N, H, Dh) = (16, 1037, 16, 64), the vitl
tile-chunk shape, by default. Each row: time, TFLOP/s (4 B H N^2 Dh),
share of the bf16 peak, its bound (_bench_util.attention_bound) and its
relative error to the einsum output.

    python -m patchfusion_tpu_torch.tools.profile_attn [--batch 16]
        [--n 1037] [--heads 16] [--dh 64] [--inner 20] [--device cuda]

--blocks (the JAX tool's sweep of row-block sizes) is accepted and does
not apply: the kernel's tile is fixed at build. q, k and v are views of
one (B, N, 3, H, Dh) tensor, as the model hands them. Prints the rows,
then one JSON line with them, the card's nvidia-smi name and power limit
and the torch version.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch
import torch.nn.functional as F

from patchfusion_tpu_torch.models.builder import check_device
from patchfusion_tpu_torch.tools import _bench_util as bu

TOOL = "profile_attn"


def profile(batch: int = 16, n: int = 1037, heads: int = 16, dh: int = 64,
            inner: int = 20, device="cuda") -> dict:
    """The module note's rows at (batch, n, heads, dh)."""
    from patchfusion_tpu_torch.models.dinov2 import fused_attention
    from patchfusion_tpu_torch.ops import vit_attention as va

    device = check_device(device)
    qkv = bu.seeded_input((batch, n, 3, heads, dh), device, 0,
                          torch.bfloat16, normal=True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    flops = 4.0 * batch * heads * n * n * dh
    peak, peak_label = bu.peak_flops(torch.bfloat16, device)
    bound_ms, bound_by = bu.attention_bound(batch, n, heads, dh)
    with torch.no_grad():
        ref = fused_attention(q, k, v, impl="einsum").float()
    scale = ref.abs().max().item()
    rows = []

    def row(name, fn):
        with torch.no_grad():
            err = (fn(q, k, v).float() - ref).abs().max().item() / scale
            t = bu.device_time(fn, q, k, v, inner=inner, device=device)
        rows.append(bu.stage_row(name, t, flops, peak, rel_err=err,
                                 bound_ms=bound_ms, bound_by=bound_by))

    row("einsum (bf16 probs)",
        lambda a, b, c: fused_attention(a, b, c, impl="einsum"))
    row("sdpa", lambda a, b, c: F.scaled_dot_product_attention(
        a.transpose(1, 2), b.transpose(1, 2),
        c.transpose(1, 2)).transpose(1, 2))
    row("pallas whole-row", va.vit_attention)
    row("pallas blocked", va.vit_attention_blocked)
    row("pallas mxsum", va.vit_attention_mxsum)
    row("pallas mxsum bf16exp",
        lambda a, b, c: va.vit_attention_mxsum(a, b, c, bf16_exp=True))
    return bu.emit(TOOL, device, rows, peak=peak_label,
                   shape=[batch, n, heads, dh])


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n", type=int, default=1037)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--dh", type=int, default=64)
    ap.add_argument("--inner", type=int, default=20)
    ap.add_argument("--blocks", default=None,
                    help="the JAX tool's row-block sweep; does not apply "
                         "(the kernel's tile is fixed at build)")
    bu.add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.blocks is not None:
        bu.say("--blocks does not apply: the attention kernel's tile is "
               "fixed at build")
    return profile(args.batch, args.n, args.heads, args.dh, args.inner,
                   args.device)


if __name__ == "__main__":
    main()
