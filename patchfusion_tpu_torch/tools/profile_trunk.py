"""Per-op floors of the DINOv2 trunk at tile-chunk shapes (the port of the
JAX package's tools/profile_trunk.py): the qkv / proj / fc1 / fc2 matmuls
(2D-collapsed and 3D-batched forms), LayerNorm, the bf16 path's tanh-GELU,
the residual + LayerScale chain, and the attention, each alone at its
in-model shape with its time (and for the matmuls and the attention its
FLOPs, TFLOP/s and share of the peak), so that the trunk's measured time
(profile_fine's "vit trunk(4 taps)") can be set against the sum of its
floors: depth x (the per-layer floor + the attention).

    python -m patchfusion_tpu_torch.tools.profile_trunk [--core vitl]
        [--batch 16] [--inner 10] [--device cuda]

The attention is measured here, three ways: the einsum form
(models/dinov2.fused_attention with PF_ATTN_IMPL=einsum, bf16
probabilities; the route of a call that carries a gradient), the port's
attention kernel (the model's route without a gradient, and
PF_ATTN_IMPL=pallas; its plain twin on the CPU) and torch's
scaled_dot_product_attention as the library's reference; the trunk floor
is printed with each of the port's two. bf16 throughout, as
the main path runs. Prints the rows, then one JSON line with them, the
card's nvidia-smi name and power limit and the torch version.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from patchfusion_tpu_torch.models.builder import check_device
from patchfusion_tpu_torch.tools import _bench_util as bu

TOOL = "profile_trunk"


def profile(core: str = "vitl", batch: int = 16, inner: int = 10,
            device="cuda", shape: Tuple[int, int] = (392, 518)) -> dict:
    """The module note's rows for a VIT_CONFIGS entry."""
    from patchfusion_tpu_torch.models.dinov2 import VIT_CONFIGS
    from patchfusion_tpu_torch.ops.activations import gelu
    from patchfusion_tpu_torch.ops.vit_attention import (vit_attention,
                                                         vit_attention_plain)

    device = check_device(device)
    cfg = VIT_CONFIGS[core]
    d, depth, heads = cfg["embed_dim"], cfg["depth"], cfg["num_heads"]
    b = batch
    h, w = shape
    n = (h // 14) * (w // 14) + 1  # patch tokens + cls
    hidden = 4 * d
    dtype = torch.bfloat16
    peak, peak_label = bu.peak_flops(dtype, device)
    seed = iter(range(1000))
    rows = []

    def mk(*shape_):
        return bu.seeded_input(shape_, device, next(seed), dtype, True)

    def row(name, fn, *args, flops=None):
        t = bu.device_time(fn, *args, inner=inner, device=device)
        rows.append(bu.stage_row(name, t, flops, peak))
        return t

    def fl(k, m):
        return 2.0 * b * n * k * m

    x2, x3 = mk(b * n, d), mk(b, n, d)
    w_qkv, w_proj = mk(d, 3 * d), mk(d, d)
    w_fc1, w_fc2 = mk(d, hidden), mk(hidden, d)
    h2, h3 = mk(b * n, hidden), mk(b, n, hidden)
    with torch.no_grad():
        row("timer overhead (id x3)", lambda y: y, x3)
        row("timer overhead (id h3)", lambda y: y, h3)
        t_qkv = row("qkv 2d", torch.matmul, x2, w_qkv, flops=fl(d, 3 * d))
        row("qkv 3d", torch.matmul, x3, w_qkv, flops=fl(d, 3 * d))
        t_proj = row("proj 2d", torch.matmul, x2, w_proj, flops=fl(d, d))
        t_fc1 = row("fc1 2d", torch.matmul, x2, w_fc1, flops=fl(d, hidden))
        t_fc2 = row("fc2 2d", torch.matmul, h2, w_fc2, flops=fl(hidden, d))
        row("fc2 3d", torch.matmul, h3, w_fc2, flops=fl(hidden, d))
        ln_g, ln_b = mk(d), mk(d)
        t_ln = row("layernorm (b,n,d)",
                   lambda y: F.layer_norm(y, (d,), ln_g, ln_b, 1e-6), x3)
        t_gelu = row("gelu (b,n,4d)", gelu, h3)
        ls = mk(d)
        t_res = row("residual+layerscale", lambda y, s: y + y * s, x3, ls)

        qkv = mk(b, n, 3, heads, d // heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        attn_flops = 4.0 * b * heads * n * n * (d // heads)
        t_einsum = row("attention einsum", vit_attention_plain, q, k, v,
                       flops=attn_flops)
        t_kernel = row("attention kernel", vit_attention, q, k, v,
                       flops=attn_flops)
        row("attention sdpa", F.scaled_dot_product_attention, qt, kt, vt,
            flops=attn_flops)

    per_layer = t_qkv + t_proj + t_fc1 + t_fc2 + 2 * t_ln + t_gelu \
        + 2 * t_res
    rows.append(bu.stage_row("per-layer linear+elementwise floor",
                             per_layer))
    for label, t_attn in (("einsum", t_einsum), ("kernel", t_kernel)):
        rows.append(bu.stage_row(
            f"trunk floor [{label} attention]", depth * (per_layer + t_attn),
            depth=depth, attention_ms=t_attn * 1e3))
    bu.say(f"trunk floor = {depth} x (per-layer floor + attention); the "
           "measured trunk: profile_fine's vit trunk(4 taps)")
    return bu.emit(TOOL, device, rows, peak=peak_label, batch=b, tokens=n)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--core", default="vitl")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--inner", type=int, default=10)
    bu.add_device_arg(ap)
    args = ap.parse_args(argv)
    return profile(args.core, args.batch, args.inner, args.device)


if __name__ == "__main__":
    main()
