"""ConditionalLogBinomial stage shoot-out at the fine branch's shapes (the
port of the JAX package's tools/profile_clb.py): B x 392x518 output, the
condition and the bin centers at the attractors' 224x296, 33 input
channels, a 128-channel condition, 64 bins, bf16. Rows:

  clb pre (proj+gelu+mlp2)  the plain composition of (p, t): the condition
                            projected at low resolution and lerped up,
                            tanh-GELU, the second layer, softplus
                            (ops/fused_head.clb_pt_plain)
  pallas logbinom kernel    the logbinomial_depth kernel alone
  clb full stage            the plain composition, then the plain
                            log-binomial depth
  clb_pt FUSED kernel       the clb_pt kernel, with its p and t errors
                            to the plain composition
  clb full (pt+logbinom)    the clb_pt kernel, then logbinomial_depth
  clb DEEP-FUSED kernel     the clb_logbinomial_depth kernel, with its
                            relative error to the two-kernel output

("pallas" names the kernels' route, PF_ATTN_IMPL's word; they are the
port's CUDA kernels.) Each row: time, the tensor-core FLOPs of the MLP
(_bench_util.clb_mlp_flops; the log-binomial's are f32 softmax work) and
the row's bound (_bench_util.head_bounds).

    python -m patchfusion_tpu_torch.tools.profile_clb [--batch 16]
        [--inner 10] [--only-fused] [--device cuda]

--only-fused skips the plain rows; --deep is accepted and always on (the
fused kernel always runs here); --ptrows (the JAX kernel's block rows)
does not apply: the kernels' tiles are fixed at build. Prints the rows,
then one JSON line with them, the card's nvidia-smi name and power limit
and the torch version.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from patchfusion_tpu_torch.models.builder import check_device
from patchfusion_tpu_torch.tools import _bench_util as bu

TOOL = "profile_clb"
SHAPE = (392, 518, 224, 296, 64, 33, 128, 80)  # oh ow ih iw k cin cc hid
TEMPS = (0.0212, 50.0)


def clb_inputs(b: int, device, shape=SHAPE):
    """Seeded bf16 inputs: last_cat, cond_lo, centers (positive) as
    channels-last views of NCHW tensors, as the model hands them, and the
    MLP's weights (w1, b1, w2, b2)."""
    oh, ow, ih, iw, k, cin, cc, hid = shape

    def nchw_view(c, h, w, seed):
        x = bu.seeded_input((b, c, h, w), device, seed, torch.bfloat16,
                            normal=True)
        return x.permute(0, 2, 3, 1)

    last = nchw_view(cin, oh, ow, 0)
    cond = nchw_view(cc, ih, iw, 1)
    cent = nchw_view(k, ih, iw, 2).abs() * 10 + 0.01
    ws = [bu.seeded_input(s, device, 3 + i, torch.bfloat16, normal=True)
          * 0.1 for i, s in enumerate(((cin + cc, hid), (hid,), (hid, 4),
                                        (4,)))]
    return last, cond, cent, ws


def profile(batch: int = 16, inner: int = 10, only_fused: bool = False,
            device="cuda", shape=SHAPE) -> dict:
    """The module note's rows at batch `batch` of `shape`."""
    from patchfusion_tpu_torch.ops import fused_head as fh

    device = check_device(device)
    oh, ow, ih, iw, k, cin, cc, hid = shape
    last, cond, cent, ws = clb_inputs(batch, device, shape)
    mlp = bu.clb_mlp_flops(batch, oh, ow, ih, iw, cin, cc, hid)
    bounds = bu.head_bounds(batch, *shape, 2)
    peak, peak_label = bu.peak_flops(torch.bfloat16, device)
    rows = []

    def row(name, fn, *args, flops=None, bound=None, **extra):
        t = bu.device_time(fn, *args, inner=inner, device=device)
        if bound:
            extra.update(bound_ms=bounds[bound][0],
                         bound_by=bounds[bound][1])
        rows.append(bu.stage_row(name, t, flops, peak, **extra))

    def plain_full(lc, cl, c):
        return fh.logbinomial_depth_plain(*fh.clb_pt_plain(lc, cl, *ws), c,
                                          *TEMPS)

    def two_kernels(lc, cl, c):
        return fh.logbinomial_depth(*fh.clb_pt(lc, cl, *ws), c, *TEMPS)

    with torch.no_grad():
        p0, t0 = fh.clb_pt_plain(last, cond, *ws)
        if not only_fused:
            row("clb pre (proj+gelu+mlp2)",
                lambda lc, cl: fh.clb_pt_plain(lc, cl, *ws), last, cond,
                flops=mlp)
            row("pallas logbinom kernel",
                lambda p, t, c: fh.logbinomial_depth(p, t, c, *TEMPS),
                p0, t0, cent, bound="logbinomial_depth")
            row("clb full stage", plain_full, last, cond, cent, flops=mlp)
        pg, tg = fh.clb_pt(last, cond, *ws)
        row("clb_pt FUSED kernel",
            lambda lc, cl: fh.clb_pt(lc, cl, *ws), last, cond, flops=mlp,
            bound="clb_pt", p_err=(pg - p0).abs().max().item(),
            t_err=(tg - t0).abs().max().item())
        row("clb full (pt+logbinom)", two_kernels, last, cond, cent,
            flops=mlp)
        two = two_kernels(last, cond, cent)
        deep = fh.clb_logbinomial_depth(last, cond, cent, *ws, *TEMPS)
        rel = ((deep - two).abs().max() / two.abs().max()).item()
        row("clb DEEP-FUSED kernel",
            lambda lc, cl, c: fh.clb_logbinomial_depth(lc, cl, c, *ws,
                                                       *TEMPS),
            last, cond, cent, flops=mlp, bound="clb_logbinomial_depth",
            rel_err=rel)
    return bu.emit(TOOL, device, rows, peak=peak_label, batch=batch,
                   shape=list(shape))


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--inner", type=int, default=10)
    ap.add_argument("--ptrows", type=int, default=0,
                    help="the JAX kernel's block rows; does not apply")
    ap.add_argument("--only-fused", action="store_true")
    ap.add_argument("--deep", action="store_true",
                    help="accepted; the fused kernel always runs")
    bu.add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.ptrows:
        bu.say("--ptrows does not apply: the kernels' tiles are fixed at "
               "build")
    return profile(args.batch, args.inner, args.only_fused, args.device)


if __name__ == "__main__":
    main()
