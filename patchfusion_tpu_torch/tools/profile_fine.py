"""Fine-branch micro-breakdown (the port of the JAX package's
tools/profile_fine.py): the DINOv2 trunk, the trunk with the DPT decoder,
the full fine ZoeDepth branch, then the DPT decoder split into its
reassemble stage, its refinenet chain and its output stage (and the
output stage op by op), and the metric-bins head, each at its in-model
shapes, with time, counted matmul+conv FLOPs, TFLOP/s and share of the
card's peak.

    python -m patchfusion_tpu_torch.tools.profile_fine [--core vitl]
        [--batch 16] [--inner 8] [--dtype bf16] [--stages all]
        [--device cuda]

--stages: a comma list of vit, dpt, zoe, head, reassemble, refinenets,
output, outputops, bins, attr, clb (default all). Each part runs the seeded
branch's own modules (the JAX tool builds stand-in flax modules for the
decoder's parts); "seed+attractors" runs the head up to the attractors,
which the JAX tool reaches by reading an intermediate that XLA then
prunes to. "up+convs tail" is the upsample and the two convs in sequence
(the JAX tool's jitted tail). Prints the rows, then one JSON line with
them, the card's nvidia-smi name and power limit and the torch version.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from patchfusion_tpu_torch.models.builder import check_device
from patchfusion_tpu_torch.tools import _bench_util as bu
from patchfusion_tpu_torch.tools.profile_stages import seeded_branch

TOOL = "profile_fine"
STAGES = ("vit", "dpt", "zoe", "head", "reassemble", "refinenets", "output",
          "outputops", "bins", "attr", "clb")


def reassemble(head, taps, ph: int, pw: int):
    """The DPT head's projections, resizes and layerN_rn convs."""
    s = head.scratch
    out = []
    for i, (tok, _cls) in enumerate(taps):
        b, _, d = tok.shape
        x = tok.transpose(1, 2).reshape(b, d, ph, pw)
        x = head.resize_layers[i](head.projects[i](x))
        out.append(getattr(s, f"layer{i + 1}_rn")(x))
    return out


def refinenets(scratch, rn):
    p4 = scratch.refinenet4(rn[3], size=rn[2].shape[-2:])
    p3 = scratch.refinenet3(p4, rn[2], size=rn[1].shape[-2:])
    p2 = scratch.refinenet2(p3, rn[1], size=rn[0].shape[-2:])
    return scratch.refinenet1(p2, rn[0])


def output_stage(scratch, p1, size: Tuple[int, int]):
    from patchfusion_tpu_torch.ops.resize import interpolate_nchw

    out = scratch.output_conv1(p1)
    out = interpolate_nchw(out, size, mode="bilinear", align_corners=True)
    out = F.relu(scratch.output_conv2[0](out))
    return F.relu(scratch.output_conv2[2](out))


def seed_attractors(head, x, x_blocks):
    """The metric-bins head up to its last attractor (the seed regressor,
    the projectors and the attractors): the last bin embedding."""
    _, b_prev = head.seed_bin_regressor(x)
    prev = head.seed_projector(x)
    emb = prev
    for proj, attr, xb in zip(head.projectors, head.attractors, x_blocks):
        emb = proj(xb)
        b_prev, _ = attr(emb, b_prev, prev)
        prev = emb
    return emb


def clb_fused(clb, last_cat, b_emb, b_centers):
    """The ConditionalLogBinomial stage as the bf16 head runs it: the clb_pt
    kernel, then the logbinomial_depth kernel (plain twins on the CPU)."""
    from patchfusion_tpu_torch.ops import fused_head

    p, tn = clb.params_pt_fused(last_cat, b_emb)
    return fused_head.logbinomial_depth(p, tn, b_centers.permute(0, 2, 3, 1),
                                        clb.min_temp, clb.max_temp)


def profile(branch_cfg: dict, batch: int = 16,
            dtype: torch.dtype = torch.bfloat16, inner: int = 8,
            device="cuda", stages: str = "all",
            shape: Tuple[int, int] = (392, 518)) -> dict:
    """The module note's rows for a DA-ZoeDepth branch config."""
    from patchfusion_tpu_torch.models.dpt import DPT_CONFIGS
    from patchfusion_tpu_torch.models.zoedepth import DA_OUTPUT_CHANNELS
    from patchfusion_tpu_torch.ops.resize import interpolate_nchw

    want = None if stages == "all" else set(stages.split(","))

    def on(name):
        return want is None or name in want

    device = check_device(device)
    core = branch_cfg["midas_model_type"]
    branch = seeded_branch(branch_cfg, dtype, device)
    dpt = branch.core.core
    head = dpt.depth_head
    peak, peak_label = bu.peak_flops(dtype, device)
    b = batch
    h, w = shape
    ph, pw = h // 14, w // 14
    dcfg = DPT_CONFIGS[core]
    feat = dcfg["features"]
    embed = dpt.pretrained.patch_embed.proj.out_channels
    seed = iter(range(1000))
    rows = []

    def mk(*shape_, normal=True):
        return bu.seeded_input(shape_, device, next(seed), dtype, normal)

    def row(name, fn, *args):
        flops = bu.count_flops(fn, *args)
        t = bu.device_time(fn, *args, inner=inner, device=device)
        rows.append(bu.stage_row(name, t, flops, peak))
        return t

    with torch.no_grad():
        x = bu.seeded_input((b, 3, h, w), device, 0, dtype)
        t_vit = t_dpt = t_zoe = None
        if on("vit"):
            t_vit = row("vit trunk(4 taps)",
                        lambda y: dpt.pretrained(y, n_taps=4), x)
        if on("dpt"):
            t_dpt = row("vit+dpt", dpt, x)
        if on("zoe"):
            t_zoe = row("fine zoe full",
                        lambda y: branch(y)["metric_depth"], x)
        if t_vit and t_dpt and t_zoe:
            rows.append(bu.stage_row("  -> dpt decoder", t_dpt - t_vit))
            rows.append(bu.stage_row("  -> bins head", t_zoe - t_dpt))

        taps = [(mk(b, ph * pw, embed), mk(b, embed)) for _ in range(4)]
        if on("head"):
            row("dpt head (isolated)", lambda t: head(t, ph, pw), taps)
        if on("reassemble"):
            row("  reassemble+rn", lambda t: reassemble(head, t, ph, pw),
                taps)
        hh, hw = (ph + 1) // 2, (pw + 1) // 2
        rn = [mk(b, feat, ph * 4, pw * 4), mk(b, feat, ph * 2, pw * 2),
              mk(b, feat, ph, pw), mk(b, feat, hh, hw)]
        if on("refinenets"):
            row("  refinenet chain", lambda r: refinenets(head.scratch, r),
                rn)
        p1 = mk(b, feat, ph * 8, pw * 8)
        if on("output"):
            row("  output stage",
                lambda z: output_stage(head.scratch, z, (h, w)), p1)
        if on("outputops"):
            half = feat // 2
            wc1, wc2, wc3 = mk(half, feat, 3, 3), mk(32, half, 3, 3), \
                mk(1, 32, 1, 1)
            up_in = mk(b, half, ph * 4, pw * 4)
            full32, fullh = mk(b, 32, h, w), mk(b, half, h, w)

            def conv(z, k):
                return F.conv2d(z, k, padding=k.shape[-1] // 2)

            def up(z):
                return interpolate_nchw(z, (h, w), mode="bilinear",
                                        align_corners=True)

            def tail(z):
                y = F.relu(conv(up(z), wc2))
                return F.relu(conv(y, wc3))

            row("    conv f->f/2 @224x296", conv, p1, wc1)
            row("    upsample f/2 ->full", up, up_in)
            row("    conv f/2->32 @full", conv, fullh, wc2)
            row("    relu+1x1 conv @full",
                lambda z, k: F.relu(conv(F.relu(z), k)), full32, wc3)
            row("    up+convs tail", tail, up_in)

        if on("bins") or on("attr") or on("clb"):
            c = DA_OUTPUT_CHANNELS[core]
            xd0 = mk(b, c, hh, hw)
            x_blocks = [mk(b, feat, ph * 2 ** i, pw * 2 ** i)
                        for i in range(4)]
            last, rel = mk(b, 32, h, w), mk(b, 1, h, w)
            if on("bins"):
                row("bins head (isolated)",
                    lambda z: branch.head_forward(z, x_blocks, last,
                                                  rel)["metric_depth"], xd0)
            if on("attr"):
                row("  seed+attractors",
                    lambda z: seed_attractors(branch, z, x_blocks), xd0)
            if on("clb"):
                clb = branch.conditional_log_binomial
                b_emb = mk(b, branch_cfg["bin_embedding_dim"], ph * 8,
                           pw * 8)
                b_centers = mk(b, branch_cfg["n_bins"], ph * 8,
                               pw * 8).abs() + 0.01
                row("  clb+logbinom (fused)",
                    lambda z: clb_fused(clb, z, b_emb, b_centers),
                    mk(b, 33, h, w))
    return bu.emit(TOOL, device, rows, peak=peak_label, batch=b,
                   dtype=str(dtype))


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--core", default="vitl")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--inner", type=int, default=8)
    ap.add_argument("--dtype", default="bf16", choices=sorted(bu.DTYPES))
    ap.add_argument("--stages", default="all",
                    help="comma list of " + ",".join(STAGES)
                    + " (default all)")
    bu.add_device_arg(ap)
    args = ap.parse_args(argv)
    return profile(bu.published_config(args.core)["fine_branch"],
                   args.batch, bu.DTYPES[args.dtype], args.inner,
                   args.device, args.stages)


if __name__ == "__main__":
    main()
