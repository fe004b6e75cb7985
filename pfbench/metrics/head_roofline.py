"""head_roofline: the hand-written metric-bins head kernels against their
roofline: the summed bound of every call of their wrappers in the traced
window over the device time of those calls (CUDA events around each,
`spans.py`). The wrappers are the module-level entries of the program's
`ops/fused_head`: `clb_pt` and `logbinomial_depth`, which the bf16 head of
both branches and of the fusion net calls in turn, and
`clb_logbinomial_depth`, which does both in one launch where the program
takes that path. Nothing else of the head (the seed and attractor MLPs,
the upsamples) is timed.

Each call's bound (copied from the program's `tools/_bench_util.
head_bounds`): every input read once and every output written once, the
MLP's products at the bf16 tensor-core rate with the condition projected
at its low resolution, about 16 f32 operations per pixel and bin of the
log-binomial softmax. The activations and centers are counted at two
bytes (bf16), p and t at four, so a wider input only lowers the share."""

from pfbench.peaks import bound_s

FUSED_HEAD = "patchfusion_tpu_torch.ops.fused_head"
KERNELS = ("clb_pt", "logbinomial_depth", "clb_logbinomial_depth")
RANGES = {k: [f"{FUSED_HEAD}:{k}"] for k in KERNELS}
ITEMSIZE = 2  # bf16


def clb_mlp_flops(hi, lo, cin, cc, hid) -> int:
    """The MLP's products over `hi` output and `lo` condition pixels."""
    return 2 * hid * (cin * hi + cc * lo) + 2 * hid * 4 * hi


def clb_pt_bound_s(last_cat, cond_lo, w1) -> float:
    """last_cat (B, OH, OW, Cin), cond_lo (B, IH, IW, Cc), w1 (Cin + Cc,
    hidden); p and t written in f32."""
    b, oh, ow, cin = last_cat
    _, ih, iw, cc = cond_lo
    hi, lo = b * oh * ow, b * ih * iw
    return bound_s(ITEMSIZE * (cin * hi + cc * lo) + 8 * hi,
                   clb_mlp_flops(hi, lo, cin, cc, w1[1]))


def logbinomial_depth_bound_s(p, centers) -> float:
    """p and t (B, OH, OW) f32, centers (B, IH, IW, K); depth in f32."""
    b, oh, ow = p
    _, ih, iw, k = centers
    hi, lo = b * oh * ow, b * ih * iw
    return bound_s(8 * hi + ITEMSIZE * k * lo + 4 * hi, 0, 16 * k * hi)


def clb_logbinomial_depth_bound_s(last_cat, cond_lo, centers, w1) -> float:
    b, oh, ow, cin = last_cat
    _, ih, iw, cc = cond_lo
    k = centers[3]
    hi, lo = b * oh * ow, b * ih * iw
    return bound_s(ITEMSIZE * (cin * hi + (cc + k) * lo) + 4 * hi,
                   clb_mlp_flops(hi, lo, cin, cc, w1[1]), 16 * k * hi)


def call_bound_s(kernel: str, args) -> float:
    if kernel == "clb_pt":
        return clb_pt_bound_s(args[0], args[1], args[2])
    if kernel == "logbinomial_depth":
        return logbinomial_depth_bound_s(args[0], args[2])
    return clb_logbinomial_depth_bound_s(*args[:4])


def read(run):
    device_ms = sum(s.get(k, 0.0) for s in run.spans for k in KERNELS)
    calls = [(k, a) for k in KERNELS for a in run.calls.get(k, [])]
    if not run.cuda or device_ms <= 0 or not calls:
        return None
    total = sum(call_bound_s(k, a) for k, a in calls)
    return 100.0 * total / (device_ms / 1e3)
