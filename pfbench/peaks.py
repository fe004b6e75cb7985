"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the roofline bound: the least
time the card could take for a piece of work (copied from the program's
`tools/_bench_util.bound`)."""

HBM_BYTES_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12


def bound_s(nbytes: float, tc_flops: float = 0.0, f32_ops: float = 0.0
            ) -> float:
    """The larger of the bytes over HBM bandwidth and the operations over
    their peak: tensor-core FLOPs at the bf16 rate, other f32 operations at
    the f32 rate."""
    return max(nbytes / HBM_BYTES_S, tc_flops / BF16_TC_FLOPS,
               f32_ops / F32_FLOPS)
