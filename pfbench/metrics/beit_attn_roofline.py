"""beit_attn_roofline: BEiT's attention core (`pf.beit_attn`, read by
`beit_attn_ms`) against its roofline: a request's bound over the device
time of its `pf.beit_attn` spans; the median over the traced window's
requests (`pfbench/program_spans.py`).

The bound counts only what any implementation must do, so that the share
reads the same work whatever computes it: q, k and v read and o written
once in bf16; QK^T and PV at the bf16 tensor-core rate (the bf16
operands' f32 products with f32 sums are what the tensor cores give);
about seven f32 operations a score (scale, bias add, max, exp, sum,
divide); nothing for the (H, N, N) bias, which a kernel can compute in
place from the small table. It is taken from the program's counter
`beit_attn_seqs` (the summed batch of the request's attention calls) with
N, H and Dh from the configuration; every term is linear in the batch, so
the request's bound is the bound at its summed batch. A program without
the counter or the span, and a run off the card, read nothing."""

import statistics

from pfbench import program_spans
from pfbench.peaks import bound_s
from pfbench.reference.beit import BEIT_CONFIGS, process_grid

F32_OPS_PER_SCORE = 7

program_spans.begin()


def attention_bound_s(b: int, n: int, h: int, dh: int) -> float:
    """The bound of attention over `b` sequences of `n` tokens, `h` heads
    of `dh`."""
    return bound_s(4 * b * n * h * dh * 2, 4 * b * h * n * n * dh,
                   F32_OPS_PER_SCORE * b * h * n * n)


def attention_shape(model_config):
    """(N, H, Dh) of the configuration's BEiT attention."""
    gh, gw = process_grid(model_config)
    vit = BEIT_CONFIGS[model_config["fine_branch"]["midas_model_type"]]
    return (1 + gh * gw, vit["num_heads"],
            vit["embed_dim"] // vit["num_heads"])


def read(run):
    if not run.cuda:
        return None
    n, h, dh = attention_shape(run.cell.model)
    shares = []
    for rec in program_spans.window():
        ms = program_spans.total_ms(rec, "pf.beit_attn")
        seqs = rec["counters"].get("beit_attn_seqs", 0)
        if ms and seqs:
            shares.append(100.0 * attention_bound_s(seqs, n, h, dh)
                          / (ms / 1e3))
    return statistics.median(shares) if shares else None
