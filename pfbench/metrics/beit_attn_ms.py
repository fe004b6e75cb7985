"""beit_attn_ms: milliseconds per request of BEiT's attention core, the
program's `pf.beit_attn` spans (each `BeitAttention` of both branches,
from obtaining the relative-position bias through P.V; the qkv and output
projections lie outside): device time summed over the request's blocks
and passes; the median over the traced window's requests
(`pfbench/program_spans.py`). A program without the span reads nothing."""

from pfbench import program_spans

program_spans.begin()


def read(run):
    return program_spans.median_ms("pf.beit_attn")
