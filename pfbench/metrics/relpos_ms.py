"""relpos_ms: milliseconds per request of obtaining BEiT's (H, N, N)
relative-position bias, the program's `pf.relpos` spans inside each
`pf.beit_attn` (the table's gather today; whatever obtains the bias after
a later change, so that a cache reads near 0): device time summed over
the request; the median over the traced window's requests
(`pfbench/program_spans.py`). A program without the span reads
nothing."""

from pfbench import program_spans

program_spans.begin()


def read(run):
    return program_spans.median_ms("pf.relpos")
