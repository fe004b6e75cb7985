"""g2l_ms: milliseconds per request of G2L, the program's `pf.g2l` span
(`PatchFusionNet.attend_coarse` over the whole image's coarse features,
once per image; the rest of `coarse_ms` is `pf.coarse_branch`): device
time; the median over the traced window's requests
(`pfbench/program_spans.py`)."""

from pfbench import program_spans

program_spans.begin()


def read(run):
    return program_spans.median_ms("pf.g2l")
