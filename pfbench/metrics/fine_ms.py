"""fine_ms: milliseconds per tile of the fine branch, the program's
`pf.fine` spans (the fine ZoeDepth pass inside `PatchFusionNet.
infer_tiles`, once per chunk; the rest of `tile_ms` is `pf.roi` and
`pf.fusion`): device time summed over a request's chunks and divided by
its `tiles` counter; the median over the traced window's requests
(`pfbench/program_spans.py`)."""

from pfbench import program_spans

program_spans.begin()


def read(run):
    return program_spans.median_ms("pf.fine", per="tiles")
