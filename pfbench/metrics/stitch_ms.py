"""stitch_ms: milliseconds per request of the stitch, the program's
`pf.stitch` spans (`PatchFusionInference._image_stream`: the blend mask's
upload, the passes' canvases and the running average; rN's raw-resolution
pastes): device time, summed over the request; the median over the traced
window's requests (`pfbench/program_spans.py`)."""

from pfbench import program_spans

program_spans.begin()


def read(run):
    return program_spans.median_ms("pf.stitch")
