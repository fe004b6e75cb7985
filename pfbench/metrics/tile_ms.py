"""tile_ms: device milliseconds per tile of the per-chunk work (ROI-align
of the coarse context, the fine branch, the fusion convs, the U-Net and
the PF head: `PatchFusionNet.coarse_postprocess` + `infer_tiles`), between
CUDA events around each call, summed over a request and divided by its
tiles; the median over the traced window's requests."""

import statistics

SPANS = {"tile": ["net.coarse_postprocess", "net.infer_tiles"]}


def read(run):
    ms = [s["tile"] / run.tiles_per_request for s in run.spans if "tile" in s]
    return statistics.median(ms) if ms else None
