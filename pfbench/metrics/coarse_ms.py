"""coarse_ms: device milliseconds per request of the coarse branch and G2L
(`PatchFusionNet.coarse_forward` + `attend_coarse`, once per image), between
CUDA events around the two calls; the median over the traced window's
requests."""

import statistics

SPANS = {"coarse": ["net.coarse_forward", "net.attend_coarse"]}


def read(run):
    ms = [s["coarse"] for s in run.spans if "coarse" in s]
    return statistics.median(ms) if ms else None
