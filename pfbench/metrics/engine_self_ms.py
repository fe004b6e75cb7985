"""engine_self_ms: milliseconds per request outside the coarse and tile
spans: the request's host-clock time minus the device time of its
`coarse` and `tile` spans. That is the api and the engine: the image's
copy to the card, crop and resize, the stitch, the depth's copy back, and
the host's gaps between them. The median over the traced window's
requests."""

import statistics

SPANS = {"coarse": ["net.coarse_forward", "net.attend_coarse"],
         "tile": ["net.coarse_postprocess", "net.infer_tiles"]}


def read(run):
    ms = [wall * 1e3 - s.get("coarse", 0.0) - s.get("tile", 0.0)
          for wall, s in zip(run.latencies_s, run.spans)]
    return statistics.median(ms) if ms else None
