"""mfu_pct: the whole request's share of the card's bf16 peak: the
matmul and convolution FLOPs of one request, counted by FlopCounterMode
over the benchmark's frozen reference (the configuration's own
reference module, `spec.reference`) at the cell's shapes on the `meta`
device, over the request's seconds (the traced window's requests
together: the window less what the harness does between them, such as
closing the profiled stretch) and 989 TFLOP/s. The count belongs to the
model and the mode, not to how the program computes them, so a later
change to the program cannot move it."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from pfbench.peaks import BF16_TC_FLOPS
from pfbench.reference import engine


def flops_per_request(config, mode: str) -> int:
    """The FLOPs of one request of `mode` on the configuration file
    `config`."""
    tiles = engine.Tiles(config["model"])
    with torch.device("meta"):
        net = engine.network(config)
    lr = torch.empty((1, *tiles.process, 3), device="meta")
    hr = torch.empty((*tiles.raw, 3), device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        engine.infer(net, tiles, lr, hr, mode, block=tiles.count(mode))
    return counter.get_total_flops()


def read(run):
    if not run.cuda or not run.latencies_s:
        return None
    flops = flops_per_request(run.cell.config, run.cell.traffic["mode"])
    rate = flops * len(run.latencies_s) / sum(run.latencies_s)
    return 100.0 * rate / BF16_TC_FLOPS
