"""setup_s: from the start of the run to the start of the window (host
clock): imports, the kernels' build or load, the network and its weights
on the card, the image pool and one warm request."""


def read(run):
    return run.setup_s
