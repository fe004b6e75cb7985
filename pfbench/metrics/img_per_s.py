"""img_per_s: requests completed in the window over the window's seconds,
from the first call to the end of the last request (host clock): all the
work over all the time."""


def read(run):
    return len(run.latencies_s) / run.window_s if run.latencies_s else None
