"""device_idle_pct: the share of the profiled stretch (host clock, whole
requests) in which no kernel and no memcpy ran on the card (the union of
their intervals in the torch.profiler trace)."""


def read(run):
    if run.profile is None or not run.cuda:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["window_s"])
