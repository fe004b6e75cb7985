"""peak_mem_gib: the device allocator's peak (`max_memory_allocated`) over
set-up, its warm request and the window, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.cuda else None
