"""warm_request_ms: host milliseconds of the warm request, the run's first
(`api.PatchFusion.infer` in set-up, before the window: the kernels' load
or build, cuDNN's and cuBLAS's first calls at the cell's shapes): its
`pf.request` span, whose children split it (`pfbench/program_spans.py`)."""

from pfbench import program_spans

program_spans.begin()


def read(run):
    rec = program_spans.warm()
    if rec is None:
        return None
    return program_spans.host_ms(rec["spans"][0])
