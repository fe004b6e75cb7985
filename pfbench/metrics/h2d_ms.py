"""h2d_ms: milliseconds per request of the images' copies to the card,
the program's `pf.h2d` spans (`PatchFusionInference._to_device`, one for
the process-resolution image and one for the 4K one): the device interval
from the stream reaching each copy to its end, pageable staging included,
summed over the request; the median over the traced window's requests
(`pfbench/program_spans.py`)."""

from pfbench import program_spans

program_spans.begin()


def read(run):
    return program_spans.median_ms("pf.h2d")
