"""Middlebury PFM disparity reader (a copy of patchfusion_tpu/data/pfm.py;
reference estimator/datasets/utils.py:4-48 readPFM behavior: header
'PF'/'Pf', dims line, scale line whose sign encodes endianness, rows stored
bottom-up)."""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np


def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline()
        while dims.startswith(b"#"):
            dims = f.readline()
        m = re.match(rb"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = data.reshape(shape)
    return np.flipud(data), scale
