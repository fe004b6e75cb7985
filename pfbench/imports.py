"""The check that no JAX, and nothing of the JAX package, is loaded in the
process: the top-level name of every module in `sys.modules` (the part
before the first dot), compared whole, since the port's own name
`patchfusion_tpu_torch` begins with the JAX package's."""

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "patchfusion_tpu")


def forbidden_loaded() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))
