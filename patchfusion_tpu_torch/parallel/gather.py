"""Cross-process metric gathering (patchfusion_tpu/parallel/gather.py; the
reference's `collect_results_gpu`, estimator/tester/tester.py:93,
trainer.py:193): every eval rank holds a ragged list of per-image metric
dicts, and the concatenation must reach every rank before
`dataset.evaluate`.

The JAX package packs the dicts into fixed-key float arrays because its
collectives move arrays; here `all_gather_object` moves each rank's list
as it is (pickled, over the CPU under gloo, over the rank's current card
under nccl, which torch.cuda.set_device must have chosen:
parallel/dist.device_for_rank). The semantics are the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

from patchfusion_tpu_torch.parallel.dist import world_size


def gather_metric_dicts(results: List[Dict[str, float]],
                        keys: Optional[Sequence[str]] = None,
                        size: Optional[int] = None
                        ) -> List[Dict[str, float]]:
    """-> every rank's `results`, concatenated rank-major, on every rank.
    With one process, `results` itself (trimmed to `size`).

    keys: the metric names every dict gets, in this order; by default the
    union of every rank's keys, sorted, so a rank with no results still
    takes part. A metric a dict lacks (or holds as None) becomes NaN, as
    pre_eval_to_metrics' nanmean expects (data/u4k.py).

    size: the dataset's length: sample-major order (rank r's i-th result
    is global index i * world + r under ShardedSampler's strided split),
    trimmed to `size`, which drops the sampler's wraparound duplicates."""
    if world_size() == 1:
        return results[:size] if size is not None else results
    per_rank: List[List[Dict[str, float]]] = [None] * world_size()
    dist.all_gather_object(per_rank, results)
    if keys is None:
        keys = sorted({k for part in per_rank for r in part for k in r})

    def pack(r):
        return {k: float("nan") if r.get(k) is None else float(r[k])
                for k in keys}

    if size is None:
        return [pack(r) for part in per_rank for r in part]
    out: List[Dict[str, float]] = []
    for i in range(max(len(part) for part in per_rank)):
        for part in per_rank:
            if i < len(part) and len(out) < size:
                out.append(pack(part[i]))
    return out
