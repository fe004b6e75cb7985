"""attn_roofline: the DINOv2 attention core (`models/dinov2.
fused_attention`, whatever it dispatches to) against its roofline: the
summed bound of every call in the traced window over the device time of
those calls (CUDA events around each, `spans.py`). The bound (copied from
the program's `tools/_bench_util.attention_bound`) reads q, k and v and writes
o once in bf16, counts QK^T and PV at the bf16 tensor-core rate and about
six f32 operations per score, so it is the same whether the einsum path or
the attention kernel does the work. BENCHMARK.json lists the cells it is
read in, those of a DINOv2 backbone: a cell of another backbone makes no
such call."""

from pfbench.peaks import bound_s

RANGES = {"attn": ["patchfusion_tpu_torch.models.dinov2:fused_attention"]}


def attention_bound_s(b: int, n: int, h: int, dh: int) -> float:
    return bound_s(4 * b * n * h * dh * 2, 4 * b * h * n * n * dh,
                   6 * b * h * n * n)


def read(run):
    device_ms = sum(s.get("attn", 0.0) for s in run.spans)
    calls = run.calls.get("attn", [])
    if not run.cuda or device_ms <= 0 or not calls:
        return None
    bound = sum(attention_bound_s(*q) for q, _k, _v in calls)
    return 100.0 * bound / (device_ms / 1e3)
