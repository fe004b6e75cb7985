"""The metrics' arithmetic on synthetic records: the interval union, the
nearest-rank percentile, the roofline bounds, the FLOP count, and each
reader finding what it reads or leaving its metric out."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pfbench import harness, peaks, spec, trace
from pfbench.reference import engine
from pfbench.tiny import tiny_cell


def reader(name):
    return spec.reader(name)


def record(**kw):
    base = dict(cell=tiny_cell(), cuda=True, setup_s=12.5,
                latencies_s=[0.2] * 9 + [0.5], window_s=2.5,
                peak_bytes=3 * 2 ** 30, tiles_per_request=16,
                spans=[{"coarse": 30.0, "tile": 160.0}] * 10, calls={})
    base.update(kw)
    return harness.Record(**base)


def test_interval_union_and_merge():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41)]
    assert trace.busy_us(iv) == 15 + 10 + 1
    assert trace.merged(iv) == [(0, 15), (20, 30), (40, 41)]
    assert trace.busy_us([]) == 0


def test_nearest_rank_p90():
    p90 = reader("latency_p90_ms").nearest_rank
    assert p90(list(range(1, 101)), 0.9) == 90
    assert p90(list(range(1, 11)), 0.9) == 9
    assert p90([5.0], 0.9) == 5.0
    assert p90(list(range(100, 0, -1)), 0.9) == 90


def test_end_to_end_readers():
    r = record()
    assert reader("img_per_s").read(r) == 10 / 2.5
    assert reader("latency_p90_ms").read(r) == pytest.approx(200.0)
    assert reader("peak_mem_gib").read(r) == 3.0
    assert reader("setup_s").read(r) == 12.5
    assert reader("img_per_s").read(record(latencies_s=[])) is None


def test_span_readers():
    r = record()
    assert reader("coarse_ms").read(r) == 30.0
    assert reader("tile_ms").read(r) == 10.0
    assert reader("engine_self_ms").read(r) == pytest.approx(200 - 190)
    assert reader("coarse_ms").read(record(spans=[])) is None


def test_attention_bound():
    mod = reader("attn_roofline")
    b, n, h, dh = 16, 1037, 16, 64
    want = max(4 * b * n * h * dh * 2 / peaks.HBM_BYTES_S,
               4 * b * h * n * n * dh / peaks.BF16_TC_FLOPS,
               6 * b * h * n * n / peaks.F32_FLOPS)
    assert mod.attention_bound_s(b, n, h, dh) == want
    assert want == pytest.approx(7.13e-5, rel=1e-2)  # bound by operations
    calls = {"attn": [[(b, n, h, dh)] * 3] * 2}
    spans = [{"attn": 1e3 * want / 0.25}] * 2
    assert mod.read(record(spans=spans, calls=calls)) == pytest.approx(25)
    assert mod.read(record(calls=calls)) is None
    assert mod.read(record(spans=spans, calls={})) is None
    assert mod.read(record(spans=spans, calls=calls, cuda=False)) is None


def test_head_bound():
    mod = reader("head_roofline")
    # the head kernels at a DA-vitl chunk of 4 tiles: 392x518 from 224x296
    b, oh, ow, ih, iw, k, cin, cc, hid = 4, 392, 518, 224, 296, 64, 33, \
        128, 80
    hi, lo = b * oh * ow, b * ih * iw
    flops = 2 * hid * (cin * hi + cc * lo) + 2 * hid * 4 * hi
    fused = max((2 * (cin * hi + (cc + k) * lo) + 4 * hi) / peaks.HBM_BYTES_S,
                flops / peaks.BF16_TC_FLOPS, 16 * k * hi / peaks.F32_FLOPS)
    x, cond, ctr, w1 = (b, oh, ow, cin), (b, ih, iw, cc), (b, ih, iw, k), \
        (cin + cc, hid)
    pt = (b, oh, ow)
    assert mod.call_bound_s("clb_logbinomial_depth",
                            [x, cond, ctr, w1, (hid,), (hid, 4), (4,)]) \
        == fused
    # PERF.md's kernel table: 0.0382, 0.0130 and 0.0474 ms
    assert fused == pytest.approx(4.74e-5, rel=1e-2)
    clb = mod.call_bound_s("clb_pt", [x, cond, w1, (hid,), (hid, 4), (4,),
                                      None])
    lbd = mod.call_bound_s("logbinomial_depth", [pt, pt, ctr, None, None])
    assert clb == pytest.approx(3.82e-5, rel=1e-2)
    assert lbd == pytest.approx(1.30e-5, rel=1e-2)
    calls = {"clb_pt": [[x, cond, w1, (hid,), (hid, 4), (4,), None]],
             "logbinomial_depth": [[pt, pt, ctr, None, None]]}
    spans = [{"clb_pt": 1e3 * clb / 0.1, "logbinomial_depth": 1e3 * lbd / 0.2}]
    got = mod.read(record(spans=spans, calls=calls))
    assert got == pytest.approx(100 * (clb + lbd) / (clb / 0.1 + lbd / 0.2))
    assert mod.read(record(spans=spans, calls={})) is None
    assert mod.read(record(calls=calls)) is None


def test_idle_share():
    mod = reader("device_idle_pct")
    prof = {"busy_s": 1.5, "window_s": 2.0}
    assert mod.read(record(profile=prof)) == pytest.approx(25.0)
    assert mod.read(record(profile=prof, cuda=False)) is None


def test_flop_count_on_meta_equals_a_real_run():
    """The mfu reader's count on the meta device is the count of the same
    reference run on real tensors."""
    config = tiny_cell().config
    tiles = engine.Tiles(config["model"])
    got = reader("mfu_pct").flops_per_request(config, "m2")
    net = engine.network(config)
    counter = FlopCounterMode(display=False)
    with counter:
        engine.infer(net, tiles, torch.rand(1, *tiles.process, 3),
                     torch.rand(*tiles.raw, 3), "m2", block=5)
    assert got == counter.get_total_flops() > 0
    r = record(cell=tiny_cell())
    want = 100 * got * 10 / 2.3 / peaks.BF16_TC_FLOPS
    assert reader("mfu_pct").read(r) == pytest.approx(want)
    assert math.isfinite(want)
