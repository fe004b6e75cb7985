"""The BEiT cell `beit-p49` (configuration `zoe-beitl`, reference module
pfbench/reference/beit.py): the metrics it reports, its three readers of
the program's BEiT spans on synthetic records (nothing read where the
program has no such span, as the parent's traced run), the roofline's
bound by hand, the FLOP count pinned, the published u4k spec drawn with
the module's hooks, and a tiny BEiT cell run to `correct` on the CPU."""

import copy
import math

import pytest
import torch

from pfbench import harness, program_spans, spec, weights
from pfbench.reference import beit as ref_beit

SEED = 2 ** 31 + 41
NEW = ("beit_attn_ms", "relpos_ms", "beit_attn_roofline")
# mfu_pct.flops_per_request of beit-p49: matmul and conv FLOPs of one m2
# request of 49 tiles, counted on the reference on the meta device
FLOPS = 161504124665856


def test_cell_reports_its_metrics_and_not_dinov2_attention():
    cell = spec.load_cell("beit-p49")
    assert cell.reference.__file__ == str(spec.HERE / "reference" / "beit.py")
    assert {m["name"] for m in cell.end_to_end} == {
        "img_per_s", "peak_mem_gib", "setup_s"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert set(NEW) <= per_layer
    assert "attn_roofline" not in per_layer
    assert not any(name.endswith(".tail") for name in per_layer)
    assert {"engine_self_ms", "coarse_ms", "tile_ms", "head_roofline",
            "mfu_pct", "device_idle_pct", "h2d_ms", "stitch_ms", "g2l_ms",
            "fine_ms", "warm_request_ms"} <= per_layer
    # the DA cells read none of the three
    for other in ("davitl-p49", "davits-p16", "davitl-p16", "davits-p49"):
        assert not set(NEW) & {m["name"] for m in
                               spec.load_cell(other).per_layer}


# --- the readers on synthetic records ---------------------------------------

def span(name, parent, dev_ms, start=0.0):
    return {"name": name, "parent": parent, "host_start_ms": start,
            "host_end_ms": start + dev_ms + 0.5, "dev_start_ms": start,
            "dev_end_ms": start + dev_ms}


def record(i, scale, beit=True, seqs=1200):
    """A request whose attention spans take 3 ms (relpos 1 ms inside) per
    call, two calls, times `scale`; without `beit`, as the parent's."""
    spans = [span("pf.request", -1, 1000.0 * scale),
             span("pf.coarse_branch", 0, 100.0 * scale)]
    counters = {"tiles": 49}
    if beit:
        for k in range(2):
            spans.append(span("pf.beit_attn", 1, 3.0 * scale, 10.0 * k))
            spans.append(span("pf.relpos", len(spans) - 1, 1.0 * scale,
                              10.0 * k))
        counters.update(beit_attn=2, beit_attn_seqs=seqs,
                        relpos_bytes=2 * 16 * 769 * 769 * 4)
    return {"id": i, "device": "cuda:0", "failed": False, "t0_s": float(i),
            "spans": spans, "counters": counters}


def run_record(cuda=True):
    cell = spec.load_cell("beit-p49")
    return harness.Record(cell=cell, cuda=cuda, setup_s=15.0,
                          latencies_s=[1.2] * 3, window_s=3.6,
                          peak_bytes=0, tiles_per_request=49, spans=[],
                          calls={})


def read(name, records, monkeypatch, cuda=True):
    mod = spec.reader(name)
    monkeypatch.setattr(program_spans, "records", lambda: records)
    return mod.read(run_record(cuda))


def test_span_readers_sum_a_request_and_take_the_window_median(monkeypatch):
    # the warm request 10x slower; the window's three at 1x, 2x, 3x
    recs = [record(0, 10.0)] + [record(i, float(i)) for i in (1, 2, 3)]
    assert read("beit_attn_ms", recs, monkeypatch) == pytest.approx(12.0)
    assert read("relpos_ms", recs, monkeypatch) == pytest.approx(4.0)
    bound = spec.reader("beit_attn_roofline").attention_bound_s(
        1200, 769, 16, 64)
    assert read("beit_attn_roofline", recs, monkeypatch) == pytest.approx(
        100.0 * bound / 12e-3)


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_the_spans(name, monkeypatch):
    # the parent's traced run: records, but no BEiT span or counter
    parent = [record(0, 1.0, beit=False), record(1, 1.0, beit=False)]
    assert read(name, parent, monkeypatch) is None
    assert read(name, [], monkeypatch) is None
    assert read(name, [record(0, 1.0)], monkeypatch) is None  # warm only


def test_roofline_reads_nothing_off_the_card(monkeypatch):
    recs = [record(0, 1.0), record(1, 1.0)]
    assert read("beit_attn_roofline", recs, monkeypatch, cuda=False) is None
    assert read("beit_attn_ms", recs, monkeypatch, cuda=False) == \
        pytest.approx(6.0)


def test_roofline_bound_by_hand():
    mod = spec.reader("beit_attn_roofline")
    assert mod.attention_shape(spec.load_cell("beit-p49").model) == \
        (769, 16, 64)
    # b = 16: 4 b H N^2 Dh = 38,755,434,496 tensor-core FLOPs bound it,
    # against 100,794,368 bytes and 1,059,718,912 f32 operations
    assert mod.attention_bound_s(16, 769, 16, 64) == pytest.approx(
        38755434496 / 989e12, rel=1e-12)
    assert 100794368 / 3.35e12 < 38755434496 / 989e12
    assert 1059718912 / 67e12 < 38755434496 / 989e12
    assert mod.attention_bound_s(1, 769, 16, 64) == pytest.approx(
        38755434496 / 16 / 989e12, rel=1e-12)
    # a request of beit-p49: the coarse image and 49 tiles, 24 blocks each
    assert mod.attention_bound_s(24 * 50, 769, 16, 64) == pytest.approx(
        2.9390e-3, rel=1e-4)


def test_flop_count_is_pinned():
    cell = spec.load_cell("beit-p49")
    assert spec.reader("mfu_pct").flops_per_request(
        cell.config, cell.traffic["mode"]) == FLOPS


# --- the weights -------------------------------------------------------------

def test_published_spec_draws_with_the_modules_hooks():
    from patchfusion_tpu_torch.models.builder import build_patchfusion

    cell = spec.load_cell("beit-p49")
    net, _ = build_patchfusion(cell.model, dtype=torch.bfloat16,
                               device="meta")
    wspec = weights.spec(net)
    rules, fixed = weights.plan(wspec, cell.reference, cell.model)
    assert len(rules) + len(fixed) == len(wspec)
    shapes = {k: s for k, s, _ in wspec}
    assert all(tuple(fixed[k].shape) == shapes[k] for k in fixed)
    grids = [k for k in fixed if ".pretrained.model.blocks." in k]
    assert len(grids) == 48
    assert all(torch.equal(fixed[k], fixed[grids[0]]) for k in grids)
    assert fixed[grids[0]].shape == (769, 769)
    assert int(fixed[grids[0]].max()) == 47 * 63 + 2
    tables = [k for k in rules if k.endswith("relative_position_bias_table")]
    assert {rules[k] for k in tables} == {(1.0, 0.0, False)}
    assert any(k.startswith("guided_fusion.") for k in tables)
    for leaf in ("q_bias", "v_bias", "gamma_1", "gamma_2"):
        keys = [k for k in rules if k.endswith("." + leaf)]
        assert len(keys) == 48 and {rules[k] for k in keys} == \
            {ref_beit.LEAF_RULES[leaf]}
    # the structural buffers alone drawn: nothing of the 776 M weights
    buffers = [x for x in wspec if x[0] in fixed]
    got = weights.make(buffers, SEED, "cpu", cell.reference, cell.model)
    assert all(tuple(got[k].shape) == s and got[k].dtype == d
               for k, s, d in buffers)
    assert sum(math.prod(s) for k, s, _ in wspec if k in rules) > 770e6


def test_grid_index_is_the_programs():
    from patchfusion_tpu_torch.models import beit

    for grid in ((4, 6), (24, 32), (3, 5)):
        assert (ref_beit.grid_index(*grid)
                == beit.relative_position_index(*grid)).all()


# --- a tiny BEiT cell --------------------------------------------------------

def tiny_beit_cell():
    import chip_smoke

    cell = copy.deepcopy(spec.load_cell("beit-p49"))
    cell.config["model"] = chip_smoke.tiny_zoe_config()
    cell.traffic.update(process_num=2, image_shape=[128, 192])
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_beit_cell_runs_to_correct(trace):
    from patchfusion_tpu_torch.utils import profiling

    try:
        result = harness.run_cell(tiny_beit_cell(), SEED, 1.0, trace, "cpu",
                                  0.0)
    finally:
        profiling.disable()
        profiling.clear()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    if trace:
        got = result["metrics"]
        # host times on the CPU; no roofline off the card
        assert got["beit_attn_ms"]["value"] > got["relpos_ms"]["value"] > 0
        assert "beit_attn_roofline" not in got
        assert "attn_roofline" not in got
