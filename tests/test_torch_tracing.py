"""The port's span tracer (patchfusion_tpu_torch/utils/profiling.py) on the
CPU at the engine tests' tiny size: off it is one shared null object and
leaves no record; on, each request through the api leaves one record with
the span tree of its layers, its counters and its launch counts, and the
depth is the same bit for bit. Plus the record store's bound, a failed
request, the trace() exporter, and profile_request's span table and idle
split."""

import json
import math

import numpy as np
import pytest
import torch

import chip_smoke
from patchfusion_tpu_torch import profile_request
from patchfusion_tpu_torch.api import BaselinePretrain, PatchFusion
from patchfusion_tpu_torch.utils import profiling

torch.set_num_threads(2)

PROCESS_NUM = 2
# the tiny config: an 84x112 image in 2x2 tiles; m2 adds 2 + 2 + 1
# half-shifted tiles; r4 at process_num 2 adds 4 random tiles in 2 groups
TILES = {"m1": 4, "m2": 9, "r4": 13}
CHUNKS = {"m1": 2, "m2": 5, "r4": 7}
# each span's parent
PARENTS = {
    "pf.h2d": {"pf.request"}, "pf.coarse": {"pf.request"},
    "pf.coarse_branch": {"pf.coarse"}, "pf.g2l": {"pf.coarse"},
    "pf.crop": {"pf.request"}, "pf.chunk": {"pf.request"},
    "pf.roi": {"pf.chunk"}, "pf.fine": {"pf.chunk"},
    "pf.fusion": {"pf.chunk"}, "pf.stitch": {"pf.request"},
    "pf.d2h": {"pf.request"}, "pf.attn": {"pf.coarse_branch", "pf.fine"},
    "pf.head.clb_pt": {"pf.coarse_branch", "pf.fine", "pf.fusion"},
    "pf.head.logbinomial_depth": {"pf.coarse_branch", "pf.fine",
                                  "pf.fusion"},
}


@pytest.fixture(autouse=True)
def tracer_off():
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


@pytest.fixture(scope="module")
def model():
    return PatchFusion.from_config(chip_smoke.tiny_config(), device="cpu",
                                   seed=0)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    return (rng.random((1, 42, 56, 3), dtype=np.float32),
            rng.random((84, 112, 3), dtype=np.float32))


def infer(model, images, mode):
    lr, hr = images
    return model.infer(lr, hr, cai_mode=mode, process_num=PROCESS_NUM,
                       rng=np.random.default_rng(5))


def one_record(model, images, mode):
    profiling.enable()
    depth = infer(model, images, mode)
    (rec,) = profiling.records()
    return rec, depth


def check_tree(rec):
    spans = rec["spans"]
    assert spans[0]["name"] == "pf.request" and spans[0]["parent"] == -1
    for s in spans[1:]:
        parent = spans[s["parent"]]
        assert parent["name"] in PARENTS[s["name"]], (s, parent)
        # a child's host interval lies in its parent's
        assert parent["host_start_ms"] <= s["host_start_ms"] \
            <= s["host_end_ms"] <= parent["host_end_ms"]
        assert s["dev_start_ms"] is None and s["dev_end_ms"] is None
    return [s["name"] for s in spans]


def test_off_span_is_one_shared_null_object(model, images):
    assert not profiling.enabled()
    null = profiling.span("h2d")
    assert all(profiling.span(n) is null
               for n in ("coarse", "chunk", "anything"))
    assert profiling.request("cpu") is null
    with null, null:  # reentrant, records nothing
        profiling.count("tiles", 3)
    infer(model, images, "m1")
    assert profiling.records() == [] and profiling.dropped() == 0


def test_on_outside_a_request_records_nothing():
    profiling.enable()
    assert profiling.span("crop") is profiling.span("roi")
    with profiling.span("crop"):
        profiling.count("tiles")
    assert profiling.records() == []


@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_request_leaves_one_record_with_the_span_tree(model, images, mode):
    rec, _ = one_record(model, images, mode)
    names = check_tree(rec)
    assert isinstance(rec["id"], int) and rec["device"] == "cpu"
    assert rec["failed"] is False and rec["t0_s"] > 0
    assert names[1:4] == ["pf.h2d", "pf.coarse", "pf.coarse_branch"]
    assert names[-1] == "pf.d2h"
    want = {"pf.request": 1, "pf.h2d": 2, "pf.coarse": 1,
            "pf.coarse_branch": 1, "pf.g2l": 1, "pf.crop": 1,
            "pf.chunk": CHUNKS[mode], "pf.roi": CHUNKS[mode],
            "pf.fine": CHUNKS[mode], "pf.fusion": CHUNKS[mode],
            "pf.stitch": 2, "pf.d2h": 1}
    assert {n: names.count(n) for n in want} == want
    # DINOv2 attention, once per block: 4 blocks in the coarse pass and in
    # each chunk's fine pass
    assert names.count("pf.attn") == 4 * (1 + CHUNKS[mode])
    # the request's host interval holds every other
    root = rec["spans"][0]
    assert root["host_start_ms"] == 0.0
    assert all(s["host_end_ms"] <= root["host_end_ms"]
               for s in rec["spans"])


@pytest.mark.parametrize("mode", ["m1", "m2", "r4"])
def test_tile_chunk_and_byte_counters(model, images, mode):
    rec, depth = one_record(model, images, mode)
    c = rec["counters"]
    assert c["tiles"] == TILES[mode]
    assert c["chunks"] == CHUNKS[mode]
    if mode != "r4":
        assert c["chunks"] == math.ceil(TILES[mode] / PROCESS_NUM)
    # the two images' float32 copies in, the depth's out
    assert c["h2d_bytes"] == (42 * 56 + 84 * 112) * 3 * 4
    assert c["d2h_bytes"] == depth.nbytes


def test_launch_counters_are_zero_on_cpu_twins(model, images):
    rec, _ = one_record(model, images, "m1")
    launches = {k: v for k, v in rec["counters"].items()
                if k.startswith("launches.")}
    assert set(launches) == {
        "launches.clb_pt", "launches.logbinomial_depth",
        "launches.logbinomial_depth_pixel",
        "launches.clb_logbinomial_depth", "launches.vit_attention",
        "launches.resize_bilinear", "launches.resize_bicubic"}
    assert set(launches.values()) == {0}


@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_record_carries_the_resize_kernel_counters(model, images, mode):
    """Each record counts the resize kernel's launches by mode (0 on the
    CPU, where the plain version runs), whatever the request's mode."""
    rec, _ = one_record(model, images, mode)
    for name in ("resize_bilinear", "resize_bicubic"):
        assert rec["counters"]["launches." + name] == 0


def test_depth_bit_identical_with_the_tracer_on_and_off(model, images):
    off = infer(model, images, "m2")
    profiling.enable()
    on = infer(model, images, "m2")
    assert np.array_equal(off, on) and len(profiling.records()) == 1


def test_bf16_head_wrappers_have_spans(images):
    model = PatchFusion.from_config(chip_smoke.tiny_config(), device="cpu",
                                    dtype=torch.bfloat16, seed=0)
    rec, _ = one_record(model, images, "m1")
    names = check_tree(rec)
    # the coarse, fine and PF heads, once each per pass: the coarse pass
    # and the m1 tiles' two chunks
    assert names.count("pf.head.clb_pt") == 1 + 2 * CHUNKS["m1"]
    assert names.count("pf.head.logbinomial_depth") == \
        names.count("pf.head.clb_pt")


def test_fine_only_baseline_pretrain_record(images):
    bp = BaselinePretrain(chip_smoke.tiny_config()["fine_branch"], 1e-3,
                          80.0, target="fine", image_raw_shape=(84, 112),
                          patch_split_num=(2, 2),
                          patch_process_shape=(42, 56), device="cpu")
    profiling.enable()
    lr, hr = images
    bp.infer(lr, hr, cai_mode="m1", process_num=PROCESS_NUM)
    (rec,) = profiling.records()
    names = check_tree(rec)
    assert "pf.coarse" not in names and "pf.roi" not in names
    assert names.count("pf.fine") == names.count("pf.chunk") == 2
    assert rec["counters"]["tiles"] == 4


def test_record_store_is_bounded_and_counts_drops():
    profiling.enable()
    n = profiling.MAX_RECORDS + 2
    for i in range(n):
        with profiling.request("cpu"):
            with profiling.span("crop"):
                profiling.count("tiles", i)
    recs = profiling.records()
    assert len(recs) == profiling.MAX_RECORDS and profiling.dropped() == 2
    assert [r["counters"]["tiles"] for r in recs] == list(range(2, n))
    assert [r["id"] for r in recs] == sorted(r["id"] for r in recs)
    profiling.clear()
    assert profiling.records() == [] and profiling.dropped() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_spans_hold_the_wrapper_calls(images, dtype, monkeypatch):
    """pf.attn and pf.head.<kernel> are host-only spans around the calls of
    the module-level wrappers, so that a wrapper replaced in its module (as
    a profiler of the calls does) runs inside them and no host work of the
    tracer falls between its call and its launches."""
    from patchfusion_tpu_torch.models import dinov2
    from patchfusion_tpu_torch.ops import fused_head

    def probe(module, name):
        orig = getattr(module, name)

        def call(*args, **kwargs):
            with profiling.span("probe." + name):
                return orig(*args, **kwargs)
        monkeypatch.setattr(module, name, call)

    probe(dinov2, "fused_attention")
    for name in ("clb_pt", "logbinomial_depth"):
        probe(fused_head, name)
    model = PatchFusion.from_config(chip_smoke.tiny_config(), device="cpu",
                                    dtype=dtype, seed=0)
    rec, _ = one_record(model, images, "m1")
    spans = rec["spans"]
    probes = [s for s in spans if s["name"].startswith("pf.probe.")]
    parents = {s["name"]: spans[s["parent"]]["name"] for s in probes}
    want = {"pf.probe.fused_attention": "pf.attn"}
    if dtype == torch.bfloat16:  # the fused head runs in bf16 only
        want.update({"pf.probe.clb_pt": "pf.head.clb_pt",
                     "pf.probe.logbinomial_depth":
                         "pf.head.logbinomial_depth"})
    assert parents == want
    n = {name: sum(s["name"] == name for s in spans) for name in want}
    assert n == {name: sum(s["name"] == parent for s in spans)
                 for name, parent in want.items()}


def test_host_only_span_is_recorded_with_host_times():
    profiling.enable()
    with profiling.request("cpu"):
        with profiling.span("outer"):
            with profiling.span("inner", device=False):
                pass
    (rec,) = profiling.records()
    assert [s["name"] for s in rec["spans"]] == [
        "pf.request", "pf.outer", "pf.inner"]
    inner = rec["spans"][2]
    assert inner["parent"] == 1 and inner["dev_start_ms"] is None
    assert 0.0 <= inner["host_start_ms"] <= inner["host_end_ms"]


def test_a_failed_request_is_marked(model, images, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("tile failure")

    profiling.enable()
    monkeypatch.setattr(model.net, "infer_tiles", boom)
    with pytest.raises(RuntimeError, match="tile failure"):
        infer(model, images, "m1")
    monkeypatch.undo()
    (rec,) = profiling.records()
    assert rec["failed"] is True
    names = [s["name"] for s in rec["spans"]]
    assert "pf.chunk" in names and "pf.d2h" not in names
    # the next request opens afresh and completes
    infer(model, images, "m1")
    assert [r["failed"] for r in profiling.records()] == [True, False]


def test_trace_writes_the_chrome_trace_and_the_records(model, images,
                                                       tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        assert profiling.enabled()
        infer(model, images, "m1")
    assert not profiling.enabled()
    (chrome,) = log_dir.glob("*.pt.trace.json")
    events = json.loads(chrome.read_text())["traceEvents"]
    ranges = {e["name"] for e in events
              if e.get("name", "").startswith("pf.")}
    assert {"pf.request", "pf.h2d", "pf.coarse", "pf.g2l", "pf.chunk",
            "pf.fine", "pf.fusion", "pf.stitch", "pf.d2h"} <= ranges
    (spans,) = log_dir.glob("pf_records_*.json")
    saved = json.loads(spans.read_text())
    assert saved["dropped"] == 0 and len(saved["records"]) == 1
    check_tree(saved["records"][0])


def test_profile_request_span_table_and_idle_split(model, images):
    rec, _ = one_record(model, images, "m1")
    rows = profile_request.span_table(rec)
    by = {(r["name"], r["parent"]): r for r in rows}
    assert by[("pf.request", "")]["calls"] == 1
    assert by[("pf.chunk", "pf.request")]["calls"] == CHUNKS["m1"]
    assert by[("pf.attn", "pf.fine")]["calls"] == 4 * CHUNKS["m1"]
    assert all(r["device_ms"] is None and r["lag_ms"] is None for r in rows)
    assert sum(r["calls"] for r in rows) == len(rec["spans"])
    # device intervals (us) with gaps at 10-20 (inside pf.h2d, itself in
    # pf.request), 30-35 (pf.request alone) and 40-50 (no range open)
    device = [("k", 0, 10), ("k", 5, 8), ("k", 20, 30), ("k", 35, 40),
              ("k", 50, 60)]
    ranges = [("pf.request", 0, 36), ("pf.h2d", 9, 19)]
    assert profile_request.idle_by_span(device, ranges) == {
        "outside": 0.01, "pf.h2d": 0.01, "pf.request": 0.005}
    calls = [("cudaMemcpyAsync", 10, 18), ("cudaMemcpyAsync", 20, 21),
             ("cudaStreamSynchronize", 30, 32), ("cudaMemcpyAsync", 40, 41)]
    assert profile_request.blocking_by_span(calls, ranges) == {
        "pf.h2d": {"cudaMemcpyAsync": [1, 0.008]},
        "pf.request": {"cudaMemcpyAsync": [1, 0.001],
                       "cudaStreamSynchronize": [1, 0.002]},
        "outside": {"cudaMemcpyAsync": [1, 0.001]}}
