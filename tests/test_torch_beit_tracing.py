"""The span tracer (utils/profiling) on the port's BEiT attention, at the toy
zoedepth config on the CPU (BEiT_tiny: 4 blocks, 4 heads of 16, a 4 x 6
grid, so 25 tokens): each BeitAttention's core is one `pf.beit_attn` span
with one `pf.relpos` span inside it, inside its branch's pass; the
counters `beit_attn`, `beit_attn_seqs` and `relpos_bytes` are what the
shapes give; the depth is the same bit for bit with the tracer on and off;
off, the spans are the shared null one."""

import numpy as np
import pytest
import torch

import chip_smoke
from patchfusion_tpu_torch.api import PatchFusion
from patchfusion_tpu_torch.utils import profiling

torch.set_num_threads(2)

PROCESS_NUM = 2
DEPTH, HEADS, TOKENS = 4, 4, 1 + 4 * 6
# the 128x192 image in 2 x 2 tiles of 64x96; m2 adds 2 + 2 + 1 shifted
TILES = {"m1": 4, "m2": 9}
CHUNKS = {"m1": 2, "m2": 5}


@pytest.fixture(autouse=True)
def tracer_off():
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


@pytest.fixture(scope="module")
def models():
    return {dt: PatchFusion.from_config(chip_smoke.tiny_zoe_config(),
                                        device="cpu", dtype=dt, seed=0)
            for dt in (torch.float32, torch.bfloat16)}


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(8)
    return (rng.random((1, 64, 96, 3), dtype=np.float32),
            rng.random((128, 192, 3), dtype=np.float32))


def infer(model, images, mode):
    lr, hr = images
    return model.infer(lr, hr, cai_mode=mode, process_num=PROCESS_NUM)


def one_record(model, images, mode):
    profiling.enable()
    depth = infer(model, images, mode)
    (rec,) = profiling.records()
    return rec, depth


@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_one_beit_attn_span_a_block_a_pass_with_relpos_inside(
        models, images, mode):
    rec, _ = one_record(models[torch.float32], images, mode)
    spans = rec["spans"]
    names = [s["name"] for s in spans]
    # the coarse pass and each chunk's fine pass run every block once
    assert names.count("pf.beit_attn") == DEPTH * (1 + CHUNKS[mode])
    assert names.count("pf.relpos") == names.count("pf.beit_attn")
    for i, s in enumerate(spans):
        if s["name"] == "pf.relpos":
            parent = spans[s["parent"]]
            assert parent["name"] == "pf.beit_attn"
            assert parent["host_start_ms"] <= s["host_start_ms"] \
                <= s["host_end_ms"] <= parent["host_end_ms"]
            # one bias for one attention core
            assert [t["parent"] for t in spans].count(s["parent"]) == 1
        if s["name"] == "pf.beit_attn":
            assert spans[s["parent"]]["name"] in ("pf.coarse_branch",
                                                  "pf.fine")
            assert s["dev_start_ms"] is None  # host times on the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["m1", "m2"])
def test_counters_are_what_the_shapes_give(models, images, mode, dtype):
    rec, _ = one_record(models[dtype], images, mode)
    c = rec["counters"]
    calls = DEPTH * (1 + CHUNKS[mode])
    assert c["beit_attn"] == calls
    # the coarse pass's one image and every tile, through every block
    assert c["beit_attn_seqs"] == DEPTH * (1 + TILES[mode])
    # an (H, N, N) float32 bias a call, in either dtype
    assert c["relpos_bytes"] == calls * HEADS * TOKENS * TOKENS * 4


def test_depth_bit_identical_with_the_tracer_on_and_off(models, images):
    model = models[torch.bfloat16]
    off = infer(model, images, "m2")
    assert profiling.records() == []
    profiling.enable()
    on = infer(model, images, "m2")
    assert np.array_equal(off, on) and len(profiling.records()) == 1


def test_off_the_spans_are_the_shared_null_one():
    assert not profiling.enabled()
    assert profiling.span("beit_attn") is profiling.span("relpos")
    profiling.enable()
    # on, but outside a request: still the null one, nothing counted
    assert profiling.span("beit_attn") is profiling.span("relpos")
    profiling.count("beit_attn_seqs", 16)
    assert profiling.records() == []
