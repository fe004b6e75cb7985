"""The readers of the program's own spans (`program_spans.py`): each on
synthetic records (the warm request's left out of the window's metrics; a
metric left out where there are no records), and a tiny traced run on the
CPU that yields them, beside an untraced one that leaves the tracer off."""

import importlib

import pytest

from pfbench import harness, program_spans, spec
from pfbench.tiny import tiny_cell
from patchfusion_tpu_torch.utils import profiling

WINDOW = ("h2d_ms", "stitch_ms", "g2l_ms", "fine_ms")


@pytest.fixture(autouse=True)
def tracer_off():
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


def span(name, parent, dev_ms, host_ms=None, start=0.0):
    host = dev_ms if host_ms is None else host_ms
    return {"name": name, "parent": parent, "host_start_ms": start,
            "host_end_ms": start + host, "dev_start_ms": start + 1.0,
            "dev_end_ms": start + 1.0 + dev_ms}


def record(i, scale, device="cuda:0", failed=False, tiles=16):
    """A request of two images' copies (3 and 40 ms x scale), G2L (20),
    two chunks' fine passes (30 and 34), two stitch spans (1 and 5), in a
    request of 500 x scale host ms."""
    spans = [span("pf.request", -1, 500 * scale),
             span("pf.h2d", 0, 3 * scale), span("pf.coarse", 0, 80 * scale),
             span("pf.g2l", 2, 20 * scale), span("pf.h2d", 0, 40 * scale),
             span("pf.stitch", 0, 1 * scale),
             span("pf.chunk", 0, 90 * scale), span("pf.fine", 6, 30 * scale),
             span("pf.chunk", 0, 90 * scale), span("pf.fine", 8, 34 * scale),
             span("pf.stitch", 0, 5 * scale)]
    if device == "cpu":
        for s in spans:
            s["dev_start_ms"] = s["dev_end_ms"] = None
    return {"id": i, "device": device, "failed": failed, "t0_s": float(i),
            "spans": spans, "counters": {"tiles": tiles, "chunks": 2}}


def read(name, records, monkeypatch):
    mod = spec.reader(name)
    monkeypatch.setattr(program_spans, "records", lambda: records)
    return mod.read(None)


def test_window_readers_leave_the_warm_record_out(monkeypatch):
    # the warm request 10x slower; the window's three at 1x, 2x, 3x
    recs = [record(0, 10.0)] + [record(i, float(i)) for i in (1, 2, 3)]
    want = {"h2d_ms": 43 * 2, "stitch_ms": 6 * 2, "g2l_ms": 20 * 2,
            "fine_ms": 64 * 2 / 16}
    for name in WINDOW:
        assert read(name, recs, monkeypatch) == pytest.approx(want[name])
        assert read(name + ".tail", recs, monkeypatch) == \
            pytest.approx(want[name])
    assert read("warm_request_ms", recs, monkeypatch) == pytest.approx(5000)


def test_failed_requests_are_left_out(monkeypatch):
    recs = [record(0, 1.0), record(1, 1.0), record(2, 9.0, failed=True)]
    assert read("g2l_ms", recs, monkeypatch) == pytest.approx(20)


def test_device_time_on_a_card_host_time_on_the_cpu(monkeypatch):
    cuda = [record(0, 1.0), record(1, 1.0)]
    cpu = [record(0, 1.0, "cpu"), record(1, 1.0, "cpu")]
    for recs in (cuda, cpu):
        for s in recs[1]["spans"]:
            s["host_end_ms"] += 7.0  # the host's interval longer
    assert read("g2l_ms", cuda, monkeypatch) == pytest.approx(20)
    assert read("g2l_ms", cpu, monkeypatch) == pytest.approx(27)


@pytest.mark.parametrize("name", WINDOW + ("warm_request_ms",))
def test_a_metric_is_left_out_without_records(name, monkeypatch):
    assert read(name, [], monkeypatch) is None
    # a warm request alone leaves the window empty
    only_warm = read(name, [record(0, 1.0)], monkeypatch)
    assert (only_warm is None) == (name != "warm_request_ms")


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    for attr in ("enable", "records", "dropped"):
        monkeypatch.delattr(profiling, attr)
    assert program_spans.begin() is False
    assert program_spans.records() == [] and program_spans.warm() is None
    assert spec.reader("h2d_ms").read(None) is None


def test_warm_record_unknown_after_drops(monkeypatch):
    monkeypatch.setattr(profiling, "dropped", lambda: 1)
    recs = [record(5, 1.0), record(6, 2.0)]
    assert read("warm_request_ms", recs, monkeypatch) is None
    # with the warm request dropped, every kept record is the window's
    assert read("g2l_ms", recs, monkeypatch) == pytest.approx(30)


def test_tiny_traced_run_yields_the_new_metrics():
    cell = tiny_cell("davits-p16")
    result = harness.run_cell(cell, 2 ** 31 + 21, 1.0, True, "cpu", 0.0)
    assert result["correct"]
    new = {"h2d_ms.tail", "stitch_ms.tail", "g2l_ms.tail", "fine_ms.tail",
           "warm_request_ms"}
    assert new <= set(result["metrics"])
    assert all(result["metrics"][n]["value"] > 0 for n in new)
    assert profiling.enabled()
    recs = profiling.records()
    assert len(recs) >= 2 and not any(r["failed"] for r in recs)


def test_importing_the_module_leaves_the_tracer_off():
    importlib.reload(program_spans)
    assert not profiling.enabled()
    # a reader's load turns it on
    spec.reader("g2l_ms")
    assert profiling.enabled()


def test_tiny_untraced_run_leaves_the_tracer_off():
    result = harness.run_cell(tiny_cell("davitl-p49"), 2 ** 31 + 22, 1.0,
                              False, "cpu", 0.0)
    assert result["correct"]
    assert not profiling.enabled() and profiling.records() == []
