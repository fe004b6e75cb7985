"""BENCHMARK.json against its contract, and the harness finding each
configuration, traffic mix, check and metric by name."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from pfbench import check, spec

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["pfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_follow_the_contract():
    for c in BENCH["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"])
        assert c["file"].startswith("pfbench/")
        assert (ROOT / c["file"]).is_file()
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == KEYS["workload"] and NAME.match(w["name"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"]
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        # a listed cell exists and reports the metric this one moves
        for cell in m.get("workloads", []):
            assert cell in cells
            assert m["moves"] in {e["name"] for e in
                                  spec.load_cell(cell).end_to_end}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["reduced"] == [] and c.config["dtype"] == "bfloat16"
    assert c.traffic["arrival"] == "closed" and c.traffic["clients"] == 1
    assert tuple(c.traffic["image_shape"]) == \
        tuple(c.model["image_raw_shape"])
    assert set(c.check["limits"]) == set(check.NUMBERS)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    # a per-layer metric without a `workloads` list is read in every cell
    # that reports the end-to-end metric it moves, and only there
    for m in BENCH["per_layer"]:
        if "workloads" not in m:
            assert (m in c.per_layer) == (m["moves"] in reported), m
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]).read)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.tail")


def test_a_split_quantity_shares_its_reader():
    assert spec.reader("coarse_ms.tail").__file__ == \
        spec.reader("coarse_ms").__file__


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "pfbench.run", "--workload", "davits-p16",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
