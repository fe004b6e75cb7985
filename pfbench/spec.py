"""A cell of the benchmark, found by name.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration and traffic mix and lists the metrics. Everything that
belongs to one of them is a file of its own, found by its name:

    pfbench/configs/<config>.json    the model configuration as it is run
    pfbench/traffic/<traffic>.json   the traffic mix's parameters
    pfbench/checks/<cell>.json       the comparison's limits
    pfbench/metrics/<metric>.py      the metric's reader (a quantity split
                                     as <metric>.<part> shares it)

and a configuration's plain reference is a module of its own, named by the
configuration file's key "reference": a path relative to the root of the
checkout (a benchmark module lies under pfbench/reference/), or an
absolute one. Without the key it is pfbench/reference/model.py, the
reference of the DA-ZoeDepth configurations. The module exports

    PatchFusionNet(model_config)     the reference network, with the
                                     `coarse` and `tiles` calls that
                                     reference/engine.py drives
    LEAF_RULES (optional)            {leaf: (std, mean, exp)}, the draw of
                                     leaves that weights.py has no rule for
    computed (optional)              computed(key, shapes, model_config):
                                     a structural buffer's value, or None

so that a later change adds a cell, a configuration, its reference, a
traffic mix or a metric by adding files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
DEFAULT_REFERENCE = "pfbench/reference/model.py"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]    # the configuration file: source, dtype, model
    traffic: Dict[str, Any]
    check: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def model(self) -> Dict[str, Any]:
        """The model configuration (the program's `model.config` dict)."""
        return self.config["model"]

    @property
    def reference(self) -> ModuleType:
        """The configuration's reference module (`reference(config)`)."""
        return reference(self.config)

    def metrics(self, trace: bool) -> List[Dict[str, Any]]:
        return self.per_layer if trace else self.end_to_end


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell `name` of BENCHMARK.json (or of the `benchmark` dict)."""
    bench = benchmark if benchmark is not None else _read(BENCHMARK)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(ROOT / configs[w["config"]]["file"])
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in end_to_end}
    # a per-layer metric without a list is read wherever what it moves is
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and _applies(m, name)]
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=_read(HERE / "traffic" / f"{w['traffic']}.json"),
        check=_read(HERE / "checks" / f"{name}.json"),
        end_to_end=end_to_end, per_layer=per_layer)


def reader(metric: str) -> ModuleType:
    """The reader module pfbench/metrics/<metric>.py; for a quantity split
    by the end-to-end metric it moves (`coarse_ms.tail`) that has no file
    of its own, the reader of the quantity (`coarse_ms.py`)."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file() and "." in metric:
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path} for the metric {metric!r}")
    return _load("pfbench_metric_" + metric.replace(".", "_")
                 .replace("-", "_"), path)


def _load(mod_name: str, path: Path) -> ModuleType:
    """The module of the file `path`, run anew under `mod_name`."""
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def reference(config: Dict[str, Any]) -> ModuleType:
    """The reference module that the configuration file `config` names
    under "reference", or pfbench/reference/model.py; loaded by its path,
    once a process."""
    path = Path(config.get("reference", DEFAULT_REFERENCE))
    return _load_reference((path if path.is_absolute() else ROOT / path)
                           .resolve())


@functools.lru_cache(maxsize=None)
def _load_reference(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no reference module {path}")
    return _load("pfbench_reference_" + re.sub(r"\W", "_", str(path)), path)
