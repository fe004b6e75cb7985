"""No JAX and nothing of the JAX package in the benchmark's process, and
nothing of the program in the frozen reference: top-level module names,
compared whole."""

import subprocess
import sys
from pathlib import Path

from pfbench import imports

ROOT = Path(__file__).resolve().parent.parent


def _tops(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_harness_and_program_load_no_jax():
    tops = _tops("import pfbench.run, pfbench.harness, pfbench.readings\n"
                 "import patchfusion_tpu_torch.api")
    assert "patchfusion_tpu_torch" in tops
    assert not tops.intersection(imports.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    tops = _tops("import pfbench.reference.engine, pfbench.reference.control"
                 "\nimport pfbench.check, pfbench.weights, pfbench.images"
                 "\nimport json\nfrom pfbench import spec\n"
                 "for w in json.loads(spec.BENCHMARK.read_text())['workloads']:"
                 "\n    spec.load_cell(w['name']).reference")
    assert not tops.intersection(imports.FORBIDDEN)
    assert "patchfusion_tpu_torch" not in tops


def test_check_compares_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in imports.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "patchfusion_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert imports.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "patchfusion_tpu.ops", sys)
    assert imports.forbidden_loaded() == ["jax", "patchfusion_tpu"]
