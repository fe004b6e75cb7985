"""The control: the reference computed in fp8 (one scale a tensor, or one
an output channel) and put in the program's place fails the comparison; on
the CPU at the tiny size, and on the card (marked `cuda`) at the cells'
own size over three seeds."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pfbench import harness, spec
from pfbench.reference import control, engine
from pfbench.tiny import tiny_cell

ROOT = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 13


def test_fp8_round_is_e4m3_under_a_per_tensor_scale():
    x = torch.linspace(-3.0, 3.0, 1001)
    y = control.fp8_round(x)
    assert y.abs().max() == pytest.approx(3.0)
    assert len(torch.unique(y)) < 256
    rel = ((y - x).abs() / x.abs().clamp(min=0.05)).max()
    assert 0.01 < rel < 0.1    # e4m3 has 3 mantissa bits


class ControlModel:
    """The fp8 reference behind the entry point's signature."""

    def __init__(self, cell, seed, wspec, per_channel=False):
        self.net = control.to_fp8(engine.build(
            cell.config, harness.seeded_weights(cell, wspec, seed, "cpu"),
            "cpu"), per_channel)
        self.tiles = engine.Tiles(cell.model)

    def infer(self, lr, hr, cai_mode, process_num):
        return engine.infer(self.net, self.tiles, torch.from_numpy(lr),
                            torch.from_numpy(hr), cai_mode).numpy()


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("cell", ["davitl-p49", "davits-p16"])
def test_control_in_the_programs_place_is_not_correct(monkeypatch, cell,
                                                      per_channel):
    real = harness.build_program

    def control_program(cell_, seed, device):
        _, wspec = real(cell_, seed, device)
        return ControlModel(cell_, seed, wspec, per_channel), wspec

    monkeypatch.setattr(harness, "build_program", control_program)
    result = harness.run_cell(tiny_cell(cell), SEED, 1.0, False, "cpu", 0.0)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["davitl-p49", "davits-p16", "davitl-p16",
                                  "davits-p49"])
def test_control_fails_every_cells_limits_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = spec.load_cell(cell).check["limits"]
    out = subprocess.run(
        [sys.executable, "-m", "pfbench.readings", "--workload", cell,
         "--seeds", "101", "102", "103"],
        cwd=ROOT, capture_output=True, text=True, timeout=3000, check=True)
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        assert all(r["program"][k] <= v for k, v in limits.items()), r
        assert any(r["control"][k] > v for k, v in limits.items()), r
    # the controls computed apart, judged as a run's outputs are
    out = subprocess.run(
        [sys.executable, "-m", "pfbench.readings", "--workload", cell,
         "--seeds", "101", "102", "103", "--controls"],
        cwd=ROOT, capture_output=True, text=True, timeout=3000, check=True)
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        assert not r["fp8_tensor"]["correct"], r
        assert not r["fp8_channel"]["correct"], r
