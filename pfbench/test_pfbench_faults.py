"""The comparison catches a broken timed path: a tiny cell driven through
the rest of a run on the CPU (the look for a card skipped), once sound and
once with each fault the cells can have planted in the program under the
entry point, and `correct` read."""

import pytest
import torch

from pfbench import harness
from pfbench.tiny import tiny_cell

SEED = 2 ** 31 + 11


def run(cell):
    return harness.run_cell(cell, SEED, 1.0, False, "cpu", 0.0)


def half_left_out(orig):
    """Half of every chunk's tiles not computed; their depth the mean of
    the rest."""
    def call(crops, *rest):
        n = crops.shape[0]
        keep = max(1, n // 2)
        depth = orig(crops[:keep], *[[r[:keep] for r in x]
                                     if isinstance(x, list) else x[:keep]
                                     for x in rest])
        fill = depth.mean(0, keepdim=True).expand(n - keep, *depth.shape[1:])
        return torch.cat([depth, fill])
    return call


def one_tile_altered(orig):
    """The first tile of every chunk mirrored where it is produced."""
    def call(*args):
        depth = orig(*args).clone()
        depth[0] = depth[0].flip(-1)
        return depth
    return call


@pytest.mark.parametrize("cell", ["davitl-p49", "davits-p16"])
def test_sound_run_is_correct(cell):
    result = run(tiny_cell(cell))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", [half_left_out, one_tile_altered])
@pytest.mark.parametrize("cell", ["davitl-p49", "davits-p16"])
def test_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    real = harness.build_program

    def broken(*args):
        model, wspec = real(*args)
        net = model.net
        object.__setattr__(net, "infer_tiles", fault(net.infer_tiles))
        return model, wspec

    monkeypatch.setattr(harness, "build_program", broken)
    result = run(tiny_cell(cell))
    assert not result["correct"], result["checks"]
