"""The readings that the comparison's limits are set from, on the card.

    python3 -m pfbench.readings --workload <cell> --seeds 1 2 3 \
        [--requests 2]

For each seed, in one process: the program as a run builds it (weights and
pool from the seed, one warm request), `--requests` requests of the cell's
mode and chunking, then, with the program freed, the numbers of
`check.py` for every returned depth map (the lower reading: a sound
run's) and for the fp8 control put in the program's place (the upper
reading), with the gaps in the map's own terms beside them. One JSON line
per seed; `reference_s` is the seconds of the reference's and the
control's runs per image.

    python3 -m pfbench.readings --workload <cell> --seeds 1 2 3 --controls

reads instead, for each seed, controls computed apart from the one that
`check.py` divides by: the reference with e4m3 operands and float32
products, once with one scale a weight tensor and once with one scale an
output channel, each put in the program's place on the first image of the
pool and judged by `harness.check_outputs` as a run's outputs are.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch

from pfbench import check, harness, images, spec
from pfbench.reference import engine as ref_engine


def readings(cell: spec.Cell, seed: int, requests: int, device) -> dict:
    model, wspec = harness.build_program(cell, seed, device)
    tiles = ref_engine.Tiles(cell.model)
    pool = images.pool(seed, cell.traffic["pool"], tiles.raw, tiles.process,
                       device)
    harness.request(model, pool[0], cell.traffic)
    which = [i % len(pool) for i in range(requests)]
    t0 = time.perf_counter()
    outs = [harness.request(model, pool[i], cell.traffic) for i in which]
    program_s = (time.perf_counter() - t0) / requests
    del model
    gc.collect()
    torch.cuda.empty_cache()
    used = sorted(set(which))
    t0 = time.perf_counter()
    refs = harness.reference_depths(cell, seed, wspec,
                                    [pool[i] for i in used], device)
    ref_s = (time.perf_counter() - t0) / len(used)
    f32 = dict(zip(used, refs["f32"]))
    fp8 = dict(zip(used, refs["fp8"]))
    block = tuple(cell.model["patch_process_shape"])

    def numbers(depths, images):
        return check.worst([{**check.compare(d, f32[i], fp8[i], block),
                        **check.absolute(d, f32[i], fp8[i])}
                       for d, i in zip(depths, images)])

    return {"seed": seed, "program_s": program_s, "reference_s": ref_s,
            "program": numbers(outs, which),
            "control": numbers([c.cpu().numpy() for c in refs["fp8"]],
                               used)}


def control_readings(cell: spec.Cell, seed: int, device) -> dict:
    from pfbench.reference import control

    model, wspec = harness.build_program(cell, seed, device)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    tiles = ref_engine.Tiles(cell.model)
    pool = images.pool(seed, cell.traffic["pool"], tiles.raw, tiles.process,
                       device)
    lr, hr = pool[0]
    out = {"seed": seed}
    for name, per_channel in (("fp8_tensor", False), ("fp8_channel", True)):
        with harness.float32_exact():
            net = control.to_fp8(ref_engine.build(
                cell.config,
                harness.seeded_weights(cell, wspec, seed, device), device),
                per_channel)
            depth = ref_engine.infer(
                net, tiles, torch.from_numpy(lr).to(device),
                torch.from_numpy(hr).to(device),
                cell.traffic["mode"]).float().cpu().numpy()
        del net
        ok, table = harness.check_outputs(cell, seed, wspec, pool, [depth],
                                          [0], device)
        out[name] = {"correct": ok,
                     **{k: v["value"] for k, v in table.items()}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--controls", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        line = (control_readings(cell, seed, device) if args.controls
                else readings(cell, seed, args.requests, device))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
