"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 -m pfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with a CUDA card. The cells,
their configurations, traffic mixes and metrics are named in
BENCHMARK.json (pfbench/spec.py says where each lives). The run builds the
program under test, `patchfusion_tpu_torch`, with weights made from the
seed, warms the cell's shapes, measures `--seconds` of a closed loop of
requests through `api.PatchFusion.infer`, checks every returned depth map
against the frozen float32 reference (pfbench/reference/), and prints one
JSON line last on standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number with its limit; the same numbers are the
last lines of standard error.

It exits non-zero and prints no result where there is no CUDA card or too
few for the cell, and where JAX or the JAX package is loaded in the
process once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"unknown ({type(e).__name__})"


def _json_number(v):
    return v if math.isfinite(v) else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from pfbench import harness, imports, spec

    found = imports.forbidden_loaded()
    if found:
        say(f"modules of {found} are loaded; the benchmark runs without them")
        return 3
    cell = spec.load_cell(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA card(s); this machine "
            f"has {cards}")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T0)
    found = imports.forbidden_loaded()
    if found:
        say(f"modules of {found} were loaded in the run; no result")
        return 3
    if args.trace:
        say(f"card: {card_line()}; rooflines and mfu against the H100 SXM "
            "data-sheet peaks (bf16 989 TFLOP/s, f32 67 TFLOP/s, "
            "3.35 TB/s)")
    checks = result["checks"]
    for name, c in checks.items():
        say(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    result["checks"] = {k: {kk: _json_number(vv) for kk, vv in c.items()}
                        for k, c in checks.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
