"""Readings that a cell's limits are set from, on the GPU.

    python3 benchmark/calibrate.py --workload <name> --seeds 12 \\
        --control-seeds 3 [--first-seed N]

For each seed: set-up as a run makes it, the window's interactions up to
the last one the check samples, and the check's numbers. Then:

* the program's readings on ``--seeds`` seeds (the lower readings);
* the frame's control on the first ``--control-seeds`` of them: the
  reference frame computed with its classified layout in float8 (e4m3)
  instead of bfloat16, against the reference frame;
* the field's control on ``--control-seeds`` further seeds: the program
  on its own narrower path (bfloat16 member chunks or member stack).

Prints one line a reading and, at the end, the largest program reading
and the smallest control reading of each number. The benchmark's runs
do not run this.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

from benchmark import run as bench_run  # noqa: E402


def readings(cell, seed: int, device, low_precision: bool,
             frame_control: bool) -> tuple[dict, dict]:
    import torch

    from benchmark import check, drivers, traffic

    driver = drivers.make(cell.config, cell.traffic, seed, device,
                          low_precision)
    chk = cell.settings["check"]
    keep = set(traffic.check_sample(seed, int(chk["interactions"]),
                                    int(chk["within"])))
    window = bench_run.Window(driver, traffic.interactions(
        cell.traffic, driver.grid_xyz, seed), keep, device)
    window.timed(0.0, count=max(keep) + 2)
    window.finish()
    driver.release()
    torch.cuda.empty_cache()
    values = check.readings(cell, driver, window.kept, seed)
    control = {}
    if frame_control and "frame_gap" in values:
        control = check.readings(cell, driver, window.kept, seed,
                                 frame_layout=torch.float8_e4m3fn)
    del driver, window
    torch.cuda.empty_cache()
    return values, control


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_001)
    args = p.parse_args(argv)
    bench_run._caches_in_checkout()
    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    lower, upper = {}, {}
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        values, control = readings(cell, seed, device, False,
                                   i < args.control_seeds)
        for name, v in values.items():
            lower[name] = max(lower.get(name, 0.0), v)
            print(f"program {cell.name} seed {seed} {name} {v!r}")
        for name, v in control.items():
            if name == "frame_gap":
                upper[name] = min(upper.get(name, float("inf")), v)
                print(f"control-float8-layout {cell.name} seed {seed} "
                      f"{name} {v!r}")
        print(f"  ({time.perf_counter() - t:.1f} s)", flush=True)
    for j in range(args.control_seeds):
        seed = seeds[-1] + 7919 * (j + 1)
        values, _ = readings(cell, seed, device, True, False)
        for name, v in values.items():
            if name == "field_gap":
                upper[name] = min(upper.get(name, float("inf")), v)
            print(f"control-bfloat16-inputs {cell.name} seed {seed} {name} "
                  f"{v!r}", flush=True)
    for name in sorted(lower):
        print(f"summary {cell.name} {name}: lower (largest program "
              f"reading) {lower[name]!r}, upper (smallest control "
              f"reading) {upper.get(name)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
