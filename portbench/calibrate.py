"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python portbench/calibrate.py --workload <cell> --seeds 11,12,... --seconds 3 \
        [--control-seeds 21,22,23]

In one process on the card, for each seed: the cell's inputs, a warm
pass, a short window at the cell's own load and the comparison with the
reference, as a run makes them: the program's readings (the lower ones).
For each control seed the same with the control in the program's place:
the program's own bfloat16 volume, the nearest precision below the
float32 the configuration states (the upper readings). One JSON line a
seed, then the largest program reading and the smallest control reading
of every number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as runmod  # noqa: F401  (paths and cache directories, as a run sets them)


def readings(driver, cell, seed: int, seconds: float, volume_dtype=None):
    res = driver.run(cell, seed, seconds, False, time.time(), volume_dtype=volume_dtype)
    return res.numbers, res.attempted, res.failed, res.notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    driver = spec.driver(cell.traffic["kind"])
    lower, upper = {}, {}
    runs = [(int(s), None, lower) for s in args.seeds.split(",") if s]
    runs += [(int(s), "bfloat16", upper) for s in args.control_seeds.split(",") if s]
    for seed, dtype, acc in runs:
        nums, attempted, failed, notes = readings(driver, cell, seed, args.seconds, dtype)
        side = "control" if dtype else "program"
        print(json.dumps({"side": side, "seed": seed, "attempted": attempted, "failed": failed,
                          **notes, "numbers": nums}), flush=True)
        for k, v in nums.items():
            acc[k] = max(acc.get(k, v), v) if side == "program" else min(acc.get(k, v), v)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
