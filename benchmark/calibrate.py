#!/usr/bin/env python3
"""Read the numbers that the correctness limits are set from, in one
process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault-seeds 7,8,9] [--seconds 4]

For each of ``--seeds`` a short run of the cell (set-up, a window of
``--seconds``, the check: the program's readings); for each of
``--control-seeds`` the control (the reference in float8 in the program's
place); for each of ``--fault-seeds`` the faults the cell's driver can
plant in the reference put in the program's place (training: half of each
batch left out). Prints one JSON line per reading; the benchmark's own
runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _seeds(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import io

    import torch

    from benchmark import harness

    dev = torch.device(args.device)
    for seed in args.seeds:
        sink, got = io.StringIO(), {}
        res = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, dev, time.perf_counter(), out=sink,
                               readings=got)
        print(json.dumps({"what": "program", "seed": seed,
                          "checks": res["checks"],
                          "metrics": res["metrics"],
                          "stats": got.get("gap_stats")}), flush=True)
    found = harness.resolve(ROOT, args.workload)
    driver = harness.load_driver(ROOT, found["workload"]["driver"])
    modes = [("float8", s) for s in args.control_seeds]
    if args.workload.startswith("train"):
        modes += [("half_batch", s) for s in args.fault_seeds]
    for mode, seed in modes:
        run = harness.Run(root=ROOT, cell=args.workload, seed=seed,
                          seconds=0, trace=False, device=dev,
                          t_start=time.perf_counter(), **found)
        t0 = time.perf_counter()
        checks = driver.control(run, mode)
        print(json.dumps({"what": mode, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "checks": {c.name: c.value for c in checks},
                          "stats": run.readings.get("gap_stats")}),
              flush=True)
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    return 0


if __name__ == "__main__":
    sys.exit(main())
