#!/usr/bin/env python3
"""Run one cell of the benchmark of ``jafpro_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Builds the cell (its configuration, seeded
weights on the card, its traffic's data), warms up every shape it uses,
measures for ``--seconds``, checks the outputs of the timed path against
the plain reference, and prints one JSON line: the cell's end-to-end
metrics (``--trace 0``) or its per-layer metrics (``--trace 1``). Exits
with 3 and prints no result without the cards the cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    chips = int(harness.resolve(ROOT, args.workload)["entry"]["chips"])
    import torch

    if not torch.cuda.is_available():
        print("benchmark: CUDA is not available; a run needs "
              f"{chips} card(s) and prints no result", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} card(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda"), T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
