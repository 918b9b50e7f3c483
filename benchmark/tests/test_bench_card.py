"""On the card, at each cell's own size: the correctness control (the
reference computed in float8 in the program's place) fails the cell's
check on three seeds, and so does training's planted fault (half of each
batch left out). Marked ``cuda``: skips without a card.

    python -m pytest benchmark/tests/test_bench_card.py -m cuda -q -s
"""

import time

import pytest

from benchmark import harness
from benchmark.tests.tiny import REPO

SEEDS = (2 ** 31 + 101, 2 ** 32 + 202, 3 * 10 ** 9 + 303)


def control(cell, mode, seed, device):
    found = harness.resolve(REPO, cell)
    driver = harness.load_driver(REPO, found["workload"]["driver"])
    run = harness.Run(root=REPO, cell=cell, seed=seed, seconds=0,
                      trace=False, device=device, t_start=time.perf_counter(),
                      **found)
    return driver.control(run, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,mode", [
    ("gen-serve-batch1", "float8"), ("gen-request-refs1to4", "float8"),
    ("train4-batch4", "float8"), ("train4-batch4", "half_batch")])
def test_control_and_faults_fail_at_the_cells_size(card, cell, mode):
    for seed in SEEDS:
        checks = control(cell, mode, seed, card)
        print(cell, mode, seed, {c.name: c.value for c in checks})
        assert any(not c.ok for c in checks), (seed, checks)
