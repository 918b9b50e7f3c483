"""Port parity for training stage(s) 3: one step of the port's step
function against the JAX package's (jitted) on the CPU, in float32, from
the same numpy-seeded weights and batch, with SGD (lr 1e-3) in place of
Adam on both sides (Adam's first update is about lr * sign(g), which
would test the optimizer's sign of near-zero gradients, not the step).

Tolerances: every metric within rtol 5e-5; every trained param's update
within 2e-3 of its largest entry plus two float32 ulps of the param (the
measured worst was 3e-4, from reassociated float32 sums); every other
param unchanged on both sides. The real optimizers run on the port alone:
finite metrics, every trained module moved, every other bitwise equal.
See _torch_train_pair.py for the configuration (64 px, 24 parts of
16 px, 2 refs, 16 px faces, batch 2).
"""

import numpy as np
import pytest
import torch

import _torch_train_pair as tp

torch.set_num_threads(1)


@pytest.mark.parametrize("stage", [3])
def test_one_sgd_step_matches_jax(stage):
    before, jafter, jm, batch = tp.jax_pair(stage)
    tafter, tm = tp.port_run(stage, before, batch)
    tp.compare(stage, before, jafter, tafter, jm, tm, rtol=5e-5,
               upd_rtol=2e-3)


@pytest.mark.parametrize("stage", [3])
def test_real_lrs_finite_and_frozen_unchanged(stage):
    metrics, moved, same, trained = tp.real_lrs_run(stage)
    for m in metrics:
        assert all(np.isfinite(v) for v in m.values()), m
    assert moved == trained
    assert same == set(tp.ALL_MODULES) - trained
    if stage == 4:
        assert "bg" in same
