"""Stage 1's sharded step on 2 gloo ranks on the CPU: one SGD step at
``tests/_torch_train_pair.py``'s 64 px configuration at global batch 4
(2 per rank), held to
  * the port's single-process step at batch 4 from the same weights: the
    loss within rtol 1e-5, each module's update within 2e-3 of its
    largest entry (plus two float32 ulps of the param), the parity
    tests' tolerance;
  * (``slow``: it jits the JAX package's step, over a minute on one core)
    ``jafpro_tpu.parallel.data_parallel_jit``'s step of the JAX package
    on 2 of the 8 virtual CPU devices (``tests/test_parallel.py``), from
    weights bridged from its numpy-seeded param tree: the loss within
    rtol 5e-5 and the updates within 2e-3, the parity tests' tolerances.
The replicas' parameters are bitwise equal after the step and the loss
equal on both ranks.
"""

import numpy as np
import pytest
import torch

import _torch_parallel_helpers as H
import _torch_train_pair as tp

torch.set_num_threads(1)


def check_replicas(r0, r1):
    assert r0["digest"] == r1["digest"]
    assert r0["metrics"] == r1["metrics"]
    assert r0["frozen_same"] and r1["frozen_same"]
    np.testing.assert_allclose(r0["metrics"]["loss"],
                               r0["port_metrics"]["loss"], rtol=1e-5)
    errs = r0["errors"]["port"]
    assert set(errs) == {"accu"}
    assert errs["accu"] <= 2e-3, errs


def test_stage1_step_sharded_equals_unsharded(tmp_path):
    check_replicas(*H.run_ranks(H.rank_sgd_check, 1, H.sgd_batch(4),
                                tmp=tmp_path))


@pytest.mark.slow
def test_stage1_step_sharded_matches_jax_sharded(tmp_path):
    batch = H.sgd_batch(4)
    params, jafter, jm = tp.jax_sharded_step(1, batch)
    r0, r1 = H.run_ranks(H.rank_sgd_check, 1, batch, params, jafter,
                         tmp=tmp_path)
    check_replicas(r0, r1)
    np.testing.assert_allclose(r0["metrics"]["loss"], jm["loss"], rtol=5e-5)
    assert r0["errors"]["jax"]["accu"] <= 2e-3, r0["errors"]["jax"]
