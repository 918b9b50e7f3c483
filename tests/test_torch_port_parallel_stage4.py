"""Stage 4's sharded step (``parallel.data_parallel_jit``) on 2 gloo ranks
on the CPU: one SGD step at ``tests/_torch_train_pair.py``'s 64 px
configuration at global batch 4 (2 per rank), held to the port's
single-process step at batch 4 from the same weights, which
``test_torch_port_train_stage4.py`` holds to the JAX package, and
(``slow``: it jits the JAX package's stage-4 step, minutes on one core)
to ``jafpro_tpu.parallel.data_parallel_jit``'s step of the JAX package on
2 of the 8 virtual CPU devices from weights bridged from its
numpy-seeded param tree.

The batch's faces are shared unequally (2 on rank 0, 1 on rank 1), so a
per-rank masked mean, per-rank batch statistics or a gradient counted
twice or by half would show. Tolerances: every metric within rtol 1e-5
of the port's step and within rtol 5e-5 of the JAX package's
(``test_torch_port_train_stage4.py``'s); each module's update within 2e-3
of its largest entry (plus two float32 ulps of the param), the parity
tests' tolerance. The replicas' parameters
are bitwise equal after the step and the metrics equal on both ranks.
"""

import numpy as np
import pytest
import torch

import _torch_parallel_helpers as H
import _torch_train_pair as tp

torch.set_num_threads(1)


def check_sharded_step(ranks, stage):
    r0, r1 = ranks
    assert r0["digest"] == r1["digest"]
    assert r0["metrics"] == r1["metrics"]
    assert r0["frozen_same"] and r1["frozen_same"]
    ref = r0["port_metrics"]
    assert set(r0["metrics"]) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=f"stage {stage} {k}")
    errs = r0["errors"]["port"]
    assert set(errs) == set(H.stage_lrs(stage))
    assert max(errs.values()) <= 2e-3, errs


def test_stage4_step_sharded_equals_unsharded(tmp_path):
    batch = H.sgd_batch(4)
    assert [H.face_valid(batch)[:2].sum(), H.face_valid(batch)[2:].sum()] \
        == [2, 1]
    check_sharded_step(H.run_ranks(H.rank_sgd_check, 4, batch, tmp=tmp_path),
                       4)


@pytest.mark.slow
def test_stage4_step_sharded_matches_jax_sharded(tmp_path):
    batch = H.sgd_batch(4)
    params, jafter, jm = tp.jax_sharded_step(4, batch)
    r0, r1 = H.run_ranks(H.rank_sgd_check, 4, batch, params, jafter,
                         tmp=tmp_path)
    check_sharded_step((r0, r1), 4)
    assert set(r0["metrics"]) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=5e-5,
                                   atol=1e-7, err_msg=f"stage 4 {k}")
    errs = r0["errors"]["jax"]
    assert set(errs) == set(H.stage_lrs(4))
    assert max(errs.values()) <= 2e-3, errs
