"""One step of the port's flow harness (``make_flow_train_step("c")``:
FlowNetC in training mode, its cost volume from ``ops.correlation``, the
multi-scale loss, Adam at optax's defaults) against the JAX package's
jitted step from the same numpy-seeded weights and
``synthetic_flow_batch``: loss, EPE, each parameter's update and the new
``batch_stats`` (tolerances in ``_torch_flow_helpers.check_harness_step``).
"""

import torch

from _torch_flow_helpers import check_harness_step

torch.set_num_threads(1)


def test_harness_step_c_matches_jax():
    check_harness_step("c")
