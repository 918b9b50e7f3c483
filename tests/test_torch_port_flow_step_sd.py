"""One step of the port's flow harness (``make_flow_train_step("sd")``:
FlowNetSD in training mode, the multi-scale loss, Adam at optax's
defaults) against the JAX package's jitted step from the same numpy-seeded
weights and ``synthetic_flow_batch``: loss, EPE, each parameter's update
and the new ``batch_stats`` (tolerances in
``_torch_flow_helpers.check_harness_step``)."""

import torch

from _torch_flow_helpers import check_harness_step

torch.set_num_threads(1)


def test_harness_step_sd_matches_jax():
    # inter_conv* are conv + batch norm: the batch mean removes the conv's
    # bias, so its gradient is zero but for rounding
    check_harness_step("sd", zero_grad_params={
        f"params/inter_conv{i}/Conv_0/bias" for i in (2, 3, 4, 5)})
