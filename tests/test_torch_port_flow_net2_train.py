"""FlowNet2 as flownet2-pytorch trains it (``batch_norm=False``, its
``resample2d`` edges, the L1 loss on the fused flow), held to the
benchmark's plain reference ``benchmark/reference/flownet2.py`` on the CPU
in float32 at 64², batch 2, on seeded random weights: the fused flow, the
loss and the EPE, and the first Adam update of the port's harness step
(``make_flow_train_step("2")``) entrywise. ``batch_norm=True`` stays the
port's FlowNet2 of before the flag (the JAX package's, whose parity
``test_torch_port_flow_net2.py`` holds).

Tolerances: the fused flow within 1e-4 of its largest magnitude (the
other nets' parity bound; five nets deep, float32 sums in other orders);
loss and EPE within 1e-5 relative; updates as
``_torch_flow_helpers.check_harness_step`` holds them (within 1e-2 lr but
for at most max(1, 0.5%) of a parameter's entries, whose gradients the
two round to opposite signs).
"""

import numpy as np
import pytest
import torch

from benchmark.reference import flownet2 as R
from jafpro_tpu_torch.models import flownet as T
from jafpro_tpu_torch.models.common import FlaxBatchNorm2d
from jafpro_tpu_torch.ops.sampling import resample2d
from jafpro_tpu_torch.train.flow_harness import (
    make_flow_train_step, synthetic_flow_batch)

torch.set_num_threads(1)
LR = 1e-3
CFG = {"optimizer_lr": LR, "optimizer_betas": [0.9, 0.999],
       "optimizer_eps": 1e-8, "optimizer_weight_decay": 0.0}


def seeded_(model, seed):
    """Kernels ~ N(0, 1/fan_in), biases in [-0.1, 0.1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=g)
                        / p[0].numel() ** 0.5)
            else:
                p.copy_(torch.rand(p.shape, generator=g) * 0.2 - 0.1)
    return model


def batch(seed=3, size=64):
    pairs, flow = synthetic_flow_batch(np.random.RandomState(seed), 2, size)
    return (255.0 * pairs).astype(np.float32), 4.0 * flow


def test_published_stack_has_no_batch_norm_and_the_reference_names():
    port = T.FlowNet2(batch_norm=False, warp_padding="border")
    assert not any(isinstance(m, FlaxBatchNorm2d) for m in port.modules())
    assert not any("BatchNorm" in k for k in port.state_dict())
    convs = [m for n, m in port.named_modules() if n.endswith(".Conv_0")]
    assert convs and all(m.bias is not None for m in convs)
    ref = R.FlowNet2()
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(v.shape) for k, v in ref.state_dict().items()}
    n = sum(p.numel() for p in port.parameters())
    assert 160e6 < n < 165e6, n


def test_batch_norm_true_is_the_default_flownet2():
    a, b = T.FlowNet2(), T.FlowNet2(batch_norm=True)
    assert list(a.state_dict()) == list(b.state_dict())
    seeded_(a, 1)
    b.load_state_dict(a.state_dict())
    x = torch.from_numpy(np.random.RandomState(2).rand(1, 6, 64, 64)
                         .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(a(x), b(x))


@pytest.mark.parametrize("scale", [0.5, 40.0])
def test_border_resample2d_is_the_references(scale):
    g = torch.Generator().manual_seed(5)
    img = torch.rand(2, 3, 9, 13, generator=g)
    flow = (torch.randn(2, 2, 9, 13, generator=g) * scale).requires_grad_()
    got = resample2d(img, flow, "border")
    want = R.resample2d(img, flow)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    w = torch.randn(got.shape, generator=g)
    ga, = torch.autograd.grad((got * w).sum(), flow)
    gb, = torch.autograd.grad((want * w).sum(), flow)
    torch.testing.assert_close(ga, gb, rtol=0, atol=1e-5)


def test_harness_step_matches_the_reference():
    pairs, flow = batch()
    init, step = make_flow_train_step("2", lr=LR, device="cpu")
    state = init(torch.Generator().manual_seed(0))
    seeded_(state.model, 7)
    ref = R.FlowNet2()
    ref.load_state_dict(state.model.state_dict())
    before = {k: v.detach().clone()
              for k, v in state.model.named_parameters()}

    # training mode takes each sub-net's finest flow, the eval output
    x = T.flownet2_preprocess(R.frames_of(torch.from_numpy(pairs)))
    with torch.no_grad():
        fused = state.model.train()(x)
        assert torch.equal(fused, state.model.eval()(x))
        want = ref(R.frames_of(torch.from_numpy(pairs)))
    scale = want.abs().max().item()
    assert scale > 0
    assert (fused - want).abs().max().item() <= 1e-4 * scale

    trainer = R.Trainer(ref, CFG)
    rm = trainer.step(pairs, flow)
    state, tm = step(state, pairs, flow)
    for k in ("loss", "epe"):
        assert abs(float(tm[k]) - float(rm[k])) <= 1e-5 * abs(float(rm[k])), k
    after = dict(ref.named_parameters())
    moved = 0
    for k, p0 in before.items():
        du = (state.model.get_parameter(k).detach() - p0).numpy()
        dr = (after[k].detach() - p0).numpy()
        off = int((np.abs(du - dr) > 1e-2 * LR).sum())
        assert off <= max(1, 0.005 * du.size), (k, off, du.size)
        moved += int(np.abs(dr).max() > 0.5 * LR)
    assert moved > len(before) // 2


def test_bfloat16_step_keeps_the_correlation_in_bfloat16():
    """Without batch norm FlowNetC's encoders hand the correlation
    bfloat16; the decoders, the flows and the loss are float32."""
    pairs, flow = batch(4, 64)
    init, step = make_flow_train_step("2", lr=LR, compute_dtype="bfloat16",
                                      device="cpu")
    state = init(torch.Generator().manual_seed(1))
    seen = {}

    def dtype_of(key):
        def hook(module, inputs, out):
            seen.setdefault(key, out.dtype)
        return hook

    net = state.model.flownetc
    net.conv3a.register_forward_hook(dtype_of("c3"))
    net.predict_flow2.register_forward_hook(dtype_of("flow"))
    state, m = step(state, pairs, flow)
    assert seen == {"c3": torch.bfloat16, "flow": torch.float32}
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
