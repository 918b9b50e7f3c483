"""The cell ``flownet2-train-batch8`` (FlowNet2 through the port's flow
harness) at the test's size on the CPU: it comes out correct, its traced
run reads its per-layer metrics, and its check fails on an altered loss,
on a state the steps left unchanged, and on B4's backward with its
gradient's sign flipped or left out. Its traffic file parses, B4's bound
is right at a shape worked by hand, and the FlowNet2 reference computes
in float32 with TF32 off."""

import json
import os

import pytest
import torch

from benchmark import flow_counts
from benchmark.tests import tiny

FLOW = "flownet2-train-batch8"


@pytest.fixture
def root(tiny_root):
    """The tiny root with FlowNet2 at 64² crops of 96 x 160 pairs, batch
    2, computed in float32 (the card's limits are set for bfloat16 at the
    cell's size; the CPU's bfloat16 convolutions at 64² are no reading of
    them)."""
    b = os.path.join(tiny_root, "benchmark")
    path = os.path.join(b, "configs", "flownet2-train-bf16.json")
    tiny.write_json(path, dict(tiny.harness.load_json(path),
                               crop_size=[64, 64], batch_size=2,
                               compute_dtype="float32"))
    path = os.path.join(b, "traffic", "flow-pairs-crop256-batch8.json")
    t = tiny.harness.load_json(path)
    t["pool"].update(records=4, height=96, width=160)
    tiny.write_json(path, t)
    return tiny_root


def test_traffic_file_parses():
    d = os.path.join(tiny.REPO, "benchmark", "traffic")
    with open(os.path.join(d, "flow-pairs-crop256-batch8.json")) as f:
        flow = json.load(f)
    assert flow["pool"]["records"] == 64 and flow["queue"] == 2
    assert (flow["pool"]["height"], flow["pool"]["width"]) == (436, 1024)


def test_b4_bound_at_a_hand_worked_shape():
    """(1, 2, 3, 4), md 2, s2 1: D = 25; forward 2·24·25 = 1200 FLOPs,
    bf16 bytes 2·(2·24 + 25·12) = 696; backward 2400 FLOPs, 2·(300 + 4·24)
    = 792 bytes. Both bound by their bytes at 3.35 TB/s."""
    shape = (1, 2, 3, 4)
    assert flow_counts.corr_displacements(2, 1) == 25
    assert flow_counts.b4_flops(shape, 2, 1) == 1200
    assert flow_counts.b4_flops(shape, 2, 1, backward=True) == 2400
    assert flow_counts.b4_bytes(shape, 2, 1) == 696
    assert flow_counts.b4_bytes(shape, 2, 1, backward=True) == 792
    assert flow_counts.b4_bound_s(shape, 2, 1) == pytest.approx(696 / 3.35e12)
    assert flow_counts.b4_bound_s(
        shape, 2, 1, backward=True) == pytest.approx(792 / 3.35e12)
    big = (8, 256, 32, 32)      # the cell's: bytes bound too
    assert flow_counts.b4_bound_s(big) == pytest.approx(
        flow_counts.b4_bytes(big) / 3.35e12)


def test_flownet2_flops_grow_with_the_crop():
    small = flow_counts.flownet2_flops_per_sample({"crop_size": [64, 64]})
    large = flow_counts.flownet2_flops_per_sample({"crop_size": [128, 128]})
    assert 3.5 < large / small < 4.5


def frozen_adam(monkeypatch):
    """The harness's Adam takes no step."""
    from jafpro_tpu_torch.train import flow_harness

    class Frozen(torch.optim.Adam):
        def step(self, closure=None):
            return None

    monkeypatch.setattr(flow_harness, "adam", lambda params, lr: Frozen(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8))


def doubled_flow_loss(monkeypatch):
    from jafpro_tpu_torch.train import flow_harness

    real = flow_harness.make_flow_train_step

    def make(*a, **kw):
        init, step = real(*a, **kw)

        def doubled(state, pairs, target):
            state, m = step(state, pairs, target)
            return state, dict(m, loss=2.0 * m["loss"])
        return init, doubled
    monkeypatch.setattr(flow_harness, "make_flow_train_step", make)


def b4_backward_times(monkeypatch, k: float):
    """B4's gradient with respect to both feature maps times ``k``."""
    from jafpro_tpu_torch.models import flownet

    real = flownet.correlation

    class Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return k * g

    monkeypatch.setattr(flownet, "correlation", lambda f1, f2, *a, **kw:
                        real(Scale.apply(f1), Scale.apply(f2), *a, **kw))


def test_flownet2_cell_correct_traced_and_its_faults(root, monkeypatch):
    res = tiny.run(root, FLOW, seconds=1.0)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"}
    traced = tiny.run(root, FLOW, seconds=1.0, trace=True)
    assert {"flow.forward_ms.flow2", "flow.backward_ms.flow2",
            "flow.enqueue_ms.flow2", "flow.optim_ms.flow2",
            "train.feed_wait_ms"} <= set(traced["metrics"])
    with monkeypatch.context() as m:
        doubled_flow_loss(m)
        bad = tiny.run(root, FLOW, seconds=1.0)
    assert not bad["correct"]
    assert bad["checks"]["loss"]["value"] > bad["checks"]["loss"]["limit"]
    with monkeypatch.context() as m:
        frozen_adam(m)
        bad = tiny.run(root, FLOW, seconds=1.0)
    assert not bad["correct"]
    assert bad["checks"]["change"]["value"] >= 1.0


@pytest.mark.parametrize("k, reads", [(-1.0, 2.0), (0.0, 1.0)])
def test_flownet2_check_sees_b4_backward(root, monkeypatch, k, reads):
    """The loss does not move (the forward is B4's own) while the second
    frame's encoder tower, which takes its gradient from B4's backward
    alone, updates the other way (``k`` -1, the group reads 2) or not at
    all (0, reads 1)."""
    b4_backward_times(monkeypatch, k)
    bad = tiny.run(root, FLOW, seconds=1.0)
    assert not bad["correct"]
    assert bad["checks"]["loss"]["value"] <= bad["checks"]["loss"]["limit"]
    assert bad["checks"]["change"]["value"] == pytest.approx(reads, abs=0.01)


def test_flownet2_reference_turns_tf32_off(root):
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    found = tiny.harness.resolve(root, FLOW)
    run = tiny.harness.Run(root=root, cell=FLOW, seed=11, seconds=0,
                           trace=False, device=torch.device("cpu"),
                           t_start=0.0, **found)
    drv = tiny.harness.load_driver(root, "flow_steps")
    source = drv.batches(run)
    out = drv.reference(run, [next(source)])
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert len(out["losses"]) == 1 and out["losses"][0]["loss"] > 0
    assert set(out["moment"]) == set(out["change"])
