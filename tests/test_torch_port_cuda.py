"""The port's CUDA kernels against their plain PyTorch versions: the
rasterizer (with and without its depth output) and the correlation
(forward and backward, float32 and bfloat16), and their launch counts; the
rasterizer's gradient recompute, small training steps (stage 4, the flow
harness) and a renderer gradient against the CPU's, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (decided
inside the test). Run on a GPU host with
``python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest``
(``tests/conftest.py`` imports JAX, which a GPU host need not have).
"""

import importlib

import numpy as np
import pytest
import torch

from jafpro_tpu_torch.geometry import rasterizer as trast
from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
from jafpro_tpu_torch.utils.meshproxy import ellipsoid_clip, sliver_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_faces(n_faces, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.8, 0.8, size=(n_faces, 1, 3))
    offsets = rng.uniform(-0.35, 0.35, size=(n_faces, 3, 3))
    fv = (centers + offsets).astype(np.float32)
    fv[:, :, 2] = rng.uniform(1.0, 5.0, size=(n_faces, 3))
    return fv


def shuffled_sphere(T=3):
    """The clip's 13776-face mesh with its faces in a seeded random order."""
    verts, cams, faces = ellipsoid_clip(T, shuffle=True)
    return SMPLFlowEngine(faces=faces, image_size=256).project_faces(
        torch.from_numpy(cams), torch.from_numpy(verts)).numpy()


SCENES = {
    "random": lambda S, n: np.stack([random_faces(n, s) for s in range(3)]),
    "shuffled_sphere": lambda S, n: shuffled_sphere(),
    "slivers": lambda S, n: np.stack([sliver_scene(S, seed=s)
                                      for s in range(2)]),
}


@pytest.mark.parametrize("scene,S,n_faces", [
    ("random", 32, 300), ("random", 64, 1000), ("random", 100, 517),
    ("shuffled_sphere", 256, 13776), ("slivers", 256, 768)])
def test_kernel_matches_plain(cuda, scene, S, n_faces):
    fv = torch.from_numpy(SCENES[scene](S, n_faces)).to(cuda)
    assert fv.shape[1] == n_faces
    before = trast.rasterize_fim_wim.launches
    fim, wim = trast.rasterize_fim_wim(fv, image_size=S)
    torch.cuda.synchronize()
    assert trast.rasterize_fim_wim.launches == before + 1
    rfim, rwim = trast.rasterize_fim_wim_reference(fv, image_size=S)
    assert torch.equal(fim, rfim)
    assert (wim - rwim).abs().max().item() <= 1e-5
    assert (fim >= 0).sum().item() > 100


def test_generate_batch_one_launch_on_card(cuda):
    """Two clips as one ``generate_batch`` pass rasterize in one launch and
    equal the clips generated one by one (float32, TF32 off)."""
    from jafpro_tpu_torch.config import Config
    from jafpro_tpu_torch.infer import VideoGenerator, stack_clips
    from jafpro_tpu_torch.pipeline import JAFProPipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    S, p, R, T = 64, 32, 2, 4
    clips = []
    for seed in (0, 1):
        verts, cams, faces = ellipsoid_clip(T, seed)
        rng = np.random.RandomState(seed)
        iuv = rng.randint(0, 25, (T, S, S, 3)).astype(np.uint8)
        clips.append({
            "src_parts": rng.uniform(-1, 1, (1, R, 24, p, p, 3)),
            "src_mask_parts": (rng.rand(1, R, 24, p, p) > 0.5) * 1.0,
            "ref_mask": np.ones((1, R)),
            "bg_incomplete": rng.uniform(-1, 1, (1, S, S, 3)),
            "src_imgs": rng.uniform(-1, 1, (R, S, S, 3)),
            "chosen_frames": np.array([seed, T - 1], np.int32),
            "tgt_iuv255": iuv, "smpl_mask": np.ones((T, S, S, 1)),
            "cams": cams, "verts": verts})
    cfg = Config(image_size=S, part_size=p, maximum_ref_frames=R,
                 compute_dtype="float32")
    pipe = JAFProPipeline(cfg, flow_engine=SMPLFlowEngine(
        faces=faces, image_size=S), device=cuda)
    gen = VideoGenerator(pipe, frame_batch=T, flow_mode="batch")
    singles = [gen(c) for c in clips]
    before = trast.rasterize_fim_wim.launches
    batch = gen.generate_batch(stack_clips(clips))
    torch.cuda.synchronize()
    assert trast.rasterize_fim_wim.launches == before + 1
    for k in ("final", "coarse", "mask", "tsf"):
        for i in range(2):
            d = (batch[k][i] - singles[i][k]).abs().max().item()
            assert d <= 1e-4, (k, i, d)


def test_stage4_step_card_vs_cpu(cuda):
    """One SGD step of training stage 4 at 64 px (parts of 16, 2 refs,
    batch 2, float32, TF32 off) on the card and on the CPU from the same
    seeded weights: metrics and every update within ``chip_smoke``'s
    stated tolerances (``TRAIN_METRIC_RTOL``, ``TRAIN_UPDATE_RTOL``)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.phase_train_reference(0, stages=(4,))


def test_data_parallel_step_two_ranks_on_card(cuda):
    """Check (b) of ``chip_smoke.py``'s phase 11: two gloo ranks sharing
    the card take one stage-4 SGD step at 64 px, global batch 4 (2 per
    rank, the faces shared 2 and 1), through ``data_parallel_jit``:
    metrics and updates within ``TRAIN_METRIC_RTOL`` /
    ``TRAIN_UPDATE_RTOL`` of one process at batch 4, replicas bitwise
    equal, the rasterizer once per rank on its 2 poses."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    assert chip_smoke.dp_reference(0, stages=(4,)) == 2


def test_avg_pool_gradient_of_channels_last_input(cuda):
    """``avg_pool_3x3s2``'s gradient on the card equals the CPU's for a
    permuted channels-last input (CUDA's ``avg_pool2d`` backward gets this
    layout wrong; the wrapper makes such an input contiguous)."""
    from jafpro_tpu_torch.ops.image import avg_pool_3x3s2

    x = np.random.RandomState(0).randn(2, 64, 64, 8).astype(np.float32)
    r = np.random.RandomState(1).randn(2, 8, 32, 32).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda):
        xt = torch.tensor(x, device=dev, requires_grad=True)
        y = avg_pool_3x3s2(xt.permute(0, 3, 1, 2))
        (g,) = torch.autograd.grad((y * torch.tensor(r, device=dev)).sum(), xt)
        grads.append(g.cpu())
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-6


@pytest.mark.parametrize("flip_y", [True, False])
@pytest.mark.parametrize("scene,S,n_faces", [
    ("random", 64, 1000), ("shuffled_sphere", 256, 13776),
    ("slivers", 256, 768)])
def test_kernel_depth_matches_plain(cuda, scene, S, n_faces, flip_y):
    """The kernel's depth output: face ids and weights as without it, depth
    within 1e-6 relative of the plain version's (the same arithmetic), 0 at
    background."""
    fv = torch.from_numpy(SCENES[scene](S, n_faces)).to(cuda)
    before = trast.rasterize_fim_wim.launches
    fim, wim, dim = trast.rasterize_fim_wim(fv, S, flip_y=flip_y,
                                            return_depth=True)
    f2, w2 = trast.rasterize_fim_wim(fv, S, flip_y=flip_y)
    torch.cuda.synchronize()
    assert trast.rasterize_fim_wim.launches == before + 2
    assert torch.equal(fim, f2) and torch.equal(wim, w2)
    rfim, rwim, rdim = trast.rasterize_fim_wim_reference(
        fv, S, flip_y=flip_y, return_depth=True)
    assert torch.equal(fim, rfim)
    found = rfim >= 0
    assert (dim[~found] == 0).all()
    rel = (dim - rdim).abs() / rdim.abs().clamp(min=1e-30)
    assert rel[found].max().item() <= 1e-6


def test_gradient_recompute_matches_kernel(cuda):
    """With a gradient the forward values stay the kernel's; the weights
    and depth the backward recomputes (``winner_weights_depth``) agree with
    them (weights 1e-5, depth 1e-6 relative)."""
    fv = torch.from_numpy(shuffled_sphere()).to(cuda)
    fim, wim, dim = trast.rasterize_fim_wim(fv, 256, return_depth=True)
    t = fv.clone().requires_grad_()
    gfim, gwim, gdim = trast.rasterize_fim_wim(t, 256, return_depth=True)
    assert torch.equal(gfim, fim) and torch.equal(gwim, wim) and torch.equal(
        gdim, dim)
    w2, d2 = trast.winner_weights_depth(fv, fim, 256)
    found = fim >= 0
    assert (w2 - wim).abs().max().item() <= 1e-5
    rel = (d2 - dim).abs() / dim.abs().clamp(min=1e-30)
    assert rel[found].max().item() <= 1e-6
    (gwim.sum() + gdim.sum()).backward()
    assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0


def test_renderer_gradient_card_vs_cpu(cuda):
    """``render(edge_gradients=True)`` and its vertex gradient on the card
    against the CPU, on a jittered quad mesh at 64x64 (float32): images
    within 1e-4, the gradient within 1e-3 relative L2."""
    from jafpro_tpu_torch.geometry.renderer import SMPLRenderer
    from jafpro_tpu_torch.train.common import synthetic_quad_mesh

    verts, faces = synthetic_quad_mesh(12)
    rng = np.random.RandomState(0)
    verts = (np.stack([verts, verts]) + 0.02 * rng.randn(2, *verts.shape)
             ).astype(np.float32)
    cam = np.float32([[1.0, 0.0, 0.0], [0.9, 0.05, -0.04]])
    tex = rng.uniform(0, 1, (2, len(faces), 3, 3, 3, 3)).astype(np.float32)
    weight = rng.randn(2, 3, 64, 64).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        r = SMPLRenderer(faces=faces, image_size=64, device=dev,
                         light_intensity_directional=0.5)
        v = torch.tensor(verts, device=dev, requires_grad=True)
        img = r.render(torch.tensor(cam, device=dev), v,
                       torch.tensor(tex, device=dev), edge_gradients=True)
        (img * torch.tensor(weight, device=dev)).sum().backward()
        out[str(dev)] = (img.detach().cpu(), v.grad.cpu())
    (ia, ga), (ib, gb) = out["cpu"], out[str(cuda)]
    assert (ia - ib).abs().max().item() <= 1e-4
    assert ((ga - gb).norm() / ga.norm()).item() <= 1e-3


CORR_SCENES = [((8, 256, 32, 32), 20, 2), ((2, 256, 48, 128), 20, 2),
               ((1, 256, 13, 29), 20, 2), ((2, 256, 32, 32), 4, 1),
               ((3, 72, 20, 70), 8, 2),   # C, W ragged against the tiles
               ((2, 2085, 12, 40), 20, 2)]  # f1's row streamed, not resident


@pytest.mark.parametrize("shape,md,s2", CORR_SCENES)
def test_correlation_kernels_match_plain(cuda, shape, md, s2):
    """Forward within 1e-5 absolute and both gradients within 1e-5
    relative L2 of the plain version in float32 (unit-normal inputs); in
    bfloat16 each within twice the plain bfloat16 form's own error against
    float32 on the same rounded inputs; the source's launch plan equal to
    ``launch_plan``'s (``chip_smoke.py`` phase 9)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    chip_smoke.check_corr_scene("test", shape, md, s2,
                                torch.Generator().manual_seed(0))


def test_correlation_launch_counts(cuda):
    """One forward launch per call, one backward launch per backward, and
    none for the plain version; a FlowNetC harness step launches each
    once, a FlowNetSD step neither."""
    # the module (the package re-exports the function under its name)
    OC = importlib.import_module("jafpro_tpu_torch.ops.correlation")
    from jafpro_tpu_torch.train.flow_harness import (
        make_flow_train_step, synthetic_flow_batch)

    f = torch.randn(2, 16, 8, 8, device=cuda, requires_grad=True)
    fwd, bwd = OC.correlation.launches, OC.correlation.backward_launches
    out = OC.correlation(f, f.detach() * 2, 4, 1)
    assert (OC.correlation.launches, OC.correlation.backward_launches) == (
        fwd + 1, bwd)
    out.sum().backward()
    OC.correlation_reference(f, f, 4, 1)
    assert (OC.correlation.launches, OC.correlation.backward_launches) == (
        fwd + 1, bwd + 1)
    pairs, flow = synthetic_flow_batch(np.random.RandomState(0), 2, 64)
    for model, want in (("c", 1), ("sd", 0)):
        init_fn, step_fn = make_flow_train_step(model, device=cuda)
        state = init_fn(torch.Generator().manual_seed(0))
        fwd, bwd = OC.correlation.launches, OC.correlation.backward_launches
        step_fn(state, pairs, flow)
        torch.cuda.synchronize()
        assert OC.correlation.launches - fwd == want
        assert OC.correlation.backward_launches - bwd == want


def test_flownet2_bfloat16_step_correlation_matches_plain(cuda,
                                                        monkeypatch):
    """A FlowNet2 harness step ("2", bfloat16, batch 8 at 256²) hands B4
    bfloat16 (8, 256, 32, 32) features: one forward and one backward
    launch; on those features and the step's own gradient of the volume
    the kernels are within twice the plain bfloat16 form's error against
    float32 (forward max abs, backward relative L2), as the scenes of
    ``test_correlation_kernels_match_plain`` are held."""
    from jafpro_tpu_torch.models import flownet
    from jafpro_tpu_torch.train.flow_harness import (
        make_flow_train_step, synthetic_flow_batch)

    OC = importlib.import_module("jafpro_tpu_torch.ops.correlation")
    seen = {}
    real = flownet.correlation

    def spy(f1, f2, md, s2):
        out = real(f1, f2, md, s2)
        seen["f"] = (f1.detach(), f2.detach(), md, s2)
        out.register_hook(lambda g: seen.setdefault("g", g.detach()))
        return out

    monkeypatch.setattr(flownet, "correlation", spy)
    init, step = make_flow_train_step("2", lr=1e-3, compute_dtype="bfloat16",
                                      device=cuda)
    state = init(torch.Generator().manual_seed(0))
    pairs, flow = synthetic_flow_batch(np.random.RandomState(0), 8, 256)
    counts = (OC.correlation.launches, OC.correlation.backward_launches)
    step(state, 255.0 * pairs, 8.0 * flow)
    torch.cuda.synchronize()
    assert (OC.correlation.launches, OC.correlation.backward_launches) == (
        counts[0] + 1, counts[1] + 1)
    f1, f2, md, s2 = seen["f"]
    g = seen["g"]
    assert f1.dtype == g.dtype == torch.bfloat16
    assert tuple(f1.shape) == (8, 256, 32, 32) and (md, s2) == (20, 2)

    def rel(a, b):
        return float((a.double() - b.double()).norm()
                     / b.double().norm().clamp_min(1e-30))

    ker = OC.correlation_cuda(f1, f2, md, s2)
    k1, k2 = OC.correlation_backward_cuda(g, f1, f2, md, s2)
    a, b = f1.float().requires_grad_(), f2.float().requires_grad_()
    r32 = OC.correlation_reference(a, b, md, s2)
    r1, r2 = torch.autograd.grad(r32, (a, b), g.float())
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    plain = OC.correlation_reference(a, b, md, s2)
    p1, p2 = torch.autograd.grad(plain, (a, b), g)
    fk = float((ker.float() - r32.detach()).abs().max())
    fp = float((plain.detach().float() - r32.detach()).abs().max())
    bk = max(rel(k1, r1), rel(k2, r2))
    bp = max(rel(p1, r1), rel(p2, r2))
    assert fk <= 2 * fp and bk <= 2 * bp, (fk, fp, bk, bp)


def test_flow_step_card_vs_cpu(cuda):
    """FlowNetC's forward and one SGD harness step at 64², batch 4, on the
    card and on the CPU (``chip_smoke.flow_reference``: forward 1e-4,
    metrics 1e-5, each module's update 5e-3 relative)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.flow_reference(0)


def test_spectral_norm_conv_card_vs_cpu(cuda):
    """The flax-style spectral-norm conv (EdgeConnect's ``_SNConv``) from
    the same seeded weights and state on the card and on the CPU, with
    ``update_sn``: outputs within 1e-4 of the largest, the stored ``u``
    and ``sigma`` within 1e-5, and the state moved by the update."""
    from jafpro_tpu_torch.models.ablations import _SNConv
    from jafpro_tpu_torch.models.common import init_params_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (2, 32, 40, 40)).astype(np.float32))
    outs, states = [], []
    for dev in (cuda, torch.device("cpu")):
        conv = init_params_(_SNConv(32, 64, 4, 2, 1, use_bias=False,
                                    spectral=True),
                            torch.Generator().manual_seed(0)).to(dev)
        u0 = conv.SpectralNorm_0.u.clone()
        for _ in range(2):
            y = conv(x.to(dev), update_sn=True)
        assert not torch.equal(conv.SpectralNorm_0.u, u0)
        outs.append(y.cpu())
        states.append((conv.SpectralNorm_0.u.cpu(),
                       conv.SpectralNorm_0.sigma.cpu()))
    assert (outs[0] - outs[1]).abs().max() <= 1e-4 * outs[1].abs().max()
    for a, b in zip(*states):
        assert (a - b).abs().max().item() <= 1e-5
