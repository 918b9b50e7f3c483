"""Port parity for evaluation: ``jafpro_tpu_torch``'s metrics, losses,
``VGG19Features``, ``FlowNetSD``, their torch-checkpoint loaders and the
bridge's transposed-conv and batch-norm rules, against ``jafpro_tpu``'s on
the CPU, in float32.

Inputs and weights are numpy-seeded; weights reach the port through
``bridge.load_flax`` (batch norm with random running means and variances
away from 1). Tolerances: 1e-5 absolute for the metrics (values of order
1); for the nets 1e-4 relative to the largest output magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jafpro_tpu import evaluate as jeval
from jafpro_tpu import losses as jlosses
from jafpro_tpu.models.flownet import FlowNetSD as JFlowNetSD
from jafpro_tpu.models.flownet import load_torch_flownet_sd as j_load_flownet
from jafpro_tpu.models.vgg import VGG19Features as JVGG
from jafpro_tpu.models.vgg import load_torch_vgg19 as j_load_vgg

from jafpro_tpu_torch import evaluate, losses
from jafpro_tpu_torch.bridge import load_flax, state_dict_from_flax
from jafpro_tpu_torch.models.flownet import FlowNetSD, load_torch_flownet_sd
from jafpro_tpu_torch.models.vgg import VGG19Features, load_torch_vgg19

torch.set_num_threads(1)
CPU = "cpu"
# the JAX nets' forward passes, compiled once per input shape
J_VGG = jax.jit(JVGG().apply)
J_FLOW = jax.jit(JFlowNetSD().apply)


def numpy_variables(jmod, x, seed=0):
    """``jmod``'s variables (``eval_shape`` of ``init``: nothing compiled)
    filled from a numpy seed: kernels ~ N(0, 1/fan_in), biases and
    batch-norm shifts and means uniform in [-0.5, 0.5), batch-norm scales
    uniform in [0.5, 1.5) and variances in [0.3, 2.5)."""
    shapes = jax.eval_shape(lambda a: jmod.init(jax.random.PRNGKey(0), a), x)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        key = path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(
                np.float32)
        if key == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if key == "var":
            return rng.uniform(0.3, 2.5, leaf.shape).astype(np.float32)
        return rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_rel(got, want, rtol, what=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert np.isfinite(got).all() and scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def frames(seed, T=3, H=64, W=64):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (T, H, W, 3)).astype(np.uint8)


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("shape", [(1, 256, 256), (2, 75, 83), (2, 20, 13)])
def test_ssim_ms_ssim_psnr(shape):
    rng = np.random.RandomState(sum(shape))
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for port, ref in ((evaluate.ssim, jeval.ssim),
                      (evaluate.ms_ssim, jeval.ms_ssim),
                      (evaluate.psnr, jeval.psnr)):
        np.testing.assert_allclose(port(ta, tb).numpy(),
                                   np.asarray(ref(ja, jb)), atol=1e-5,
                                   rtol=0, err_msg=port.__name__)
    # odd sizes: the edge-replicating downsample, at every level
    np.testing.assert_allclose(
        evaluate._downsample2(ta).numpy(),
        np.asarray(jeval._downsample2(ja)), atol=1e-6, rtol=0)
    assert torch.isinf(evaluate.psnr(ta, ta)).all()
    assert np.isinf(np.asarray(jeval.psnr(ja, ja))).all()


def test_rgb_to_gray_and_losses():
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (2, 5, 6, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 5, 6, 3)).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(evaluate.rgb_to_gray(tx).numpy(),
                               np.asarray(jeval.rgb_to_gray(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(losses.vgg_preprocess(tx).numpy(),
                               np.asarray(jlosses.vgg_preprocess(x)),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(losses.l1(tx, ty)),
                               float(jlosses.l1(x, y)), atol=1e-6, rtol=0)
    fx = [rng.rand(2, 4, 4, c).astype(np.float32) for c in (1, 2, 3, 4, 5)]
    fy = [rng.rand(*f.shape).astype(np.float32) for f in fx]
    for w in (losses.VGG_LOSS_WEIGHTS, losses.CRN_VGG_WEIGHTS):
        got = losses.vgg_feature_l1([torch.from_numpy(f) for f in fx],
                                    [torch.from_numpy(f) for f in fy], w)
        np.testing.assert_allclose(float(got),
                                   float(jlosses.vgg_feature_l1(fx, fy, w)),
                                   atol=1e-5, rtol=0)
    assert losses.VGG_LOSS_WEIGHTS == jlosses.VGG_LOSS_WEIGHTS
    assert losses.CRN_VGG_WEIGHTS == jlosses.CRN_VGG_WEIGHTS


@pytest.mark.parametrize("as_float", [False, True])
def test_evaluate_video_and_similarity_without_hooks(as_float):
    p, g = frames(2, T=2), frames(3, T=2)
    g[1] = p[1]  # one identical frame: psnr inf for it
    if as_float:
        p, g = p / 255.0, g / 255.0
    got = evaluate.evaluate_video(p, g, device=CPU)
    want = jeval.evaluate_video(p, g)
    assert set(got) == set(want) == {"ssim", "l1", "ms_ssim", "psnr"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    got = evaluate.similarity_analysis(p, g, device=CPU)
    want = jeval.similarity_analysis(p, g)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_metrics_refuse_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.evaluate_video(frames(0), frames(1))


def test_scoring_runs_without_tf32(monkeypatch):
    """Both scoring functions turn TF32 off in cuDNN and cuBLAS while they
    run, whatever the caller set, and give the caller's settings back;
    the deep-metric nets run inside that block."""
    seen = []

    def spy(x):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return [x.mean(dim=(2, 3), keepdim=True)] * 5

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    real_ssim = evaluate.ssim
    monkeypatch.setattr(evaluate, "ssim", lambda a, b: (
        spy(a[:, None]), real_ssim(a, b))[1])
    evaluate.evaluate_video(frames(0, T=2), frames(1, T=2), vgg=spy,
                            device=CPU)
    evaluate.similarity_analysis(frames(0, T=2), frames(1, T=2), device=CPU)
    assert seen == [(False, False)] * 4
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


# ------------------------------------------------------------------- nets

@pytest.fixture(scope="module")
def nets():
    """Port VGG19 and FlowNetSD loaded through the bridge from the same
    numpy variables as the JAX modules."""
    vvars = numpy_variables(JVGG(), jnp.zeros((1, 32, 32, 3)), seed=0)
    fvars = numpy_variables(JFlowNetSD(), jnp.zeros((1, 64, 64, 6)), seed=1)
    vgg, flow = VGG19Features(), FlowNetSD()
    load_flax(vgg, vvars)
    load_flax(flow, fvars)
    return {"vvars": vvars, "fvars": fvars,
            "vgg": vgg.eval(), "flow": flow.eval()}


def test_vgg19_features_match_jax(nets):
    x = np.random.RandomState(4).uniform(-120, 120, (2, 32, 32, 3)).astype(
        np.float32)
    want = J_VGG(nets["vvars"], jnp.asarray(x))
    with torch.no_grad():
        got = nets["vgg"](torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, i
        assert_rel(g, w, 1e-4, f"feature {i}")


def test_flownet_sd_matches_jax(nets):
    """Non-trivial running statistics and every transposed conv on the
    path (deconv2..5, up_flow3..6)."""
    assert float(nets["flow"].conv0.BatchNorm_0.running_var.min()) > 0.29
    x = np.random.RandomState(5).rand(1, 64, 64, 6).astype(np.float32)
    want = np.asarray(J_FLOW(nets["fvars"], jnp.asarray(x)))
    with torch.no_grad():
        got = nets["flow"](torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 16, 16, 2)
    assert_rel(got, want, 1e-4, "flow2")


def test_evaluate_video_with_both_hooks_matches_jax(nets):
    p, g = frames(6, T=2), frames(7, T=2)
    want = jeval.evaluate_video(
        p, g, vgg_apply=J_VGG, vgg_params=nets["vvars"],
        flow_apply=J_FLOW, flow_params=nets["fvars"])
    got = evaluate.evaluate_video(p, g, vgg=nets["vgg"],
                                  flownet=nets["flow"], device=CPU)
    assert set(got) == set(want) == {"ssim", "l1", "ms_ssim", "psnr", "vgg",
                                     "flow_l1"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_bridge_conv_transpose_rule():
    """A flax ``ConvTranspose(k=4, s=2, "SAME")`` kernel (not flipped,
    (kh, kw, cin, cout)) becomes a ``ConvTranspose2d(4, 2, 1)`` weight by
    the module's rule; read by the rank (as a conv) it would be wrong."""
    import flax.linen as fnn

    jm = fnn.ConvTranspose(3, (4, 4), strides=(2, 2), padding="SAME")
    x = np.random.RandomState(8).rand(1, 5, 6, 2).astype(np.float32)
    v = numpy_variables(jm, jnp.asarray(x), seed=8)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = torch.nn.ConvTranspose2d(2, 3, 4, 2, 1)
    load_flax(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)
    k = np.asarray(v["params"]["kernel"])
    assert not np.allclose(tm.weight.detach().numpy(), k.transpose(2, 3, 0, 1))
    with pytest.raises(TypeError):
        state_dict_from_flax(v, torch.nn.Linear(2, 3))


# ---------------------------------------------- torch-checkpoint loaders

def torch_layout_flownet(fvars, seed=9):
    """A state dict in the reference FlowNetSD's key layout (keys and
    shapes read off the JAX tree, values numpy-seeded)."""
    rng = np.random.RandomState(seed)
    params = fvars["params"]
    up = {f"up_flow{i}": f"upsampled_flow{i}_to_{i - 1}" for i in range(3, 7)}
    sd = {}

    def put(key, shape, lo=-0.5, hi=0.5):
        sd[key] = torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32))

    for mod, sub in params.items():
        if mod in up:
            kh, kw, ci, co = sub["kernel"].shape
            put(f"{up[mod]}.weight", (ci, co, kh, kw))
            put(f"{up[mod]}.bias", (co,))
        elif mod.startswith("predict_flow"):
            kh, kw, ci, co = sub["Conv_0"]["kernel"].shape
            put(f"{mod}.weight", (co, ci, kh, kw))
            put(f"{mod}.bias", (co,))
        elif mod.startswith("deconv"):
            kh, kw, ci, co = sub["ConvTranspose_0"]["kernel"].shape
            put(f"{mod}.0.weight", (ci, co, kh, kw), -0.1, 0.1)
            put(f"{mod}.0.bias", (co,))
        else:
            kh, kw, ci, co = sub["Conv_0"]["kernel"].shape
            put(f"{mod}.0.weight", (co, ci, kh, kw),
                -(kh * kw * ci) ** -0.5, (kh * kw * ci) ** -0.5)
            if "bias" in sub["Conv_0"]:
                put(f"{mod}.0.bias", (co,))
            put(f"{mod}.1.weight", (co,), 0.5, 1.5)
            put(f"{mod}.1.bias", (co,))
            put(f"{mod}.1.running_mean", (co,))
            put(f"{mod}.1.running_var", (co,), 0.3, 2.5)
            sd[f"{mod}.1.num_batches_tracked"] = torch.tensor(7)
    return sd


def test_torch_checkpoint_loaders_match_jax(nets, tmp_path):
    rng = np.random.RandomState(10)
    vsd = {}
    for idx, (name, sub) in zip(
            (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34),
            nets["vvars"]["params"].items()):
        kh, kw, ci, co = sub["kernel"].shape
        vsd[f"features.{idx}.weight"] = torch.from_numpy(rng.normal(
            0, (kh * kw * ci) ** -0.5, (co, ci, kh, kw)).astype(np.float32))
        vsd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.uniform(-0.5, 0.5, co).astype(np.float32))
    vsd["classifier.0.weight"] = torch.zeros(4, 4)  # not a conv: ignored
    torch.save(vsd, tmp_path / "vgg19.pth")
    torch.save({"state_dict": torch_layout_flownet(nets["fvars"]),
                "epoch": 3}, tmp_path / "flownet_sd.pth")

    x = np.random.RandomState(11).uniform(-120, 120, (1, 32, 32, 3)).astype(
        np.float32)
    jv = j_load_vgg(str(tmp_path / "vgg19.pth"))
    vgg = VGG19Features()
    vgg.load_state_dict(load_torch_vgg19(str(tmp_path / "vgg19.pth")),
                        strict=True)
    with torch.no_grad():
        got = vgg(torch.from_numpy(x).permute(0, 3, 1, 2))
    for i, (g, w) in enumerate(zip(got, J_VGG(jv, jnp.asarray(x)))):
        assert_rel(g.permute(0, 2, 3, 1).numpy(), w, 1e-4, f"vgg {i}")

    y = np.random.RandomState(12).rand(1, 64, 64, 6).astype(np.float32)
    jf = j_load_flownet(str(tmp_path / "flownet_sd.pth"))
    flow = FlowNetSD()
    flow.load_state_dict(load_torch_flownet_sd(
        str(tmp_path / "flownet_sd.pth")), strict=True)
    with torch.no_grad():
        got = flow(torch.from_numpy(y).permute(0, 3, 1, 2))
    assert_rel(got.permute(0, 2, 3, 1).numpy(),
               J_FLOW(jf, jnp.asarray(y)), 1e-4, "flownet")
