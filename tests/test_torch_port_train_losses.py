"""Port parity for the training losses, the discriminators, the inverse
param bridge and ``crop_faces``: ``jafpro_tpu_torch`` against ``jafpro_tpu``
on the CPU, in float32.

Tolerances: losses and their gradients rtol 1e-5 (the VGG gradient
atol 1e-4 of values up to ~5), discriminator outputs atol 1e-5, the
bridge round trip exact, bilinear face crops atol 1e-6, nearest crops
exact. Params are numpy-seeded in the flax trees' structure and go
through the bridge, or are the port's own seeded init going through the
inverse bridge into JAX.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jafpro_tpu import losses as jl
from jafpro_tpu.config import Config as JConfig
from jafpro_tpu.models import discriminators as jdisc
from jafpro_tpu.models.vgg import VGG19Features as JVGG
from jafpro_tpu.pipeline import JAFProPipeline as JPipeline
from jafpro_tpu.pipeline import crop_faces as j_crop_faces

from jafpro_tpu_torch import losses as tl
from jafpro_tpu_torch.bridge import (
    ALL_MODULES, flax_from_state_dict, jax_params, load_flax,
    state_dict_from_flax)
from jafpro_tpu_torch.checkpoints import load_params_npz, save_checkpoint
from jafpro_tpu_torch.config import Config
from jafpro_tpu_torch.models import discriminators as tdisc
from jafpro_tpu_torch.models.vgg import VGG19Features as TVGG
from jafpro_tpu_torch.pipeline import JAFProPipeline
from jafpro_tpu_torch.pipeline import crop_faces as t_crop_faces
from jafpro_tpu_torch.train.common import TrainState

torch.set_num_threads(1)
F32 = jnp.float32


def nchw(a):
    return torch.from_numpy(np.array(np.moveaxis(a, -1, 1), order="C"))


def rand(shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def numpy_params(jmod, *jargs, seed=0):
    """A param tree of ``jmod``'s structure filled from a numpy seed
    (kernels ~ N(0, 1/fan_in), other leaves uniform in [-0.5, 0.5))."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(
                np.float32)
        return rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)

    shapes = jax.eval_shape(
        lambda *a: jmod.init(jax.random.PRNGKey(0), *a), *jargs)
    return jax.tree_util.tree_map_with_path(fill, shapes)


# ---------------------------------------------------------------- losses

def test_bce_near_zero_and_one():
    """The clipped-eps formula at 0 and 1 (``nn.BCELoss`` would clamp the
    log at -100 and give 100 for a confident miss)."""
    pred = np.float32([[0.0], [1e-9], [1e-6], [0.5], [1 - 1e-6], [1.0]])
    for target in (np.ones_like(pred), np.zeros_like(pred)):
        want = float(jl.bce(jnp.asarray(pred), jnp.asarray(target)))
        got = float(tl.bce(torch.from_numpy(pred), torch.from_numpy(target)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    miss = float(tl.bce(torch.zeros(1, 1), torch.ones(1, 1)))
    np.testing.assert_allclose(miss, -np.log(np.float32(1e-7)), rtol=1e-5)
    assert float(torch.nn.functional.binary_cross_entropy(
        torch.zeros(1, 1), torch.ones(1, 1))) == pytest.approx(100.0)


def test_bce_masked_one_invalid_sample():
    pred = rand((3, 1), 1, 0.0, 1.0)
    target = np.float32([[1], [0], [1]])
    for valid in ([True, False, True], [False, False, False]):
        v = np.asarray(valid)
        want = float(jl.bce_masked(jnp.asarray(pred), jnp.asarray(target),
                                   jnp.asarray(v)))
        got = float(tl.bce_masked(torch.from_numpy(pred),
                                  torch.from_numpy(target),
                                  torch.from_numpy(v)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # the invalid sample does not count: the mean over the two valid ones
    full = float(tl.bce(torch.from_numpy(pred[[0, 2]]),
                        torch.from_numpy(target[[0, 2]])))
    np.testing.assert_allclose(
        float(tl.bce_masked(torch.from_numpy(pred), torch.from_numpy(target),
                            torch.tensor([True, False, True]))),
        full, rtol=1e-6)


def test_masked_atlas_l1():
    rng = np.random.RandomState(2)
    pred, tgt = rand((2, 8, 12, 3), 3), rand((2, 8, 12, 3), 4)
    src = (rng.rand(2, 3, 8, 12) > 0.5).astype(np.float32)
    tmask = (rng.rand(2, 2, 8, 12) > 0.5).astype(np.float32)
    want = float(jl.masked_atlas_l1(*map(jnp.asarray, (pred, tgt, src,
                                                       tmask))))
    got = float(tl.masked_atlas_l1(*map(torch.from_numpy, (pred, tgt, src,
                                                           tmask))))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_vgg_l1_loss_value_and_grad():
    """Perceptual + L1 loss at 32 px and its gradient w.r.t. the image; the
    target's features carry no gradient."""
    x, y = rand((2, 32, 32, 3), 5), rand((2, 32, 32, 3), 6)
    jvgg = JVGG(dtype=F32)
    params = numpy_params(jvgg, jnp.asarray(x))
    tvgg = TVGG()
    load_flax(tvgg, params)

    def jloss(a, b):
        return jl.vgg_l1_loss(jvgg.apply, params, a, b)

    want, (gx, gy) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    got = tl.vgg_l1_loss(tvgg, xt, yt)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    scale = float(np.abs(np.asarray(gx)).max())
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               atol=1e-4 * scale, rtol=0)
    # y reaches the loss through the plain L1 only, in both packages
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy), atol=1e-7,
                               rtol=1e-5)


# -------------------------------------------------------- discriminators

@pytest.mark.parametrize("kind,size", [("image", 128), ("face", 64)])
def test_discriminator_forward(kind, size, monkeypatch):
    """Batch 2 (batch statistics), a head map of 2x2 / 4x4, so the Dense
    rows' (H, W, C) order matters: flattening the NCHW map as it lies
    gives another answer."""
    x = rand((2, size, size, 6), 7)
    if kind == "image":
        j, t = jdisc.ImageDiscriminator(dtype=F32), \
            tdisc.ImageDiscriminator(size)
    else:
        j, t = jdisc.FaceDiscriminator(dtype=F32), \
            tdisc.FaceDiscriminator(size)
    params = numpy_params(j, jnp.asarray(x), seed=1)
    load_flax(t, params)
    want = np.asarray(jax.jit(j.apply)(params, jnp.asarray(x)))
    got = t(nchw(x)).detach().numpy()
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    def chw_flatten(self, h):
        h = h.reshape(h.shape[0], -1)
        return torch.sigmoid(self.Dense_1(
            torch.nn.functional.leaky_relu(self.Dense_0(h), 0.2)))

    monkeypatch.setattr(tdisc._MLPHead, "forward", chw_flatten)
    wrong = t(nchw(x)).detach().numpy()
    assert np.abs(wrong - want).max() > 1e-3


# ---------------------------------------------------------------- bridge

def small_cfgs():
    kw = dict(image_size=64, part_size=16, maximum_ref_frames=2,
              face_crop_size=16, compute_dtype="float32")
    return Config(**kw), JConfig(**kw)


def test_bridge_round_trip_and_tree_structure():
    """port -> flax -> port is exact for every module, and the flax tree
    the port writes has the JAX pipeline's structure and shapes."""
    cfg, jcfg = small_cfgs()
    pipe = JAFProPipeline(cfg, flow_engine=None, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    tree = jax_params(pipe)
    jshapes = jax.eval_shape(JPipeline(jcfg, flow_engine=None).init_params,
                             jax.random.PRNGKey(0))
    assert set(tree) == set(ALL_MODULES) == set(jshapes)
    jax.tree_util.tree_map(
        lambda a, s: np.testing.assert_equal(a.shape, s.shape), tree,
        jshapes)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(jshapes)
    for name in ALL_MODULES:
        mod = getattr(pipe, name)
        back = state_dict_from_flax(flax_from_state_dict(mod), mod)
        sd = mod.state_dict()
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), (name, k)


def test_port_checkpoint_loads_into_jax(tmp_path):
    """A port-written ``.npz`` (the port's own seeded weights) loads into the
    JAX pipeline, and the JAX modules give the port's outputs."""
    cfg, jcfg = small_cfgs()
    pipe = JAFProPipeline(cfg, flow_engine=None, device="cpu",
                          generator=torch.Generator().manual_seed(4))
    path = save_checkpoint(str(tmp_path), 7, pipe, TrainState(pipe, {}))
    params = jax.tree_util.tree_map(jnp.asarray, load_params_npz(path))
    for name in os.listdir(tmp_path):  # ~0.5 GB: do not keep it
        os.remove(os.path.join(tmp_path, name))
    jpipe = JPipeline(jcfg, flow_engine=None)
    S, B = cfg.image_size, 2
    img = rand((B, S, S, 6), 8)
    face = rand((B, 16, 16, 6), 9)
    parts = rand((B, 2, 24, 16, 16, 3), 10)
    smask = (rand((B, 2, 24, 16, 16), 11, 0, 1) > 0.5).astype(np.float32)
    refm = np.float32([[1, 1], [1, 0]])

    def jrun(p, img, face, parts, smask, refm):
        inp, _ = jpipe.prepare_textures(p, parts, refm, smask)
        return (jpipe.D.apply(p["D"], img), jpipe.FD.apply(p["FD"], face),
                jpipe.vgg.apply(p["vgg"], img[..., :3])[-1],
                jpipe.background(p, img[..., :3]), inp,
                jpipe.pro.apply(p["pro"], img[..., :3], img[..., 3:],
                                img[..., :3], img[..., :1])["pred_target"])

    want = jax.jit(jrun)(params, *map(jnp.asarray, (img, face, parts,
                                                     smask, refm)))
    with torch.no_grad():
        inp, _ = pipe.prepare_textures(torch.from_numpy(parts),
                                       torch.from_numpy(refm),
                                       torch.from_numpy(smask))
        c = nchw(img)
        got = (pipe.D(c), pipe.FD(nchw(face)),
               pipe.vgg(c[:, :3])[-1].permute(0, 2, 3, 1),
               pipe.background(torch.from_numpy(img[..., :3])), inp,
               pipe.pro(c[:, :3], c[:, 3:], c[:, :3], c[:, :1])[
                   "pred_target"].permute(0, 2, 3, 1))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(w).max()))


# ------------------------------------------------------------ face crops

@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_crop_faces(mode):
    """An integer box, a box on half pixels (nearest rounds with
    floor(x + 0.5)) and an empty box."""
    images = rand((3, 32, 32, 3), 12)
    bbox = np.float32([[4, 20, 6, 30], [4.5, 20.5, 6.5, 22.5], [0, 0, 0, 0]])
    want = np.asarray(jax.jit(j_crop_faces, static_argnums=(2, 3))(
        jnp.asarray(images), jnp.asarray(bbox), 16, mode))
    got = t_crop_faces(torch.from_numpy(images), torch.from_numpy(bbox), 16,
                       mode).numpy()
    assert got.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=0 if mode == "nearest"
                               else 1e-6, rtol=0)
