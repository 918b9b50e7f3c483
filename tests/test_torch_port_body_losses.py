"""Port parity: the extra losses (``losses_extra.py``) and LPIPS
(``lpips.py``) against ``jafpro_tpu`` on the CPU, float32, with weights
bridged from the JAX package's param trees (and, for LPIPS, torch
state_dicts the tests write).

Tolerances: losses within 1e-5 relative (VGG-based ones 1e-4: conv
stacks in two libraries); LPIPS distances within 1e-5 relative.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from jafpro_tpu import losses_extra as JX
from jafpro_tpu import lpips as jlp

from jafpro_tpu_torch import bridge
from jafpro_tpu_torch import losses_extra as TX
from jafpro_tpu_torch import lpips as tlp
from jafpro_tpu_torch.models.common import Conv2d

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
RTOL = 1e-5
VGG_RTOL = 1e-4


def nchw(a):
    return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2)


def assert_rel(t, j, rtol=RTOL):
    if isinstance(t, torch.Tensor):
        t = t.detach()
    t, j = float(t), float(j)
    assert abs(t - j) <= rtol * max(abs(j), 1e-6), (t, j)


@pytest.fixture(scope="module")
def vgg_pair():
    """VGG19 taps (vid2vid, max pool) in both packages, bridged."""
    x = jnp.zeros((1, 32, 32, 3))
    m = JX.VGG19Taps(taps=JX.VID2VID_VGG_TAPS, pool="max")
    v = m.init(KEY, x)
    t = TX.VGG19Taps(TX.VID2VID_VGG_TAPS, pool="max")
    bridge.load_flax(t, v)
    return (lambda im: m.apply(v, im)), t


@pytest.mark.parametrize("taps,pool", [("VID2VID_VGG_TAPS", "max"),
                                       ("TRUNC_VGG_TAPS", "avg")])
def test_vgg_taps_match_jax(taps, pool):
    m = JX.VGG19Taps(taps=getattr(JX, taps), pool=pool)
    x = np.random.RandomState(1).randn(1, 32, 32, 3).astype(np.float32)
    v = m.init(KEY, jnp.asarray(x))
    t = TX.VGG19Taps(getattr(TX, taps), pool=pool)
    bridge.load_flax(t, v)
    jf = m.apply(v, jnp.asarray(x))
    with torch.no_grad():
        tf = t(nchw(x))
    assert len(tf) == len(jf)
    for a, b in zip(tf, jf):
        b = np.asarray(b)
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), b,
                                   atol=VGG_RTOL * np.abs(b).max())


def test_vgg_taps_load_a_whole_vgg19_tree():
    """Taps that stop at block 4 load the block 1-4 subtrees of a
    VGG19Features tree, as flax ignores the unused block 5; the whole tree
    is refused by the strict load."""
    from jafpro_tpu.models.vgg import VGG19Features

    full = VGG19Features().init(KEY, jnp.zeros((1, 32, 32, 3)))
    t = TX.VGG19Taps(TX.TRUNC_VGG_TAPS)
    with pytest.raises(Exception):
        bridge.load_flax(t, full)
    owned = dict(t.named_children())
    bridge.load_flax(t, {"params": {k: v for k, v in full["params"].items()
                                    if k in owned}})
    np.testing.assert_array_equal(
        t.conv4_4.bias.detach().numpy(),
        np.asarray(full["params"]["conv4_4"]["bias"]))


def test_sequence_and_masked_losses_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 4, 4, 3).astype(np.float32)
    y = rng.randn(2, 3, 4, 4, 3).astype(np.float32)
    assert_rel(TX.vid_loss(torch.from_numpy(x), torch.from_numpy(y),
                           lambda a, b: (a - b).abs().mean()),
               JX.vid_loss(jnp.asarray(x), jnp.asarray(y),
                           lambda a, b: jnp.abs(a - b).mean()))
    with pytest.raises(ValueError):
        TX.vid_loss(torch.from_numpy(x), torch.from_numpy(y), None, "exp")
    p, t = rng.randn(2, 8, 8, 3), rng.randn(2, 8, 8, 3)
    mask = (rng.rand(2, 8, 8, 1) > 0.5).astype(np.float32)
    assert_rel(TX.masked_l1_loss(nchw(p), nchw(t), nchw(mask)),
               JX.masked_l1_loss(jnp.asarray(p), jnp.asarray(t),
                                 jnp.asarray(mask)))
    f = rng.randn(2, 5, 6, 7).astype(np.float32)
    np.testing.assert_allclose(
        TX.gram_matrix(nchw(f)).numpy(),
        np.asarray(JX.gram_matrix(jnp.asarray(f))), rtol=1e-5, atol=1e-4)
    for real in (True, False):
        pr = rng.rand(2, 4, 4, 1).astype(np.float32)
        assert_rel(TX.nsgan_loss(nchw(pr), real),
                   JX.nsgan_loss(jnp.asarray(pr), real))


def test_vgg_losses_match_jax(vgg_pair):
    jfn, tnet = vgg_pair
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    y = np.clip(x + 0.2 * rng.randn(*x.shape), -1, 1).astype(np.float32)
    jx, jy, tx_, ty = jnp.asarray(x), jnp.asarray(y), nchw(x), nchw(y)
    assert_rel(TX.vid2vid_vgg_loss(tnet, tx_, ty),
               JX.vid2vid_vgg_loss(jfn, jx, jy), VGG_RTOL)
    assert_rel(TX.style_loss(tnet, tx_, ty, size=24),
               JX.style_loss(jfn, jx, jy, size=24), VGG_RTOL)
    assert_rel(TX.face_feature_loss(tnet, tx_, ty, size=(28, 24)),
               JX.face_feature_loss(jfn, jx, jy, size=(28, 24)), VGG_RTOL)
    w = (0.5, 1.0, 2.0, 0.1, 0.3)
    assert_rel(TX.face_feature_loss(tnet, tx_, ty, weights=w, size=(28, 24)),
               JX.face_feature_loss(jfn, jx, jy, weights=w, size=(28, 24)),
               VGG_RTOL)


def test_pvgg_losses_match_jax():
    m = JX.VGG19Taps(taps=JX.TRUNC_VGG_TAPS, pool="avg")
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    v = m.init(KEY, jnp.asarray(x))
    t = TX.VGG19Taps(TX.TRUNC_VGG_TAPS, pool="avg")
    bridge.load_flax(t, v)
    jfn = lambda im: m.apply(v, im)
    stds = [rng.uniform(0.5, 2.0, (c,)).astype(np.float32)
            for c in (64, 64, 128, 128, 256, 256, 256, 256,
                      512, 512, 512, 512)]
    assert_rel(TX.pvgg_loss(t, nchw(x), nchw(y),
                            [torch.from_numpy(s) for s in stds]),
               JX.pvgg_loss(jfn, jnp.asarray(x), jnp.asarray(y),
                            [jnp.asarray(s) for s in stds]), VGG_RTOL)
    assert_rel(TX.pvgg_loss_no_norm(t, nchw(x), nchw(y), 12),
               JX.pvgg_loss_no_norm(jfn, jnp.asarray(x), jnp.asarray(y), 12),
               VGG_RTOL)


def test_loss_gradients_detach_the_target(vgg_pair):
    """hmr_loss, vid2vid_vgg_loss and face_feature_loss stop the target's
    gradient, as the JAX package's stop_gradient does."""
    jfn, tnet = vgg_pair
    rng = np.random.RandomState(5)
    x = rng.randn(1, 8, 8, 3).astype(np.float32)
    y = rng.randn(1, 8, 8, 3).astype(np.float32)

    def hmr_fn_t(a):
        return a.mean(dim=(2, 3)), a.sum(dim=(2, 3))

    def hmr_fn_j(a):
        return a.mean(axis=(1, 2)), a.sum(axis=(1, 2))

    tx_, ty = nchw(x).requires_grad_(), nchw(y).requires_grad_()
    loss = TX.hmr_loss(hmr_fn_t, tx_, ty)
    loss.backward()
    assert_rel(loss, JX.hmr_loss(hmr_fn_j, jnp.asarray(x), jnp.asarray(y)))
    jg = jax.grad(lambda a, b: JX.hmr_loss(hmr_fn_j, a, b), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(tx_.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jg[0]), atol=1e-6)
    assert ty.grad is None or (ty.grad == 0).all()
    assert not np.asarray(jg[1]).any()


def test_edgeconnect_losses_match_jax(vgg_pair):
    jfn, tnet = vgg_pair
    rng = np.random.RandomState(6)
    img = rng.randn(1, 32, 32, 3).astype(np.float32)
    # the same disc_fn in both: one 4x4/2 conv + sigmoid, numpy weights
    k = (0.1 * rng.randn(4, 4, 3, 1)).astype(np.float32)
    conv = Conv2d(3, 1, 4, 2, 1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))

    def jdisc(x):
        y = jax.lax.conv_general_dilated(
            x, jnp.asarray(k), (2, 2), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jax.nn.sigmoid(y), [y]

    def tdisc(x):
        y = conv(x)
        return torch.sigmoid(y), [y]

    out = (np.tanh(img) * 0.5 + 0.5).astype(np.float32)
    real = np.full_like(img, 0.5)
    mask = (rng.rand(1, 32, 32, 1) > 0.3).astype(np.float32)
    jg, jd, jlogs = JX.edgeconnect_inpainting_losses(
        jnp.asarray(out), jnp.asarray(real), jnp.asarray(mask), jdisc, jfn)
    tg, td, tlogs = TX.edgeconnect_inpainting_losses(
        nchw(out), nchw(real), nchw(mask), tdisc, tnet)
    assert set(tlogs) == set(jlogs)
    assert_rel(tg, jg, VGG_RTOL)
    assert_rel(td, jd, VGG_RTOL)
    for k_ in jlogs:
        assert_rel(tlogs[k_], jlogs[k_], VGG_RTOL)


def test_lpips_matches_jax():
    m = jlp.LPIPS()
    rng = np.random.RandomState(7)
    x = (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    y = np.clip(x + 0.5 * rng.randn(*x.shape), -1, 1).astype(np.float32)
    v = m.init(KEY, jnp.asarray(x), jnp.asarray(x))
    heads = {f"lin{k}": rng.uniform(0.1, 1.0, np.shape(
        v["params"][f"lin{k}"])).astype(np.float32) for k in range(5)}
    v = {"params": dict(v["params"], **heads)}
    t = tlp.LPIPS(device="cpu")
    bridge.load_flax(t, v)
    jd = np.asarray(m.apply(v, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        td = t(nchw(x), nchw(y)).numpy()
    np.testing.assert_allclose(td, jd, rtol=RTOL)
    assert (td > 1e-4).all()
    pred = rng.rand(2, 32, 32, 3).astype(np.float32)
    gt = rng.rand(2, 32, 32, 3).astype(np.float32)
    assert_rel(tlp.lpips_pair(t, pred, gt), jlp.lpips_pair(v, pred, gt))
    assert tlp.lpips_pair(t, pred, pred) < 1e-5
    # the bridge gives back the JAX tree
    back = bridge.flax_from_state_dict(t)["params"]
    np.testing.assert_array_equal(back["lin3"], heads["lin3"])
    np.testing.assert_array_equal(back["vgg"]["conv5_3"]["kernel"],
                                  np.asarray(v["params"]["vgg"]["conv5_3"]
                                             ["kernel"]))


def test_load_torch_lpips_matches_jax(tmp_path):
    """Torch state_dicts written by the test, in torchvision's VGG16 and
    the lpips package's layouts, load to the same weights in both."""
    rng = np.random.RandomState(8)
    sd, cin = {}, 3
    for idx, w in zip(tlp._TORCHVISION_IDX,
                      [w for ws in tlp._VGG16_BLOCKS for w in ws]):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (0.05 * rng.randn(w, cin, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            (0.01 * rng.randn(w)).astype(np.float32))
        cin = w
    heads = {f"lin{k}.model.1.weight": torch.from_numpy(
        rng.rand(1, ws[-1], 1, 1).astype(np.float32))
        for k, ws in enumerate(tlp._VGG16_BLOCKS)}
    vp, hp = str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth")
    torch.save(sd, vp)
    torch.save(heads, hp)
    t = tlp.LPIPS(device="cpu")
    t.load_state_dict(tlp.load_torch_lpips(vp, hp), strict=True)
    jv = jlp.load_torch_lpips(vp, hp)
    x = (rng.rand(1, 32, 32, 3) * 2 - 1).astype(np.float32)
    y = (rng.rand(1, 32, 32, 3) * 2 - 1).astype(np.float32)
    jd = np.asarray(jlp.LPIPS().apply(jv, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        td = t(nchw(x), nchw(y)).numpy()
    np.testing.assert_allclose(td, jd, rtol=RTOL)
