"""Port parity for the flow path's ops: ``correlation_reference`` (the
plain form of the correlation kernel) and its backward against
``jafpro_tpu.ops.correlation`` and ``jax.grad``; the backward kernel's
gathers in plain form (``correlation_backward_reference``); the kernel's
tiling (``tiled_correlation`` below mirrors ``csrc/correlation.cu``'s index
map) and its launch plan; ``resample2d``; and ``FlaxBatchNorm2d``
(FlowNet's and HMR's batch norm) against flax's ``nn.BatchNorm`` in
training mode, running statistics included.

Inputs are numpy-seeded, float32 unless a test says otherwise. Tolerances:
1e-6 absolute on the correlation (channel means of unit-normal products),
1e-5 relative L2 on its gradients, 1e-5 absolute on the warps, 1e-5
relative on batch norm.
"""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jafpro_tpu.models import hmr as jhmr
from jafpro_tpu.ops.correlation import correlation as j_corr
from jafpro_tpu.ops.sampling import resample2d as j_resample2d

from jafpro_tpu_torch.bridge import flax_from_state_dict, load_flax
from jafpro_tpu_torch.models import hmr as thmr
from jafpro_tpu_torch.models.common import FlaxBatchNorm2d
from jafpro_tpu_torch.ops.sampling import resample2d
# the module (``jafpro_tpu_torch.ops`` re-exports the function under its
# name, as ``jafpro_tpu.ops`` does)
tc = importlib.import_module("jafpro_tpu_torch.ops.correlation")

torch.set_num_threads(1)

# (B, C, H, W, max_displacement, stride2): FlowNetC's window on odd sizes
# smaller and larger than it, and a dense stride-1 window
CASES = [(2, 5, 7, 9, 20, 2), (1, 3, 13, 29, 20, 2), (2, 4, 23, 11, 2, 1),
         (1, 6, 9, 10, 4, 1)]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def features(case, seed):
    B, C, H, W, _, _ = case
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, C).astype(np.float32),
            rng.randn(B, H, W, C).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_correlation_reference_matches_jax(case):
    md, s2 = case[4:]
    a, b = features(case, 0)
    want = np.asarray(j_corr(jnp.asarray(a), jnp.asarray(b), md, s2))
    got = tc.correlation_reference(nchw(a), nchw(b), md, s2)
    n = tc.window(md, s2)
    assert got.shape == (case[0], n * n, case[2], case[3])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6, rtol=0)
    # on the CPU the wrapper is the plain version and launches nothing
    before = tc.correlation.launches
    torch.testing.assert_close(tc.correlation(nchw(a), nchw(b), md, s2), got,
                               rtol=0, atol=0)
    assert tc.correlation.launches == before


@pytest.mark.parametrize("case", CASES)
def test_correlation_gradients_match_jax(case):
    """Autograd of the plain version against ``jax.grad``, and the backward
    kernel's gathers (plain form) against both, 1e-5 relative L2."""
    md, s2 = case[4:]
    a, b = features(case, 1)
    n = tc.window(md, s2)
    g = np.random.RandomState(2).randn(case[0], case[2], case[3],
                                       n * n).astype(np.float32)
    ja, jb = jax.grad(lambda x, y: jnp.sum(j_corr(x, y, md, s2) * g),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = nchw(a).requires_grad_(), nchw(b).requires_grad_()
    ga, gb = torch.autograd.grad(tc.correlation_reference(ta, tb, md, s2),
                                 (ta, tb), nchw(g))
    ka, kb = tc.correlation_backward_reference(nchw(g), nchw(a), nchw(b),
                                               md, s2)
    for got in ((ga, gb), (ka, kb)):
        assert rel_l2(got[0].permute(0, 2, 3, 1), ja) <= 1e-5
        assert rel_l2(got[1].permute(0, 2, 3, 1), jb) <= 1e-5


def test_correlation_bfloat16_mirrors_jax():
    """bfloat16 inputs: products and mean in float32, one rounding to
    bfloat16, as XLA runs the JAX scan; held to JAX within one bfloat16
    step of each output (measured: equal)."""
    case = CASES[0]
    md, s2 = case[4:]
    a, b = features(case, 3)
    want = np.asarray(j_corr(jnp.asarray(a, jnp.bfloat16),
                             jnp.asarray(b, jnp.bfloat16), md, s2),
                      np.float32)
    got = tc.correlation_reference(nchw(a).bfloat16(), nchw(b).bfloat16(),
                                   md, s2)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= step).all()


def test_correlation_refuses_bad_arguments():
    a = torch.zeros(1, 2, 5, 5)
    with pytest.raises(ValueError, match="multiple of stride2"):
        tc.correlation(a, a, 5, 2)
    with pytest.raises(ValueError, match="one shape"):
        tc.correlation(a, torch.zeros(1, 2, 5, 6), 2, 1)
    with pytest.raises(ValueError, match="dtype"):
        tc.correlation(a, a.double(), 2, 1)
    with pytest.raises(ValueError, match="CUDA"):   # the kernel's wrapper
        tc.correlation_cuda(a, a, 2, 1)


def tiled_correlation(f1, f2, g, md, s2, dtype=torch.float32):
    """``csrc/correlation.cu``'s index map in plain torch (float64): per block
    (row y, tile of ``xt`` = 16·s2 pixels from X0) and parity class π, the
    class's 16 pixels x_m = X0 + π + s2·m against the staged rows' class
    columns t = 0 .. N-1 at x' = X0 - md + π + s2·t (N = ``nc``, the band's
    M + n - 1 = 15 + n rounded up to 8; zero outside the image and past the
    band), channels zero-padded to whole chunks, rows y ± dy outside the
    image skipped. Forward: P = A·B, out[iy·n + j, y, x_m] = P[m, m + j].
    Backward: grad_f1 = Σ_dy G·B^T with G[m, m + j] = g[iy·n + j, y, x_m];
    grad_f2 = Σ_dy G'·A'^T over f1's rows y - dy with G'[m, m + n-1-j] =
    g[iy·n + j, y - dy, x_m + (n-1-j)·s2 - md]. Returns (out, grad_f1,
    grad_f2) in float64, each divided by C."""
    plan = tc.launch_plan(tuple(f1.shape), md, s2, dtype)
    n, nc, wpc, xt = plan["n"], plan["nc"], plan["wpc"], plan["xt"]
    B, C, H, W = f1.shape
    f32 = dtype == torch.float32
    kc = 8 * wpc * (1 if f32 else 2)          # channels per forward chunk
    cb = 4 * 16 * wpc                         # channels per backward block
    nck = nc if f32 else -(-nc // 16) * 16    # the backward's K extent
    cf, cg = -(-C // kc) * kc, -(-C // cb) * cb
    a, b, gr = (t.double() for t in (f1, f2, g))
    out = torch.zeros(B, n * n, H, W, dtype=torch.float64)
    g1 = torch.zeros(B, C, H, W, dtype=torch.float64)
    g2 = torch.zeros_like(g1)
    m, j = torch.arange(16), torch.arange(n)

    def rows(fmap, row, pi, X0, cols, cpad):
        """(B, cpad, cols): fmap's row at the class columns, zero-padded."""
        t = torch.arange(cols)
        x = X0 - md + pi + s2 * t
        ok = (x >= 0) & (x < W) & (t < 15 + n)
        st = torch.zeros(B, cpad, cols, dtype=torch.float64)
        st[:, :C, ok] = fmap[:, :, row, x[ok]]
        return st

    for X0 in range(0, W, xt):
        for pi in range(s2):
            xm = X0 + pi + s2 * m
            okm = xm < W
            mv, xv = m[okm], xm[okm]
            for y in range(H):
                A = torch.zeros(B, cf, 16, dtype=torch.float64)
                A[:, :C, okm] = a[:, :, y, xv]
                for iy in range(n):
                    dy = -md + iy * s2
                    if 0 <= y + dy < H:
                        P = torch.einsum("bcm,bct->bmt", A,
                                         rows(b, y + dy, pi, X0, nc, cf))
                        band = P[:, mv[:, None], mv[:, None] + j]  # (B,m,j)
                        out[:, iy * n + j[:, None], y, xv] = \
                            band.permute(0, 2, 1)
                        G = torch.zeros(B, 16, nck, dtype=torch.float64)
                        G[:, mv[:, None], mv[:, None] + j] = gr[
                            :, iy * n + j, y][:, :, xv].permute(0, 2, 1)
                        F2 = rows(b, y + dy, pi, X0, nck, cg)
                        g1[:, :, y, xv] += torch.einsum(
                            "bmt,bct->bcm", G, F2)[:, :C, okm]
                    if 0 <= y - dy < H:
                        x_src = xm[:, None] + (n - 1 - j) * s2 - md  # (m, j)
                        ok = okm[:, None] & (x_src >= 0) & (x_src < W)
                        G = torch.zeros(B, 16, nck, dtype=torch.float64)
                        mi, ji = ok.nonzero(as_tuple=True)
                        G[:, mi, mi + n - 1 - ji] = gr[
                            :, iy * n + ji, y - dy, x_src[mi, ji]]
                        F1 = rows(a, y - dy, pi, X0, nck, cg)
                        g2[:, :, y, xv] += torch.einsum(
                            "bmt,bct->bcm", G, F1)[:, :C, okm]
    return out / C, g1 / C, g2 / C


# the kernel scenes' ragged cases at small C: W over one tile or not a
# multiple of it, stride 1 and 2, C not a multiple of a chunk
TILING_SCENES = [((1, 5, 13, 29), 20, 2), ((1, 6, 9, 21), 4, 1),
                 ((2, 9, 11, 70), 8, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,md,s2", TILING_SCENES)
def test_kernel_tiling_matches_plain_forms(shape, md, s2, dtype):
    """The kernel's index map (parity classes, N = M + n - 1 band columns,
    the band P[m, m + j], the banded G of both gradients, zero-padded C and
    W edges) gives ``correlation_reference`` and
    ``correlation_backward_reference``: 1e-6 absolute forward, 1e-5
    relative L2 on the gradients (float32 inputs; ``dtype`` picks the
    bfloat16 plan's chunks and K extent)."""
    rng = np.random.RandomState(sum(shape))
    f1, f2 = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
              for _ in range(2))
    n = tc.window(md, s2)
    g = torch.from_numpy(rng.randn(shape[0], n * n, *shape[2:]).astype(
        np.float32))
    out, g1, g2 = tiled_correlation(f1, f2, g, md, s2, dtype)
    ref = tc.correlation_reference(f1, f2, md, s2)
    r1, r2 = tc.correlation_backward_reference(g, f1, f2, md, s2)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=0)
    assert rel_l2(g1, r1) <= 1e-5 and rel_l2(g2, r2) <= 1e-5


# launch_plan for the phase-9 scenes: (forward grid, threads, shared bytes,
# backward grid, shared bytes), float32 then bfloat16. FlowNetC float32: a
# block per (x-tile, row, image) with 2 classes x 4 warps; forward shared
# words 256 x 40 (f1's row) + 4 x 32 x 88 (the f2 ring) + 2 x 4 x 16 x 40
# (partial P tiles) = 26624; backward 4 x 2 x (16 + 64) x 44 = 28160.
PLAN_SCENES = {
    ((8, 256, 32, 32), 20, 2): [((1, 32, 8), 256, 106496, (1, 32, 8),
                                 112640),
                                ((1, 32, 8), 256, 86016, (1, 32, 8), 71680)],
    ((2, 256, 48, 128), 20, 2): [((4, 48, 2), 256, 106496, (4, 48, 2),
                                  112640),
                                 ((4, 48, 2), 256, 86016, (4, 48, 2), 71680)],
    ((1, 256, 13, 29), 20, 2): [((1, 13, 1), 256, 106496, (1, 13, 1),
                                 112640),
                                ((1, 13, 1), 256, 86016, (1, 13, 1), 71680)],
    ((2, 256, 32, 32), 4, 1): [((2, 32, 2), 256, 61440, (2, 32, 2), 64512),
                               ((2, 32, 2), 256, 49152, (2, 32, 2), 46080)],
    ((3, 72, 20, 70), 8, 2): [((3, 20, 3), 256, 56320, (3, 20, 3), 71680),
                              ((3, 20, 3), 256, 51200, (3, 20, 3), 51200)],
}


@pytest.mark.parametrize("scene", list(PLAN_SCENES))
def test_launch_plan_of_the_scenes(scene):
    shape, md, s2 = scene
    for dtype, want in zip((torch.float32, torch.bfloat16),
                           PLAN_SCENES[scene]):
        p = tc.launch_plan(shape, md, s2, dtype)
        got = (p["forward"]["grid"], p["forward"]["threads"],
               p["forward"]["smem"], p["backward"]["grid"],
               p["backward"]["smem"])
        assert got == want
        assert max(got[2], got[4]) <= tc.SMEM_LIMIT


@pytest.mark.parametrize("dtype,last", [(torch.float32, 1024),
                                        (torch.bfloat16, 2048)])
def test_launch_plan_streams_f1_past_shared_memory(dtype, last):
    """At md 20, s2 2 f1's row stays resident up to ``last`` channels
    (32 x 40 words per 32-word chunk, 4 x 32 x 88 for the f2 ring, 2 x 4 x
    16 x 40 for the P tiles: 57 344 words at 32 chunks); past that its
    chunks ride the ring with f2's, at the same shared memory for any C."""
    fwd = [tc.launch_plan((2, c, 12, 40), 20, 2, dtype)["forward"]
           for c in (last, last + 1, 2085, 8 * last)]
    assert [f["f1_resident"] for f in fwd] == [True, False, False, False]
    assert fwd[0]["smem"] == 4 * (32 * 32 * 40 + 4 * 32 * 88 + 2 * 4 * 16 * 40)
    assert fwd[1]["smem"] == fwd[2]["smem"] == fwd[3]["smem"] == \
        4 * (4 * 32 * 40 + 4 * 32 * 88 + 2 * 4 * 16 * 40)
    assert fwd[0]["smem"] <= tc.SMEM_LIMIT


def test_launch_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="stride2"):
        tc.launch_plan((1, 8, 32, 32), 18, 9)
    with pytest.raises(ValueError, match="displacements"):
        tc.launch_plan((1, 8, 32, 32), 42, 1)      # n = 85
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tc.launch_plan((1, 8, 32, 32), 4, 1, torch.float16)


@pytest.mark.parametrize("H,W,scale", [(8, 8, 1.5), (7, 12, 4.0),
                                       (16, 5, 0.3)])
def test_resample2d_matches_jax(H, W, scale):
    rng = np.random.RandomState(H * W)
    img = rng.rand(2, H, W, 3).astype(np.float32)
    flow = (rng.randn(2, H, W, 2) * scale).astype(np.float32)
    want = np.asarray(j_resample2d(jnp.asarray(img), jnp.asarray(flow)))
    got = resample2d(nchw(img), nchw(flow)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def bn_variables(c, seed):
    rng = np.random.RandomState(seed)
    return {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": rng.uniform(-0.5, 0.5, c).astype(np.float32)},
            "batch_stats": {
                "mean": rng.uniform(-0.5, 0.5, c).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (4, 1, 1, 7), (1, 1, 1, 5)])
def test_flax_batch_norm_matches_flax(shape):
    """Training mode: the output (float32, from a bfloat16 input too) and
    flax's update of the running statistics by the biased batch variance;
    evaluation mode reads them."""
    B, H, W, C = shape
    v = bn_variables(C, 0)
    x = (np.random.RandomState(1).randn(*shape) * 3 + 1).astype(np.float32)
    jm = fnn.BatchNorm(use_running_average=False)
    want, upd = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tm = FlaxBatchNorm2d(C)
    load_flax(tm, v)
    got = tm.train()(nchw(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = flax_from_state_dict(tm)["batch_stats"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], np.asarray(
            upd["batch_stats"][k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert FlaxBatchNorm2d(C)(nchw(x).bfloat16()).dtype == torch.float32
    ev = np.asarray(fnn.BatchNorm(use_running_average=True).apply(
        {"params": v["params"], "batch_stats": upd["batch_stats"]},
        jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ev, rtol=1e-5, atol=1e-5)


def test_hmr_training_batch_stats_match_flax():
    """HMR in training mode (a 1-block-per-layer ResNet at 64²) moves its
    running statistics as flax does. Before ``FlaxBatchNorm2d`` it used
    ``nn.BatchNorm2d``, whose unbiased update left every ``var`` off by up
    to N/(N-1) of the step (ROADMAP.md Queue C)."""
    blocks = (1, 1, 1, 1)
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    jm = jhmr.PreActResNet50(num_blocks=blocks)
    shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a),
                            jnp.asarray(x))
    rng = np.random.RandomState(3)

    def fill(path, leaf):
        key = path[-1].key
        if key == "kernel":
            return rng.normal(0, np.prod(leaf.shape[:-1]) ** -0.5,
                              leaf.shape).astype(np.float32)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    want, upd = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    tm = thmr.PreActResNet50(num_blocks=blocks)
    load_flax(tm, v)
    got = tm.train()(nchw(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    got_s = flax_from_state_dict(tm)["batch_stats"]
    want_s = jax.tree_util.tree_map(np.asarray, upd["batch_stats"])
    flat_w = jax.tree_util.tree_leaves_with_path(want_s)
    assert len(flat_w) == 2 * (3 * sum(blocks) + 1)
    for path, w in flat_w:
        node = got_s
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, w, rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
