"""Port parity: ops, projection, texture warps and the barycentric
transform of ``jafpro_tpu_torch`` against ``jafpro_tpu`` on the CPU.

Inputs come from a numpy seed and go to both packages; float32 throughout.
Tolerance atol 1e-5 (the two evaluate the same expressions; only the order
of a few sums and the matmul blocking differ).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jafpro_tpu.data import texture as jtex
from jafpro_tpu.geometry import flow as jflow
from jafpro_tpu.geometry import projection as jproj
from jafpro_tpu.ops import image as jimage
from jafpro_tpu.ops import sampling as jsamp
from jafpro_tpu.train.common import normalize_batch as j_normalize_batch

from jafpro_tpu_torch.data import texture as ttex
from jafpro_tpu_torch.geometry import flow as tflow
from jafpro_tpu_torch.geometry import projection as tproj
from jafpro_tpu_torch.infer import normalize_batch as t_normalize_batch
from jafpro_tpu_torch.ops import image as timage
from jafpro_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(1)
ATOL = 1e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample(padding_mode, mode):
    rng = np.random.RandomState(0)
    img = rng.uniform(-1, 1, (2, 9, 11, 3)).astype(np.float32)
    # covers in-range, out-of-range and exactly-on-border coordinates
    grid = rng.uniform(-1.4, 1.4, (2, 7, 5, 2)).astype(np.float32)
    grid[0, 0, 0] = [-1.0, 1.0]
    grid[0, 0, 1] = [-2.0, -2.0]
    want = jsamp.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                             padding_mode=padding_mode, mode=mode)
    got = tsamp.grid_sample(nchw(img), torch.from_numpy(grid),
                            padding_mode=padding_mode, mode=mode)
    close(to_nhwc(got), want)


def test_grid_sample_pixel_coords():
    rng = np.random.RandomState(1)
    img = rng.uniform(-1, 1, (1, 6, 8, 2)).astype(np.float32)
    grid = rng.uniform(-1, 9, (1, 4, 4, 2)).astype(np.float32)
    want = jsamp.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                             pixel_coords=True)
    got = tsamp.grid_sample(nchw(img), torch.from_numpy(grid),
                            pixel_coords=True)
    close(to_nhwc(got), want)


@pytest.mark.parametrize("size,align", [
    ((16, 12), True), ((3, 5), True), ((1, 1), True), ((14, 18), False),
    ((4, 3), False), ((7, 9), True)])
def test_resize_bilinear(size, align):
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (2, 7, 9, 4)).astype(np.float32)
    want = jsamp.resize_bilinear(jnp.asarray(x), size, align_corners=align)
    got = tsamp.resize_bilinear(nchw(x), size, align_corners=align)
    close(to_nhwc(got), want)


@pytest.mark.parametrize("size", [(14, 18), (3, 4), (7, 9)])
def test_resize_nearest(size):
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (2, 7, 9, 3)).astype(np.float32)
    want = jsamp.resize_nearest(jnp.asarray(x), size)
    got = tsamp.resize_nearest(nchw(x), size)
    np.testing.assert_array_equal(to_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (1, 1)])
def test_pools_and_channel_norm(hw):
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (2, *hw, 5)).astype(np.float32)
    close(to_nhwc(timage.avg_pool_3x3s2(nchw(x))),
          jimage.avg_pool_3x3s2(jnp.asarray(x)))
    np.testing.assert_array_equal(
        to_nhwc(timage.max_pool_3x3s2(nchw(x))),
        np.asarray(jimage.max_pool_3x3s2(jnp.asarray(x))))
    close(to_nhwc(timage.channel_norm(nchw(x))),
          jimage.channel_norm(jnp.asarray(x)))


def test_projection():
    rng = np.random.RandomState(5)
    verts = rng.uniform(-1, 1, (3, 20, 3)).astype(np.float32)
    cam = rng.uniform(0.5, 1.5, (3, 3)).astype(np.float32)
    faces = rng.randint(0, 20, (30, 3)).astype(np.int32)
    want = jproj.project_to_view(jnp.asarray(verts), jnp.asarray(cam))
    got = tproj.project_to_view(torch.from_numpy(verts),
                                torch.from_numpy(cam))
    close(got.numpy(), want)
    close(tproj.project_to_view_np(verts, cam),
          jproj.project_to_view_np(verts, cam))
    close(tproj.vertices_to_faces(got, torch.from_numpy(faces).long()),
          jproj.vertices_to_faces(want, jnp.asarray(faces)))
    eye = np.array([0.3, -0.2, -2.5], np.float32)
    close(tproj.look_at(torch.from_numpy(verts), eye).numpy(),
          jproj.look_at(jnp.asarray(verts), eye))


def _iuv(rng, B, S, P=24):
    iuv = np.zeros((B, S, S, 3), np.float32)
    iuv[..., 0] = rng.randint(0, P + 1, (B, S, S))
    iuv[..., 1:] = rng.randint(0, 256, (B, S, S, 2))
    return iuv


def test_texture_warps():
    rng = np.random.RandomState(6)
    parts = rng.uniform(-1, 1, (2, 24, 10, 10, 3)).astype(np.float32)
    iuv = _iuv(rng, 2, 12)
    j_atlas = jtex.parts_to_atlas(jnp.asarray(parts))
    t_atlas = ttex.parts_to_atlas(torch.from_numpy(parts))
    np.testing.assert_array_equal(t_atlas.numpy(), np.asarray(j_atlas))
    close(ttex.texture_warp_atlas(t_atlas, torch.from_numpy(iuv)),
          jtex.texture_warp_atlas(j_atlas, jnp.asarray(iuv)))
    j_lut = jtex.build_texture_warp_lut(jnp.asarray(parts))
    t_lut = ttex.build_texture_warp_lut(torch.from_numpy(parts))
    close(t_lut, j_lut)
    close(ttex.texture_warp_lut(t_lut, torch.from_numpy(iuv)),
          jtex.texture_warp_lut(j_lut, jnp.asarray(iuv)))


def test_texture_warp_shared_table():
    """A batch-1 table serves a batch of IUV maps, as the JAX generator's
    broadcast table does."""
    rng = np.random.RandomState(7)
    parts = rng.uniform(-1, 1, (1, 24, 8, 8, 3)).astype(np.float32)
    iuv = _iuv(rng, 3, 10)
    j_lut = jtex.build_texture_warp_lut(jnp.asarray(parts))
    t_lut = ttex.build_texture_warp_lut(torch.from_numpy(parts))
    want = jtex.texture_warp_lut(jnp.broadcast_to(j_lut, (3,) + j_lut.shape[1:]),
                                 jnp.asarray(iuv))
    close(ttex.texture_warp_lut(t_lut, torch.from_numpy(iuv)), want)
    j_at = jtex.parts_to_atlas(jnp.asarray(parts))
    want = jtex.texture_warp_atlas(
        jnp.broadcast_to(j_at, (3,) + j_at.shape[1:]), jnp.asarray(iuv))
    close(ttex.texture_warp_atlas(ttex.parts_to_atlas(
        torch.from_numpy(parts)), torch.from_numpy(iuv)), want)


def test_cal_bc_transform():
    rng = np.random.RandomState(8)
    B, F, S = 2, 40, 9
    f2pts = rng.uniform(-1, 1, (B, F, 3, 2)).astype(np.float32)
    fim = rng.randint(-1, F, (B, S, S)).astype(np.int32)
    wim = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    want = jflow.cal_bc_transform(jnp.asarray(f2pts), jnp.asarray(fim),
                                  jnp.asarray(wim))
    got = tflow.cal_bc_transform(torch.from_numpy(f2pts),
                                 torch.from_numpy(fim), torch.from_numpy(wim))
    close(got, want)
    assert (got.numpy()[fim < 0] == -2.0).all()


def test_normalize_batch_uint8():
    rng = np.random.RandomState(9)
    batch = {
        "src_imgs": rng.randint(0, 256, (2, 4, 4, 3)).astype(np.uint8),
        "smpl_mask": rng.randint(0, 256, (2, 4, 4, 1)).astype(np.uint8),
        "tgt_iuv255": rng.randint(0, 256, (2, 4, 4, 3)).astype(np.uint8),
        "cams": rng.uniform(0, 1, (2, 3)).astype(np.float32),
    }
    want = j_normalize_batch({k: jnp.asarray(v) for k, v in batch.items()})
    got = t_normalize_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
