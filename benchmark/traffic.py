"""The benchmark's one traffic generator: seeded clips and training
records in the program's uint8 wire format, and the pools they are drawn
from.

The data of a pool is fixed by its traffic file (its ``pool`` parameters),
so every ``--seed`` serves the same sizes, and the run's seed draws the
order, the references' curriculum and the weights. A pool is written once
into a fixed directory of the user's cache (``$XDG_CACHE_HOME``, else
``~/.cache``) and read back by later runs; regenerating one of its clips
gives the same arrays as the pool holds, which is what the reference
reads.

The clip mesh is a closed UV sphere with SMPL's counts (V = 6890,
F = 13776) stretched to an upright ellipsoid at z = 2 and jittered per
pose; IUV codes are uniform over the body's columns.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, Iterator

import numpy as np

VERSION = "1"


def rng_for(*keys: int) -> np.random.Generator:
    return np.random.default_rng([int(k) % 2 ** 63 for k in keys])


def uv_sphere(rings: int = 84, segments: int = 82) -> tuple:
    """Closed UV sphere: 84 * 82 + 2 = 6890 vertices, 13776 faces wound
    outward, pole to pole. Returns (verts (V, 3), faces (F, 3) int32)."""
    theta = np.pi * np.arange(1, rings + 1) / (rings + 1)
    phi = 2.0 * np.pi * np.arange(segments) / segments
    ring = np.stack([np.sin(theta)[:, None] * np.cos(phi)[None],
                     np.cos(theta)[:, None] * np.ones_like(phi)[None],
                     np.sin(theta)[:, None] * np.sin(phi)[None]],
                    -1).reshape(-1, 3)
    top, bottom = 0, rings * segments + 1
    verts = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])

    def vid(r, s):
        return 1 + r * segments + s % segments

    faces = [[top, vid(0, s + 1), vid(0, s)] for s in range(segments)]
    for r in range(rings - 1):
        for s in range(segments):
            a, b = vid(r, s), vid(r, s + 1)
            c, d = vid(r + 1, s), vid(r + 1, s + 1)
            faces += [[a, b, c], [b, d, c]]
    faces += [[bottom, vid(rings - 1, s), vid(rings - 1, s + 1)]
              for s in range(segments)]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def mesh(cfg: dict) -> tuple:
    """The configuration's mesh: SMPL's counts, or a smaller sphere where
    ``num_verts`` asks for one (tests)."""
    if cfg["num_verts"] == 6890:
        return uv_sphere()
    rings = int(round(np.sqrt(cfg["num_verts"] - 2)))
    return uv_sphere(rings, (cfg["num_verts"] - 2) // rings)


def poses(cfg: dict, T: int, rng: np.random.Generator) -> tuple:
    """(verts (T, V, 3), cams (T, 3)): the ellipsoid (0.35, 0.9, 0.35) at
    z = 2 jittered per pose by N(0, 0.01), a unit weak-perspective camera."""
    v0, _ = mesh(cfg)
    verts = (v0 * np.float32([0.35, 0.9, 0.35])
             + rng.normal(scale=0.01, size=(T, 1, 3))).astype(np.float32)
    verts[..., 2] += 2.0
    return verts, np.tile(np.float32([[1.0, 0.0, 0.0]]), (T, 1))


def body_columns(verts: np.ndarray, S: int) -> np.ndarray:
    """(S,) bool: the image columns the projected mesh covers."""
    px = 0.5 * (verts[..., 0] * S + S - 1)
    lo = max(int(np.floor(px.min())) - 1, 0)
    hi = min(int(np.ceil(px.max())) + 1, S - 1)
    cols = np.zeros((S,), bool)
    cols[lo:hi + 1] = True
    return cols


def iuv_maps(rng, n: int, S: int, P: int, cols: np.ndarray) -> np.ndarray:
    """(n, S, S, 3) uint8 IUV codes: uniform part ids 0..P and U, V inside
    the body's columns, background elsewhere."""
    iuv = rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8)
    iuv[..., 0] = rng.integers(0, P + 1, (n, S, S), dtype=np.uint8)
    iuv[..., 0] *= cols[None, None, :].astype(np.uint8)
    return iuv


def mask_parts(rng, shape) -> np.ndarray:
    return np.where(rng.random(shape, dtype=np.float32) > 0.5, 255,
                    0).astype(np.uint8)


def make_clip(cfg: dict, refs: int, frames: int, seed: int) -> Dict:
    """One serving clip in the pack's layout (``ClipPackReader.load``'s
    fields): uint8 textures, masks, images and IUV; float32 background,
    cameras and vertices; the references at evenly spaced frames."""
    S, p, P = cfg["image_size"], cfg["part_size"], cfg["num_parts"]
    rng = rng_for(seed, refs, frames)
    verts, cams = poses(cfg, frames, rng)
    cols = body_columns(verts, S)
    iuv = iuv_maps(rng, frames, S, P, cols)
    smpl = np.broadcast_to(np.where(cols, 255, 0).astype(np.uint8)[
        None, None, :, None], (frames, S, S, 1)).copy()
    return {
        "src_parts": rng.integers(0, 256, (1, refs, P, p, p, 3),
                                  dtype=np.uint8),
        "src_mask_parts": mask_parts(rng, (1, refs, P, p, p)),
        "bg_incomplete": rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32),
        "src_imgs": rng.integers(0, 256, (refs, S, S, 3), dtype=np.uint8),
        "chosen_frames": np.linspace(0, frames - 1, refs).round().astype(
            np.int32),
        "tgt_iuv255": iuv,
        "smpl_mask": smpl,
        "cams": cams,
        "verts": verts,
    }


def face_bbox(iuv255: np.ndarray, S: int) -> np.ndarray:
    """(x0, x1, y0, y1) of parts 23/24 with a -2 / +3 margin; zeros
    without face pixels."""
    ys, xs = np.where((iuv255[..., 0] == 23) | (iuv255[..., 0] == 24))
    if xs.size == 0:
        return np.zeros((4,), np.float32)
    return np.asarray([max(xs.min() - 2, 0), min(xs.max() + 3, S),
                       max(ys.min() - 2, 0), min(ys.max() + 3, S)],
                      np.float32)


def make_record(cfg: dict, seed: int) -> Dict:
    """One stage-3/4 training record in the interval layout: 4 reference
    textures and images, one target frame with its IUV, mask, face box and
    background, the 5 poses drawn from a 30-pose motion."""
    S, p, P = cfg["image_size"], cfg["part_size"], cfg["num_parts"]
    R = cfg["maximum_ref_frames"]
    rng = rng_for(seed, 7)
    verts, cams = poses(cfg, 30, rng)
    t = rng.choice(30, R + 1, replace=False)
    cols = body_columns(verts, S)
    iuv = iuv_maps(rng, 1, S, P, cols)
    return {
        "src_parts": rng.integers(0, 256, (R, P, p, p, 3), dtype=np.uint8),
        "src_mask_parts": mask_parts(rng, (R, P, p, p)),
        "tgt_iuv255": iuv,
        "tgt_img": rng.integers(0, 256, (1, S, S, 3), dtype=np.uint8),
        "src_img_first": rng.integers(0, 256, (1, S, S, 3), dtype=np.uint8),
        "src_imgs": rng.integers(0, 256, (R, S, S, 3), dtype=np.uint8),
        "bg_incomplete": rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32),
        "smpl_mask": np.where(iuv[..., :1] > 0, 255, 0).astype(np.uint8),
        "face_bbox": face_bbox(iuv[0], S)[None],
        "src_cams": cams[t[1:]],
        "src_verts": verts[t[1:]],
        "tgt_cam": cams[t[:1]],
        "tgt_verts": verts[t[:1]],
    }


def cache_root() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "jafpro_bench")


def pool_dir(kind: str, cfg: dict, pool: dict) -> str:
    """The fixed directory of one pool: its kind, widths and parameters
    hashed into the name."""
    key = json.dumps([VERSION, kind, pool, {k: cfg[k] for k in (
        "image_size", "part_size", "num_parts", "num_verts",
        "maximum_ref_frames")}], sort_keys=True)
    digest = hashlib.blake2b(key.encode(), digest_size=8).hexdigest()
    return os.path.join(cache_root(), f"{kind}-{digest}")


def ensure_pool(path: str, write) -> str:
    """``write(tmp_dir)`` fills a new pool once; later runs find it whole
    (a pool is renamed into place only when complete)."""
    if os.path.isdir(path):
        return path
    tmp = path + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    write(tmp)
    os.replace(tmp, path)
    return path


def clip_seed(pool: dict, refs: int, i: int) -> int:
    return int(pool["seed"]) * 1000 + refs * 100 + i


def clip_pools(cfg: dict, pool: dict) -> Dict[int, str]:
    """{refs: pack dir} of ``pool["clips"]`` clips for each reference count
    in ``pool["refs"]``, written with the program's clip-pack writer."""
    from jafpro_tpu_torch.data.shardio import write_clip_pack

    out = {}
    for refs in pool["refs"]:
        spec = dict(pool, refs=refs)

        def write(d, refs=refs):
            write_clip_pack(
                (dict(make_clip(cfg, refs, pool["frames"],
                                clip_seed(pool, refs, i)),
                      vid_name=f"clip_{i}", chosen_names=[])
                 for i in range(pool["clips"])), d, mode="test",
                num_refs=refs)
        out[refs] = ensure_pool(pool_dir("clips", cfg, spec), write)
    return out


def record_seed(pool: dict, i: int) -> int:
    return int(pool["seed"]) * 1000 + i


def record_pool(cfg: dict, pool: dict) -> str:
    """A shard of ``pool["records"]`` interval records, written with the
    program's shard writer; returns the shard's path."""
    from jafpro_tpu_torch.data.shardio import interval_spec, pack_shard

    spec = interval_spec(
        num_refs=cfg["maximum_ref_frames"], image_size=cfg["image_size"],
        part_size=cfg["part_size"], num_parts=cfg["num_parts"],
        num_verts=cfg["num_verts"])

    def write(d):
        pack_shard(spec, (make_record(cfg, record_seed(pool, i))
                          for i in range(pool["records"])),
                   os.path.join(d, "train-interval-00000.shard"))
    d = ensure_pool(pool_dir("records", cfg, pool), write)
    return os.path.join(d, "train-interval-00000.shard")


def draws(seed: int, n: int, stream: int = 0) -> Iterator[int]:
    """An endless seeded sequence of indices in [0, n)."""
    rng = rng_for(seed, 11 + stream)
    while True:
        yield from rng.integers(0, n, 256).tolist()
