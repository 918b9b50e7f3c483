"""Port parity for the serving input path: ``jafpro_tpu_torch``'s config,
angles, dataset, shardio, texture ``write_gif`` and ``run_overlapped``
against ``jafpro_tpu``'s on the CPU.

These modules are numpy and file code, so every comparison is exact:
equal arrays, equal file bytes, equal hashes. The dataset fixture is
``tools/make_fixture.py::write_fixture`` at 64x64 frames, 4 frames per
clip, in a temporary directory.
"""

import json
import os
import sys

import numpy as np
import pytest

from jafpro_tpu import config as jconfig
from jafpro_tpu.data import angles as jangles
from jafpro_tpu.data import dataset as jdataset
from jafpro_tpu.data import shardio as jshardio
from jafpro_tpu.data.texture import write_gif as j_write_gif
from jafpro_tpu.utils.overlap import run_overlapped as j_run_overlapped

from jafpro_tpu_torch import config
from jafpro_tpu_torch.data import angles, dataset, shardio
from jafpro_tpu_torch.data.texture import write_gif
from jafpro_tpu_torch.utils.overlap import run_overlapped

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from make_fixture import write_fixture  # noqa: E402

SERVING_PACK = os.path.join(ROOT, "serving_clip_pack")


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """Two test clips (and three train clips) of 4 frames at 64x64."""
    root = str(tmp_path_factory.mktemp("fx"))
    write_fixture(root, vids_per_mode=3, frames=4, image_size=64, seed=0)
    return root


def roots(root, mode="test"):
    return (os.path.join(root, "data", mode), os.path.join(root, "smpl", mode),
            os.path.join(root, "mask", mode))


def assert_same_clip(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_config_paths_and_env(monkeypatch):
    for var in ("JAFPRO_DATA_ROOT", "JAFPRO_SMPL_ROOT", "JAFPRO_MASK_ROOT"):
        monkeypatch.delenv(var, raising=False)
    fields = ("project_dir", "model_save_dir", "test_save_dir", "data_root",
              "smpl_root", "mask_root")
    for f in fields:
        assert getattr(config.Config(), f) == getattr(jconfig.Config(), f), f
    monkeypatch.setenv("JAFPRO_DATA_ROOT", "/d")
    monkeypatch.setenv("JAFPRO_MASK_ROOT", "/m")
    a, b = config.get_general_options(), jconfig.get_general_options()
    for f in fields:
        assert getattr(a, f) == getattr(b, f), f
    assert (a.data_root, a.smpl_root, a.mask_root) == ("/d", "", "/m")


def test_compute_angle_and_reference_selection():
    rng = np.random.RandomState(0)
    for t in range(12):
        iuv = np.zeros((32, 32, 3), np.float32)
        iuv[..., 0] = rng.choice([0, 1, 2, 7, 9, 13, 14, 5], (32, 32),
                                 p=[.3, .1, .1, .1, .1, .1, .1, .1])
        if t % 4 == 0:
            iuv[..., 0][iuv[..., 0] == 2] = 0   # front part 2 absent
        if t % 4 == 1:
            iuv[..., 0] = 0                      # nothing visible
        assert angles.compute_angle(iuv) == jangles.compute_angle(iuv), t
    for T in (1, 4, 7, 30):
        a = rng.uniform(-90, 90, T)
        for n in range(1, 7):
            np.testing.assert_array_equal(
                angles.select_reference_frames(a, n),
                jangles.select_reference_frames(a, n), err_msg=(T, n))


def test_dataset_helpers(fixture_root):
    d = roots(fixture_root)[0]
    vids = dataset.list_videos(os.path.join(fixture_root, "data"), "test")
    assert vids == jdataset.list_videos(os.path.join(fixture_root, "data"),
                                        "test")
    assert len(vids) == 2
    assert dataset.list_videos(fixture_root, "nope") == []
    files = dataset.list_clip_files(os.path.join(d, vids[0]))
    assert files == jdataset.list_clip_files(os.path.join(d, vids[0]))
    assert [len(files[k]) for k in ("img", "iuv", "text", "mask")] == [4] * 4
    for name in ("frame_000012.jpg", "a1b22_text.png", "noint.png"):
        assert dataset._frame_number(name) == jdataset._frame_number(name)
    atlas = np.random.RandomState(1).randint(0, 255, (2, 40, 60, 3), np.uint8)
    np.testing.assert_array_equal(dataset._atlas_to_parts_np(atlas, 10),
                                  jdataset._atlas_to_parts_np(atlas, 10))


@pytest.mark.parametrize("num_refs", [2, 4])
def test_load_clip_matches_jax(fixture_root, num_refs):
    vid = dataset.list_videos(os.path.join(fixture_root, "data"), "test")[1]
    a = dataset.load_clip(*roots(fixture_root), vid, num_refs=num_refs)
    b = jdataset.load_clip(*roots(fixture_root), vid, num_refs=num_refs)
    assert_same_clip(a, b)
    assert a["src_parts"].shape == (1, num_refs, 24, 200, 200, 3)
    assert a["src_parts"].dtype == np.uint8


def test_spec_hash_and_record_helpers():
    specs = [shardio.clip_spec(), shardio.clip_spec(2, 4, 64, 16, 24, 36),
             [("a", (3,), "float32"), ("b", (2, 2), "uint8")]]
    assert specs[0] == jshardio.clip_spec()
    for spec in specs:
        assert shardio.spec_hash(spec) == jshardio.spec_hash(spec)
        assert shardio._pack_header(spec) == jshardio._pack_header(spec)
        assert shardio.record_bytes(spec) == jshardio.record_bytes(spec)
    assert shardio.spec_hash(specs[0]) != shardio.spec_hash(specs[1])
    assert shardio.clip_spec(2, 4, 64, 16, 24, 36) == jshardio.clip_spec(
        2, 4, 64, 16, 24, 36)
    rng = np.random.RandomState(2)
    for name in ("src_imgs", "smpl_mask", "tgt_iuv255", "other"):
        v = rng.uniform(-1.5, 300.0, (5, 7)).astype(np.float32)
        np.testing.assert_array_equal(shardio.encode_field_u8(name, v),
                                      jshardio.encode_field_u8(name, v))
    spec = specs[2]
    recs = [{"a": rng.rand(3).astype(np.float32),
             "b": rng.randint(0, 255, (2, 2)).astype(np.uint8)}
            for _ in range(3)]
    raw = b"".join(shardio.pack_record(spec, r) for r in recs)
    assert raw == b"".join(jshardio.pack_record(spec, r) for r in recs)
    buf = np.frombuffer(raw, np.uint8)
    a, b = shardio.unpack_batch(spec, buf, 3), jshardio.unpack_batch(
        spec, buf, 3)
    assert_same_clip(a, b)
    with pytest.raises(ValueError):
        shardio.pack_record(spec, {"a": np.zeros(4), "b": recs[0]["b"]})


def small_clip_records(n, rng):
    spec = shardio.clip_spec(num_refs=2, frames=3, image_size=16,
                             part_size=8, num_parts=24, num_verts=10)
    recs = []
    for _ in range(n):
        rec = {}
        for name, shape, dtype in spec:
            if dtype == "uint8":
                rec[name] = rng.randint(0, 256, shape).astype(np.uint8)
            elif dtype == "int32":
                rec[name] = rng.randint(0, 3, shape).astype(np.int32)
            else:
                rec[name] = rng.randn(*shape).astype(np.float32)
        recs.append(rec)
    return spec, recs


def write_index(d, spec, vids):
    with open(os.path.join(d, "index.json"), "w") as f:
        json.dump({"mode": "test", "num_refs": 2, "vids": vids,
                   "chosen_names": [[f"frame_{i}.jpg"] for i in
                                    range(len(vids))],
                   "spec": [[n, list(s), t] for n, s, t in spec]}, f)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pack_shard_read_by_the_other_package(tmp_path, writer):
    """A pack written by one package's ``pack_shard`` reads back equal
    through both ``ClipPackReader``s; the files are byte-equal."""
    spec, recs = small_clip_records(3, np.random.RandomState(3))
    vids = ["v0", "v1", "v2"]
    paths = {}
    for who, mod in (("jax", jshardio), ("port", shardio)):
        d = tmp_path / who
        d.mkdir()
        assert mod.pack_shard(spec, iter(recs),
                              str(d / "test-clips-00000.shard")) == 3
        write_index(str(d), spec, vids)
        paths[who] = str(d)
    with open(os.path.join(paths["jax"], "test-clips-00000.shard"), "rb") as a:
        with open(os.path.join(paths["port"], "test-clips-00000.shard"),
                  "rb") as b:
            assert a.read() == b.read()
    p = shardio.ClipPackReader(paths[writer])
    j = jshardio.ClipPackReader(paths[writer])
    assert len(p) == len(j) == 3 and p.vids == j.vids
    for i in range(3):
        assert_same_clip(p.load(i), j.load(i))
        np.testing.assert_array_equal(p.load(i)["src_parts"][0],
                                      recs[i]["src_parts"])


def test_spec_mismatched_header_is_refused(tmp_path):
    spec, recs = small_clip_records(2, np.random.RandomState(4))
    path = str(tmp_path / "test-clips-00000.shard")
    shardio.pack_shard(spec, iter(recs), path)
    other = list(spec)
    other[-1] = ("verts", (3, 11, 3), "float32")
    for mod in (shardio, jshardio):
        with pytest.raises(IOError, match="spec hash"):
            mod._check_header(path, other, mod.record_bytes(other))
    # a headerless file whose size does not divide into records
    with open(path, "rb") as f:
        body = f.read()[shardio.HEADER_BYTES:]
    with open(path, "wb") as f:
        f.write(body[:-1])
    for mod in (shardio, jshardio):
        with pytest.raises(IOError, match="not a multiple"):
            mod._check_header(path, spec, mod.record_bytes(spec))
    # an index that lists more clips than the shard holds
    shardio.pack_shard(spec, iter(recs), path)
    write_index(str(tmp_path), spec, ["a", "b", "c"])
    with pytest.raises(IOError, match="repack"):
        shardio.ClipPackReader(str(tmp_path))


def test_pack_test_clips_matches_jax(fixture_root, tmp_path):
    """Both packages pack the fixture's test clips into byte-equal files,
    and each reads the other's pack as ``load_clip`` loads the clip."""
    data, smpl, mask = (os.path.join(fixture_root, k)
                        for k in ("data", "smpl", "mask"))
    assert shardio.pack_test_clips(data, smpl, mask, str(tmp_path / "p"),
                                   num_refs=2) == 2
    assert jshardio.pack_test_clips(data, smpl, mask, str(tmp_path / "j"),
                                    num_refs=2) == 2
    for name in ("test-clips-00000.shard", "index.json"):
        with open(tmp_path / "p" / name, "rb") as a, \
                open(tmp_path / "j" / name, "rb") as b:
            assert a.read() == b.read(), name
    p = shardio.ClipPackReader(str(tmp_path / "j"))
    j = jshardio.ClipPackReader(str(tmp_path / "p"))
    for i, vid in enumerate(p.vids):
        want = dataset.load_clip(*roots(fixture_root), vid, num_refs=2)
        del want["gt_frames"]
        assert_same_clip(p.load(i), j.load(i))
        assert_same_clip(p.load(i), want)


@pytest.mark.skipif(not os.path.isdir(SERVING_PACK),
                    reason="serving_clip_pack/ is not in this checkout")
def test_serving_clip_pack_record0():
    p = shardio.ClipPackReader(SERVING_PACK)
    j = jshardio.ClipPackReader(SERVING_PACK)
    assert p.vids == j.vids and p.num_refs == j.num_refs
    assert_same_clip(p.load(0), j.load(0))


def test_write_gif_matches_jax(tmp_path):
    rng = np.random.RandomState(5)
    for frames in (rng.randint(0, 255, (3, 16, 16, 3)).astype(np.uint8),
                   rng.rand(2, 8, 8).astype(np.float32)):
        a = write_gif(str(tmp_path / "a.png"), frames, fps=5)
        b = j_write_gif(str(tmp_path / "b.png"), frames, fps=5)
        assert a.endswith("a.gif") and b.endswith("b.gif")
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_run_overlapped_matches_jax():
    items = list(range(7))
    for fn in (run_overlapped, j_run_overlapped):
        wrote = []
        order = list(fn(items, lambda i: i * 10, lambda i, x: x + i,
                        lambda i, y: wrote.append((i, y)), prefetch=3,
                        writers=2))
        assert order == items
        assert sorted(wrote) == [(i, 11 * i) for i in items]
        with pytest.raises(ZeroDivisionError):
            list(fn(items, lambda i: 1 // (i - 3), lambda i, x: x,
                    lambda i, y: None))
