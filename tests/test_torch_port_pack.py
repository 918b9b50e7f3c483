"""``pack --kind interval|textonly`` in the port: ``shardio.pack_dancevideo``
against ``jafpro_tpu.data.shardio.pack_dancevideo`` on one
``tools/make_fixture.py`` dataset (256², the record specs' image size):
the same fixture and seed give the same shard, and ``unpack_batch`` of
either package reads the same records from it. The port's ``pack``
command takes the JAX CLI's flags and defaults (``--kind interval``,
``--mode train``, 4 samples per video, 4 references, seed 0).
"""

import os
import sys

import numpy as np
import pytest
import torch

from jafpro_tpu.data import shardio as jsio

from jafpro_tpu_torch import cli
from jafpro_tpu_torch.config import Config
from jafpro_tpu_torch.data import shardio as tsio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from make_fixture import write_fixture  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("packfx"))
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("JAFPRO_SMPL_FACES", raising=False)
        write_fixture(root, vids_per_mode=2, frames=5, image_size=256,
                      seed=0)
    verts = tsio_verts(root)
    return {"root": root, "num_verts": verts}


def tsio_verts(root):
    import pickle

    d = os.path.join(root, "smpl", "train")
    vid = sorted(os.listdir(d))[0]
    with open(os.path.join(d, vid, "pose_shape.pkl"), "rb") as f:
        return int(np.asarray(pickle.load(f)["vertices"]).shape[1])


def roots(ds):
    r = ds["root"]
    return (os.path.join(r, "data"), os.path.join(r, "smpl"),
            os.path.join(r, "mask"))


@pytest.mark.parametrize("kind", ["interval", "textonly"])
def test_pack_dancevideo_matches_jax(dataset, tmp_path, kind):
    kw = dict(mode="train", samples_per_video=2, num_refs=2, seed=3,
              num_verts=dataset["num_verts"], kind=kind, num_target=2)
    nt = tsio.pack_dancevideo(*roots(dataset), str(tmp_path / "t"), **kw)
    nj = jsio.pack_dancevideo(*roots(dataset), str(tmp_path / "j"), **kw)
    assert nt == nj == 4
    name = f"train-{kind}-00000.shard"
    tpath, jpath = str(tmp_path / "t" / name), str(tmp_path / "j" / name)
    if kind == "textonly":
        spec = tsio.textonly_spec(num_refs=2, num_target=2)
        jspec = jsio.textonly_spec(num_refs=2, num_target=2)
    else:
        spec = tsio.interval_spec(num_refs=2, num_verts=dataset["num_verts"])
        jspec = jsio.interval_spec(num_refs=2,
                                   num_verts=dataset["num_verts"])
    assert tsio.spec_hash(spec) == jsio.spec_hash(jspec)
    with open(tpath, "rb") as f:
        tbytes = f.read()
    with open(jpath, "rb") as f:
        jbytes = f.read()
    assert tbytes == jbytes
    buf = np.frombuffer(tbytes[tsio.HEADER_BYTES:], np.uint8)
    got = tsio.unpack_batch(spec, buf, nt)
    want = jsio.unpack_batch(jspec, np.frombuffer(
        jbytes[jsio.HEADER_BYTES:], np.uint8), nj)
    assert set(got) == set(want) == {n for n, _, _ in spec}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["src_parts"].std() > 0


def test_pack_cli_kinds_and_defaults(dataset, tmp_path, monkeypatch):
    data, smpl, mask = roots(dataset)
    cfg = Config(data_root=data, smpl_root=smpl, mask_root=mask)
    monkeypatch.setattr(cli, "get_general_options", lambda: cfg)
    seen = []
    real = tsio.pack_dancevideo

    def spy(*a, **kw):
        seen.append(kw)
        return real(*a, **{**kw, "num_verts": dataset["num_verts"]})

    monkeypatch.setattr(tsio, "pack_dancevideo", spy)
    cli.main(["pack", "--out", str(tmp_path / "a")])
    assert seen[-1] == dict(mode="train", kind="interval",
                            samples_per_video=4, num_refs=4, seed=0)
    assert os.path.exists(tmp_path / "a" / "train-interval-00000.shard")
    cli.main(["pack", "--kind", "textonly", "--mode", "test", "--out",
              str(tmp_path / "b"), "--samples_per_video", "1",
              "--num_refs", "2", "--seed", "5"])
    assert seen[-1] == dict(mode="test", kind="textonly",
                            samples_per_video=1, num_refs=2, seed=5)
    assert os.path.exists(tmp_path / "b" / "test-textonly-00000.shard")
    with pytest.raises(SystemExit):
        cli.main(["pack", "--kind", "frames", "--out", str(tmp_path / "c")])
    with pytest.raises(ValueError, match="kind"):
        real(data, smpl, mask, str(tmp_path / "d"), kind="clips")
