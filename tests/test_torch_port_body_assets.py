"""Port parity: the UV assets (``geometry/uvmap.py``) and
``fit_uv_image`` against ``jafpro_tpu`` on the CPU, on an OBJ and json
tables that the tests write.

Tolerances: the NumPy asset code is a copy and must agree exactly;
``fit_uv_image`` after 20 Adam steps within 1e-5 (optax's and torch's
Adam, same defaults, round differently).
"""

import json

import numpy as np
import pytest
import torch

from jafpro_tpu.geometry import uvmap as ju

from jafpro_tpu_torch.geometry import uvmap as tu

torch.set_num_threads(1)


@pytest.fixture
def obj_path(tmp_path):
    """A UV-mapped OBJ with 16 faces, written by the test."""
    rng = np.random.RandomState(0)
    verts = rng.randn(10, 3)
    vts = rng.rand(12, 2)
    lines = ["# synthetic"]
    lines += ["v %f %f %f" % tuple(v) for v in verts]
    lines += ["vt %f %f" % tuple(v) for v in vts]
    lines += ["vn 0 0 1"]
    for _ in range(16):
        f = rng.choice(10, 3, replace=False) + 1
        t = rng.choice(12, 3, replace=False) + 1
        lines.append("f " + " ".join(f"{a}/{b}/1" for a, b in zip(f, t)))
    p = tmp_path / "mapper.obj"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def test_obj_io_matches_jax(obj_path, tmp_path):
    a, b = tu.load_obj(obj_path), ju.load_obj(obj_path)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    out = str(tmp_path / "out.obj")
    tu.save_obj(out, a["verts"], a["faces"])
    back = ju.load_obj(out)
    np.testing.assert_allclose(back["verts"], a["verts"], atol=1e-5)
    np.testing.assert_array_equal(back["faces"], a["faces"])


@pytest.mark.parametrize("fill_back", [False, True])
def test_uv_tables_match_jax(obj_path, fill_back):
    f2 = tu.get_f2vts(obj_path, fill_back=fill_back)
    np.testing.assert_array_equal(f2, ju.get_f2vts(obj_path, fill_back))
    np.testing.assert_array_equal(tu.compute_barycenter(f2),
                                  ju.compute_barycenter(f2))
    np.testing.assert_array_equal(tu.create_uvsampler(obj_path, 3),
                                  ju.create_uvsampler(obj_path, 3))


@pytest.mark.parametrize("name", ["uv", "seg", "uv_seg", "ids", "binary",
                                  "par", "front", "head", "back"])
def test_create_mapping_matches_jax(obj_path, tmp_path, name):
    """Every kind; the part, front and head tables are json files the test
    writes."""
    parts = tmp_path / "parts.json"
    parts.write_text(json.dumps({"arm": [0, 5], "leg": [5, 9],
                                 "head": [9, 10, 12]}))
    front = tmp_path / "front.json"
    front.write_text(json.dumps({"face": [1, 3, 9]}))
    head = tmp_path / "head.json"
    head.write_text(json.dumps({"face": [3, 9, 11, 12]}))
    kw = dict(part_info=str(parts), front_info=str(front),
              head_info=str(head))
    for contain_bg in (True, False):
        np.testing.assert_array_equal(
            tu.create_mapping(name, obj_path, contain_bg=contain_bg, **kw),
            ju.create_mapping(name, obj_path, contain_bg=contain_bg, **kw))
    with pytest.raises(ValueError):
        tu.create_mapping("nope", obj_path)


def test_default_asset(tmp_path, monkeypatch):
    (tmp_path / "mapper.txt").write_text("")
    monkeypatch.setenv("JAFPRO_ASSETS", str(tmp_path))
    assert tu.default_asset("mapper.txt") == str(tmp_path / "mapper.txt")
    assert tu.default_asset("absent.json") is None


def test_fit_uv_image_matches_jax():
    rng = np.random.RandomState(0)
    F, T = 16, 3
    uv = rng.uniform(-0.9, 0.9, size=(F, T * T, 2)).astype(np.float32)
    tgt = rng.uniform(-0.8, 0.8, (F, T, T, 3)).astype(np.float32)
    j = np.asarray(ju.fit_uv_image(uv, tgt, uv_size=16, steps=20))
    t = tu.fit_uv_image(uv, tgt, uv_size=16, steps=20, device="cpu")
    assert t.shape == (16, 16, 3)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5)
    assert np.abs(j - np.tanh(-1.0)).max() > 0.05      # it moved
