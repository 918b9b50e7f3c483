"""Port parity for serving: the port's CLI (``infer``, ``evaluate``,
``gif``, ``pack``) against ``jafpro_tpu.cli`` on the CPU.

Tolerance: ``evaluate``'s metrics equal the JAX CLI's within 1e-5. The CLI
runs on ``tools/make_fixture.py``'s dataset (2 test clips of 4 frames at
64x64, 24 parts of 200 px) at the full net widths in float32, one
reference per clip to keep it cheap; the JAX CLI's generator is stubbed
(its numerics are held to the port's elsewhere), so what is compared is
its file names and audit lines.
"""

import ast
import os
import sys

import numpy as np
import pytest
import torch

from jafpro_tpu import cli as jcli
from jafpro_tpu.config import Config as JConfig
from jafpro_tpu.pipeline import JAFProPipeline as JPipeline
from jafpro_tpu.train.common import synthetic_quad_mesh

from jafpro_tpu_torch import cli
from jafpro_tpu_torch.config import Config
from jafpro_tpu_torch.data.dataset import load_clip
from jafpro_tpu_torch.infer import VideoGenerator, frames_to_uint8, stack_clips

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from make_fixture import write_fixture  # noqa: E402

torch.set_num_threads(1)
OUT_KEYS = ("final", "coarse", "mask", "tsf")


# ------------------------------------------------------------------- CLI

def _stub_jax_generator(p, **kw):
    """The JAX CLI's generator, replaced: uint8 zeros of the output shapes
    (this test compares the JAX CLI's files and audit lines only)."""
    def gen(params, clip):
        t, s = clip["tgt_iuv255"].shape[:2]
        return {k: np.zeros((t, s, s, 1 if k == "mask" else 3), np.uint8)
                for k in OUT_KEYS}
    return gen


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The fixture dataset served by both CLIs (``infer -n 1``), the port's
    with two clips per batch, each in its own working directory."""
    base = tmp_path_factory.mktemp("serve")
    fx = str(base / "fx")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("JAFPRO_SMPL_FACES", raising=False)
        write_fixture(fx, vids_per_mode=3, frames=4, image_size=64, seed=0)
    faces_path = str(base / "faces.npy")
    np.save(faces_path, synthetic_quad_mesh(16)[1])
    roots = {k: os.path.join(fx, k) for k in ("data", "smpl", "mask")}
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAFPRO_SMPL_FACES", faces_path)
        for var in ("JAFPRO_DATA_ROOT", "JAFPRO_SMPL_ROOT",
                    "JAFPRO_MASK_ROOT"):
            mp.delenv(var, raising=False)
        # the port's CLI, with its generator's input and output recorded
        work = base / "port"
        work.mkdir()
        mp.chdir(work)
        cfg = Config(image_size=64, compute_dtype="float32",
                     data_root=roots["data"], smpl_root=roots["smpl"],
                     mask_root=roots["mask"])
        mp.setattr(cli, "get_general_options", lambda: cfg)
        seen = []
        real = VideoGenerator.generate_batch

        def record(self, clips):
            out = real(self, clips)
            seen.append((clips, {k: v.clone() for k, v in out.items()}))
            return out

        mp.setattr(VideoGenerator, "generate_batch", record)
        cli.main(["infer", "-e", "t", "-n", "1", "--clips-per-batch", "2",
                  "--device", "cpu"])
        runs["port"] = {"dir": str(work), "seen": seen, "cfg": cfg}

        # the JAX CLI, its generator stubbed, its params never built
        work = base / "jax"
        work.mkdir()
        mp.chdir(work)
        jcfg = JConfig(image_size=64, compute_dtype="float32",
                       data_root=roots["data"], smpl_root=roots["smpl"],
                       mask_root=roots["mask"])
        mp.setattr("jafpro_tpu.config.get_general_options", lambda: jcfg)
        mp.setattr(JPipeline, "init_params", lambda self, key: {})
        mp.setattr("jafpro_tpu.infer.VideoGenerator", _stub_jax_generator)
        jcli.main(["infer", "-e", "t", "-n", "1"])
        runs["jax"] = {"dir": str(work)}
    runs["fx"] = fx
    runs["roots"] = roots
    runs["faces"] = faces_path
    return runs


def _audit_lines(d):
    with open(os.path.join(d, "log_result", "chosen_frame.txt")) as f:
        return sorted(x for x in f.read().split("\n\n") if x)


def test_infer_cli_files_and_audit_match_jax(served):
    vids = sorted(os.listdir(os.path.join(served["roots"]["data"], "test")))
    assert len(vids) == 2
    for vid in vids:
        names = [sorted(os.listdir(os.path.join(served[w]["dir"],
                                                "test_results", "t", vid)))
                 for w in ("port", "jax")]
        assert names[0] == names[1], vid
        assert len(names[0]) == 4 * 4
    assert _audit_lines(served["port"]["dir"]) == _audit_lines(
        served["jax"]["dir"])
    assert len(_audit_lines(served["port"]["dir"])) == 2
    import json
    with open(os.path.join(served["port"]["dir"], "test_results", "t",
                           "serving_stats.json")) as f:
        stats = json.load(f)
    assert stats["clips"] == 2 and stats["items"] == 1
    assert stats["clips_per_batch"] == 2 and stats["device"] == "cpu"


def test_infer_cli_frames_are_the_generators(served):
    """One ``generate_batch`` call served both clips, its input was the
    two decoded clips, and every jpg holds exactly that call's frames."""
    import cv2

    seen = served["port"]["seen"]
    assert len(seen) == 1
    clips, out = seen[0]
    cfg = served["port"]["cfg"]
    want = stack_clips([
        load_clip(*(os.path.join(served["roots"][k], "test")
                    for k in ("data", "smpl", "mask")), v, num_refs=1)
        for v in sorted(os.listdir(os.path.join(cfg.data_root, "test")))])
    assert set(clips) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(clips[k]), want[k],
                                      err_msg=k)
    vids = sorted(os.listdir(os.path.join(cfg.data_root, "test")))
    prefix = {"final": "frame", "coarse": "coarse_frame",
              "mask": "mask_frame", "tsf": "tsf_frame"}
    for ci, vid in enumerate(vids):
        d = os.path.join(served["port"]["dir"], "test_results", "t", vid)
        for s in OUT_KEYS:
            arr = frames_to_uint8(out[s][ci])
            assert arr.shape[0] == 4 and arr.dtype == np.uint8
            for i in range(4):
                with open(os.path.join(d, f"{prefix[s]}_{i:03d}.jpg"),
                          "rb") as f:
                    assert f.read() == cv2.imencode(".jpg", arr[i])[
                        1].tobytes(), (vid, s, i)


def _printed(out):
    rows = {}
    for line in out.splitlines():
        if "{" in line:
            head, body = line.split(" {", 1)
            rows[head] = ast.literal_eval("{" + body)
    return rows


def test_evaluate_cli_matches_jax(served, monkeypatch, capsys, tmp_path):
    pred = os.path.join(served["port"]["dir"], "test_results", "t")
    gt = os.path.join(served["roots"]["data"], "test")
    logs = {}
    for who, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jcli.main, [])):
        work = tmp_path / who
        work.mkdir()
        monkeypatch.chdir(work)
        main(["evaluate", "--pred", pred, "--gt", gt, "--no-deep-metrics"]
             + extra)
        logs[who] = _printed(capsys.readouterr().out)
        with open(work / "log_results_video" / "t.errors.txt") as f:
            logs[who + "_mean"] = ast.literal_eval(f.read().strip())
    assert set(logs["port"]) == set(logs["jax"])
    assert len(logs["port"]) == 3  # two videos and the dataset mean
    for row in logs["port"]:
        assert set(logs["port"][row]) == set(logs["jax"][row]) == {
            "ssim", "l1", "ms_ssim", "psnr"}
    a, b = logs["port_mean"], logs["jax_mean"]
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0, err_msg=k)


def test_infer_refuses_mismatched_pack_and_bad_options(served, monkeypatch,
                                                       tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("JAFPRO_SMPL_FACES", served["faces"])
    cfg = Config(image_size=64, compute_dtype="float32",
                 data_root=served["roots"]["data"],
                 smpl_root=served["roots"]["smpl"],
                 mask_root=served["roots"]["mask"],
                 model_save_dir=str(tmp_path / "checkpoints"))
    monkeypatch.setattr(cli, "get_general_options", lambda: cfg)
    real_pack, seen = cli.cmd_pack, []
    monkeypatch.setattr(cli, "cmd_pack", seen.append)
    cli.main(["pack", "--out", str(tmp_path / "pk"), "--mode", "test"])
    assert seen[0].kind == "interval"  # no --kind: the JAX CLI's default
    monkeypatch.setattr(cli, "cmd_pack", real_pack)
    cli.main(["pack", "--kind", "clips", "--out", str(tmp_path / "pk"),
              "--mode", "test", "--num_refs", "1"])
    with pytest.raises(SystemExit, match="repack"):
        cli.main(["infer", "-n", "2", "--packed-clips", str(tmp_path / "pk"),
                  "--device", "cpu"])
    # the packed path feeds the generator what the decoded path does
    vids, load_packed = cli.open_clip_source(cfg, 1, str(tmp_path / "pk"))
    _, load_decoded = cli.open_clip_source(cfg, 1)
    a, b = load_packed(vids), load_decoded(vids)
    sa, sb = stack_clips(a), stack_clips(b)
    for k in sb:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    # a JAX checkpoint newer than every export is refused, not served
    os.makedirs(tmp_path / "checkpoints" / "exp" / "iter_9")
    with pytest.raises(SystemExit, match="export_jax_params.py -e exp"):
        cli.main(["infer", "-n", "1", "--packed-clips", str(tmp_path / "pk"),
                  "--device", "cpu"])
    for argv in (["--streams", "coarse"], ["--streams", "final,nope"],
                 ["--clips-per-batch", "0"]):
        with pytest.raises(SystemExit):
            cli.main(["infer", "--device", "cpu"] + argv)
    # ranks never share a card: more ranks than cards is refused
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(SystemExit, match="--num-devices 2 needs 2 CUDA "
                           "devices, this host has 1"):
            cli.main(["infer", "-n", "1", "--num-devices", "2"])
    monkeypatch.delenv("JAFPRO_SMPL_FACES")
    monkeypatch.setattr(cli, "default_smpl_faces_path", lambda: None)
    with pytest.raises(SystemExit, match="SMPL faces"):
        cli.main(["infer", "-n", "1", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["infer", "-n", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["evaluate", "--pred", str(tmp_path), "--gt",
                  str(tmp_path), "--no-deep-metrics"])


def test_gif_cli_matches_jax(served, monkeypatch, tmp_path, capsys):
    pred = os.path.join(served["port"]["dir"], "test_results", "t")
    for who, main in (("port", cli.main), ("jax", jcli.main)):
        main(["gif", "--pred_dir", pred, "--out_dir", str(tmp_path / who),
              "--fps", "5"])
    capsys.readouterr()
    for vid in sorted(os.listdir(pred)):
        if not os.path.isdir(os.path.join(pred, vid)):
            continue
        paths = [tmp_path / w / "t" / f"{vid}_video" / "video.gif"
                 for w in ("port", "jax")]
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read(), vid
