"""The port's ``train`` command on the CPU: ``python -m jafpro_tpu_torch.cli
train --stage N --synthetic --iters 2 --device cpu`` for stages 1-4 writes
``losses.jsonl`` and an ``.npz`` checkpoint that the port's ``infer``
serves; ``--resume`` and ``--init-from`` behave as in the JAX CLI (resume
continues the step count and the loss log; a warm start loads the stage's
consumed modules from a donor and nothing else); ``--no-face-gan`` drops
the face GAN; ``--num-devices 2`` with a batch it does not divide or more
ranks than cards, and a run without CUDA and without ``--device cpu``,
are refused (``test_torch_port_parallel_cli.py`` trains over ranks).

A checkpoint of every module is ~0.5 GB (the two CRNs) and a stage-3
optimizer state ~0.8 GB, so the runs go in one fixture that records what
the tests check and deletes each experiment once nothing later reads it.
"""

import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from jafpro_tpu_torch import cli
from jafpro_tpu_torch.bridge import ALL_MODULES
from jafpro_tpu_torch.checkpoints import load_params_npz
from jafpro_tpu_torch.config import Config
from jafpro_tpu_torch.train.common import synthetic_quad_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from make_fixture import write_fixture  # noqa: E402

torch.set_num_threads(1)
METRICS = {1: {"loss"}, 2: {"loss"},
           3: {"loss", "recon", "G", "FG", "D", "FD"},
           4: {"loss", "recon", "G", "FG", "D", "FD"}}


def train(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["train", *argv])
    return out.getvalue()


def ckpt(exp):
    return os.path.join("checkpoints", exp)


def run(stage, exp, *extra, iters=2):
    """One synthetic ``train`` run in the working directory: what it
    printed, its files, its loss rows and its newest ``.npz`` tree."""
    printed = train("--stage", str(stage), "-n", exp, "--synthetic",
                    "--iters", str(iters), "--device", "cpu", *extra)
    d = ckpt(exp)
    files = sorted(os.listdir(d))
    with open(os.path.join(d, "losses.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    npz = [n for n in files if n.endswith(".npz")][-1]
    return {"printed": printed, "files": files, "rows": rows,
            "tree": load_params_npz(os.path.join(d, npz))}


def leaves(tree):
    return [leaves(v) if isinstance(v, dict) else v
            for _, v in sorted(tree.items())]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("train")
    rec = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(base)
        for var in ("JAFPRO_DATA_ROOT", "JAFPRO_SMPL_ROOT",
                    "JAFPRO_MASK_ROOT", "JAFPRO_SMPL_FACES"):
            mp.delenv(var, raising=False)
        rec[1] = run(1, "s1")
        # resume s1 for one more step
        rec["resume"] = run(1, "s1", "--resume", iters=1)
        rec["resume"]["state"] = torch.load(
            os.path.join(ckpt("s1"), "train_state_iter_2.pt"),
            weights_only=True)
        shutil.rmtree(ckpt("s1"))
        rec[2] = run(2, "s2")
        shutil.rmtree(ckpt("s2"))
        for stage in (3, 4):
            rec[stage] = run(stage, f"s{stage}")
            os.remove(os.path.join(ckpt(f"s{stage}"),
                                   "train_state_iter_1.pt"))

        # infer serves the stage-4 checkpoint on a fixture clip
        fx = str(base / "fx")
        write_fixture(fx, vids_per_mode=2, frames=4, image_size=64, seed=0)
        np.save(base / "faces.npy", synthetic_quad_mesh(16)[1])
        mp.setenv("JAFPRO_SMPL_FACES", str(base / "faces.npy"))
        cfg = Config(image_size=64, compute_dtype="float32",
                     data_root=os.path.join(fx, "data"),
                     smpl_root=os.path.join(fx, "smpl"),
                     mask_root=os.path.join(fx, "mask"))
        with mp.context() as mp2:
            mp2.setattr(cli, "get_general_options", lambda: cfg)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli.main(["infer", "-e", "s4", "-n", "1", "--streams",
                          "final", "--device", "cpu"])
        served = os.path.join("test_results", "s4")
        rec["infer"] = {"printed": out.getvalue(), "videos": {
            v: sorted(os.listdir(os.path.join(served, v)))
            for v in os.listdir(served)
            if os.path.isdir(os.path.join(served, v))}}
        shutil.rmtree(ckpt("s4"))

        # stage 4 warm-started from stage 3, one step without the face GAN
        rec["warm"] = run(4, "warm", "--init-from", "s3", "--no-face-gan",
                          "--batch-size", "2", iters=1)
        for exp in ("s3", "warm"):
            shutil.rmtree(ckpt(exp))
    yield rec
    shutil.rmtree(base, ignore_errors=True)


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_train_writes_losses_and_checkpoint(runs, stage):
    r = runs[stage]
    assert r["printed"].rstrip().endswith("Training Done.")
    assert [row["iter"] for row in r["rows"]] == [0, 1]
    for row in r["rows"]:
        assert row["stage"] == stage
        assert set(row) == {"stage", "iter", "seconds"} | METRICS[stage]
        assert all(np.isfinite(row[k]) for k in METRICS[stage])
    # no iter_<step>/ directory, which would read as a JAX checkpoint
    assert r["files"] == ["losses.jsonl", "params_iter_1.npz",
                          "train_state_iter_1.pt"]
    assert set(r["tree"]) == set(ALL_MODULES)


def test_infer_serves_the_trained_npz(runs):
    r = runs["infer"]
    assert "restored ./checkpoints/s4/params_iter_1.npz" in r["printed"]
    assert list(r["videos"].values()) == [
        [f"frame_{i:03d}.jpg" for i in range(4)]]


def test_resume_continues_step_and_log(runs):
    r = runs["resume"]
    assert "resumed from ./checkpoints/s1/params_iter_1.npz" in r["printed"]
    assert "[stage1] iter 2 " in r["printed"]
    assert [row["iter"] for row in r["rows"]] == [0, 1, 2]
    assert {"params_iter_2.npz", "train_state_iter_2.pt"} <= set(r["files"])
    assert r["state"]["step"] == 3
    assert int(r["state"]["opts"]["accu"]["state"][0]["step"]) == 3


def test_init_from_loads_donor_modules(runs, tmp_path, monkeypatch):
    """Stage 4 warm-started from the stage-3 run: bg, loaded from the
    donor and frozen in stage 4, is the donor's after a step, while
    without the warm start it is the seeded init, which stage 3 trained
    away from."""
    r, donor, fresh = runs["warm"], runs[3]["tree"], runs[4]["tree"]
    assert "warm start: {accu,inpaint,bg,refine} <- " \
        "./checkpoints/s3/params_iter_1.npz" in r["printed"]
    np.testing.assert_equal(leaves(r["tree"]["bg"]), leaves(donor["bg"]))
    kernel = ("params", "Conv_0", "kernel")

    def at(tree):
        for k in kernel:
            tree = tree[k]
        return tree

    assert not np.array_equal(at(fresh["bg"]), at(donor["bg"]))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="stages 2-4"):
        train("--stage", "1", "--synthetic", "--init-from", "s1",
              "--device", "cpu")
    with pytest.raises(SystemExit, match="no checkpoints"):
        train("--stage", "2", "--synthetic", "--init-from", "nobody",
              "--device", "cpu")


def test_no_face_gan(runs):
    row = runs["warm"]["rows"][0]
    assert row["FD"] == 0.0 and row["FG"] == 0.0 and row["D"] > 0.0


def test_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # data parallelism refuses a batch that its ranks cannot share evenly,
    # and more ranks than cards (ranks never share a card)
    with pytest.raises(SystemExit, match="batch_size 3 not divisible by "
                       "--num-devices 2"):
        train("--stage", "1", "--synthetic", "--num-devices", "2",
              "--batch-size", "3", "--device", "cpu")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(SystemExit, match="--num-devices 2 needs 2 CUDA "
                           "devices, this host has 1"):
            train("--stage", "1", "--synthetic", "--num-devices", "2",
                  "-n", "twocards")
    assert not os.path.exists(ckpt("twocards"))
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train("--stage", "1", "--synthetic", "-n", "nocuda")
    assert not os.path.exists(ckpt("nocuda"))
    # a JAX export has no optimizer state to resume from
    os.makedirs(ckpt("jaxexport"))
    np.savez(os.path.join(ckpt("jaxexport"), "params_iter_5.npz"),
             x=np.zeros(1))
    with pytest.raises(SystemExit, match="no optimizer state"):
        train("--stage", "1", "--synthetic", "-n", "jaxexport", "--resume",
              "--device", "cpu")
