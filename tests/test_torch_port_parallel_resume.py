"""``cli train --resume --num-devices 2 --device cpu``: a stage-4 save
(``save_checkpoint`` of the ``--synthetic`` pipeline, as the CLI writes
it on one device) is restored on both gloo ranks, and rank 0 alone writes
it back. The other half of
``tests/test_cli.py::test_train_stage4_shards_mesh_resume``'s check
(``test_torch_port_parallel_cli.py`` steps over the ranks; a resumed run
that steps as well takes longer than this file may on one core).
"""

import argparse
import os
import shutil
from unittest import mock

import torch

from _torch_parallel_helpers import CKPT, setup_shards
from jafpro_tpu_torch import cli
from jafpro_tpu_torch.checkpoints import save_checkpoint
from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
from jafpro_tpu_torch.pipeline import JAFProPipeline
from jafpro_tpu_torch.train.common import TrainState, synthetic_quad_mesh

torch.set_num_threads(1)


def test_train_stage4_resume_over_two_ranks(tmp_path, monkeypatch, capfd):
    args = setup_shards(tmp_path, monkeypatch)
    try:
        # the save to resume from; its weights are torch's defaults (the
        # seeded initialisation costs seconds and nothing here reads them)
        with mock.patch("jafpro_tpu_torch.pipeline.init_params_",
                        lambda *a: None):
            pipe = JAFProPipeline(
                cli.train_config(argparse.Namespace(
                    synthetic=True, no_face_gan=False, dtype="", batch_size=2,
                    stage=4, debug=False)), device="cpu",
                flow_engine=SMPLFlowEngine.create(
                    faces=synthetic_quad_mesh(6)[1], image_size=64))
        save_checkpoint(CKPT, 0, pipe, TrainState(pipe, cli.make_step(
            pipe, 4)[1]))
        del pipe
        cli.main(args + ["--iters", "0", "--num-devices", "2", "--resume"])
        out = capfd.readouterr().out
        assert "data-parallel over 2 devices" in out
        # rank 0 alone prints and writes
        assert out.count(
            "resumed from ./checkpoints/exp_sh/params_iter_0.npz") == 1
        assert out.count("Training Done") == 1
        assert sorted(os.listdir(CKPT)) == [
            "losses.jsonl", "params_iter_0.npz", "train_state_iter_0.pt"]
        state = torch.load(os.path.join(CKPT, "train_state_iter_0.pt"),
                           weights_only=True)
        assert state["step"] == 0 and set(state["opts"]) == {
            "accu", "inpaint", "refine", "pro", "D", "FD"}
    finally:  # a save of every module is over 1 GB
        shutil.rmtree(CKPT, ignore_errors=True)
