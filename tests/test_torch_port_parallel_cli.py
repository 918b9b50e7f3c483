"""``cli train --num-devices 2 --device cpu`` on the CPU: the CLI starts 2
gloo ranks itself (``parallel.spawn``), each reads the same packed
interval records through the shard reader, keeps its half of every batch
and steps stage 4 through ``data_parallel_jit``; rank 0 alone logs and
saves, and ``--resume`` restores on every rank. Mirrors
``tests/test_cli.py::test_train_stage4_shards_mesh_resume`` (one step per
run: each rank builds the full-width pipeline, seconds on one core;
``test_torch_port_parallel_resume.py`` resumes over the ranks).
"""

import os
import shutil

import torch

from _torch_parallel_helpers import CKPT, check_rows, setup_shards
from jafpro_tpu_torch import cli

torch.set_num_threads(1)


def test_train_stage4_shards_over_two_ranks(tmp_path, monkeypatch, capfd):
    args = setup_shards(tmp_path, monkeypatch)
    try:
        cli.main(args + ["--iters", "1", "--num-devices", "2"])
        out = capfd.readouterr().out
        assert "data-parallel over 2 devices" in out
        # rank 0 alone prints, logs and saves
        assert out.count("shard reader: 6 records") == 1
        assert out.count("[stage4] iter 0 loss") == 1
        assert out.count("Training Done") == 1
        assert sorted(os.listdir(CKPT)) == [
            "losses.jsonl", "params_iter_0.npz", "train_state_iter_0.pt"]
        check_rows([0])
    finally:  # a save of every module is over 1 GB
        shutil.rmtree(CKPT, ignore_errors=True)
