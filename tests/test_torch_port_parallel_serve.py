"""``cli infer --num-devices 2 --device cpu``: the CLI starts 2 gloo ranks,
each serves its share of the clip batches from a pack (round-robin) and
writes its clips' frames and audit lines; rank 0 writes one
``serving_stats.json`` for all. Held to ``--num-devices 1`` on the same
pack: the same files, every frame within 1 uint8 step, the same audit
lines (one whole line per clip). Small widths
(``_torch_parallel_helpers.GEN``: 32 px, 4 parts of 16 px, 2 references,
4 frames), four seeded clips, seeded weights.
"""

import json
import os

import numpy as np
import pytest
import torch

import _torch_parallel_helpers as H
from jafpro_tpu_torch import cli
from jafpro_tpu_torch.config import Config
from jafpro_tpu_torch.data.shardio import write_clip_pack
from jafpro_tpu_torch.utils.meshproxy import uv_sphere

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    base = tmp_path_factory.mktemp("serve")
    pack = str(base / "pack")
    write_clip_pack(
        (dict(H.gen_clip(i), vid_name=f"clip_{i}",
              chosen_names=[f"frame_{i:06d}", f"frame_{i + 2:06d}"])
         for i in range(4)), pack, mode="test", num_refs=2)
    np.save(base / "faces.npy", uv_sphere(8, 10)[1])
    cfg = Config(**H.GEN, num_frames=H.GEN_T)
    out = {}
    # the one-device run computes with the threads each rank gets (the
    # host's cores shared out), so that both sum in one order: a jpg can
    # turn a 1-step difference of a frame into 2
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // 2))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("JAFPRO_SMPL_FACES", str(base / "faces.npy"))
            mp.setattr(cli, "get_general_options", lambda: cfg)
            for n in (1, 2):
                work = base / f"n{n}"
                work.mkdir()
                mp.chdir(work)
                cli.main(["infer", "-e", "t", "-n", "2", "--packed-clips",
                          pack, "--device", "cpu", "--num-devices", str(n)])
                out[n] = str(work)
    finally:
        torch.set_num_threads(threads)
    return out


def frames(work):
    import cv2

    root = os.path.join(work, "test_results", "t")
    return {os.path.join(vid, name): cv2.imread(os.path.join(root, vid, name))
            for vid in sorted(os.listdir(root))
            if os.path.isdir(os.path.join(root, vid))
            for name in sorted(os.listdir(os.path.join(root, vid)))}


def audit(work):
    with open(os.path.join(work, "log_result", "chosen_frame.txt")) as f:
        text = f.read()
    return text, sorted(x for x in text.split("\n\n") if x)


def test_infer_two_ranks_writes_the_frames_of_one(served):
    one, two = frames(served[1]), frames(served[2])
    assert sorted(one) == sorted(two)
    assert len(one) == 4 * 4 * H.GEN_T   # 4 clips, 4 streams, T frames
    for k in one:
        d = np.abs(one[k].astype(int) - two[k].astype(int)).max()
        assert d <= 1, (k, d)


def test_infer_two_ranks_audit_lines(served):
    text1, lines1 = audit(served[1])
    text2, lines2 = audit(served[2])
    assert lines2 == lines1 and len(lines1) == 4
    # whole lines only: every line ends its record
    assert text2.count(".\n\n") == 4 and len(text2) == len(text1)


def test_infer_two_ranks_one_stats_file(served):
    with open(os.path.join(served[2], "test_results", "t",
                           "serving_stats.json")) as f:
        stats = json.load(f)
    assert stats["clips"] == 4 and stats["items"] == 4
    assert stats["ranks"] == 2 and stats["clips_per_batch"] == 1
    assert stats["loop_seconds"] > 0 and stats["clips_per_s"] > 0
