"""How well conditioned is one training step of the port's small check
configuration? Runs one SGD (lr 1e-3) step of a stage at 64 px (parts of
16, 2 refs, float32) twice on the CPU, the second time with
``bg_incomplete`` moved by N(0, eps^2), and prints how far each metric
and each module's update (after - before, relative L2) move, per batch
size. A step whose updates move far more than eps cannot be held to
another device's within float32 rounding.

    python tools/train_conditioning.py [--stage 4] [--eps 1e-5]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jafpro_tpu_torch import cli  # noqa: E402
from jafpro_tpu_torch.bridge import jax_params  # noqa: E402
from jafpro_tpu_torch.checkpoints import flatten  # noqa: E402
from jafpro_tpu_torch.config import Config  # noqa: E402
from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine  # noqa: E402
from jafpro_tpu_torch.pipeline import JAFProPipeline  # noqa: E402
from jafpro_tpu_torch.train.common import (  # noqa: E402
    TrainState, synthetic_batch, synthetic_quad_mesh, to_device)


def sgd_step(stage: int, batch: int, eps: float, seed: int = 0):
    verts, faces = synthetic_quad_mesh(6)
    cfg = Config(image_size=64, part_size=16, maximum_ref_frames=2,
                 face_crop_size=16, compute_dtype="float32")
    pipe = JAFProPipeline(cfg, flow_engine=SMPLFlowEngine(
        faces=faces, image_size=64), device="cpu",
        generator=torch.Generator().manual_seed(seed))
    b = synthetic_batch(np.random.RandomState(seed), batch=batch,
                        num_refs=2, part_size=16, image_size=64,
                        num_verts=verts.shape[0], num_targets=2)
    b["prev_verts"] = np.tile(verts[None], (batch, 1, 1))
    b["tgt_verts"] = b["prev_verts"] + np.float32([0.05, 0.0, 0.0])
    b["bg_incomplete"] = b["bg_incomplete"] + np.float32(eps) * \
        np.random.RandomState(seed + 1).randn(
            *b["bg_incomplete"].shape).astype(np.float32)
    before = flatten(jax_params(pipe))
    step, lrs = cli.make_step(pipe, stage)
    state = TrainState(pipe, lrs,
                       optimizer=lambda ps, lr: torch.optim.SGD(ps, 1e-3))
    state, m = step(state, to_device(b, torch.device("cpu")))
    after = flatten(jax_params(pipe))
    return {k: after[k] - before[k] for k in before}, \
        {k: float(v) for k, v in m.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", type=int, default=4, choices=[1, 2, 3, 4])
    ap.add_argument("--eps", type=float, default=1e-5)
    ap.add_argument("--batches", default="2,4")
    a = ap.parse_args(argv)
    for batch in (int(x) for x in a.batches.split(",")):
        d0, m0 = sgd_step(a.stage, batch, 0.0)
        d1, m1 = sgd_step(a.stage, batch, a.eps)
        mods: dict = {}
        for k, u in d0.items():
            e = mods.setdefault(k.split("/")[0], [0.0, 0.0])
            e[0] += float(np.square(d1[k] - u, dtype=np.float64).sum())
            e[1] += float(np.square(u, dtype=np.float64).sum())
        print(f"stage {a.stage} batch {batch} eps {a.eps}: metrics rel "
              + ", ".join(f"{k} {abs(m1[k] - m0[k]) / abs(m0[k]):.2e}"
                          for k in m0)
              + "; update rel L2 " + ", ".join(
                  f"{k} {(d / n) ** 0.5:.2e}" for k, (d, n) in
                  sorted(mods.items()) if n > 0), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
