"""Does a served clip depend on how its inputs are laid out? On the card,
for packed full-width clips (``chip_smoke.pack_clips``) and the CLI's
serving generator in bfloat16 and float32, prints the largest uint8
difference between:

* the serving path on a one-clip group (``cli.generate_group``, what
  ``cli infer --clips-per-batch 1`` and each data-parallel rank run);
* ``gen(clip)`` on the pack reader's arrays, whose size-1 axes carry
  stride 0 (``VideoGenerator.__call__`` adds the clip axis with
  ``[None]``);
* ``gen(clip)`` on a copy of those arrays with fresh strides;
* ``gen(clip)`` run again (is one path deterministic?).

Needs a Hopper card and builds the kernels as ``chip_smoke.py`` does:

    python tools/serving_strides.py [--seed 0] [--clips 2]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from jafpro_tpu_torch import cli  # noqa: E402
from jafpro_tpu_torch.config import Config  # noqa: E402
from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine  # noqa: E402
from jafpro_tpu_torch.pipeline import JAFProPipeline  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clips", type=int, default=2)
    args = ap.parse_args(argv)
    card = C.phase_environment()   # TF32 off, as chip_smoke runs
    C.phase_build()
    for dtype in ("bfloat16", "float32"):
        cfg = Config(compute_dtype=dtype)
        T, NR, S, p, P = cfg.num_frames, cfg.maximum_ref_frames, \
            cfg.image_size, cfg.part_size, cfg.num_parts
        _, faces = C.make_clip(args.seed, T, NR, S, p, P)
        engine = SMPLFlowEngine(faces=faces, image_size=S)
        with tempfile.TemporaryDirectory() as root:
            C.pack_clips(args.seed, args.clips, T, NR, S, p, P, root)
            pipe = JAFProPipeline(
                cfg, flow_engine=engine, device="cuda",
                generator=torch.Generator().manual_seed(args.seed))
            gen = cli.serving_generator(pipe, cfg)
            served = cli.generate_group(gen)
            vids, load = cli.open_clip_source(cfg, NR, root)
            for vid, clip in zip(vids, load(vids)):
                alone = {k: v[0] for k, v in served((vid,), [clip]).items()}
                called = gen(clip)
                copied = gen({k: np.array(v, copy=True)
                              for k, v in clip.items()
                              if isinstance(v, np.ndarray)})
                again = gen(clip)
                print(f"[strides] {dtype} {vid}: served alone vs gen(clip) "
                      f"{C.u8_diff(alone, called)} LSB, vs gen(fresh-strided "
                      f"copy) {C.u8_diff(alone, copied)} LSB; gen(clip) "
                      f"run again {C.u8_diff(called, again)} LSB [{card}]",
                      flush=True)
            del pipe, gen, served
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
