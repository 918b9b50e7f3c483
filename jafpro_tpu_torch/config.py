"""Configuration of the generation, serving and training paths.

The fields of ``jafpro_tpu/config.py::Config`` that the port reads, under
the same names and defaults; TPU-only knobs are left out.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class Config:
    num_frames: int = 30            # frames per clip (2 s @ 15 FPS)
    maximum_ref_frames: int = 4
    # targets per textonly sample (reference options.py:23); must match
    # the value the textonly shards were packed with
    num_target: int = 3
    fix_frame: bool = True
    self_recon: bool = False

    # ---- training schedule ----
    vis_interval: int = 200
    model_save_interval: int = 3000
    batch_size: int = 4
    face_GAN: bool = True

    image_size: int = 256
    part_size: int = 200            # each of the 24 DensePose parts
    num_parts: int = 24
    face_crop_size: int = 64

    num_verts: int = 6890
    num_faces: int = 13776
    viewing_angle: float = 30.0
    near: float = 0.1
    far: float = 25.0

    project_dir: str = "."
    model_save_dir: str = "./checkpoints"
    test_save_dir: str = "./test_results"
    data_root: str = ""
    smpl_root: str = ""
    mask_root: str = ""

    compute_dtype: str = "bfloat16"   # conv activations dtype


def get_general_options() -> Config:
    """``Config()`` with the data roots taken from ``JAFPRO_DATA_ROOT``,
    ``JAFPRO_SMPL_ROOT`` and ``JAFPRO_MASK_ROOT`` where they are set."""
    cfg = Config()
    for attr, var in (("data_root", "JAFPRO_DATA_ROOT"),
                      ("smpl_root", "JAFPRO_SMPL_ROOT"),
                      ("mask_root", "JAFPRO_MASK_ROOT")):
        v = os.environ.get(var)
        if v:
            setattr(cfg, attr, v)
    return cfg


def default_smpl_faces_path() -> Optional[str]:
    """Locate the SMPL face-index asset (``JAFPRO_SMPL_FACES`` or the
    package's ``assets/smpl_faces.npy``); None when absent."""
    candidates = [
        os.environ.get("JAFPRO_SMPL_FACES", ""),
        os.path.join(os.path.dirname(__file__), "assets", "smpl_faces.npy"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None
