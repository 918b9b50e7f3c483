"""DanceVideo clip loading for serving (port of the serving half of
``jafpro_tpu/data/dataset.py``; numpy and ``cv2`` only).

File protocol (reference ``src/utils.py:11-58`` + ``src/data.py``):
  <data_root>/<mode>/<vid>/   frameNNN.jpg            images (256x256)
                              frameNNN*IUV*.png       DensePose IUV maps
                              frameNNN*text*.png      800x1200 texture atlases
                              frameNNN*mask*.png      800x1200 atlas masks
  <smpl_root>/<mode>/<vid>/pose_shape.pkl             cams(3) pose(72)
                                                      shape(10) vertices(V,3)
  <mask_root>/<mode>/<vid>/*.png                      SMPL-rendered masks

``load_clip`` assembles the whole-clip dict that
``jafpro_tpu_torch.infer.VideoGenerator`` consumes, with the angle-based
reference selection (reference ``src/data.py:499-528``). ``cv2`` is
imported where an image is read, so the module imports without it.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict, List, Optional

import numpy as np

from jafpro_tpu_torch.data.angles import compute_angle, select_reference_frames


def _frame_number(path: str) -> int:
    m = re.findall(r"(\d+)", os.path.basename(path))
    return int(m[-1]) if m else 0


def _atlas_to_parts_np(atlas: np.ndarray, part_size: int = 200) -> np.ndarray:
    """(B, 4*p, 6*p, C) -> (B, 24, p, p, C) on the host (a reshape and a
    transpose)."""
    B, H, W, C = atlas.shape
    rows, cols = H // part_size, W // part_size
    x = atlas.reshape(B, rows, part_size, cols, part_size, C)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(x.reshape(B, rows * cols, part_size, part_size, C))


def list_clip_files(vid_path: str) -> Dict[str, List[str]]:
    """Split a clip directory into sorted image/IUV/texture/mask lists."""
    files = {"img": [], "iuv": [], "text": [], "mask": []}
    for name in sorted(os.listdir(vid_path)):
        p = os.path.join(vid_path, name)
        if "IUV" in name:
            files["iuv"].append(p)
        elif "mask" in name:
            files["mask"].append(p)
        elif "text" in name:
            files["text"].append(p)
        elif "bbox" in name or name.endswith(".pkl"):
            continue
        else:
            files["img"].append(p)
    for k in files:
        files[k].sort(key=_frame_number)
    return files


def _imread(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def load_clip(
    data_dir: str, smpl_dir: str, mask_dir: str, vid_name: str,
    num_refs: int = 4, rng: Optional[np.random.RandomState] = None,
) -> Dict[str, np.ndarray]:
    """Assemble the whole-clip inference dict (plus gt frames). Image-like
    fields stay uint8; the generator expands them on the device."""
    vid_path = os.path.join(data_dir, vid_name)
    files = list_clip_files(vid_path)
    T = len(files["img"])

    iuv_u8 = np.stack([_imread(p) for p in files["iuv"]])
    angles = np.array(
        [compute_angle(iuv_u8[i].astype(np.float32)) for i in range(T)])
    pro_frames = select_reference_frames(angles, num_refs)
    frames = np.clip(pro_frames, 0, 30)

    imgs_u8 = np.stack([_imread(p) for p in files["img"]])  # BGR, as ref

    texture_u8 = np.stack([_imread(files["text"][f]) for f in frames])
    masks_u8 = np.stack(
        [_imread(files["mask"][f])[..., 0] for f in frames])

    with open(os.path.join(smpl_dir, vid_name, "pose_shape.pkl"), "rb") as f:
        smpl = pickle.load(f)
    smpl_seq = np.concatenate(
        [smpl["cams"], smpl["pose"], smpl["shape"]], axis=1).astype(np.float32)

    real_mask_dir = os.path.join(mask_dir, vid_name)
    rm_files = sorted(
        (os.path.join(real_mask_dir, n) for n in os.listdir(real_mask_dir)
         if n.endswith("png")), key=_frame_number)
    smpl_mask = np.stack([_imread(p)[..., :1] for p in rm_files])

    src_parts = _atlas_to_parts_np(texture_u8, 200)
    mask_parts = _atlas_to_parts_np(masks_u8[..., None], 200)[..., 0]

    first_img = (imgs_u8[frames[0]].astype(np.float32) / 255.0 - 0.5) * 2.0
    in_image = (iuv_u8[frames[0], ..., 0] > 0).astype(np.float32)[..., None]
    rng = rng or np.random.RandomState(0)
    # carries unclipped Gaussian noise -> stays float32
    bg_incomplete = (1 - in_image) * first_img + in_image * \
        rng.randn(*first_img.shape).astype(np.float32)

    return {
        "src_parts": src_parts[None],
        "src_mask_parts": mask_parts[None],
        "ref_mask": np.ones((1, num_refs), np.float32),
        "bg_incomplete": bg_incomplete[None],
        "src_imgs": imgs_u8[frames],
        "chosen_frames": pro_frames.astype(np.int32),
        "tgt_iuv255": iuv_u8,
        "smpl_mask": smpl_mask,
        "cams": smpl_seq[:, 0:3],
        "verts": np.asarray(smpl["vertices"], np.float32),
        "gt_frames": (imgs_u8.astype(np.float32) / 255.0 - 0.5) * 2.0,
        "vid_name": vid_name,
        # basenames of the chosen reference frames, for the audit log the
        # reference appends per video (``src/data.py:530-535``)
        "chosen_names": [os.path.basename(files["img"][f]) for f in frames],
    }


def list_videos(data_root: str, mode: str = "test") -> List[str]:
    d = os.path.join(data_root, mode)
    if not os.path.isdir(d):
        return []
    return sorted(n for n in os.listdir(d)
                  if os.path.isdir(os.path.join(d, n)))
