"""DanceVideo loading for serving and training (port of
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
reference selection (reference ``src/data.py:499-528``);
``load_textonly_sample`` and ``load_interval_sample`` give one training
sample of stages 1-2 and 3-4, drawing from a ``np.random.RandomState`` in
the JAX package's order. ``cv2`` is imported where an image is read, so
the module imports without it.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict, List, Optional

import numpy as np

from jafpro_tpu_torch.data.angles import compute_angle, select_reference_frames
from jafpro_tpu_torch.data.texture import masks_to_atlas, transfer_texture


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


def face_bbox_from_iuv(iuv255: np.ndarray, image_size: int = 256) -> np.ndarray:
    """Face bbox (x0, x1, y0, y1) from DensePose parts 23/24 with the
    reference's -2 / +3 margin (``src/data.py:700-716``); zeros when no
    face pixel exists (the trainer masks such samples out)."""
    ys1, xs1 = np.where(iuv255[..., 0] == 23)
    ys2, xs2 = np.where(iuv255[..., 0] == 24)
    xs = np.concatenate([xs1, xs2])
    ys = np.concatenate([ys1, ys2])
    if xs.size == 0:
        return np.zeros((4,), np.float32)
    return np.asarray([
        max(xs.min() - 2, 0), min(xs.max() + 3, image_size),
        max(ys.min() - 2, 0), min(ys.max() + 3, image_size),
    ], np.float32)


def sample_frame_indices(
    T: int, rng: np.random.RandomState, num_inputs: int, num_target: int,
    fix_frame: bool = True, self_recon: bool = False,
) -> np.ndarray:
    """Frame sampling of the texture datasets (``src/data.py:41-63``),
    laid out [targets..., sources...]. ``fix_frame=False`` (``data.py:52-56``):
    w.p. 1/3 source 0 is duplicated into sources 1 and 2, w.p. 1/3 into
    source 1 only. ``self_recon=True`` (``data.py:58-63``): w.p. 0.3 one of
    the first ``num_inputs`` slots takes source 0's frame."""
    frames = rng.choice(T, num_inputs + num_target, replace=False)
    random_number = rng.random_sample()
    if not fix_frame and num_inputs >= 2:
        if random_number < 0.33333:
            if 2 + num_target < frames.size:
                frames[2 + num_target] = frames[num_target]
            frames[1 + num_target] = frames[num_target]
        elif random_number < 0.66666:
            frames[1 + num_target] = frames[num_target]
    if self_recon:
        if rng.random_sample() < 0.3:
            random_index = rng.choice(num_inputs, 1)
            frames[random_index] = frames[num_target]
    return frames


def load_textonly_sample(
    data_dir: str, vid_name: str, rng: np.random.RandomState,
    num_inputs: int = 4, num_target: int = 3,
    fix_frame: bool = True, self_recon: bool = False,
) -> Dict[str, np.ndarray]:
    """A stage-1/2 sample (reference ``Fusion_dataset_textonly``,
    ``src/data.py:187-258``): disjoint random reference and target frames,
    their 800x1200 atlases and masks as 24-part stacks, in float32."""
    files = list_clip_files(os.path.join(data_dir, vid_name))
    T = len(files["text"])
    frames = sample_frame_indices(T, rng, num_inputs, num_target,
                                  fix_frame=fix_frame, self_recon=self_recon)

    def read_parts(paths, idxs, is_mask):
        arr = np.stack([_imread(p)[..., 0] if is_mask else _imread(p)
                        for p in (paths[i] for i in idxs)]).astype(np.float32)
        if is_mask:
            arr = (arr / 255.0)[..., None]
        else:
            arr = (arr / 255.0 - 0.5) * 2.0
        return _atlas_to_parts_np(arr, 200)

    src_idx = frames[num_target:]
    tgt_idx = frames[:num_target]
    return {
        "src_parts": read_parts(files["text"], src_idx, False)[None],
        "src_mask_parts": read_parts(files["mask"], src_idx, True)[None, ..., 0],
        "tgt_parts": read_parts(files["text"], tgt_idx, False)[None],
        "tgt_mask_parts": read_parts(files["mask"], tgt_idx, True)[None, ..., 0],
        "ref_mask": np.ones((1, num_inputs), np.float32),
    }


def load_interval_sample(
    data_dir: str, smpl_dir: str, mask_dir: str, vid_name: str,
    rng: np.random.RandomState, num_inputs: int = 4, num_target: int = 1,
) -> Dict[str, np.ndarray]:
    """A stage-3/4 sample (reference ``Fusion_dataset_smpl_interval``,
    ``src/data.py:608-776``): images, IUVs, atlases and SMPL params of
    disjoint random frames in the step's batch layout (the curriculum
    fills the ``prev_*`` fields)."""
    files = list_clip_files(os.path.join(data_dir, vid_name))
    T = len(files["img"])
    frames = rng.choice(T, num_inputs + num_target, replace=False)
    src_idx, tgt_idx = frames[num_target:], frames[:num_target]

    tex = np.stack([_imread(files["text"][i]) for i in src_idx]).astype(np.float32)
    tex = (tex / 255.0 - 0.5) * 2.0
    masks = np.stack(
        [_imread(files["mask"][i])[..., 0] for i in src_idx]).astype(np.float32) / 255.0
    src_parts = _atlas_to_parts_np(tex, 200)
    mask_parts = _atlas_to_parts_np(masks[..., None], 200)[..., 0]

    def read_imgs(paths, idxs):
        a = np.stack([_imread(paths[i]) for i in idxs]).astype(np.float32)
        return (a / 255.0 - 0.5) * 2.0

    src_img = read_imgs(files["img"], src_idx)
    tgt_img = read_imgs(files["img"], tgt_idx)
    src_iuv255 = np.stack(
        [_imread(files["iuv"][i]) for i in src_idx]).astype(np.float32)
    tgt_iuv255 = np.stack(
        [_imread(files["iuv"][i]) for i in tgt_idx]).astype(np.float32)

    with open(os.path.join(smpl_dir, vid_name, "pose_shape.pkl"), "rb") as f:
        smpl = pickle.load(f)
    cams = np.asarray(smpl["cams"], np.float32)
    verts = np.asarray(smpl["vertices"], np.float32)

    rm_dir = os.path.join(mask_dir, vid_name)
    rm_files = sorted((os.path.join(rm_dir, n) for n in os.listdir(rm_dir)
                       if n.endswith("png")), key=_frame_number)
    smpl_mask = (_imread(rm_files[tgt_idx[0]])[..., :1].astype(np.float32)
                 / 255.0)

    in_image = (src_iuv255[0, ..., 0] > 0).astype(np.float32)[..., None]
    bg_incomplete = (1 - in_image) * src_img[0] + in_image * rng.randn(
        *src_img[0].shape).astype(np.float32)

    # the reference's other stage-3/4 mask fields (``src/data.py:680-720``):
    # produced but read by no loss (train/3:213-220, train/4:224-228)
    face_mask = np.isin(tgt_iuv255[0, ..., 0], (23, 24)).astype(np.float32)
    src_mask_in_image = (src_iuv255[..., 0] > 0).astype(np.float32)
    union_atlas = masks_to_atlas(mask_parts.max(axis=0))
    src_area = transfer_texture(
        union_atlas.astype(np.float32), tgt_iuv255[0])
    tgt_mask_in_image = (tgt_iuv255[0, ..., 0] > 0).astype(np.float32)
    image_inpaint_area = np.logical_xor(
        tgt_mask_in_image > 0, src_area > 0).astype(np.float32)

    return {
        "src_parts": src_parts[None],
        "src_mask_parts": mask_parts[None],
        "ref_mask": np.ones((1, num_inputs), np.float32),
        "face_mask": face_mask[None, ..., None],          # (1, S, S, 1)
        "src_mask_in_image": src_mask_in_image[None],     # (1, R, S, S)
        "image_inpaint_area": image_inpaint_area[None],   # (1, S, S)
        "tgt_iuv255": tgt_iuv255[:1],                     # (1, S, S, 3)
        "tgt_iuv": ((tgt_iuv255[0] / 255.0 - 0.5) * 2.0)[None],
        "tgt_img": tgt_img[:1],
        "src_img_first": src_img[:1],
        "src_imgs": src_img,
        "bg_incomplete": bg_incomplete[None],
        "smpl_mask": smpl_mask[None],
        "face_bbox": face_bbox_from_iuv(tgt_iuv255[0])[None],
        "src_frame_indices": src_idx.astype(np.int32),
        "tgt_cam": cams[tgt_idx[:1]],
        "tgt_verts": verts[tgt_idx[:1]],
        "src_cams": cams[src_idx],
        "src_verts": verts[src_idx],
    }
