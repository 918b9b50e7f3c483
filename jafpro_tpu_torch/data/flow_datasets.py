"""Optical-flow dataset loaders for the FlowNet harness (the port's copy of
``jafpro_tpu/data/flow_datasets.py``; plain numpy, no JAX in either).

Rebuilds the reference's dataset surface
(``src/flownet2_pytorch/datasets.py``): Middlebury ``.flo`` IO, the
MpiSintel / FlyingChairs / ChairsSDHom / ImagesFromFolder index layouts,
and the static random/center crop semantics — as plain NumPy index builders
plus a batched sampler, instead of torch ``Dataset`` objects.  The harness
consumes NHWC float batches directly (``train/flow_harness.py``, which
moves them to NCHW on the device).

Images load as float32 in [0, 1] RGB (the harness's synthetic source uses
the same range; the reference normalizes by ``rgb_max`` inside the
network wrappers instead).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

_FLO_MAGIC = 202021.25  # Middlebury sanity constant ("PIEH" as float)


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32
    (``flownet2_pytorch/utils/flow_utils.py`` readFlow semantics)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(_FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"a .flo holds (H, W, 2), got {flow.shape}")
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        np.asarray([_FLO_MAGIC], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.tofile(f)


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 RGB in [0, 1]. Imports ``cv2`` here: a host
    without it can still index datasets and read flows."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., ::-1].astype(np.float32) / 255.0


def index_mpi_sintel(root: str, dstype: str = "clean"
                     ) -> Tuple[List[Tuple[str, str]], List[str]]:
    """(image pairs, flows) for an MPI-Sintel layout
    (``datasets.py:30-75``): flows under ``flow/<scene>/frame_NNNN.flo``,
    frames under ``<dstype>/<scene>/frame_NNNN.png``; 'test' scenes and
    pairs with missing files are skipped."""
    flow_root = os.path.join(root, "flow")
    image_root = os.path.join(root, dstype)
    pairs, flows = [], []
    for flo in sorted(glob.glob(os.path.join(flow_root, "*", "*.flo"))):
        rel = os.path.relpath(flo, flow_root)
        if "test" in rel:  # scene-relative: the dataset root itself may
            continue       # legitimately contain "test" in its path
        prefix, num = rel[:-8], int(rel[-8:-4])
        img1 = os.path.join(image_root, f"{prefix}{num:04d}.png")
        img2 = os.path.join(image_root, f"{prefix}{num + 1:04d}.png")
        if os.path.isfile(img1) and os.path.isfile(img2):
            pairs.append((img1, img2))
            flows.append(flo)
    return pairs, flows


def index_flying_chairs(root: str
                        ) -> Tuple[List[Tuple[str, str]], List[str]]:
    """FlyingChairs_release/data layout (``datasets.py:114-135``):
    sorted ``*.ppm`` pair up two-per-flow with sorted ``*.flo``."""
    images = sorted(glob.glob(os.path.join(root, "*.ppm")))
    flows = sorted(glob.glob(os.path.join(root, "*.flo")))
    if len(images) != 2 * len(flows):
        raise ValueError(
            f"{root}: {len(images)} images vs {len(flows)} flows "
            "(expected 2 images per flow)")
    pairs = [(images[2 * i], images[2 * i + 1]) for i in range(len(flows))]
    return pairs, flows


def index_chairs_sdhom(root: str, dstype: str = "train"
                       ) -> Tuple[List[Tuple[str, str]], List[str]]:
    """ChairsSDHom layout (``datasets.py:250-271``): t0/t1/flow dirs.
    NOTE: reference flips the flow vertically at load (``:289``)."""
    im1 = sorted(glob.glob(os.path.join(root, dstype, "t0", "*.png")))
    im2 = sorted(glob.glob(os.path.join(root, dstype, "t1", "*.png")))
    flows = sorted(glob.glob(os.path.join(root, dstype, "flow", "*.flo")))
    if not (len(im1) == len(im2) == len(flows)):
        raise ValueError(f"{root}/{dstype}: mismatched t0/t1/flow counts")
    return list(zip(im1, im2)), flows


def index_images_from_folder(root: str, iext: str = "png"
                             ) -> List[Tuple[str, str]]:
    """Consecutive frame pairs from a flat folder (``datasets.py:320-344``);
    inference-only (no ground-truth flow)."""
    frames = sorted(glob.glob(os.path.join(root, f"*.{iext}")))
    return list(zip(frames[:-1], frames[1:]))


def crop_offset(rng: Optional[np.random.RandomState],
                image_size: Tuple[int, int],
                crop_size: Tuple[int, int]) -> Tuple[int, int]:
    """StaticRandomCrop (rng given) / StaticCenterCrop (rng None) offsets
    (``datasets.py:13-28``); one offset shared by both frames + flow."""
    h, w = image_size
    th, tw = crop_size
    if rng is None:
        return (h - th) // 2, (w - tw) // 2
    return rng.randint(0, h - th + 1), rng.randint(0, w - tw + 1)


class FlowPairSource:
    """Batched sampler over an indexed flow dataset.

    ``crop_size`` (h, w) is required for batching (the harness takes a
    static shape; the reference's center-crop-to-multiple-of-64 inference
    path maps to passing the rounded size here).  ``flip_flow_vertical``
    reproduces the ChairsSDHom ``flow[::-1]`` quirk."""

    def __init__(self, pairs: Sequence[Tuple[str, str]],
                 flows: Sequence[str], crop_size: Tuple[int, int],
                 random_crop: bool = True,
                 flip_flow_vertical: bool = False):
        if len(pairs) != len(flows):
            raise ValueError("pairs/flows length mismatch")
        if not pairs:
            raise ValueError("empty flow dataset")
        self.pairs = list(pairs)
        self.flows = list(flows)
        self.crop_size = tuple(crop_size)
        self.random_crop = random_crop
        self.flip_flow_vertical = flip_flow_vertical

    def __len__(self) -> int:
        return len(self.pairs)

    def sample_batch(self, rng: np.random.RandomState, batch: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(pairs (B, th, tw, 6), flow (B, th, tw, 2)) float32 NHWC."""
        th, tw = self.crop_size
        xs = np.empty((batch, th, tw, 6), np.float32)
        ys = np.empty((batch, th, tw, 2), np.float32)
        for b in range(batch):
            i = rng.randint(len(self.pairs))
            img1 = read_image(self.pairs[i][0])
            img2 = read_image(self.pairs[i][1])
            flow = read_flo(self.flows[i])
            if self.flip_flow_vertical:
                flow = flow[::-1]
            off = crop_offset(rng if self.random_crop else None,
                              img1.shape[:2], (th, tw))
            y0, x0 = off
            xs[b, ..., :3] = img1[y0:y0 + th, x0:x0 + tw]
            xs[b, ..., 3:] = img2[y0:y0 + th, x0:x0 + tw]
            ys[b] = flow[y0:y0 + th, x0:x0 + tw]
        return xs, ys


DATASETS = {
    "MpiSintelClean": lambda root: index_mpi_sintel(root, "clean"),
    "MpiSintelFinal": lambda root: index_mpi_sintel(root, "final"),
    "FlyingChairs": index_flying_chairs,
    "ChairsSDHomTrain": lambda root: index_chairs_sdhom(root, "train"),
    "ChairsSDHomTest": lambda root: index_chairs_sdhom(root, "test"),
}


def make_source(name: str, root: str, crop_size: Tuple[int, int],
                random_crop: bool = True) -> FlowPairSource:
    """Build a sampler by reference dataset name (``main.py --training_dataset``)."""
    if name not in DATASETS:
        raise KeyError(f"unknown flow dataset {name!r}; "
                       f"one of {sorted(DATASETS)}")
    pairs, flows = DATASETS[name](root)
    return FlowPairSource(pairs, flows, crop_size, random_crop,
                          flip_flow_vertical=name.startswith("ChairsSDHom"))
