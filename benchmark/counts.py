"""The yardstick's arithmetic: model FLOPs of the plain reference at a
cell's shapes, the rasterizer's bytes bound, and the card's peaks.

FLOPs are those of the reference's convolutions, matrix products and
their gradients, counted by ``torch.utils.flop_counter`` while the
reference runs on the ``meta`` device (shapes only, nothing computed), 2
per multiply-add. They are the work the model needs, whatever the program
executes: a later change that skips work leaves them as they are.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _meta_net(cfg: dict, modules):
    from benchmark.reference.nets import build

    return build(cfg["image_size"], cfg["face_crop_size"], cfg["num_parts"],
                 modules=modules, device="meta")


def count_flops(fn) -> int:
    """FLOPs of the convolutions, matrix products and their gradients that
    ``fn`` runs."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def _generator_flops(S, p, P, face, refs, frames) -> int:
    from benchmark.reference import ops
    from benchmark.reference.generate import textures

    cfg = {"image_size": S, "part_size": p, "num_parts": P,
           "face_crop_size": face}
    net = _meta_net(cfg, ("accu", "inpaint", "bg", "refine", "pro"))
    m = torch.device("meta")

    def forward():
        with torch.no_grad():
            parts = textures(net, torch.empty(1, refs, P, p, p, 3, device=m),
                             torch.empty(1, refs, P, p, p, device=m),
                             torch.empty(1, refs, device=m))
            net.bg(torch.empty(1, 3, S, S, device=m), S)
            iuv = torch.zeros(1, frames, S, S, 3, device=m)
            warped = ops.texture_warp_lattice(parts, iuv)[0]
            refined, fg = net.refine(warped.permute(0, 3, 1, 2), S)
            x = torch.empty(frames, 3, S, S, device=m)
            net.pro(refined, x, x, torch.empty(frames, 1, S, S, device=m),
                    per_sample_norm=True)
    return count_flops(forward)


def generator_flops_per_clip(cfg: dict, refs: int, frames: int) -> int:
    """One clip: texture fusion over ``refs`` references, inpainting, the
    background CRN, then per frame the texture warp's table, the refine
    CRN and the propagation net."""
    return _generator_flops(cfg["image_size"], cfg["part_size"],
                            cfg["num_parts"], cfg["face_crop_size"], refs,
                            frames)


@functools.lru_cache(maxsize=None)
def _train_flops(S, p, P, face, R, V, F, batch) -> int:
    from benchmark.reference.train import Stage4

    cfg = {"image_size": S, "part_size": p, "num_parts": P,
           "face_crop_size": face, "near": 0.1, "far": 25.0,
           "viewing_angle": 30.0}
    net = _meta_net(cfg, None)
    m = torch.device("meta")
    faces = torch.zeros(F, 3, dtype=torch.long, device=m)
    step = Stage4(net, faces, cfg, apply=False)
    B = batch
    f32 = torch.float32
    fields = {
        "src_parts": (B, R, P, p, p, 3), "src_mask_parts": (B, R, P, p, p),
        "tgt_iuv255": (B, S, S, 3), "tgt_img": (B, S, S, 3),
        "src_img_first": (B, S, S, 3), "prev_img": (B, S, S, 3),
        "bg_incomplete": (B, S, S, 3), "smpl_mask": (B, S, S, 1),
        "face_bbox": (B, 4), "prev_cam": (B, 3), "tgt_cam": (B, 3),
        "prev_verts": (B, V, 3), "tgt_verts": (B, V, 3), "ref_mask": (B, R)}
    batch_t = {k: torch.empty(v, dtype=f32, device=m)
               for k, v in fields.items()}
    return count_flops(lambda: step.step(batch_t))


def train_flops_per_sample(cfg: dict) -> float:
    """One stage-4 step at the configuration's batch, over its samples:
    the generator's forward and backward, the discriminators' forwards
    and backwards (1 face, 3 image updates and the generator's terms),
    VGG19 on both images and its backward to the input."""
    B = cfg["batch_size"]
    return _train_flops(cfg["image_size"], cfg["part_size"],
                        cfg["num_parts"], cfg["face_crop_size"],
                        cfg["maximum_ref_frames"], cfg["num_verts"],
                        cfg["num_faces"], B) / B


def b1_bytes(cfg: dict, poses: int) -> int:
    """What the rasterizer (B1) must move for ``poses`` poses without its
    depth output: each face's 3 view-space vertices read once (36 B), each
    pixel's face id and 3 weights written once (16 B)."""
    S = cfg["image_size"]
    return poses * (cfg["num_faces"] * 36 + S * S * 16)


def b1_bound_s(cfg: dict, poses: int) -> float:
    """B1's least time: its bytes at the HBM's peak (its operations,
    ~40 per pixel centre inside each face's box, bound it far lower)."""
    return b1_bytes(cfg, poses) / PEAK_HBM_BYTES
