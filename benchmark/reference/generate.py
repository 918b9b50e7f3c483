"""One served clip, as the reference computes it: the four uint8 streams
(final, coarse, mask, tsf) of the generator at integer IUV codes.

Per clip: fuse the references' part textures (ConvLSTM accumulation), mask
by the union of their visibility, inpaint, synthesise the background. Per
frame: warp the texture through the frame's IUV, refine (CRN with a mask
head), fuse with the background; warp the reference frame nearest in time to
the frame's pose through the SMPL barycentric flow; blend the two with the
propagation net (statistics per sample).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import ops

SYMMETRIC = ("src_parts", "src_imgs", "tgt_img", "src_img_first", "prev_img")
UNIT = ("src_mask_parts", "smpl_mask")


def expand(fields: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The uint8 wire format as floats: images to (-1, 1), masks to
    (0, 1), IUV codes kept; ``tgt_iuv`` derived from ``tgt_iuv255``."""
    out = {}
    for k, v in fields.items():
        t = (v if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v))).to(device)
        if t.dtype == torch.uint8:
            t = t.float()
            if k in SYMMETRIC:
                t = t / 255.0 * 2.0 - 1.0
            elif k in UNIT:
                t = t / 255.0
        out[k] = t
    if "tgt_iuv255" in out:
        out["tgt_iuv"] = (out["tgt_iuv255"] / 255.0 - 0.5) * 2.0
    return out


def encode_u8(x: torch.Tensor) -> torch.Tensor:
    """(-1, 1) -> uint8, truncating."""
    return torch.clamp((x * 0.5 + 0.5) * 255.0, 0, 255).to(torch.uint8)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def textures(net, src_parts, src_mask_parts, ref_mask):
    """(n, R, P, p, p, 3), (n, R, P, p, p), (n, R) -> inpainted parts."""
    fused = net.accu(src_parts, ref_mask)
    union = (src_mask_parts * ref_mask[:, :, None, None, None]).amax(dim=1)
    return net.inpaint(fused * union[..., None])


@torch.no_grad()
def generate_clip(net, clip: Dict[str, np.ndarray], faces: torch.Tensor,
                  cfg: dict, frames_per_pass: int = 10,
                  zbuffer_chunk: int = 1 << 24) -> Dict[str, np.ndarray]:
    """``clip``: one clip's wire-format fields (src_parts (1, R, P, p, p,
    3), src_mask_parts (1, R, P, p, p), bg_incomplete (1, S, S, 3),
    src_imgs (R, S, S, 3), chosen_frames (R,), tgt_iuv255 (T, S, S, 3),
    smpl_mask (T, S, S, 1), cams (T, 3), verts (T, V, 3)). Returns the
    four (T, S, S, C) uint8 streams on the host."""
    dev = next(net.parameters()).device
    c = expand(clip, dev)
    S = cfg["image_size"]
    R = c["src_imgs"].shape[0]
    ref_mask = torch.ones((1, R), device=dev)
    inpainted = textures(net, c["src_parts"], c["src_mask_parts"], ref_mask)
    bg = net.bg(nchw(c["bg_incomplete"]), S)                  # (1, 3, S, S)
    T = c["tgt_iuv255"].shape[0]
    chosen = c["chosen_frames"].long()
    pro = chosen.clamp(0, T - 1)
    src_pts = ops.source_points(c["cams"][pro], c["verts"][pro], faces,
                                cfg["viewing_angle"])          # (R, F, 3, 2)
    src_imgs = nchw(c["src_imgs"])
    out = {"final": [], "coarse": [], "mask": [], "tsf": []}
    for t0 in range(0, T, frames_per_pass):
        t = torch.arange(t0, min(T, t0 + frames_per_pass), device=dev)
        iuv255 = c["tgt_iuv255"][t]
        warped = ops.texture_warp_lattice(inpainted, iuv255[None])[0]
        refined, fg = net.refine(nchw(warped), S)
        fusion = refined * fg + bg * (1.0 - fg)
        ref = torch.argmin(torch.abs(t[:, None] - chosen[None, :]), dim=1)
        fim, wim = ops.zbuffer(
            ops.project_faces(c["cams"][t], c["verts"][t], faces,
                              cfg["viewing_angle"]),
            S, cfg["near"], cfg["far"], zbuffer_chunk)
        grid = ops.barycentric_grid(src_pts[ref], fim, wim)
        tsf = ops.grid_sample(src_imgs[ref], grid, "border")
        res = net.pro(fusion, tsf, nchw(c["tgt_iuv"][t]),
                      nchw(c["smpl_mask"][t]), per_sample_norm=True)
        out["final"].append(encode_u8(nhwc(res["pred_target"])))
        out["coarse"].append(encode_u8(nhwc(fusion)))
        out["tsf"].append(encode_u8(nhwc(tsf)))
        out["mask"].append(torch.clamp(nhwc(res["weight"]) * 255.0, 0,
                                       255).to(torch.uint8))
    return {k: torch.cat(v).cpu().numpy() for k, v in out.items()}
