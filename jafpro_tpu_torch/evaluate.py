"""Video quality metrics (port of ``jafpro_tpu/evaluate.py``).

Per frame: SSIM (grayscale), L1, VGG perceptual distance and FlowNetSD
flow-consistency L1; per video: MS-SSIM and PSNR on the grayscale stack —
the metric set the reference logs (``test/video_evaluation.py:184-246``).

SSIM follows skimage's ``compare_ssim`` defaults (7x7 uniform window,
Bessel-corrected covariances, valid filtering); MS-SSIM is
skvideo.measure.msssim's algorithm (5 scales, Gaussian fspecial(11, 1.5)
window, 'product' combination). Plain torch ops on an explicit device,
``"cuda"`` by default, in full float32: TF32 is off in cuDNN and cuBLAS
while a video is scored (SSIM's ``E[x^2] - E[x]^2`` loses most of its
digits to TF32's 10-bit mantissa).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from jafpro_tpu_torch.device import resolve_device
from jafpro_tpu_torch.losses import (
    CRN_VGG_WEIGHTS, vgg_feature_l1, vgg_preprocess)

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB [0,1] -> (...) luma (ITU-R 601, skimage convention).
    Frames read with cv2 are BGR and go through as they are, as in the
    reference evaluator."""
    w = x.new_tensor([0.2125, 0.7154, 0.0721])
    return torch.tensordot(x, w, dims=1)


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Valid-mode uniform filter over the trailing two axes of (B, H, W)."""
    k = x.new_ones((1, 1, size, size)) / (size * size)
    return F.conv2d(x[:, None], k)[:, 0]


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7) -> torch.Tensor:
    """Mean SSIM between grayscale images (B, H, W) -> (B,)."""
    a, b = a.float(), b.float()
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)  # skimage sample covariance

    ux = _uniform_filter(a, win_size)
    uy = _uniform_filter(b, win_size)
    uxx = _uniform_filter(a * a, win_size)
    uyy = _uniform_filter(b * b, win_size)
    uxy = _uniform_filter(a * b, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    s = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
    # skimage crops (win_size-1)//2 from each side: the valid filter did
    return s.mean(dim=(1, 2))


def _fspecial_gauss_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """1-D factor of MATLAB's fspecial('gaussian', size, sigma)."""
    radius = size // 2
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_filter(x: torch.Tensor, size: int = 11,
                     sigma: float = 1.5) -> torch.Tensor:
    """Valid-mode fspecial-Gaussian filter over (B, H, W), separable."""
    g = torch.from_numpy(_fspecial_gauss_1d(size, sigma)).to(x)
    y = F.conv2d(x[:, None], g.view(1, 1, size, 1))
    return F.conv2d(y, g.view(1, 1, 1, size))[:, 0]


def _ssim_for_scale(a, b, data_range=1.0, size=11, sigma=1.5):
    """One MS-SSIM scale: (mean l*cs map, mean cs map)."""
    a, b = a.float(), b.float()
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    mu1 = _gaussian_filter(a, size, sigma)
    mu2 = _gaussian_filter(b, size, sigma)
    mu11, mu22, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s11 = _gaussian_filter(a * a, size, sigma) - mu11
    s22 = _gaussian_filter(b * b, size, sigma) - mu22
    s12 = _gaussian_filter(a * b, size, sigma) - mu12
    v1 = 2.0 * s12 + C2
    v2 = s11 + s22 + C2
    ssim_map = ((2.0 * mu12 + C1) * v1) / ((mu11 + mu22 + C1) * v2)
    return ssim_map.mean(dim=(1, 2)), (v1 / v2).mean(dim=(1, 2))


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """skvideo's inter-scale downsample: 2x2 average, stride 2; an odd
    trailing row or column averages with its reflection, i.e. itself
    (edge replication)."""
    _, H, W = x.shape
    x = x[:, None]
    if H % 2 or W % 2:
        x = F.pad(x, (0, W % 2, 0, H % 2), mode="replicate")
    return F.avg_pool2d(x, 2, 2)[:, 0]


def ms_ssim(a: torch.Tensor, b: torch.Tensor,
            data_range: float = 1.0) -> torch.Tensor:
    """Multi-scale SSIM on grayscale stacks (B, H, W) -> (B,). Inputs below
    11*2^4 = 176 px use the scales that fit the 11-px window, with the
    truncated weights renormalized."""
    weights = list(MSSSIM_WEIGHTS)
    sides, s = [], min(a.shape[1], a.shape[2])
    for _ in weights:
        sides.append(s)
        s = (s + 1) // 2  # the reflect downsample ceils odd sizes
    levels = max(1, sum(1 for s in sides if s >= 11))
    if levels < len(weights):
        total = sum(weights[:levels])
        weights = [w / total for w in weights[:levels]]
    mcs = []
    last_ssim = None
    for i in range(levels):
        s, cs = _ssim_for_scale(a, b, data_range)
        mcs.append(cs)
        last_ssim = s
        if i < levels - 1:
            a = _downsample2(a)
            b = _downsample2(b)
    out = last_ssim ** weights[-1]
    for i, w in enumerate(weights[:-1]):
        out = out * mcs[i] ** w
    return out


def psnr(a: torch.Tensor, b: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Per-image PSNR; ``inf`` where the images are equal."""
    mse = torch.square(a.float() - b.float()).mean(dim=tuple(range(1, a.ndim)))
    return 10.0 * torch.log10(data_range ** 2 / mse)


@contextlib.contextmanager
def _no_tf32():
    """No TF32 in convolutions or matmuls inside the block; the caller's
    settings come back after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _frames(pred, gt, device):
    pred = np.asarray(pred, np.float32)
    gt = np.asarray(gt, np.float32)
    if pred.max() > 1.5:
        pred, gt = pred / 255.0, gt / 255.0
    return (torch.from_numpy(pred).to(device),
            torch.from_numpy(gt).to(device))


def evaluate_video(pred: np.ndarray, gt: np.ndarray, vgg=None, flownet=None,
                   device="cuda") -> Dict[str, float]:
    """pred/gt: (T, H, W, 3) uint8 or [0,1] float. ``vgg``: a
    ``VGG19Features``, ``flownet``: a ``FlowNetSD``, both on ``device``
    (optional). Returns the metric dict the reference's evaluator logs per
    video."""
    dev = resolve_device(device)
    with torch.no_grad(), _no_tf32():
        p, g = _frames(pred, gt, dev)
        pg, gg = rgb_to_gray(p), rgb_to_gray(g)
        out = {
            "ssim": float(ssim(pg, gg).mean()),
            "l1": float(torch.abs(p - g).mean()),
            "ms_ssim": float(ms_ssim(pg, gg).mean()),
            "psnr": float(psnr(pg, gg).mean()),
        }
        if vgg is not None:
            def feats(x):
                return vgg(vgg_preprocess(x * 2 - 1).permute(0, 3, 1, 2))

            out["vgg"] = float(vgg_feature_l1(feats(p), feats(g),
                                              CRN_VGG_WEIGHTS))
        if flownet is not None:
            # flow consistency: L1 between the predicted video's flow and
            # the gt video's over consecutive frames
            # (reference video_evaluation.py:199-202)
            def flow(x):
                pairs = torch.cat([x[:-1], x[1:]], dim=-1)
                return flownet(pairs.permute(0, 3, 1, 2))

            out["flow_l1"] = float(torch.abs(flow(p) - flow(g)).mean())
    return out


def similarity_analysis(pred: np.ndarray, gt: np.ndarray,
                        device="cuda") -> Dict[str, float]:
    """Per-frame PSNR / SSIM / L1 means and standard deviations over a
    video pair (T, H, W, 3) (reference
    ``src/similarity_analysis_update.py:56-89``)."""
    dev = resolve_device(device)
    with torch.no_grad(), _no_tf32():
        p, g = _frames(pred, gt, dev)
        pg, gg = rgb_to_gray(p), rgb_to_gray(g)
        ssims = ssim(pg, gg).cpu().numpy()
        psnrs = psnr(pg, gg).cpu().numpy()
    l1s = np.abs((p - g).cpu().numpy()).reshape(p.shape[0], -1).mean(1)
    return {
        "psnr_mean": float(psnrs.mean()), "psnr_std": float(psnrs.std()),
        "ssim_mean": float(ssims.mean()), "ssim_std": float(ssims.std()),
        "l1_mean": float(l1s.mean()), "l1_std": float(l1s.std()),
    }
