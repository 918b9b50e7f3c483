"""Live training visualizers and video makers (a copy of
``jafpro_tpu/utils/visualizer.py``, which is NumPy, PIL and ``cv2`` only;
each imports what it needs where it is used).

A rebuild of the reference's alternate visualization stack
(``utils/visdom_visualizer.py:23-163`` and ``utils/video.py:25-96``):

* :class:`DashboardVisualizer` exposes the reference ``VisdomVisualizer``
  method surface (``vis_named_img`` / ``vis_preds_gts`` / ``vis_keypoints``
  / ``draw_skeleton``) but renders to a self-contained auto-refreshing HTML
  dashboard (PNG image grids + SVG skeleton charts): a training host often
  has no visdom server, so the live view is a plain directory servable by
  ``python -m http.server``.  If the ``visdom`` package is importable and
  ``ip``/``port`` are given, every call is also forwarded to a visdom
  server (same windows/semantics).
* :func:`make_video` / :func:`fuse_image` / :func:`fuse_video` are the
  ``utils/video.py`` equivalents (cv2 VideoWriter; optional ffmpeg h264
  re-encode when the binary exists).

Array convention: like the reference, images arrive as ``(T, C, H, W)`` or
``(T, H, W)`` in [-1, 1] (``denormalize=True`` maps to [0, 1]); keypoints
are COCO/LSP-ordered ``(T, num_points, 2)`` in [-1, 1] with y up.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

# LSP 14-point skeleton edges (1-based in the reference visualizer,
# utils/visdom_visualizer.py:69-70), plus the 5 face points of LSP-plus
_LSP_EDGES = [(14, 13), (13, 10), (10, 11), (11, 12), (13, 9), (9, 8),
              (8, 7), (13, 4), (13, 3), (4, 5), (5, 6), (3, 2), (2, 1)]
_LSP_PLUS_EDGES = _LSP_EDGES + [(18, 16), (16, 15), (15, 17), (17, 19)]


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _to_thwc(imgs, denormalize: bool, transpose: bool) -> np.ndarray:
    """Reference input handling (visdom_visualizer.py:91-119): (T,H,W) ->
    (T,1,H,W); optional NHWC->NCHW transpose; [-1,1] -> [0,1].  Returns
    uint8 (T,H,W,C)."""
    x = _to_numpy(imgs).astype(np.float32)
    if x.ndim == 3:
        x = x[:, None]
    elif transpose:
        x = np.transpose(x, (0, 3, 1, 2))
    if denormalize:
        x = (x + 1.0) / 2.0
    x = np.transpose(x, (0, 2, 3, 1))  # -> THWC for PNG writing
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def _tile(imgs: np.ndarray, nrow: int = 8) -> np.ndarray:
    """(T,H,W,C) -> one grid image, ``nrow`` images per row (visdom's
    ``images`` default layout)."""
    T, H, W, C = imgs.shape
    cols = min(nrow, T)
    rows = (T + cols - 1) // cols
    grid = np.zeros((rows * H, cols * W, C), imgs.dtype)
    for i in range(T):
        r, c = divmod(i, cols)
        grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = imgs[i]
    return grid


def skeleton_svg(key_points: np.ndarray, title: str,
                 plus: bool = False, size: int = 320) -> str:
    """Render an LSP(-plus) skeleton as an SVG line chart on [-1, 1]^2 axes
    (the reference plots the same edge list via ``visdom.line`` with
    xtickmin/-max +-1, visdom_visualizer.py:84-88)."""
    kp = _to_numpy(key_points)
    edges = [(a - 1, b - 1) for a, b in
             (_LSP_PLUS_EDGES if plus else _LSP_EDGES)]

    def sx(v):  # [-1,1] -> svg x
        return (float(v) + 1.0) / 2.0 * size

    def sy(v):  # [-1,1] -> svg y (svg y grows downward)
        return (1.0 - float(v)) / 2.0 * size

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
        f'height="{size}" viewBox="0 0 {size} {size}">',
        f'<rect width="{size}" height="{size}" fill="white" stroke="#ccc"/>',
        f'<title>{title}</title>',
    ]
    for a, b in edges:
        if a >= len(kp) or b >= len(kp):
            continue
        parts.append(
            f'<line x1="{sx(kp[a][0]):.1f}" y1="{sy(kp[a][1]):.1f}" '
            f'x2="{sx(kp[b][0]):.1f}" y2="{sy(kp[b][1]):.1f}" '
            'stroke="#1f77b4" stroke-width="2"/>')
    for i in range(len(kp)):
        parts.append(f'<circle cx="{sx(kp[i][0]):.1f}" '
                     f'cy="{sy(kp[i][1]):.1f}" r="3" fill="#d62728"/>')
    parts.append("</svg>")
    return "\n".join(parts)


class DashboardVisualizer:
    """Reference ``VisdomVisualizer`` API over a file-backed live dashboard.

    Every window is one file under ``out_dir`` (``<win>.png`` for image
    grids, ``<win>.svg`` for skeleton charts) plus an auto-refreshing
    ``index.html``.  Point a browser (or ``python -m http.server``) at the
    directory for a live view during training.
    """

    def __init__(self, env: str, out_dir: str = "visualizations",
                 time_step: int = 1, num_points: int = 18,
                 ip: Optional[str] = None, port: Optional[int] = None,
                 nrow: int = 8):
        self.env = env
        self.time_step = time_step
        self.num_points = num_points
        self.nrow = nrow
        self.out_dir = os.path.join(out_dir, env)
        os.makedirs(self.out_dir, exist_ok=True)
        self._windows: List[str] = []
        self.vis = None
        if ip and port:  # optional real-visdom mirror, gated on the package
            try:
                from visdom import Visdom  # not in the base env

                self.vis = Visdom(server=ip, endpoint="events", port=port,
                                  env=env)
            except ImportError:
                pass

    # ---- windows / index ----

    def _register(self, win: str, fname: str):
        if fname not in self._windows:
            self._windows.append(fname)
        items = "\n".join(
            f'<div style="display:inline-block;margin:4px;text-align:center">'
            f'<div>{os.path.splitext(f)[0]}</div>'
            f'<img src="{f}?ts={np.random.randint(1 << 30)}" '
            f'style="max-width:640px"/></div>'
            for f in self._windows)
        html = ("<html><head><meta http-equiv='refresh' content='2'>"
                f"<title>{self.env}</title></head><body>"
                f"<h3>{self.env}</h3>\n{items}\n</body></html>")
        tmp = os.path.join(self.out_dir, ".index.tmp")
        with open(tmp, "w") as f:
            f.write(html)
        os.replace(tmp, os.path.join(self.out_dir, "index.html"))

    def _write_png(self, win: str, grid: np.ndarray):
        from PIL import Image

        fname = win.replace(" ", "_").replace("/", "_") + ".png"
        tmp = os.path.join(self.out_dir, "." + fname + ".tmp")
        Image.fromarray(grid).save(tmp, format="PNG")
        os.replace(tmp, os.path.join(self.out_dir, fname))
        self._register(win, fname)

    # ---- reference API ----

    def vis_named_img(self, name: str, imgs, denormalize: bool = True,
                      transpose: bool = False):
        """Image-grid window (reference visdom_visualizer.py:91-120)."""
        thwc = _to_thwc(imgs, denormalize, transpose)
        self._write_png(name, _tile(thwc, self.nrow))
        if self.vis is not None:
            x = _to_numpy(imgs)
            if x.ndim == 3:
                x = x[:, None]
            elif transpose:
                x = np.transpose(x, (0, 3, 1, 2))
            if denormalize:
                x = (x + 1.0) / 2.0
            self.vis.images(tensor=x, win=name, opts={"title": name})

    def vis_preds_gts(self, preds=None, gts=None):
        """Two fixed windows (reference visdom_visualizer.py:122-163)."""
        if preds is not None:
            self.vis_named_img("predicted images", preds)
        if gts is not None:
            self.vis_named_img("ground truth images", gts)

    def draw_skeleton(self, key_points, win_name: str, plus: bool = False):
        svg = skeleton_svg(_to_numpy(key_points), win_name, plus=plus)
        fname = win_name.replace(" ", "_") + ".svg"
        tmp = os.path.join(self.out_dir, "." + fname + ".tmp")
        with open(tmp, "w") as f:
            f.write(svg)
        os.replace(tmp, os.path.join(self.out_dir, fname))
        self._register(win_name, fname)

    def vis_keypoints(self, preds, gts):
        """Per-timestep pred/gt skeleton windows with the reference's y-axis
        flip (visdom_visualizer.py:44-56)."""
        preds = _to_numpy(preds).copy()
        gts = _to_numpy(gts).copy()
        preds[:, :, 1] = -preds[:, :, 1]
        gts[:, :, 1] = -gts[:, :, 1]
        for i in range(min(self.time_step, len(preds))):
            self.draw_skeleton(preds[i], f"pred_keypoints_{i}", plus=True)
        for i in range(min(self.time_step, len(gts))):
            self.draw_skeleton(gts[i], f"gt_keypoints_{i}", plus=False)


# ---- video makers (reference utils/video.py:25-96) ----


def make_video(output_mp4_path: str, img_path_list: Sequence[str],
               save_frames_dir: Optional[str] = None, fps: int = 24) -> str:
    """Frames-on-disk -> mp4 (reference ``make_video``).  Uses cv2's mp4v
    writer directly; re-encodes to h264 with ffmpeg when the binary exists.
    """
    import shutil
    import subprocess

    import cv2

    first = cv2.imread(img_path_list[0])
    h, w = first.shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(output_mp4_path, fourcc, fps, (w, h))
    for i, path in enumerate(img_path_list):
        writer.write(cv2.imread(path))
        if save_frames_dir:
            shutil.copy(path, os.path.join(save_frames_dir, "%.8d.jpg" % i))
    writer.release()
    if shutil.which("ffmpeg"):
        tmp = output_mp4_path + ".h264.mp4"
        rc = subprocess.call(
            ["ffmpeg", "-y", "-i", output_mp4_path, "-vcodec", "h264", tmp],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        if rc == 0:
            os.replace(tmp, output_mp4_path)
        elif os.path.exists(tmp):
            os.remove(tmp)
    return output_mp4_path


def fuse_image(img_path_list: Sequence[str], row_num: int,
               col_num: int) -> np.ndarray:
    """Tile row_num x col_num images (reference ``fuse_image``)."""
    import cv2

    assert len(img_path_list) == row_num * col_num
    imgs = [cv2.imread(p) for p in img_path_list]
    rows = [np.concatenate(imgs[r * col_num:(r + 1) * col_num], axis=1)
            for r in range(row_num)]
    return np.concatenate(rows, axis=0)


def fuse_video(video_frames_path_list: Sequence[Sequence[str]],
               output_mp4_path: str, row_num: int, col_num: int,
               fps: int = 24) -> str:
    """Side-by-side comparison video of N frame sequences (reference
    ``fuse_video``)."""
    import shutil
    import subprocess

    import cv2

    assert len(video_frames_path_list) == row_num * col_num
    frame_num = len(video_frames_path_list[0])
    first = fuse_image([v[0] for v in video_frames_path_list],
                       row_num, col_num)
    h, w = first.shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(output_mp4_path, fourcc, fps, (w, h))
    for t in range(frame_num):
        writer.write(fuse_image([v[t] for v in video_frames_path_list],
                                row_num, col_num))
    writer.release()
    if shutil.which("ffmpeg"):
        tmp = output_mp4_path + ".h264.mp4"
        rc = subprocess.call(
            ["ffmpeg", "-y", "-i", output_mp4_path, "-vcodec", "h264", tmp],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        if rc == 0:
            os.replace(tmp, output_mp4_path)
        elif os.path.exists(tmp):
            os.remove(tmp)
    return output_mp4_path
