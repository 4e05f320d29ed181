"""Hook protocol + the eval hooks — port of ``xrnerf_tpu/core/hooks.py``
(``TestHook``, ``SaveSpiralHook``, ``ElapsedTimeHook``). Images are written
only when ``save_img`` is set, and ``imageio`` is imported only then.
"""

from __future__ import annotations

import json
import os
import time
from typing import TYPE_CHECKING, Dict, List

import numpy as np

from ..registry import HOOKS
from ..utils.logger import get_logger
from ..utils.metrics import psnr, ssim, to8b

if TYPE_CHECKING:  # pragma: no cover
    from .trainer import Trainer


class Hook:
    def on_run_begin(self, tr: "Trainer") -> None: ...

    def after_step(self, tr: "Trainer", step: int, logs: Dict[str, float]) -> None: ...

    def on_eval(self, tr: "Trainer", step: int) -> None: ...

    def on_run_end(self, tr: "Trainer") -> None: ...


@HOOKS.register
class TestHook(Hook):
    """Test-set PSNR/SSIM (per scale ``idx % ndown``) dumped to
    ``<work_dir>/test/test_results.json`` at run end."""

    def __init__(self, save_img: bool = True, ndown: int = 1):
        self.save_img = save_img
        self.ndown = ndown

    def on_run_end(self, tr: "Trainer") -> None:
        ds = tr.dataset
        per_scale: Dict[int, List[float]] = {i: [] for i in range(self.ndown)}
        per_scale_ssim: Dict[int, List[float]] = {i: [] for i in range(self.ndown)}
        out_dir = os.path.join(tr.work_dir, "test")
        os.makedirs(out_dir, exist_ok=True)
        for n, i in enumerate(ds.i_test):
            rays, gt = ds.eval_item(int(i))
            ret = tr.render_image(rays, gt.shape[0], gt.shape[1])
            s = n % self.ndown
            per_scale[s].append(float(psnr(ret["rgb"], gt)))
            per_scale_ssim[s].append(float(ssim(ret["rgb"], gt)))
            if self.save_img:
                import imageio.v2 as imageio

                imageio.imwrite(os.path.join(out_dir, f"test_{n}.png"), to8b(ret["rgb"]))
        results = {
            "psnr": {s: float(np.mean(v)) for s, v in per_scale.items() if v},
            "ssim": {s: float(np.mean(v)) for s, v in per_scale_ssim.items() if v},
        }
        with open(os.path.join(out_dir, "test_results.json"), "w") as f:
            json.dump(results, f, indent=2)
        get_logger().info("[test] %s", results)
        tr.eval_metrics = results


@HOOKS.register
class SaveSpiralHook(Hook):
    """Render the orbit path; with ``save_img`` write it as an mp4 (gif
    fallback). The uint8 frames are kept in ``self.frames``."""

    def __init__(self, n_frames: int = 0, fps: int = 20, save_img: bool = True):
        self.n_frames = n_frames
        self.fps = fps
        self.save_img = save_img
        self.frames: List[np.ndarray] = []

    def on_eval(self, tr: "Trainer", step: int) -> None:
        ds = tr.dataset
        poses = ds.render_poses
        if self.n_frames > 0:
            poses = poses[: self.n_frames]
        self.frames = []
        for pose in poses:
            rays, hw = ds.spiral_item(np.asarray(pose))
            ret = tr.render_image(rays, hw[0], hw[1])
            self.frames.append(to8b(ret["rgb"]))
        if not self.save_img:
            return
        import imageio.v2 as imageio

        out = os.path.join(tr.work_dir, f"spiral_{step}")
        os.makedirs(tr.work_dir, exist_ok=True)
        try:
            imageio.mimwrite(out + ".mp4", self.frames, fps=self.fps, quality=8)
        except (ValueError, RuntimeError, ImportError):  # no ffmpeg backend
            imageio.mimwrite(out + ".gif", self.frames, duration=1000 // self.fps)


@HOOKS.register
class ElapsedTimeHook(Hook):
    """Average full-image render latency (ms/frame, host clock around a
    render whose results are back on the host), first image dropped as
    warm-up."""

    def __init__(self, n_images: int = 3):
        self.n_images = n_images

    def on_eval(self, tr: "Trainer", step: int) -> None:
        ds = tr.dataset
        idxs = (ds.i_test if len(ds.i_test) else ds.i_val)[: self.n_images]
        times = []
        for i in idxs:
            rays, gt = ds.eval_item(int(i))
            t0 = time.perf_counter()
            tr.render_image(rays, gt.shape[0], gt.shape[1])
            times.append((time.perf_counter() - t0) * 1000)
        if len(times) > 1:
            times = times[1:]  # drop warmup
        get_logger().info("[eval %d] render %.1f ms/frame", step, float(np.mean(times)))
        tr.eval_metrics = {**getattr(tr, "eval_metrics", {}), "ms_per_frame": float(np.mean(times))}
