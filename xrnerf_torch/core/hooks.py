"""Hook protocol + the standard hooks — port of ``xrnerf_tpu/core/hooks.py``
(``ValidateHook``, ``TestHook``, ``SaveSpiralHook``, ``OccupationHook``,
``ElapsedTimeHook``, ``ProfileHook``, ``SampleBudgetHook``). Images are written only when
``save_img`` is set, and ``imageio`` is imported only then. Under a mesh every
rank renders (the renderer shares the chunks out) and only global rank 0
(``parallel.mesh.is_main``) writes images, JSON and traces or reads the kill switch.
"""

from __future__ import annotations

import json
import os
import time
from typing import TYPE_CHECKING, Dict, List

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..parallel.mesh import is_main
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
class ValidateHook(Hook):
    """Val PSNR/SSIM at eval slots; with ``save_img`` side-by-side
    (render | ground truth) pngs in ``<work_dir>/val_<step>/``."""

    def __init__(self, save_img: bool = True, max_images: int = -1):
        self.save_img = save_img
        self.max_images = max_images

    def on_eval(self, tr: "Trainer", step: int) -> None:
        ds = tr.dataset
        idxs = ds.i_val if len(ds.i_val) else ds.i_test
        if self.max_images > 0:
            idxs = idxs[: self.max_images]
        psnrs, ssims = [], []
        out_dir = os.path.join(tr.work_dir, f"val_{step}")
        for n, i in enumerate(idxs):
            rays, gt = ds.eval_item(int(i))
            ret = tr.render_image(rays, gt.shape[0], gt.shape[1])
            psnrs.append(float(psnr(ret["rgb"], gt)))
            ssims.append(float(ssim(ret["rgb"], gt)))
            if self.save_img and is_main():
                import imageio.v2 as imageio

                os.makedirs(out_dir, exist_ok=True)
                side = np.concatenate([to8b(ret["rgb"]), to8b(gt)], axis=1)
                imageio.imwrite(os.path.join(out_dir, f"val_{n}.png"), side)
        get_logger().info(
            "[eval %d] val PSNR %.3f SSIM %.4f (%d imgs)",
            step, float(np.mean(psnrs)), float(np.mean(ssims)), len(idxs),
        )
        tr.eval_metrics = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}


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
        if is_main():
            os.makedirs(out_dir, exist_ok=True)
        for n, i in enumerate(ds.i_test):
            rays, gt = ds.eval_item(int(i))
            ret = tr.render_image(rays, gt.shape[0], gt.shape[1])
            s = n % self.ndown
            per_scale[s].append(float(psnr(ret["rgb"], gt)))
            per_scale_ssim[s].append(float(ssim(ret["rgb"], gt)))
            if self.save_img and is_main():
                import imageio.v2 as imageio

                imageio.imwrite(os.path.join(out_dir, f"test_{n}.png"), to8b(ret["rgb"]))
        results = {
            "psnr": {s: float(np.mean(v)) for s, v in per_scale.items() if v},
            "ssim": {s: float(np.mean(v)) for s, v in per_scale_ssim.items() if v},
        }
        if is_main():
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
        if not (self.save_img and is_main()):
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


@HOOKS.register
class OccupationHook(Hook):
    """Cooperative kill switch: stop when ``<work_dir>/<marker>`` is removed
    (under a mesh, rank 0 reads it and the ranks stop together at the end
    of a log window)."""

    def __init__(self, marker: str = "delete_me_to_stop"):
        self.marker = marker

    def on_run_begin(self, tr: "Trainer") -> None:
        if is_main():
            os.makedirs(os.path.join(tr.work_dir, self.marker), exist_ok=True)

    def after_step(self, tr: "Trainer", step: int, logs) -> None:
        if is_main() and not os.path.isdir(os.path.join(tr.work_dir, self.marker)):
            get_logger().info("kill-switch dir removed; stopping at step %d", step)
            tr.request_stop()


@HOOKS.register
class SampleBudgetHook(Hook):
    """Bucketed replacement for Instant-NGP's dynamic batch adaptation
    (resize the ray batch so live samples per step hit ``target_samples``):
    the ray batch moves between a fixed set of power-of-two buckets based on
    the EMA of the network's logged ``live_frac`` (live samples /
    (rays * n_keep)), so every step sees one of a few static shapes."""

    def __init__(self, target_samples: int = 2**18, buckets=(1024, 2048, 4096, 8192, 16384), ema: float = 0.8):
        self.target = int(target_samples)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.ema = float(ema)
        self._frac = None

    def pick(self, n_keep: int) -> int:
        """Largest bucket whose full-budget sample count stays within target."""
        frac = max(self._frac if self._frac is not None else 1.0, 1e-3)
        needed = self.target / (frac * max(n_keep, 1))
        fitting = [b for b in self.buckets if b <= needed]
        return fitting[-1] if fitting else self.buckets[0]

    def after_step(self, tr: "Trainer", step: int, logs) -> None:
        if step % tr.log_interval != 0:
            return
        live = tr.last_logs.get("live_frac") if tr.last_logs else None
        if live is None:
            return
        self._frac = live if self._frac is None else self.ema * self._frac + (1 - self.ema) * live
        n_keep = int(getattr(tr.network, "n_keep", 0) or 0)
        if n_keep <= 0 or not hasattr(tr.dataset, "N_rand"):
            return
        chosen = self.pick(n_keep)
        if chosen != tr.dataset.N_rand:
            tr.logger.info("SampleBudgetHook: live_frac %.3f -> N_rand %d -> %d", self._frac, tr.dataset.N_rand, chosen)
            tr.dataset.N_rand = chosen


@HOOKS.register
class ProfileHook(Hook):
    """``torch.profiler`` over steps ``start_step + 1 .. start_step +
    num_steps`` (CPU activity, and the card's where the network runs on
    one); a Chrome trace goes to ``<work_dir>/profile`` (or ``logdir``)."""

    def __init__(self, start_step: int = 50, num_steps: int = 5, logdir: str = ""):
        self.start_step = start_step
        self.num_steps = num_steps
        self.logdir = logdir
        self._prof = None

    def after_step(self, tr: "Trainer", step: int, logs) -> None:
        if step == self.start_step and self._prof is None:
            acts = [ProfilerActivity.CPU]
            if tr.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        elif self._prof is not None and step >= self.start_step + self.num_steps:
            self._stop(tr, step)

    def _stop(self, tr: "Trainer", step: int) -> None:
        if tr.device.type == "cuda":
            torch.cuda.synchronize(tr.device)
        self._prof.__exit__(None, None, None)
        logdir = self.logdir or os.path.join(tr.work_dir, "profile")
        if is_main():
            os.makedirs(logdir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(logdir, f"trace_{self.start_step}_{step}.json"))
        self._prof = None
        get_logger().info("[profile] trace for steps %d-%d written to %s", self.start_step, step, logdir)

    def on_run_end(self, tr: "Trainer") -> None:
        if self._prof is not None:
            self._stop(tr, tr.step)
