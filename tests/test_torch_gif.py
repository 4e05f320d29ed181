"""``utils/gif.py`` (the spiral's gif) read back by Pillow, and
``SaveSpiralHook`` writing it when ``imageio`` is hidden or has no ffmpeg.

Bars: Pillow reads the frame count and each frame's duration that were
written, and every frame is within 30 dB PSNR of its input (one adaptive
256-colour palette per frame; the frames are smooth render-like images).
"""

import os
import sys
from types import ModuleType, SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

from xrnerf_torch.core.hooks import SaveSpiralHook  # noqa: E402
from xrnerf_torch.utils.gif import lzw, write_gif  # noqa: E402

MIN_PSNR_DB = 30.0


def _frames(n, h, w, seed=0):
    """A shaded ball drifting over a gradient, with a little noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    out = []
    for t in range(n):
        r2 = ((x - w * (0.3 + 0.1 * t)) ** 2 + (y - h / 2) ** 2) / (0.3 * h) ** 2
        img = np.stack([0.2 + 0.6 * x / w, 0.3 + 0.4 * y / h, 0.8 - 0.3 * x / w], -1)
        ball = r2 < 1
        img[ball] = (np.array([0.9, 0.4, 0.2]) * (0.3 + 0.7 * np.sqrt(np.clip(1 - r2, 0, 1)))[..., None])[ball]
        out.append(np.clip(np.round(255 * img + rng.randn(h, w, 3)), 0, 255).astype(np.uint8))
    return out


def _read(path):
    im = Image.open(path)
    frames, durations = [], []
    for i in range(im.n_frames):
        im.seek(i)
        durations.append(im.info.get("duration"))
        frames.append(np.asarray(im.convert("RGB")))
    return frames, durations, im.info.get("loop")


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


@pytest.mark.parametrize("n,h,w,fps", [(3, 40, 56, 20), (1, 17, 9, 10), (2, 120, 160, 30)])
def test_gif_reads_back_in_pillow(n, h, w, fps, tmp_path):
    frames = _frames(n, h, w, seed=n)
    path = str(tmp_path / "spiral.gif")
    write_gif(path, frames, duration=1000 // fps)
    got, durations, loop = _read(path)
    assert len(got) == n and loop == 0
    assert durations == [(1000 // fps) // 10 * 10] * n
    for a, b in zip(got, frames):
        assert a.shape == b.shape and _psnr(a, b) >= MIN_PSNR_DB


def test_lzw_table_resets_on_a_long_frame(tmp_path):
    """A frame of more than 4096 distinct runs fills the code table (a clear
    code mid-stream); a frame of at most 256 colours comes back exactly."""
    rng = np.random.RandomState(4)
    palette = rng.randint(0, 256, (200, 3)).astype(np.uint8)
    frame = palette[rng.randint(0, 200, (150, 170))]
    path = str(tmp_path / "noisy.gif")
    write_gif(path, [frame], duration=50)
    got, _, _ = _read(path)
    assert np.array_equal(got[0], frame)
    assert len(lzw(rng.randint(0, 256, 20_000).astype(np.uint8))) > 0


def _no_ffmpeg_imageio():
    """An ``imageio`` whose ``mimwrite`` fails for an mp4 as it does without
    the ffmpeg plugin; any other write is a fault of the hook."""
    def mimwrite(path, *args, **kw):
        if path.endswith(".mp4"):
            raise ValueError("Could not find a backend to open `x.mp4` with iomode `wI`.")
        raise AssertionError(f"the hook wrote {path} through imageio")

    v2 = ModuleType("imageio.v2")
    v2.mimwrite = mimwrite
    top = ModuleType("imageio")
    top.v2 = v2
    return {"imageio": top, "imageio.v2": v2}


@pytest.mark.parametrize("imageio_state", ["hidden", "without_ffmpeg"])
def test_save_spiral_hook_writes_a_gif_without_imageio(imageio_state, tmp_path, monkeypatch):
    """Without ``imageio``, or with it but no ffmpeg, the spiral is the gif
    of ``write_gif`` on the same frames, byte for byte."""
    frames = _frames(4, 24, 32, seed=9)
    ds = SimpleNamespace(render_poses=np.zeros((4, 3, 4), np.float32),
                         spiral_item=lambda pose, it=iter(range(4)): (next(it), (24, 32)))
    work = tmp_path / "work"
    tr = SimpleNamespace(dataset=ds, work_dir=str(work),
                         render_image=lambda i, h, w: {"rgb": frames[i].astype(np.float32) / 255.0})
    for name in [m for m in sys.modules if m.split(".")[0] == "imageio"] + ["imageio"]:
        monkeypatch.setitem(sys.modules, name, None)
    if imageio_state == "without_ffmpeg":
        for name, module in _no_ffmpeg_imageio().items():
            monkeypatch.setitem(sys.modules, name, module)
    SaveSpiralHook(fps=25).on_eval(tr, 7)
    path = os.path.join(str(work), "spiral_7.gif")
    assert sorted(os.listdir(work)) == ["spiral_7.gif"]
    write_gif(str(tmp_path / "want.gif"), frames, duration=40)
    with open(path, "rb") as got_fh, open(tmp_path / "want.gif", "rb") as want_fh:
        assert got_fh.read() == want_fh.read()
    got, durations, _ = _read(path)
    assert len(got) == 4 and durations == [40] * 4
    for a, b in zip(got, frames):
        assert _psnr(a, b) >= MIN_PSNR_DB
