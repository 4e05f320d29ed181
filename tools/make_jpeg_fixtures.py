#!/usr/bin/env python3
"""Write ``tests/data/jpeg/``: the JPEG files that ``tests/test_torch_jpeg.py``
and ``chip_smoke.py``'s ``captures`` phase read, and their ``manifest.json``.
It needs Pillow, ``imageio``, OpenCV (for the 4:4:0 and 4:1:1 files, which
Pillow cannot write) and the JAX package, so it runs where those are
installed, never on the card's machine:

    JAX_PLATFORMS=cpu python tools/make_jpeg_fixtures.py

- ``conformance/``: small files of odd sizes: 4:4:4, 4:2:2, 4:2:0, 4:4:0 and
  4:1:1 sampling, grey, quality 50 to 100, optimised Huffman tables, a
  restart interval, RGB with Adobe's transform 0, an EXIF orientation tag
  (not applied by ``imageio``), 1x1, and one progressive file, which the
  port refuses.
- ``zju/``: the photos of a ZJU-MoCap capture, ``make_synthetic_zju`` at
  ``chip_smoke.CAPTURE_ZJU`` (2 frames, 4 cameras, 512x512), as OpenCV's
  defaults write them: quality 95, 4:2:0.
- ``genebody/``: the photos of a GeneBody capture, ``make_synthetic_genebody``
  at ``chip_smoke.CAPTURE_GENEBODY`` (6 cameras at 1024x1024, the sphere
  large enough that each crop is downscaled to ``load_size`` 512), quality
  95, 4:2:0.
- ``llff/images/``: 4 full-size photos of 1008x756 (a quarter of LLFF's
  4032x3024), quality 95, 4:2:0, and no ``images_8`` directory.

``manifest.json`` holds, for each file, its writer and settings, its shape
and the SHA-256 of ``imageio.v2.imread``'s array; for each capture, the
shape, dtype and SHA-256 of the arrays that the JAX package's loaders make
of the capture directory (the photos, with the masks, annotations and SMPL
files that ``chip_smoke.py``'s ``zju_capture``, ``genebody_capture`` and
``llff_capture`` write around them).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "jpeg")


def pattern(rng, h, w, channels):
    """Smooth waves plus noise: every DCT band carries something."""
    y, x = np.mgrid[:h, :w]
    base = np.stack([128 + 100 * np.sin(x / 5.0 + k) * np.cos(y / 7.0 - k) for k in range(channels)], -1)
    return np.clip(base + rng.randint(-40, 40, base.shape), 0, 255).astype(np.uint8)


def llff_photo(i, h, w):
    """A forward-facing view: a sky gradient, a soft striped ground and a
    shaded ball, shifted a little per view."""
    y, x = np.mgrid[:h, :w].astype(np.float64)
    v, u = y / h, x / w
    img = np.stack([0.45 + 0.35 * v, 0.55 + 0.25 * v, 0.95 - 0.1 * v], -1)
    ground = v > 0.62
    stripes = 0.5 + 0.5 * np.sin(40 * u + 6 * v + 0.3 * i)
    img[ground] = np.stack([0.35 + 0.2 * stripes, 0.45 + 0.15 * stripes, 0.25 + 0.1 * stripes], -1)[ground]
    cx, cy, r = w * (0.45 + 0.02 * i), h * 0.5, 0.18 * h
    d2 = ((x - cx) ** 2 + (y - cy) ** 2) / r**2
    ball = d2 < 1
    shade = np.sqrt(np.clip(1 - d2, 0, 1)) * 0.8 + 0.2
    img[ball] = (np.array([0.85, 0.3, 0.2]) * shade[..., None])[ball]
    return np.round(255 * np.clip(img, 0, 1)).astype(np.uint8)


def save_pillow(path, img, **kw):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path, "JPEG", **kw)


def save_cv2(path, img, sampling, quality):
    import cv2

    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    ok, data = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality,
                                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
    assert ok
    with open(path, "wb") as f:
        f.write(data.tobytes())


def digest(a) -> dict:
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype), "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def conformance(rng):
    """(name, writer, settings, writer call) of each conformance file."""
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = 6  # orientation: rotate 90 degrees clockwise to view
    c = lambda h, w: pattern(rng, h, w, 3)  # noqa: E731
    return [
        ("c444_q95.jpg", "pillow", dict(quality=95, subsampling=0), c(37, 53)),
        ("c422_q75.jpg", "pillow", dict(quality=75, subsampling=1), c(37, 53)),
        ("c420_q50.jpg", "pillow", dict(quality=50, subsampling=2), c(37, 53)),
        ("c420_q100.jpg", "pillow", dict(quality=100, subsampling=2), c(53, 37)),
        ("c440_q95.jpg", "cv2", dict(quality=95, sampling="440"), c(37, 53)),
        ("c411_q95.jpg", "cv2", dict(quality=95, sampling="411"), c(29, 70)),
        ("grey_q95.jpg", "pillow", dict(quality=95), pattern(rng, 37, 53, 1)[..., 0]),
        ("c420_optimize.jpg", "pillow", dict(quality=90, optimize=True), c(45, 61)),
        ("c420_restart.jpg", "pillow", dict(quality=90, restart_marker_blocks=3), c(45, 61)),
        ("rgb_adobe.jpg", "pillow", dict(quality=95, subsampling=0, keep_rgb=True), c(23, 31)),
        ("exif_orientation6.jpg", "pillow", dict(quality=95, exif=exif.tobytes()), c(21, 34)),
        ("tiny_1x1.jpg", "pillow", dict(quality=95), c(1, 1)),
        ("progressive.jpg", "pillow", dict(quality=95, progressive=True), c(37, 53)),
    ]


def main() -> int:
    import imageio.v2 as imageio

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from xrnerf_torch.datasets.load.synthetic import make_synthetic_genebody, make_synthetic_zju

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    files, rng = {}, np.random.RandomState(cs.SEED)

    def record(rel, writer, settings):
        arr = np.asarray(imageio.imread(os.path.join(OUT, rel)))
        files[rel] = {"writer": writer, "settings": settings, **digest(arr)}

    for name, writer, settings, img in conformance(rng):
        path = os.path.join(OUT, "conformance", name)
        if writer == "cv2":
            os.makedirs(os.path.dirname(path), exist_ok=True)
            save_cv2(path, img, settings["sampling"], settings["quality"])
        else:
            save_pillow(path, img, **settings)
        shown = {k: (v if not isinstance(v, bytes) else "orientation 6") for k, v in settings.items()}
        record(f"conformance/{name}", writer, shown)

    opencv_default = dict(quality=95, subsampling=2)  # cv2.imwrite's defaults: quality 95, 4:2:0
    zju = make_synthetic_zju(**cs.CAPTURE_ZJU)
    for f in range(zju["imgs"].shape[0]):
        for c in range(zju["imgs"].shape[1]):
            rel = f"zju/Camera_B{c + 1}/{f:06d}.jpg"
            save_pillow(os.path.join(OUT, rel), cs.to_u8(zju["imgs"][f, c]), **opencv_default)
            record(rel, "pillow", opencv_default)
    gb = make_synthetic_genebody(**cs.CAPTURE_GENEBODY)
    for f in range(gb["imgs"].shape[0]):
        for c in range(gb["imgs"].shape[1]):
            rel = f"genebody/image/{c:02d}/{f:04d}.jpg"
            save_pillow(os.path.join(OUT, rel), np.round(255 * gb["imgs"][f, c]).astype(np.uint8), **opencv_default)
            record(rel, "pillow", opencv_default)
    for i in range(cs.CAPTURE_LLFF["n_images"]):
        rel = f"llff/images/img_{i:03d}.jpg"
        save_pillow(os.path.join(OUT, rel), llff_photo(i, cs.CAPTURE_LLFF["H"], cs.CAPTURE_LLFF["W"]),
                    **opencv_default)
        record(rel, "pillow", opencv_default)

    # the JAX package's loaders on each capture directory
    from xrnerf_tpu import build_dataset, load_config
    from xrnerf_tpu.datasets.load.llff import load_llff_data

    captures = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "zju")
        cs.zju_capture(root, os.path.join(OUT, "zju"))
        cfg = load_config(os.path.join(ROOT, "configs", "neuralbody", "nb_zjumocap.py"), dataname="313")
        ds = build_dataset(dict(cfg["data"], datadir=root))
        captures["zju"] = {"loader": "NeuralBodyDataset (configs/neuralbody/nb_zjumocap.py data)",
                           "imgs": digest(ds.imgs), "masks": digest(ds.masks)}
        root = os.path.join(tmp, "genebody")
        cs.genebody_capture(root, os.path.join(OUT, "genebody"))
        cfg = load_config(os.path.join(ROOT, "configs", "gnr", "gnr_genebody.py"), dataname=cs.CAPTURE_SUBJECT)
        ds = build_dataset(dict(cfg["data"], datadir=root, input_views=cs.CAPTURE_GENEBODY_VIEWS))
        captures["genebody"] = {"loader": "GeneBodyDataset (configs/gnr/gnr_genebody.py data, input_views "
                                          f"{list(cs.CAPTURE_GENEBODY_VIEWS)})",
                                "imgs": digest(ds.imgs), "masks": digest(ds.masks), "Ks": digest(ds.Ks)}
        root = os.path.join(tmp, "llff")
        cs.llff_capture(root, os.path.join(OUT, "llff"))
        captures["llff"] = {"loader": "load_llff_data (factor 8 from images/)",
                            "images": digest(load_llff_data(root)[0])}

    manifest = {"written_by": "tools/make_jpeg_fixtures.py", "refused": {"conformance/progressive.jpg": "progressive"},
                "files": files, "captures": captures}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(OUT) for n in ns)
    print(f"wrote {len(files)} files and manifest.json under {OUT}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
