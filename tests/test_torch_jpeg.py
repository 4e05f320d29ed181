"""The port's JPEG reader (``utils/jpeg.py``, ``native/jpeg_decode.cpp``), its
Pillow resizes in numpy (``datasets/load/pil_resize.py``) and the loaders
that read JPEG photos, held bit for bit against ``imageio.v2.imread``,
Pillow and the JAX package's loaders on the same files.

The JPEGs are written here by Pillow (4:4:4, 4:2:2, 4:2:0, grey, restart
markers, RGB, EXIF) and by OpenCV (4:4:0 and 4:1:1, which Pillow cannot
write), from seeded numpy images of sizes that 8 and 16 do not divide; the
committed files under ``tests/data/jpeg/`` are held to ``manifest.json``.
Every port-side read runs with ``imageio``, ``PIL`` and ``cv2`` hidden
(``sys.modules`` entries set to ``None``). Tolerance: none, every array is
compared exactly.
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
imageio = pytest.importorskip("imageio.v2")
from PIL import Image  # noqa: E402

import chip_smoke  # noqa: E402
from xrnerf_torch import build_dataset, load_config  # noqa: E402
from xrnerf_torch.datasets.load.pil_resize import resize_bicubic, resize_nearest  # noqa: E402
from xrnerf_torch.utils.jpeg import decode_jpeg, imread_jpeg  # noqa: E402
from xrnerf_torch.utils.png import imread, imwrite_png  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
SIZES = [(37, 53), (16, 16), (1, 1), (9, 70), (70, 9), (33, 65)]  # (H, W)
CODECS = ("imageio", "PIL", "cv2")


def hide_codecs(monkeypatch):
    """Hide imageio, Pillow and OpenCV from the rest of a test (the port's side)."""
    for name in list(sys.modules):
        if name.split(".")[0] in CODECS:
            monkeypatch.setitem(sys.modules, name, None)
    for name in CODECS:
        monkeypatch.setitem(sys.modules, name, None)


def _pattern(rng, h, w, channels=3):
    y, x = np.mgrid[:h, :w]
    base = np.stack([128 + 100 * np.sin(x / 5.0 + k) * np.cos(y / 7.0 - k) for k in range(channels)], -1)
    out = np.clip(base + rng.randint(-40, 40, base.shape), 0, 255).astype(np.uint8)
    return out[..., 0] if channels == 1 else out


def _pillow_jpeg(img, mode=None, **kw):
    buf = io.BytesIO()
    im = Image.fromarray(img)
    (im.convert(mode) if mode else im).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _cv2_jpeg(img, sampling, quality, optimize=False, restart=0):
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    ok, data = cv2.imencode(".jpg", img[..., ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag,
        cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize), cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    return data.tobytes()


def _same_as_imageio(data, name):
    want = np.asarray(imageio.imread(io.BytesIO(data), format="JPEG"))
    got = decode_jpeg(data, name)
    assert got.dtype == np.uint8 and got.shape == want.shape, (name, got.shape, want.shape)
    assert np.array_equal(got, want), (name, int(np.abs(got.astype(int) - want).max()))


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# --- the decoder against imageio.v2.imread ---------------------------------------------


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440"])
def test_decode_matches_imageio(sampling, quality, optimize):
    """Every size, bit for bit; 4:4:0 is written by OpenCV."""
    rng = np.random.RandomState(quality + 7 * optimize)
    for h, w in SIZES:
        img = _pattern(rng, h, w)
        if sampling == "440":
            data = _cv2_jpeg(img, sampling, quality, optimize)
        else:
            data = _pillow_jpeg(img, quality=quality, optimize=optimize, subsampling=f"4:{sampling[1]}:{sampling[2]}")
        _same_as_imageio(data, f"{sampling} q{quality} {h}x{w}")


CASES = {
    "restart_every_block": lambda rng, h, w: _pillow_jpeg(_pattern(rng, h, w), quality=90, restart_marker_blocks=1),
    "restart_every_5_blocks_444": lambda rng, h, w: _pillow_jpeg(_pattern(rng, h, w), quality=90,
                                                                 restart_marker_blocks=5, subsampling=0),
    "restart_every_row": lambda rng, h, w: _pillow_jpeg(_pattern(rng, h, w), quality=80, restart_marker_rows=1),
    "restart_440_opencv": lambda rng, h, w: _cv2_jpeg(_pattern(rng, h, w), "440", 90, restart=2),
    "grey": lambda rng, h, w: _pillow_jpeg(_pattern(rng, h, w, 1), quality=90),
    "grey_restart": lambda rng, h, w: _pillow_jpeg(_pattern(rng, h, w, 1), quality=70, restart_marker_blocks=2),
    "rgb_adobe_transform_0": lambda rng, h, w: _pillow_jpeg(_pattern(rng, h, w), quality=95, keep_rgb=True),
    "sampling_411_opencv": lambda rng, h, w: _cv2_jpeg(_pattern(rng, h, w), "411", 85),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_restart_grey_and_rgb(case):
    rng = np.random.RandomState(len(case))
    for h, w in SIZES:
        _same_as_imageio(CASES[case](rng, h, w), f"{case} {h}x{w}")


def test_exif_orientation_is_not_applied(tmp_path):
    """imageio.v2 returns the stored pixels of a file tagged to be rotated; so does the port."""
    exif = Image.Exif()
    exif[0x0112] = 6
    img = _pattern(np.random.RandomState(3), 21, 34)
    path = str(tmp_path / "rotated.jpg")
    Image.fromarray(img).save(path, "JPEG", quality=95, exif=exif.tobytes())
    got = imread(path)
    assert got.shape == (21, 34, 3)
    assert np.array_equal(got, np.asarray(imageio.imread(path)))


# --- the committed fixtures -------------------------------------------------------------


@pytest.mark.parametrize("rel", sorted(MANIFEST["files"]))
def test_fixture_matches_manifest(rel, monkeypatch):
    """imageio's hash in the manifest, through the port with the codecs hidden
    (the refused file raises naming itself and the reason)."""
    hide_codecs(monkeypatch)
    path = os.path.join(FIXTURES, rel)
    want = MANIFEST["files"][rel]
    if rel in MANIFEST["refused"]:
        with pytest.raises(ValueError, match=MANIFEST["refused"][rel]) as e:
            imread(path)
        assert path in str(e.value)
        return
    got = imread(path)
    assert list(got.shape) == want["shape"] and str(got.dtype) == want["dtype"]
    assert _digest(got) == want["sha256"]


def test_manifest_hashes_are_imageios():
    """The manifest is what the installed imageio reads from the files."""
    for rel, want in MANIFEST["files"].items():
        assert _digest(np.asarray(imageio.imread(os.path.join(FIXTURES, rel)))) == want["sha256"], rel


@pytest.mark.parametrize("capture", ["zju", "genebody", "llff"])
def test_committed_captures_load_like_jax(capture, tmp_path, monkeypatch):
    """The capture directories that ``chip_smoke.py`` builds around the
    committed photos load, without the codecs, to the JAX loaders' hashes."""
    from xrnerf_torch.datasets.load.llff import load_llff_data

    hide_codecs(monkeypatch)
    root = str(tmp_path / capture)
    want = MANIFEST["captures"][capture]
    if capture == "zju":
        chip_smoke.zju_capture(root, os.path.join(FIXTURES, "zju"))
        cfg = load_config(os.path.join(ROOT, "configs", "neuralbody", "nb_zjumocap.py"), dataname="313")
        ds = build_dataset(dict(cfg["data"], datadir=root))
        got = {"imgs": ds.imgs, "masks": ds.masks}
    elif capture == "genebody":
        chip_smoke.genebody_capture(root, os.path.join(FIXTURES, "genebody"))
        cfg = load_config(os.path.join(ROOT, "configs", "gnr", "gnr_genebody.py"), dataname=chip_smoke.CAPTURE_SUBJECT)
        ds = build_dataset(dict(cfg["data"], datadir=root, input_views=chip_smoke.CAPTURE_GENEBODY_VIEWS))
        got = {"imgs": ds.imgs, "masks": ds.masks, "Ks": ds.Ks}
    else:
        chip_smoke.llff_capture(root, os.path.join(FIXTURES, "llff"))
        got = {"images": load_llff_data(root)[0]}
    for k, arr in got.items():
        arr = np.ascontiguousarray(arr)
        assert [list(arr.shape), str(arr.dtype), _digest(arr)] == [want[k]["shape"], want[k]["dtype"],
                                                                    want[k]["sha256"]], (capture, k)


# --- refusals and failures --------------------------------------------------------------


def _baseline():
    return _pillow_jpeg(_pattern(np.random.RandomState(5), 19, 23), quality=90)


def _patch_sof(data, marker=None, precision=None):
    i = data.index(b"\xff\xc0")
    data = bytearray(data)
    if marker is not None:
        data[i + 1] = marker
    if precision is not None:
        data[i + 4] = precision
    return bytes(data)


REFUSALS = {
    "progressive": (lambda: _pillow_jpeg(_pattern(np.random.RandomState(6), 19, 23), progressive=True), "progressive"),
    "arithmetic": (lambda: _patch_sof(_baseline(), marker=0xC9), "arithmetic-coded"),
    "lossless": (lambda: _patch_sof(_baseline(), marker=0xC3), "lossless"),
    "hierarchical": (lambda: _patch_sof(_baseline(), marker=0xC5), "hierarchical"),
    "twelve_bit": (lambda: _patch_sof(_baseline(), precision=12), "12-bit samples"),
    "cmyk": (lambda: _pillow_jpeg(_pattern(np.random.RandomState(7), 19, 23), mode="CMYK", quality=90),
             "CMYK or YCCK"),
    "truncated_scan": (lambda: _baseline()[:-60], "truncated"),
    "truncated_header": (lambda: _baseline()[:100], "truncated"),
    "no_huffman_table": (lambda: _baseline().replace(b"\xff\xc4", b"\xff\xfe", 1), "no DC Huffman table 0"),
}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_refusals_name_the_file_and_the_reason(kind, tmp_path, monkeypatch):
    make, reason = REFUSALS[kind]
    path = str(tmp_path / f"{kind}.jpg")
    with open(path, "wb") as f:
        f.write(make())
    hide_codecs(monkeypatch)
    with pytest.raises(ValueError, match=reason) as e:
        imread(path)
    assert path in str(e.value)


def test_decoder_build_failure_names_gxx_and_the_build_dir(monkeypatch, tmp_path):
    from xrnerf_torch import native

    monkeypatch.setattr(native, "_jpeg_lib", None)
    monkeypatch.setattr(native, "jpeg_lib_path", lambda: tmp_path / "libjpeg_decode-missing.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"reading a JPEG builds jpeg_decode.cpp.*g\+\+ on PATH and a writable .*_build"):
        native.load_jpeg_decoder()


def test_imread_goes_by_content_not_name(tmp_path, monkeypatch):
    """A JPEG named .png and a PNG named .jpg are read as what they hold."""
    img = _pattern(np.random.RandomState(8), 12, 17)
    jpg = _pillow_jpeg(img, quality=90)
    with open(tmp_path / "photo.png", "wb") as f:
        f.write(jpg)
    imwrite_png(str(tmp_path / "image.jpg"), img)
    want = np.asarray(imageio.imread(io.BytesIO(jpg), format="JPEG"))
    hide_codecs(monkeypatch)
    assert np.array_equal(imread(str(tmp_path / "photo.png")), want)
    assert np.array_equal(imread_jpeg(str(tmp_path / "photo.png")), want)
    assert np.array_equal(imread(str(tmp_path / "image.jpg")), img)


# --- Pillow's resizes in numpy -----------------------------------------------------------


def _with_alpha(rng, h, w, colours):
    """Random colours under an alpha that is 0 or 255 in places (the
    unpremultiply's two pass-through values) and anything between elsewhere."""
    alpha = rng.randint(0, 256, (h, w, 1))
    alpha[rng.rand(h, w) < 0.2] = 0
    alpha[rng.rand(h, w) < 0.2] = 255
    return np.concatenate([rng.randint(0, 256, (h, w, colours)), alpha], -1).astype(np.uint8)


RESIZES = {  # (filter, image maker, dtype of the Pillow mode)
    "bicubic_rgb": ("bicubic", lambda rng, h, w: rng.randint(0, 256, (h, w, 3)).astype(np.uint8)),
    "bicubic_l": ("bicubic", lambda rng, h, w: rng.randint(0, 256, (h, w)).astype(np.uint8)),
    "bicubic_rgba": ("bicubic", lambda rng, h, w: _with_alpha(rng, h, w, 3)),
    "bicubic_la": ("bicubic", lambda rng, h, w: _with_alpha(rng, h, w, 1)),
    "nearest_l": ("nearest", lambda rng, h, w: (255 * (rng.rand(h, w) > 0.5)).astype(np.uint8)),
    "nearest_f": ("nearest", lambda rng, h, w: rng.rand(h, w).astype(np.float32) * 3.7),
}


@pytest.mark.parametrize("direction", ["down", "up"])
@pytest.mark.parametrize("kind", sorted(RESIZES))
def test_resize_matches_pillow(kind, direction, monkeypatch):
    """Random crop boxes of a seeded image resized to a square ``load_size``
    (down: crops larger than it, as GeneBody's photos give; up: smaller, as a
    small mask gives), and non-square sizes, against ``Image.resize``."""
    filt, make = RESIZES[kind]
    rng = np.random.RandomState(len(kind) + (direction == "up"))
    img = make(rng, 181, 203)
    cases = []
    for _ in range(12):
        side = rng.randint(70, 181) if direction == "down" else rng.randint(5, 40)
        t, l = rng.randint(0, 181 - side + 1), rng.randint(0, 203 - side + 1)
        size = (64, 64) if rng.rand() < 0.5 else tuple(int(v) for v in rng.randint(1, 64 if direction == "down" else 120, 2))
        crop = np.ascontiguousarray(img[t:t + side, l:l + side + rng.randint(0, 3)])
        resample = Image.BICUBIC if filt == "bicubic" else Image.NEAREST
        cases.append((crop, size, np.asarray(Image.fromarray(crop).resize(size, resample))))
    hide_codecs(monkeypatch)
    fn = resize_bicubic if filt == "bicubic" else resize_nearest
    for crop, size, want in cases:
        got = fn(crop, size)
        assert got.dtype == want.dtype and got.shape == want.shape, (kind, crop.shape, size)
        assert np.array_equal(got, want), (kind, crop.shape, size)


def test_resize_bicubic_refuses_what_pillow_has_no_mode_for():
    with pytest.raises(ValueError, match="uint8"):
        resize_bicubic(np.zeros((8, 8, 5), np.uint8), (4, 4))
    with pytest.raises(ValueError, match="uint8"):
        resize_bicubic(np.zeros((8, 8), np.float32), (4, 4))


def test_imwrite_png_writes_sixteen_bit_depth(tmp_path):
    """``smpl_depth`` maps (uint16 millimetres) round-trip through imageio and the port."""
    depth = np.random.RandomState(9).randint(0, 65536, (13, 21)).astype(np.uint16)
    path = str(tmp_path / "depth.png")
    imwrite_png(path, depth)
    assert np.array_equal(np.asarray(imageio.imread(path)), depth)
    assert np.array_equal(imread(path), depth)


# --- each loader that reads JPEG photos, against the JAX package's -----------------------


def _to_jpeg(paths, quality=92):
    """Re-encode image files as JPEGs beside them (``.jpg``); the originals are removed."""
    out = []
    for p in paths:
        img = np.asarray(imageio.imread(p))[..., :3]
        q = os.path.splitext(p)[0] + ".jpg"
        Image.fromarray(img).save(q, "JPEG", quality=quality)
        os.remove(p)
        out.append(q)
    return out


def _zju_jpeg(root, arrays, ani):
    from test_torch_neuralbody import write_zju

    write_zju(root, arrays, ani=ani)
    annots = np.load(os.path.join(root, "annots.npy"), allow_pickle=True).item()
    for frame in annots["ims"]:
        _to_jpeg([os.path.join(root, p) for p in frame["ims"]])
        frame["ims"] = [p.replace(".png", ".jpg") for p in frame["ims"]]
    np.save(os.path.join(root, "annots.npy"), np.array(annots, dtype=object))


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want), what


def _llff(root):
    rng = np.random.RandomState(11)
    os.makedirs(os.path.join(root, "photos", "images"))
    for i in range(chip_smoke.CAPTURE_LLFF["n_images"]):
        Image.fromarray(_pattern(rng, 45, 67)).save(os.path.join(root, "photos", "images", f"img_{i:03d}.jpg"),
                                                    "JPEG", quality=95)
    chip_smoke.llff_capture(os.path.join(root, "scene"), os.path.join(root, "photos"))
    return os.path.join(root, "scene")


def _loader_case(kind, root):
    """(JAX result, port function) of one loader on a JPEG layout under ``root``."""
    rng = np.random.RandomState(len(kind))
    if kind == "llff_full_size":
        from xrnerf_tpu.datasets.load.llff import load_llff_data as jload
        from xrnerf_torch.datasets.load.llff import load_llff_data

        d = _llff(root)
        return jload(d), lambda: load_llff_data(d)
    if kind == "nsvf":
        from xrnerf_tpu.datasets.load.nsvf import load_nsvf_data as jload
        from xrnerf_torch.datasets.load.nsvf import load_nsvf_data

        os.makedirs(os.path.join(root, "rgb"))
        os.makedirs(os.path.join(root, "pose"))
        for split, count in ((0, 3), (1, 2), (2, 2)):
            for i in range(count):
                name = f"{split}_{i:04d}"
                Image.fromarray(_pattern(rng, 17, 19)).save(os.path.join(root, "rgb", name + ".jpg"), quality=90)
                pose = np.eye(4)
                pose[:3, 3] = [rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), 4.0]
                np.savetxt(os.path.join(root, "pose", name + ".txt"), pose)
        with open(os.path.join(root, "intrinsics.txt"), "w") as fh:
            fh.write("20.0 9.5 8.5 0\n0 0 0\n0 0 0\n")
        np.savetxt(os.path.join(root, "bbox.txt"), np.array([[-1, -1, -1, 1, 1, 1, 0.1]]))
        return jload(root), lambda: load_nsvf_data(root)
    if kind == "linemod":
        from xrnerf_tpu.datasets.load.linemod import load_linemod_data as jload
        from xrnerf_torch.datasets.load.linemod import load_linemod_data

        K = [[15.0, 0, 8.0], [0, 15.0, 8.0], [0, 0, 1.0]]
        for s, count in (("train", 3), ("val", 2), ("test", 2)):
            frames = []
            for i in range(count):
                rel = f"{s}_{i}.jpg"
                Image.fromarray(_pattern(rng, 16, 16)).save(os.path.join(root, rel), quality=90)
                pose = np.eye(4)
                pose[:3, 3] = [rng.uniform(-0.3, 0.3), 0.0, 4.0]
                frames.append({"file_path": rel, "transform_matrix": pose.tolist(), "intrinsic_matrix": K})
            with open(os.path.join(root, f"transforms_{s}.json"), "w") as fh:
                json.dump({"frames": frames, "near": 2.3, "far": 5.8}, fh)
        return jload(root), lambda: load_linemod_data(root)
    if kind == "google":
        from test_torch_bungee import write_google
        from xrnerf_tpu.datasets.load.google import load_google_data as jload
        from xrnerf_torch.datasets.load.google import load_google_data

        write_google(root, size=24)
        imgdir = os.path.join(root, "images")
        _to_jpeg([os.path.join(imgdir, f) for f in sorted(os.listdir(imgdir))])
        return jload(root, factor=2), lambda: load_google_data(root, factor=2)
    if kind in ("zju_neuralbody", "zju_aninerf"):
        from test_torch_aninerf import ani_arrays

        ani = kind == "zju_aninerf"
        arrays = ani_arrays(H=29, W=37)
        _zju_jpeg(root, arrays, ani)
        name = "AniNeRFDataset" if ani else "NeuralBodyDataset"
        module = __import__(f"xrnerf_tpu.datasets.{'aninerf' if ani else 'neuralbody'}", fromlist=[name])
        kw = dict(datadir=root, training_view=(0, 1), N_rand=64, mask_dir="mask_cihp")
        jds = getattr(module, name)(**kw)
        return ((jds.imgs, jds.masks),
                lambda: (lambda ds: (ds.imgs, ds.masks))(build_dataset(dict(type=name, **kw))))
    if kind in ("genebody", "genebody_rgba_png"):
        from test_torch_gnr import write_genebody
        from xrnerf_tpu.datasets.genebody import GeneBodyDataset as JDS
        from xrnerf_torch.datasets.load.synthetic import make_synthetic_genebody

        arrays = make_synthetic_genebody(n_frames=2, n_cams=5, H=72, W=80, radius=0.45)
        write_genebody(root, "subject", arrays)
        base = os.path.join(root, "subject", "image")
        photos = [os.path.join(base, c, f) for c in sorted(os.listdir(base)) for f in sorted(os.listdir(
            os.path.join(base, c)))]
        if kind == "genebody":
            _to_jpeg(photos)
        else:  # RGBA PNGs: Pillow premultiplies the alpha around its bicubic resize
            for p in photos:
                img = np.asarray(imageio.imread(p))[..., :3]
                alpha = rng.randint(0, 256, img.shape[:2] + (1,)).astype(np.uint8)
                alpha[rng.rand(*img.shape[:2]) < 0.3] = 255
                imageio.imwrite(p, np.concatenate([img, alpha], -1))
        kw = dict(datadir=root, subject="subject", input_views=(0, 1, 2, 3), load_size=48)
        jds = JDS(**kw)
        return ((jds.imgs, jds.masks, jds.Ks, jds.smpl_depth),
                lambda: (lambda ds: (ds.imgs, ds.masks, ds.Ks, ds.smpl_depth))(
                    build_dataset(dict(type="GeneBodyDataset", **kw))))
    raise KeyError(kind)


LOADERS = ["llff_full_size", "nsvf", "linemod", "google", "zju_neuralbody", "zju_aninerf", "genebody",
           "genebody_rgba_png"]


@pytest.mark.parametrize("kind", LOADERS)
def test_loaders_read_jpeg_like_jax(kind, tmp_path, monkeypatch):
    """The JAX loader (imageio, Pillow) on a JPEG layout (or GeneBody's
    photos as RGBA PNGs), then the port's with the codecs hidden: every array
    bit-equal."""
    root = str(tmp_path / kind)
    os.makedirs(root, exist_ok=True)
    want, port = _loader_case(kind, root)
    hide_codecs(monkeypatch)
    got = port()
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, (list, tuple)):
            for j, (gg, ww) in enumerate(zip(g, w)):
                _same(gg, ww, f"{kind} item {i}.{j}")
        elif w is None:
            assert g is None, f"{kind} item {i}"
        else:
            _same(g, w, f"{kind} item {i}")
