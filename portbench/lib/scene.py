"""The training traffic's scene: blender's layout (``transforms_{train,val,
test}.json`` and 8-bit RGBA PNGs) of an analytic sphere, written once into
a cache directory at a fixed path inside the checkout and read by the port's
own loader. The scene depends on the traffic's parameters alone, never on a
run's seed, so every run of a cell after the first finds it written.

``read_png`` is the reference's reader of these files (filter-0 rows, as
``write_png`` writes them): the port and the reference read the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import zlib
from typing import Dict

import numpy as np

from . import rays

SIGNATURE = b"\x89PNG\r\n\x1a\n"
FORMAT = 1  # bump when the files written for the same parameters change


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def write_png(path: str, rgba: np.ndarray) -> None:
    """uint8 [H, W, 4] as one IDAT of filter-0 rows (zlib level 1)."""
    h, w, _ = rgba.shape
    raw = np.zeros((h, 1 + 4 * w), np.uint8)
    raw[:, 1:] = rgba.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """uint8 [H, W, 4] of a file that :func:`write_png` wrote."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        pos += 12 + length
    w, h, depth, colour = ihdr[:4]
    if (depth, colour) != (8, 6):
        raise ValueError(f"{path}: not an 8-bit RGBA PNG")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 4 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0")
    return raw[:, 1:].reshape(h, w, 4)


def scene_poses(scene: Dict) -> np.ndarray:
    """The training views' c2w [n, 4, 4]."""
    if scene["poses"] == "sphere":
        return rays.sphere_poses(scene["views"], scene["pose_seed"], scene["radius"])
    if scene["poses"] == "orbit":
        ring = rays.orbit(40, -30.0, scene["radius"])
        return ring[np.arange(scene["views"]) % len(ring)]
    raise ValueError(f"unknown poses {scene['poses']!r}")


def blender_scene(scene: Dict, cache_root: str) -> str:
    """The directory of the scene ``scene`` (the traffic's ``scene`` entry),
    written under ``cache_root`` if it is not there yet."""
    key = hashlib.sha256(json.dumps({"scene": scene, "format": FORMAT}, sort_keys=True).encode()).hexdigest()[:16]
    final = os.path.join(cache_root, "scenes", key)
    if os.path.isfile(os.path.join(final, "transforms_test.json")):
        return final
    part = final + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(part)
    H = W = int(scene["size"])
    focal = rays.focal_of(W, scene["camera_angle_x"])
    K = rays.intrinsics(H, W, focal)
    train = scene_poses(scene)
    held = rays.orbit(40, -30.0, scene["radius"])[:1]  # one val and one test view: the loader reads both splits
    for split, poses in (("train", train), ("val", held), ("test", held)):
        os.makedirs(os.path.join(part, split))
        frames = []
        for i, c2w in enumerate(poses):
            o, d = rays.image_rays(H, W, K, c2w)
            write_png(os.path.join(part, split, f"r_{i}.png"), rays.sphere_rgba(o, d).reshape(H, W, 4))
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(part, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": scene["camera_angle_x"], "frames": frames}, f)
    os.replace(part, final)
    return final
