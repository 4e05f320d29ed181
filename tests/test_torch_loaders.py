"""The port's scene loaders and ``SceneDataset`` layouts, held against the JAX
package on the same files: ``area_resize`` against ``cv2.resize(INTER_AREA)``,
the blender half-res, the LLFF / NSVF / DeepVoxels / LINEMOD loaders on
small on-disk fixtures (built as ``tests/test_loaders.py`` builds them; the
LLFF fixture's images have sizes that 8 does not divide, so the
fractional-area resize runs), ``SceneDataset`` for every ``dataset_type``
(batches, eval items, intrinsics, near/far, bbox), and the CLI training
``configs/nerf/nerf_llff.py`` cut to a tiny network on the LLFF fixture.

Tolerances: ``uint8`` images and everything computed from the same float32
arithmetic on both sides are held exactly. Area means of float images are
summed in another order than OpenCV's: atol 1e-6 (values in [0, 1]). Pose
arithmetic (recentring, spherifying: ``np.linalg`` on both sides, but
float64 intermediates differ in order) rtol 1e-5 / atol 1e-6.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

cv2 = pytest.importorskip("cv2")

from xrnerf_torch import build_dataset, run_nerf  # noqa: E402
from xrnerf_torch.datasets.load.resize import area_resize  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_RTOL, POSE_ATOL = 1e-5, 1e-6


def _write_png(path, arr):
    import imageio.v2 as imageio

    imageio.imwrite(path, arr.astype(np.uint8))


def _same(got, want, what=""):
    """Exact for arrays, recursively for lists / tuples; scalars exact."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    elif want is None:
        assert got is None, what
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def _pose_close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=POSE_RTOL, atol=POSE_ATOL, err_msg=what)


# --- area_resize against cv2 ---

SIZES = [(24, 24, 12, 12), (800, 800, 100, 100), (40, 30, 10, 5), (37, 53, 12, 20), (52, 75, 6, 9),
         (17, 33, 5, 8), (31, 29, 15, 14), (10, 10, 3, 3)]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("channels", [None, 1, 3, 4], ids=["2d", "c1", "c3", "c4"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{a}x{b}->{c}x{d}" for a, b, c, d in SIZES])
def test_area_resize_matches_cv2(size, channels, dtype):
    """Divisible sizes take the box mean, the others the fractional-area
    taps; ``uint8`` results equal OpenCV's bit for bit (its rounding, ties
    up at exactly 2x, to even elsewhere), float ones to 1e-6."""
    h, w, H, W = size
    rng = np.random.RandomState(h * 1000 + w)
    shape = (h, w) if channels is None else (h, w, channels)
    img = rng.randint(0, 256, shape).astype(np.uint8) if dtype == "uint8" else rng.rand(*shape).astype(np.float32)
    want = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA).reshape((H, W) + shape[2:])
    got = area_resize(img, H, W)
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == "uint8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_area_resize_rounds_uint8_ties_as_cv2():
    """Constant blocks whose means end in exactly .5 (2x and 4x), and a
    non-integer factor whose exact means sit on .5."""
    img = np.zeros((8, 12, 3), np.uint8)
    img[::2] = 1  # every 2x2 block sums to 2: mean 0.5; 4x4 blocks to 8: 0.5
    img[1::4, :, 1] = 3
    for H, W in ((4, 6), (2, 3), (3, 5)):
        want = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(area_resize(img, H, W), want)


def test_area_resize_refuses_upscaling():
    with pytest.raises(ValueError):
        area_resize(np.zeros((4, 4), np.float32), 8, 4)


# --- blender half-res ---


def test_blender_half_res_matches_jax(synthetic_scene):
    from xrnerf_tpu.datasets.load.blender import load_blender_data as jload
    from xrnerf_torch.datasets.load.blender import load_blender_data

    got, want = load_blender_data(synthetic_scene, half_res=True, testskip=1), jload(synthetic_scene, half_res=True,
                                                                                      testskip=1)
    assert got[0].shape == want[0].shape == (8, 12, 12, 4)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    for g, w, k in zip(got[1:], want[1:], ("poses", "render_poses", "hwf", "i_split")):
        _same(g, w, k)


# --- fixtures: one directory per layout ---


@pytest.fixture(scope="module")
def llff_dir(tmp_path_factory):
    """10 images of 52x75 (8 divides neither side) and ``poses_bounds.npy``:
    cameras near z = 0 looking down -z, LLFF's [down, right, back] columns."""
    d = tmp_path_factory.mktemp("llff")
    os.makedirs(d / "images")
    rng = np.random.RandomState(4)
    rows = []
    for i in range(10):
        _write_png(d / "images" / f"img_{i:03d}.png", rng.randint(0, 256, (52, 75, 3)))
        a = rng.uniform(-0.1, 0.1, 3)  # small rotation about each axis
        cx, sx, cy, sy, cz, sz = np.cos(a[0]), np.sin(a[0]), np.cos(a[1]), np.sin(a[1]), np.cos(a[2]), np.sin(a[2])
        rot = (np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]) @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
               @ np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]))
        right, up, back = rot[:, 0], rot[:, 1], rot[:, 2]
        t = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.3, 0.3), rng.uniform(-0.1, 0.1)])
        pose = np.stack([-up, right, back, t, [52.0, 75.0, 60.0]], 1)  # [3, 5]
        rows.append(np.concatenate([pose.reshape(-1), [rng.uniform(1.5, 2.5), rng.uniform(6.0, 9.0)]]))
    np.save(d / "poses_bounds.npy", np.stack(rows).astype(np.float64))
    return str(d)


@pytest.fixture(scope="module")
def llff_dir_prebuilt(tmp_path_factory, llff_dir):
    """The same scene with a ready ``images_4`` directory, which the loader
    reads as it is."""
    import shutil

    d = tmp_path_factory.mktemp("llff_pre")
    shutil.copy(os.path.join(llff_dir, "poses_bounds.npy"), d / "poses_bounds.npy")
    os.makedirs(d / "images_4")
    rng = np.random.RandomState(5)
    for i in range(10):
        _write_png(d / "images_4" / f"img_{i:03d}.png", rng.randint(0, 256, (13, 18, 3)))
    return str(d)


@pytest.fixture(scope="module")
def nsvf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("nsvf")
    os.makedirs(d / "rgb")
    os.makedirs(d / "pose")
    rng = np.random.RandomState(0)
    for split, count in ((0, 3), (1, 3), (2, 2)):
        for i in range(count):
            name = f"{split}_{i:04d}"
            _write_png(d / "rgb" / f"{name}.png", rng.randint(0, 255, (16, 16, 4)))
            pose = np.eye(4)
            pose[:3, 3] = [rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), 4.0]
            np.savetxt(d / "pose" / f"{name}.txt", pose)
    with open(d / "intrinsics.txt", "w") as fh:
        fh.write("20.0 8.0 8.0 0\n0 0 0\n0 0 0\n")
    np.savetxt(d / "bbox.txt", np.array([[-1, -1, -1, 1, 1, 1, 0.1]]))
    return str(d)


@pytest.fixture(scope="module")
def nsvf_dir_full(tmp_path_factory, nsvf_dir):
    """The NSVF scene with the optional files: a 4x4 intrinsics matrix,
    ``near_and_far.txt``, ``background_color.txt`` and ``test_traj.txt``."""
    import shutil

    d = tmp_path_factory.mktemp("nsvf_full") / "scene"
    shutil.copytree(nsvf_dir, d)
    np.savetxt(d / "intrinsics.txt", np.array([[18.0, 0, 7.5, 0], [0, 18.0, 8.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    np.savetxt(d / "near_and_far.txt", np.array([[2.5, 5.5]]))
    np.savetxt(d / "background_color.txt", np.array([[1.0, 1.0, 1.0]]))
    traj = np.stack([np.eye(4)] * 3)
    traj[:, 2, 3] = [3.0, 3.5, 4.0]
    np.savetxt(d / "test_traj.txt", traj.reshape(-1, 4))
    return str(d)


@pytest.fixture(scope="module")
def dv_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("dv")
    rng = np.random.RandomState(1)
    for split, count in (("train", 3), ("validation", 2), ("test", 2)):
        base = d / split / "cube"
        os.makedirs(base / "rgb")
        os.makedirs(base / "pose")
        for i in range(count):
            _write_png(base / "rgb" / f"{i:04d}.png", rng.randint(0, 255, (8, 8, 3)))
            pose = np.eye(4)
            pose[:3, 3] = [rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), 3.0]
            with open(base / "pose" / f"{i:04d}.txt", "w") as fh:
                fh.write(" ".join(str(v) for v in pose.reshape(-1)))
        with open(base / "intrinsics.txt", "w") as fh:
            fh.write("10.0 4.0 4.0\n0 0 0\n1.0\n1.0\n8 8\n0\n")
    return str(d)


@pytest.fixture(scope="module")
def linemod_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    rng = np.random.RandomState(2)
    K = [[15.0, 0, 8.0], [0, 15.0, 8.0], [0, 0, 1.0]]
    for s, count in (("train", 3), ("val", 2), ("test", 2)):
        frames = []
        for i in range(count):
            rel = f"{s}_{i}.png"
            _write_png(d / rel, rng.randint(0, 255, (16, 16, 3)))
            pose = np.eye(4)
            pose[:3, 3] = [rng.uniform(-0.3, 0.3), 0.0, 4.0]
            frames.append({"file_path": os.path.join(str(d), rel), "transform_matrix": pose.tolist(),
                           "intrinsic_matrix": K})
        with open(d / f"transforms_{s}.json", "w") as fh:
            json.dump({"frames": frames, "near": 2.3, "far": 5.8}, fh)
    return str(d)


# --- the loaders against the JAX package's ---


@pytest.mark.parametrize("kw", [{}, {"factor": 4, "spherify": True}, {"path_zflat": True, "llffhold": 0},
                                {"factor": 1, "recenter": False, "bd_factor": None}],
                         ids=["default", "spherify", "zflat_holdout", "full_res"])
def test_load_llff_matches_jax(llff_dir, kw):
    from xrnerf_tpu.datasets.load.llff import load_llff_data as jload
    from xrnerf_torch.datasets.load.llff import load_llff_data

    imgs, poses, bds, render_poses, i_split = load_llff_data(llff_dir, **kw)
    jimgs, jposes, jbds, jrender, jsplit = jload(llff_dir, **kw)
    factor = kw.get("factor", 8)
    assert imgs.shape == jimgs.shape == (10, 52 // factor, 75 // factor, 3)
    _same(imgs, jimgs, "imgs")  # uint8 resized as cv2 rounds, then / 255 on both sides
    _pose_close(poses, jposes, "poses")
    _pose_close(bds, jbds, "bds")
    _pose_close(render_poses, jrender, "render_poses")
    _same(i_split, jsplit, "i_split")


def test_load_llff_reads_a_prebuilt_directory(llff_dir_prebuilt):
    from xrnerf_tpu.datasets.load.llff import load_llff_data as jload
    from xrnerf_torch.datasets.load.llff import load_llff_data

    got, want = load_llff_data(llff_dir_prebuilt, factor=4), jload(llff_dir_prebuilt, factor=4)
    assert got[0].shape == (10, 13, 18, 3)
    _same(got[0], want[0], "imgs")
    _pose_close(got[1], want[1], "poses")


@pytest.mark.parametrize("which", ["base", "full"])
def test_load_nsvf_matches_jax(nsvf_dir, nsvf_dir_full, which):
    from xrnerf_tpu.datasets.load.nsvf import load_nsvf_data as jload
    from xrnerf_torch.datasets.load.nsvf import load_nsvf_data

    d = nsvf_dir if which == "base" else nsvf_dir_full
    for skip in (1, 2):
        got, want = load_nsvf_data(d, testskip=skip), jload(d, testskip=skip)
        names = ("imgs", "poses", "K", "near", "far", "bbox", "bg", "render_poses", "i_split")
        for g, w, k in zip(got, want, names):
            _same(g, w, k)
    assert (got[6] is None) == (which == "base")


def test_load_deepvoxels_matches_jax(dv_dir):
    from xrnerf_tpu.datasets.load.deepvoxels import load_deepvoxels_data as jload
    from xrnerf_torch.datasets.load.deepvoxels import load_deepvoxels_data

    for kw in ({"testskip": 1}, {"testskip": 2, "side": 8}):
        got, want = load_deepvoxels_data(dv_dir, **kw), jload(dv_dir, **kw)
        for g, w, k in zip(got, want, ("imgs", "poses", "render_poses", "hwf", "cxcy", "i_split")):
            _same(g, w, k)


@pytest.mark.parametrize("half_res", [False, True])
def test_load_linemod_matches_jax(linemod_dir, half_res):
    from xrnerf_tpu.datasets.load.linemod import load_linemod_data as jload
    from xrnerf_torch.datasets.load.linemod import load_linemod_data

    got, want = load_linemod_data(linemod_dir, half_res=half_res), jload(linemod_dir, half_res=half_res)
    names = ("imgs", "poses", "render_poses", "hwf", "K", "i_split", "near", "far")
    for g, w, k in zip(got, want, names):
        _same(g, w, k)
    assert got[0].shape[1] == (8 if half_res else 16)


# --- SceneDataset, layout by layout ---


def _datasets(**kw):
    from xrnerf_tpu.datasets.scene import SceneDataset as JScene

    return build_dataset(dict(type="SceneDataset", **kw)), JScene(**kw)


IMAGE_KEYS = ("imgs", "alphas", "target", "alpha", "gt")


def _hold_dataset(ds, jds, steps=(0, 3, 1000), img_atol=0.0):
    """Everything a trainer or a hook reads of a scene dataset; image values
    within ``img_atol`` (0: exact), all else exact."""

    def same(got, want, what):
        if img_atol and any(what.endswith(k) or what.endswith(f"[{k}]") for k in IMAGE_KEYS) and want is not None:
            np.testing.assert_allclose(got, want, rtol=0, atol=img_atol, err_msg=what)
        else:
            _same(got, want, what)

    for k in ("H", "W", "near", "far", "N_rand"):
        assert getattr(ds, k) == getattr(jds, k), k
    assert ds.focal == pytest.approx(jds.focal, rel=1e-7)
    for k in ("K", "bbox", "imgs", "poses", "render_poses", "alphas", "i_train", "i_val", "i_test"):
        same(getattr(ds, k), getattr(jds, k), k)
    for step in steps:
        got, want = ds.train_batch(step), jds.train_batch(step)
        assert sorted(got) == sorted(want), step
        for k in want:
            same(got[k], want[k], f"train_batch({step})[{k}]")
    (rays, gt), (jrays, jgt) = ds.eval_item(int(ds.i_test[0])), jds.eval_item(int(jds.i_test[0]))
    same(gt, jgt, "gt")
    for k in jrays:
        same(rays[k], jrays[k], f"eval_item[{k}]")
    (rays, hw), (jrays, jhw) = ds.spiral_item(ds.render_poses[1]), jds.spiral_item(jds.render_poses[1])
    assert hw == jhw
    for k in jrays:
        same(rays[k], jrays[k], f"spiral_item[{k}]")


@pytest.mark.parametrize("kw", [
    dict(use_ndc=True, batching=True, white_bkgd=False, N_rand=64),
    dict(use_ndc=False, batching=False, white_bkgd=False, N_rand=32, with_radii=True),
    dict(use_ndc=True, batching=False, white_bkgd=False, N_rand=6, precrop_iters=2),  # a 2x4 crop of 6x9
], ids=["ndc_pooled", "metric_images", "ndc_images_precrop"])
def test_scene_dataset_llff_matches_jax(llff_dir, kw):
    ds, jds = _datasets(datadir=llff_dir, dataset_type="llff", **kw)
    assert ds.bbox is None and ds.alphas is None
    if kw["use_ndc"]:
        assert (ds.near, ds.far) == (0.0, 1.0)
    else:
        assert 0 < ds.near < ds.far
    _hold_dataset(ds, jds)
    if kw["batching"]:
        assert ds._pool["rays_o"].shape[0] == len(ds.i_train) * ds.H * ds.W
        z = ds.train_batch(5)["rays_o"][:, 2]
        assert bool(np.all(np.abs(z + 1.0) < 1e-4))  # NDC origins sit on the near plane, z = -1


@pytest.mark.parametrize("batching", [False, True])
def test_scene_dataset_nsvf_matches_jax(nsvf_dir_full, batching):
    ds, jds = _datasets(datadir=nsvf_dir_full, dataset_type="nsvf", N_rand=16, testskip=1, batching=batching)
    assert (ds.near, ds.far) == (2.5, 5.5) and ds.K[0, 2] == 7.5
    np.testing.assert_array_equal(ds.bbox[0], [-1, -1, -1])
    _hold_dataset(ds, jds)


def test_scene_dataset_deepvoxels_matches_jax(dv_dir):
    ds, jds = _datasets(datadir=dv_dir, dataset_type="deepvoxels", N_rand=8, testskip=1)
    assert ds.far - ds.near == pytest.approx(2.0)
    _hold_dataset(ds, jds)


@pytest.mark.parametrize("half_res", [False, True])
def test_scene_dataset_linemod_matches_jax(linemod_dir, half_res):
    ds, jds = _datasets(datadir=linemod_dir, dataset_type="LINEMOD", N_rand=8, testskip=1, half_res=half_res)
    assert (ds.near, ds.far) == (2.0, 6.0)
    _hold_dataset(ds, jds)


@pytest.mark.parametrize("half_res", [False, True])
def test_scene_dataset_blender_matches_jax(synthetic_scene, half_res):
    ds, jds = _datasets(datadir=synthetic_scene, N_rand=16, testskip=1, half_res=half_res, batching=half_res)
    assert ds.H == (12 if half_res else 24)
    # float area means at half res: another summation order than OpenCV's
    _hold_dataset(ds, jds, img_atol=1e-6 if half_res else 0.0)


def test_scene_dataset_refuses_unknown_layout(synthetic_scene):
    with pytest.raises(ValueError, match="unknown dataset_type"):
        build_dataset(dict(type="SceneDataset", datadir=synthetic_scene, dataset_type="colmap"))


# --- the CLI on configs/nerf/nerf_llff.py ---


def test_cli_trains_nerf_llff(llff_dir, tmp_path):
    """``configs/nerf/nerf_llff.py`` as written (NDC, pooled batches, density
    noise, its hooks), with the network narrowed and the data pointed at the
    fixture, trains on the CPU through ``run_nerf``, validates and writes
    its images; ``--test_only`` from its weights scores the test views."""
    src = open(os.path.join(ROOT, "configs", "nerf", "nerf_llff.py")).read()
    cfg = tmp_path / "llff_cfg.py"
    cfg.write_text(src + f"""
model.update(n_samples=8, n_importance=8, netdepth=2, netwidth=16, multires=4, multires_dirs=2)
data.update(datadir=r"{llff_dir}", N_rand=64)
eval_interval = 4
eval_chunk = 512
log_interval = 2
""")
    wd = tmp_path / "wd"
    tr = run_nerf.main(["--config", str(cfg), "--device", "cpu", "--max_iters", "4", "--work_dir", str(wd)])
    assert tr.step == 4 and tr.dataset.use_ndc and tr.dataset.batching
    assert np.isfinite(tr.last_logs["loss"]) and "psnr" in tr.eval_metrics
    assert os.path.exists(wd / "val_4" / "val_0.png")
    pt = tmp_path / "w.pt"
    torch.save(tr.network.state_dict(), pt)
    run_nerf.main(["--config", str(cfg), "--device", "cpu", "--test_only", "--load_from", str(pt),
                   "--work_dir", str(tmp_path / "test_only")])
    res = json.load(open(tmp_path / "test_only" / "test" / "test_results.json"))
    assert list(res["psnr"]) == ["0"] and np.isfinite(res["psnr"]["0"])
