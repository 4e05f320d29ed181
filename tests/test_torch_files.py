"""The port reads and writes the JAX package's files without ``msgpack``,
flax or ``imageio``: the flax msgpack codec against flax, a JAX
``Trainer``'s checkpoint loaded by the port's ``load_from`` into every
method family, PNGs against ``imageio``, a port-made scene, and the CLI
on PNG files from a ``.msgpack`` checkpoint with ``imageio`` hidden. Also
``LPIPS`` against the JAX package's."""

import json
import os
import struct
import sys
import warnings
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from flax import serialization  # noqa: E402

import xrnerf_tpu  # noqa: E402
import xrnerf_torch  # noqa: E402
from xrnerf_torch.core.trainer import Trainer  # noqa: E402
from xrnerf_torch.utils import flax_msgpack  # noqa: E402
from xrnerf_torch.utils.checkpoint import load_raw  # noqa: E402
from xrnerf_torch.utils.png import SIGNATURE, imread, imread_png, imwrite_png  # noqa: E402
from xrnerf_torch.utils.weights import (  # noqa: E402
    grid_state_from_jax,
    jax_params_from_state_dict,
    state_dict_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(type="adam", lr=1e-3)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits_equal(got, want, what=""):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), f"{what}: values differ"


# --- the msgpack codec against flax ---------------------------------------------


def _tree():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 4).astype(np.float32),
        "f16": rng.randn(5).astype(np.float16),
        "bf16": rng.randn(2, 3).astype(ml_dtypes.bfloat16),
        "bool": rng.rand(4) > 0.5,
        "i32": np.arange(-3, 3, dtype=np.int32),
        "i64": np.arange(40, dtype=np.int64).reshape(2, 4, 5),
        "u8": np.arange(300).astype(np.uint8),
        "c64": (rng.randn(3) + 1j * rng.randn(3)).astype(np.complex64),
        "empty": np.zeros((0, 3), np.float32),
        "scalars": {"f32": np.float32(1.5), "i64": np.int64(-7), "bool": np.bool_(True), "f64": np.float64(0.25),
                    "bf16": np.asarray(2.5, ml_dtypes.bfloat16)[()], "c64": np.complex64(1 - 1j)},
        "py": {"complex": 1 + 2j, "float": 0.1, "none": None, "true": True, "false": False, "str": "x" * 40,
               "long_str": "y" * 300, "bytes": b"\x00\x01", "ints": [0, 127, 128, 255, 256, -1, -32, -33, -128, -129,
                                                                     65535, 65536, -32768, -32769, 2**32 - 1, 2**32,
                                                                     -2**31, -2**31 - 1, 2**63, -2**63]},
        "nested": {"list": [np.zeros(()), {"k": 3, "a": 1}], "map16": {str(i): i for i in range(20)},
                   "array16": list(range(20)), "dict": {}},
    }


def _same_tree(got, want, path="/"):
    """``want`` from flax: ml_dtypes' bfloat16 leaves are compared widened to float32."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}{k}/")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}{i}/")
    elif isinstance(want, (np.ndarray, np.generic)):
        if want.dtype == ml_dtypes.bfloat16:
            assert got.dtype == np.float32, path
            want = np.asarray(want).astype(np.float32)
        else:
            assert type(got) is type(want), (path, type(got), type(want))
        _bits_equal(got, want, path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_unpackb_matches_msgpack_restore():
    data = serialization.msgpack_serialize(_tree())
    _same_tree(flax_msgpack.unpackb(data), serialization.msgpack_restore(data))


def test_packb_writes_msgpack_serialize_bytes():
    tree = _tree()
    assert flax_msgpack.packb(tree) == serialization.msgpack_serialize(tree)


def test_chunked_arrays_match_flax(monkeypatch):
    """Arrays over flax's chunk limit (made small here) are written and
    joined back as flax writes and joins them, in maps and at the top."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 40)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 40)
    rng = np.random.RandomState(1)
    for tree in ({"w": rng.randn(5, 7).astype(np.float32), "n": {"v": np.arange(30, dtype=np.int64)},
                  "small": np.ones(3, np.float32), "bf": rng.randn(33).astype(ml_dtypes.bfloat16)},
                 rng.randn(30).astype(np.float32)):
        data = serialization.msgpack_serialize(tree)
        assert b"__msgpack_chunked_array__" in data
        assert flax_msgpack.packb(tree) == data
        _same_tree({"t": flax_msgpack.unpackb(data)}, {"t": serialization.msgpack_restore(data)})


def test_unknown_dtype_and_bad_data_raise():
    data = serialization.msgpack_serialize({"a": np.zeros(3, np.float16)})
    with pytest.raises(ValueError, match="floatXY"):
        flax_msgpack.unpackb(data.replace(b"float16", b"floatXY"))
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpackb(data[:-3])
    with pytest.raises(ValueError, match="extra data"):
        flax_msgpack.unpackb(data + b"\xc0")
    with pytest.raises(TypeError, match="tuple"):
        flax_msgpack.packb({"a": (1, 2)})


def test_file_paths_import_no_codec_package(tmp_path):
    """Writing and reading a PNG and a ``.msgpack`` file through the port
    leaves ``msgpack``, flax, JAX, ``imageio`` and Pillow out of ``sys.modules``."""
    import subprocess

    code = (
        "import sys, numpy as np\n"
        "from xrnerf_torch.utils import flax_msgpack\n"
        "from xrnerf_torch.utils.checkpoint import load_raw\n"
        "from xrnerf_torch.utils.png import imread_png, imwrite_png\n"
        f"p = {str(tmp_path)!r}\n"
        "imwrite_png(p + '/a.png', np.zeros((4, 5, 3), np.uint8))\n"
        "assert imread_png(p + '/a.png').shape == (4, 5, 3)\n"
        "open(p + '/c.msgpack', 'wb').write(flax_msgpack.packb({'params': {'w': np.ones(3, np.float32)}}))\n"
        "assert load_raw(p + '/c.msgpack')['params']['w'].sum() == 3\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('msgpack', 'flax', 'jax', 'imageio', 'PIL')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# --- JAX checkpoints into every family ---------------------------------------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A blender-layout sphere scene written by the port's maker."""
    from xrnerf_torch.datasets.load.synthetic import make_synthetic_blender

    return make_synthetic_blender(str(tmp_path_factory.mktemp("files") / "sphere"), n_train=4, n_val=2, n_test=2,
                                  H=24, W=24)


def _occupancy(tmp_path):
    occ = np.zeros((16, 16, 16), bool)
    occ[4:12, 4:12, 4:12] = True
    np.save(tmp_path / "occupancy.npy", occ)
    return str(tmp_path / "occupancy.npy")


NERF_KW = dict(n_samples=8, n_importance=8, netdepth=8, netwidth=32, multires=4, multires_dirs=2)
NGP_KW = dict(n_levels=4, n_features=2, log2_table_size=10, base_res=4, max_res=32, hidden_dim=64, geo_feat_dim=15,
              n_cascades=1, grid_res=16, n_candidates=64, n_keep=16, grid_update_samples=512)


def _family(name, scene, tmp_path):
    """(model cfg, data cfg of each package) of a family at the tests' small sizes."""
    from xrnerf_torch.datasets.load.synthetic import make_synthetic_genebody, make_synthetic_zju

    blender = dict(datadir=scene, testskip=1)
    if name.startswith("nerf"):
        return dict(type="NerfNetwork", fused=name == "nerf_fused", **NERF_KW), dict(
            type="SceneDataset", N_rand=32, **blender)
    if name.startswith("ngp"):
        layout = dict(hash_layout="brick", n_lattices=2) if name == "ngp_brick" else {}
        return dict(type="HashNerfNetwork", **NGP_KW, **layout), dict(type="HashNerfDataset", N_rand=32, **blender)
    if name == "mipnerf":
        return dict(type="MipNerfNetwork", num_levels=2, n_samples=8, netdepth=2, netwidth=16), dict(
            type="MipMultiScaleDataset", n_scales=2, N_rand=32, white_bkgd=True, **blender)
    if name == "kilonerf":
        return dict(type="KiloNerfNetwork", resolution=(4, 4, 4), domain_min=(-0.7,) * 3, domain_max=(0.7,) * 3,
                    hidden=16, multires=4, multires_dirs=2, n_samples=32, n_keep=12, march="pooled", march_group=8,
                    march_groups_keep=4, occupancy_path=_occupancy(tmp_path)), dict(
            type="KiloNerfDataset", N_rand=32, **blender)
    if name == "kilonerf_student":
        return dict(type="StudentNerfNetwork", resolution=(2, 2, 2), hidden=16, multires=4, multires_dirs=0,
                    capacity_factor=8.0), dict(type="KiloNerfDistillDataset", resolution=(2, 2, 2),
                                               points_per_net=16)
    if name == "bungee":
        return dict(type="BungeeNerfNetwork", n_stages=3, n_samples=8, netwidth=32, max_deg_point=6), dict(
            type="BungeeDataset", n_stages=3, N_rand=32, datadir=scene)
    if name == "neuralbody":
        return dict(type="NeuralBodyNetwork", n_verts=200, code_dim=4, grid_dims=(16, 16, 16), conv_widths=(8, 8, 8),
                    num_frames=4, appearance_dim=8, hidden=32, n_samples=8), dict(
            type="NeuralBodyDataset", arrays=make_synthetic_zju(n_frames=2, n_cams=4, H=24, W=24, n_verts=200),
            N_rand=32, training_view=(0, 1, 2))
    if name.startswith("aninerf"):
        arr = make_synthetic_zju(n_frames=2, n_cams=3, H=20, W=20, n_verts=100)
        arr["joints"] = np.array([[0.0, 0.0, 0.0], [0.15, 0.0, 0.0], [0.0, 0.15, 0.05]], np.float32)
        arr["parents"] = np.array([-1, 0, 1])
        w = np.exp(-np.linalg.norm(arr["verts"][0][:, None] - arr["joints"][None], axis=-1) / 0.1)
        arr["weights"] = (w / w.sum(-1, keepdims=True)).astype(np.float32)
        arr["poses"] = (0.3 * np.random.RandomState(3).randn(2, 3, 3)).astype(np.float32)
        return dict(type="AniNeRFNetwork", n_joints=3, num_frames=4, n_samples=8, hidden=32, smpl_dist_threshold=0.2,
                    phase=name.split("_", 1)[1]), dict(type="AniNeRFDataset", arrays=arr, N_rand=16,
                                                       training_view=(0, 1))
    assert name == "gnr"
    return dict(type="GnrNetwork", num_views=4, n_samples=8, load_size=32, num_stack=1, num_hourglass=1,
                hourglass_dim=8, mlp_depth=3, mlp_width=16, skips=(1,), mesh_chunk=128), dict(
        type="GeneBodyDataset", arrays=make_synthetic_genebody(n_frames=2, n_cams=6, H=32, W=32), N_rand=16,
        num_views=4, input_views=(0, 1, 2, 3))


def _jax_trainer(model, data, work_dir, **kw):
    from xrnerf_tpu.core.trainer import Trainer as JTrainer

    if data["type"] == "KiloNerfDistillDataset":
        data = dict(data, teacher_fn=lambda p, d: (0.5 + 0.5 * jnp.tanh(p), jnp.exp(-jnp.sum(p**2, -1))))
    net = xrnerf_tpu.build_network(model)
    object.__setattr__(net, "init", jax.jit(net.init, static_argnames="train"))  # the trainer's init, compiled
    return JTrainer(net, xrnerf_tpu.build_dataset(data), optimizer=OPT, work_dir=str(work_dir), max_iters=1,
                    ckpt_interval=0, log_interval=1, **kw)


def _port_trainer(model, data, work_dir, **kw):
    if data["type"] == "KiloNerfDistillDataset":
        data = dict(data, device="cpu",
                    teacher_fn=lambda p, d: (0.5 + 0.5 * torch.tanh(p), torch.exp(-torch.sum(p**2, -1))))
    return Trainer(xrnerf_torch.build_network(model, device="cpu"), xrnerf_torch.build_dataset(data), optimizer=OPT,
                   work_dir=str(work_dir), max_iters=1, ckpt_interval=0, log_interval=1, device="cpu", **kw)


def _jax_checkpoint(jtr, work_dir, aux=None):
    """The JAX trainer's own checkpoint file (state with optax's, and aux)."""
    from xrnerf_tpu.utils import checkpoint as jckpt

    return jckpt.save(str(work_dir), 7, {"state": jtr.state, "aux": jtr.aux if aux is None else aux})


def _params_np(tree):
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))


FAMILIES = ["nerf", "nerf_fused", "ngp", "ngp_brick", "mipnerf", "kilonerf", "kilonerf_student", "bungee",
            "neuralbody", "gnr"]


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_checkpoint_loads_into_every_family(family, scene, tmp_path):
    """A checkpoint the JAX trainer writes (optax state and aux included)
    gives the port's ``Trainer(load_from=...)`` every parameter bit for bit;
    its aux stays what ``init_aux`` made (a changed grid in the file is not
    read), as in the JAX trainer."""
    model, data = _family(family, scene, tmp_path)
    jtr = _jax_trainer(model, data, tmp_path / "jax")
    aux = None
    if family.startswith("ngp"):  # a grid the load must not take
        aux = type(jtr.aux)(jnp.full_like(jtr.aux.density, 0.5), jnp.zeros_like(jtr.aux.bitfield))
    elif family == "kilonerf":
        aux = ~np.asarray(jtr.aux)
    path = _jax_checkpoint(jtr, tmp_path / "jax", aux)
    raw = load_raw(path)
    assert set(raw) == {"state", "aux"} and "opt_state" in raw["state"]
    tr = _port_trainer(model, data, tmp_path / "torch", load_from=path)
    want = _params_np(jtr.state.params)
    got = dict(tr.network.named_parameters())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        _bits_equal(got[k], v, k)
    if family.startswith("ngp"):
        for k, v in grid_state_from_jax(jtr.aux).items():
            _bits_equal(tr.network.state_dict()[k], v, k)
    elif family == "kilonerf":
        _bits_equal(tr.network.occupancy, np.asarray(jtr.aux), "occupancy")


def test_aninerf_novel_pose_from_a_jax_train_pose_checkpoint(scene, tmp_path):
    """AniNeRF's ``novel_pose`` phase reads the ``train_pose`` checkpoint: from
    the JAX trainer's file the port holds what the JAX trainer holds after
    its own ``load_from`` of it, bit for bit."""
    model, data = _family("aninerf_train_pose", scene, tmp_path)
    path = _jax_checkpoint(_jax_trainer(model, data, tmp_path / "tp"), tmp_path / "tp")
    novel = dict(model, phase="novel_pose")
    jload = _jax_trainer(novel, data, tmp_path / "np_jax", load_from=path)
    tr = _port_trainer(novel, data, tmp_path / "np", load_from=path)
    want = _params_np(jload.state.params)
    assert sorted(dict(tr.network.named_parameters())) == sorted(want)
    for k, p in tr.network.named_parameters():
        _bits_equal(p, want[k], k)


def test_msgpack_under_a_model_axis_loads_this_ranks_slice(scene, tmp_path):
    """Under a mesh the file's parameters go through ``local_state`` as a
    ``.pt`` file's do: model rank 1 of 2 holds the second half of the hash
    table's buckets, every other parameter whole."""
    from types import SimpleNamespace

    from xrnerf_torch.parallel import mesh as pm
    from xrnerf_torch.utils.checkpoint import load_weights

    model, _ = _family("ngp", scene, tmp_path)
    full = xrnerf_torch.build_network(model, device="cpu")
    full.reset_parameters(torch.Generator().manual_seed(3))
    sd = {k: v.detach().numpy() for k, v in full.named_parameters()}
    path = str(tmp_path / "ngp.msgpack")
    with open(path, "wb") as f:
        f.write(flax_msgpack.packb({"params": jax_params_from_state_dict(sd)}))
    mesh = SimpleNamespace(model_size=2, model_rank=1)
    net = xrnerf_torch.build_network(model, device="cpu")
    dims = pm.shard_module(net, mesh)
    assert dims == {"field.encoding.table": 1}
    load_weights(net, path, dims, mesh)
    for k, p in net.named_parameters():
        want = sd[k][:, sd[k].shape[1] // 2:] if k in dims else sd[k]
        _bits_equal(p, np.ascontiguousarray(want), k)


def _close_fine(got, want, atol, what):
    """Fine outputs go through ``sample_pdf``, where last-ulp cdf differences
    move a sample along a bin near the 1e-5 floor
    (``tests/test_torch_nerf_render.py:_close_fine``): at most 5 % of values
    above ``atol``, none above 20x, the mean within it."""
    err = np.abs(_np(got) - np.asarray(want))
    assert err.max() <= 20 * atol and err.mean() <= atol, f"{what}: max {err.max()}, mean {err.mean()}"
    assert float((err > atol).mean()) <= 0.05, f"{what}: {float((err > atol).mean()):.1%} above {atol}"


@pytest.mark.parametrize("family,atol", [("nerf", 1e-4), ("nerf_fused", 8e-3), ("ngp", 8e-3)])
def test_outputs_from_the_file_match_jax_load_from(family, atol, scene, tmp_path):
    """The eval frame from the file in each trainer: the port's against the
    JAX trainer's ``load_from`` of the same file (f32: the fine-sample rule at
    1e-4; where a kernel's plain version runs, bf16: at the forward bar)."""
    model, data = _family(family, scene, tmp_path)
    path = _jax_checkpoint(_jax_trainer(model, data, tmp_path / "jax"), tmp_path / "jax")
    jload = _jax_trainer(model, data, tmp_path / "jload", load_from=path)
    tr = _port_trainer(model, data, tmp_path / "torch", load_from=path)
    rays, gt = tr.dataset.eval_item(int(tr.dataset.i_test[0]))
    got = tr.render_image(rays, gt.shape[0], gt.shape[1])
    want = jload.render_image(rays, gt.shape[0], gt.shape[1])
    for k in ("rgb", "acc"):
        if family == "ngp":  # no fine resampling: every value at the forward bar
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=2e-2, atol=atol, err_msg=k)
        else:
            _close_fine(got[k], want[k], atol, k)


def test_mismatched_tree_raises_as_flax_does(scene, tmp_path):
    """A parameter missing from the file raises in both trainers; the port
    also refuses a file with a parameter the network lacks (flax ignores
    it) and one with another shape."""
    model, data = _family("nerf", scene, tmp_path)
    params = jax.tree_util.tree_map(np.asarray, _jax_trainer(model, data, tmp_path / "jax").state.params)

    def write(tree, name):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(serialization.msgpack_serialize({"params": tree}))
        return path

    missing = jax.tree_util.tree_map(lambda x: x, params)
    del missing["mlp_fine"]["rgb"]
    path = write(missing, "missing.msgpack")
    with pytest.raises(ValueError, match="rgb"):
        _jax_trainer(model, data, tmp_path / "j2", load_from=path)
    with pytest.raises(ValueError, match="mlp_fine.rgb.bias"):
        _port_trainer(model, data, tmp_path / "t2", load_from=path)
    extra = dict(params, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="extra.weight"):
        _port_trainer(model, data, tmp_path / "t3", load_from=write(extra, "extra.msgpack"))
    reshaped = jax.tree_util.tree_map(lambda x: x, params)
    reshaped["mlp_fine"]["rgb"]["bias"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="shape"):
        _port_trainer(model, data, tmp_path / "t4", load_from=write(reshaped, "shape.msgpack"))
    with pytest.raises(ValueError, match="cannot be resumed"):
        _port_trainer(model, data, tmp_path / "t5", resume_from=str(tmp_path / "missing.msgpack"))


# --- PNG against imageio -------------------------------------------------------


def _pillow_file(path, kind):
    from PIL import Image

    rng = np.random.RandomState(2)
    shape = (9, 13)
    if kind in ("L", "LA", "RGB", "RGBA"):
        ch = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,)}[kind]
        Image.fromarray(rng.randint(0, 256, shape + ch).astype(np.uint8), kind).save(path)
    elif kind == "I;16":
        Image.fromarray(rng.randint(0, 65536, shape).astype(np.uint16)).save(path)
    else:  # palette: 8, 4, 2 and 1 bits; with tRNS as bytes or as one index
        bits = {"P": 8, "P_trns": 8, "P_trns_index": 8, "P4": 4, "P2": 2, "P1": 1}[kind]
        im = Image.fromarray(rng.randint(0, 2**bits, shape).astype(np.uint8), "P")
        im.putpalette(rng.randint(0, 256, 3 * 2**bits).astype(np.uint8).tolist())
        kw = {"P_trns": dict(transparency=bytes([10, 20, 30])), "P_trns_index": dict(transparency=1)}.get(kind, {})
        im.save(path, bits=bits, **kw)


@pytest.mark.parametrize("kind", ["L", "LA", "RGB", "RGBA", "I;16", "P", "P_trns", "P_trns_index", "P4", "P2", "P1"])
def test_imread_png_matches_imageio_on_pillow_files(kind, tmp_path):
    """Pillow's files: the same dtype, shape and values as imageio (a
    palette image comes back as its RGB colours, tRNS dropped, as imageio
    returns it through Pillow)."""
    import imageio.v2 as imageio

    path = str(tmp_path / "im.png")
    _pillow_file(path, kind)
    with warnings.catch_warnings():  # Pillow warns that it drops a palette's tRNS bytes
        warnings.simplefilter("ignore")
        want = np.asarray(imageio.imread(path))
    _bits_equal(imread_png(path), want, kind)


def _chunk(ctype, body):
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def _filter_rows(img, filters, bpp):
    """Each row of ``img`` (uint8 [H, stride]) filtered with its type, by the
    PNG spec's definitions (a plain loop)."""
    out = []
    prev = np.zeros(img.shape[1], np.int64)
    for row, ft in zip(img.astype(np.int64), filters):
        raw = np.empty_like(row)
        for x in range(len(row)):
            a = row[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            raw[x] = (row[x] - pred) % 256
        out.append(bytes([ft]) + raw.astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _png_bytes(img, color, filters, depth=8, interlace=0, n_idat=3):
    """A PNG built chunk by chunk: the rows filtered as given, the zlib
    stream split over several IDAT chunks."""
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    if depth == 16:
        rows = img.astype(">u2").reshape(h, -1).view(np.uint8)
    bpp = max(1, rows.shape[1] // w)
    stream = zlib.compress(_filter_rows(rows, filters, bpp), 9)
    cut = np.linspace(0, len(stream), n_idat + 1).astype(int)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + b"".join(_chunk(b"IDAT", stream[a:b]) for a, b in zip(cut[:-1], cut[1:])) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("color,channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_each_filter_type_matches_imageio(ftype, color, channels, tmp_path):
    """Every row filtered with one type (or the five in turn), including
    Paeth at the first row and column; the file equals the source image
    and imageio's reading of it."""
    import imageio.v2 as imageio

    rng = np.random.RandomState(color * 10 + (5 if ftype == "mixed" else ftype))
    img = rng.randint(0, 256, (7, 11, channels) if channels > 1 else (7, 11)).astype(np.uint8)
    img[3] = img[2]  # runs, where Up and Paeth predict exactly
    filters = [i % 5 for i in range(7)] if ftype == "mixed" else [ftype] * 7
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(img, color, filters))
    _bits_equal(imread_png(path), img, "source")
    _bits_equal(imread_png(path), np.asarray(imageio.imread(path)), "imageio")


def test_sixteen_bit_grey_with_filters(tmp_path):
    import imageio.v2 as imageio

    img = np.random.RandomState(9).randint(0, 65536, (6, 5)).astype(np.uint16)
    path = str(tmp_path / "g16.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(img, 0, [4, 3, 1, 2, 0, 4], depth=16))
    _bits_equal(imread_png(path), img, "source")
    _bits_equal(imread_png(path), np.asarray(imageio.imread(path)), "imageio")


def test_bad_files_raise_naming_the_file(tmp_path):
    img = np.random.RandomState(3).randint(0, 256, (4, 5, 3)).astype(np.uint8)
    good = _png_bytes(img, 2, [1] * 4)
    cases = {
        "crc": (good[:-8] + bytes([good[-8] ^ 1]) + good[-7:], "CRC mismatch"),  # a byte of IEND's CRC
        "interlaced": (_png_bytes(img, 2, [0] * 4, interlace=1), "interlaced"),
        "grey4": (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 4, 0, 0, 0, 0))
                  + _chunk(b"IDAT", zlib.compress(bytes(12))) + _chunk(b"IEND", b""), "bit depth 4"),
        "rgb16": (_png_bytes(img.astype(np.uint16), 2, [0] * 4, depth=16), "16-bit colour"),
        "filter": (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 4, 8, 2, 0, 0, 0))
                   + _chunk(b"IDAT", zlib.compress(b"".join(bytes([7]) + r.tobytes() for r in img)))
                   + _chunk(b"IEND", b""), "filter type 7"),
        "signature": (b"GIF89a" + good[6:], "not a PNG"),
        "zlib": (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 4, 8, 2, 0, 0, 0))
                 + _chunk(b"IDAT", b"not a zlib stream") + _chunk(b"IEND", b""), "corrupt image data"),
    }
    for name, (data, msg) in cases.items():
        path = str(tmp_path / f"{name}.png")
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError, match=msg) as e:
            imread_png(path)
        assert path in str(e.value), name


@pytest.mark.parametrize("shape", [(6, 9), (6, 9, 3), (6, 9, 4)])
def test_imwrite_png_round_trips_through_imageio(shape, tmp_path):
    import imageio.v2 as imageio

    img = np.random.RandomState(4).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "w.png")
    imwrite_png(path, img)
    _bits_equal(np.asarray(imageio.imread(path)), img, "imageio")
    _bits_equal(imread_png(path), img, "imread_png")
    with pytest.raises(ValueError, match="uint8"):
        imwrite_png(path, img.astype(np.float32))


def test_imread_needs_imageio_only_for_other_formats(monkeypatch, tmp_path):
    """PNG and JPEG files read without imageio; another format (a BMP)
    raises naming the file."""
    import imageio.v2 as imageio

    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    imwrite_png(str(tmp_path / "a.png"), img)
    rgb = np.random.RandomState(5).randint(0, 256, (9, 11, 3)).astype(np.uint8)
    imageio.imwrite(str(tmp_path / "b.jpg"), rgb, quality=90)
    imageio.imwrite(str(tmp_path / "c.bmp"), rgb)
    jpeg = np.asarray(imageio.imread(str(tmp_path / "b.jpg")))
    monkeypatch.setitem(sys.modules, "imageio", None)
    _bits_equal(imread(str(tmp_path / "a.png")), img, "png")
    _bits_equal(imread(str(tmp_path / "b.jpg")), jpeg, "jpeg")
    with pytest.raises(ModuleNotFoundError, match="c.bmp"):
        imread(str(tmp_path / "c.bmp"))


def test_unfilter_build_failure_names_gxx_and_the_build_dir(monkeypatch, tmp_path):
    """Without a compiler the first PNG read raises, naming what it needs."""
    from xrnerf_torch import native

    monkeypatch.setattr(native, "_png_lib", None)
    monkeypatch.setattr(native, "png_lib_path", lambda: tmp_path / "libpng_unfilter-missing.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+ on PATH and a writable .*_build"):
        native.load_png_unfilter()


# --- the port's scene and the CLI ----------------------------------------------------


def test_port_scene_loads_like_the_jax_fixture(synthetic_scene, tmp_path):
    """The port's maker writes (without imageio) the scene the JAX maker
    writes through imageio: both load to the same arrays in each package's
    loader."""
    from xrnerf_tpu.datasets.load.blender import load_blender_data as jload

    from xrnerf_torch.datasets.load.blender import load_blender_data
    from xrnerf_torch.datasets.load.synthetic import make_synthetic_blender

    port = make_synthetic_blender(str(tmp_path / "sphere"), n_train=4, n_val=2, n_test=2, H=24, W=24)
    got, want = load_blender_data(port), jload(synthetic_scene)
    for g, w in zip(got, want):
        if isinstance(w, list):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            np.testing.assert_array_equal(g, w)
    for g, w in zip(jload(port)[:2], want[:2]):
        np.testing.assert_array_equal(g, w)


def test_cli_trains_and_tests_from_msgpack_without_imageio(scene, tmp_path, monkeypatch):
    """With ``imageio`` hidden: the port's CLI tests a PNG scene from a JAX
    trainer's ``.msgpack`` checkpoint (its PSNR equals the JAX trainer's
    render of the same file), and trains from it with ``ValidateHook``
    writing a PNG equal to ``to8b`` of its render."""
    from xrnerf_torch import run_nerf
    from xrnerf_torch.utils.metrics import psnr, to8b

    model, data = _family("nerf", scene, tmp_path)
    jtr = _jax_trainer(model, data, tmp_path / "jax")
    path = _jax_checkpoint(jtr, tmp_path / "jax")
    rays, gt = jtr.dataset.eval_item(int(jtr.dataset.i_test[0]))
    want_psnr = float(psnr(np.asarray(jtr.render_image(rays, 24, 24)["rgb"]), gt))

    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"""
eval_chunk = 256
eval_interval = 2
log_interval = 1
ckpt_interval = 0
model = dict({", ".join(f"{k}={v!r}" for k, v in model.items() if k != "type")}, type="NerfNetwork")
data = dict(type="SceneDataset", datadir=r"{scene}", N_rand=32, testskip=1)
hooks = [dict(type="ValidateHook", save_img=True, max_images=1)]
""")
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    test_dir = tmp_path / "test"
    tr = run_nerf.main(["--config", str(cfg), "--test_only", "--load_from", path, "--device", "cpu",
                        "--work_dir", str(test_dir)])
    res = json.load(open(test_dir / "test" / "test_results.json"))
    assert abs(res["psnr"]["0"] - want_psnr) < 0.05
    assert imread(str(test_dir / "test" / "test_0.png")).shape == (24, 24, 3)

    train_dir = tmp_path / "train"
    tr = run_nerf.main(["--config", str(cfg), "--load_from", path, "--device", "cpu", "--max_iters", "2",
                        "--work_dir", str(train_dir)])
    assert tr.step == 2 and np.isfinite(tr.last_logs["loss"])
    vrays, vgt = tr.dataset.eval_item(int(tr.dataset.i_val[0]))
    side = np.concatenate([to8b(tr.render_image(vrays, 24, 24)["rgb"]), to8b(vgt)], axis=1)
    _bits_equal(imread(str(train_dir / "val_2" / "val_0.png")), side, "val png")


# --- LPIPS -----------------------------------------------------------------------


def test_lpips_matches_jax_package(tmp_path):
    """The port's LPIPS on the CPU against the JAX package's (torch both)
    with one random VGG-shaped state dict (13 convs and 5 lin layers)."""
    from xrnerf_tpu.utils.metrics import LPIPS as JLPIPS

    from xrnerf_torch.utils.metrics import LPIPS

    g = torch.Generator().manual_seed(0)
    widths = [3, 8, 8, 16, 16, 24, 24, 24, 32, 32, 32, 32, 32, 32]
    idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    sd = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        sd[f"features.{idx[i]}.weight"] = torch.randn(b, a, 3, 3, generator=g) * (2.0 / (9 * a)) ** 0.5
        sd[f"features.{idx[i]}.bias"] = 0.01 * torch.randn(b, generator=g)
    for i, c in enumerate((8, 16, 24, 32, 32)):
        sd[f"lin{i}.weight"] = torch.rand(c, generator=g)
    path = str(tmp_path / "vgg.pt")
    torch.save(sd, path)
    rng = np.random.RandomState(5)
    a = rng.rand(48, 40, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(48, 40, 3), 0, 1).astype(np.float32)
    got, want = LPIPS(path, device="cpu")(a, b), JLPIPS(path)(a, b)
    assert want > 0 and abs(got - want) <= 1e-6 * abs(want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LPIPS(path)
