"""The PyTorch port stands alone: no JAX, no flax/optax, nothing of xrnerf_tpu,
and its entry points refuse to run on the CPU unless asked to."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "xrnerf_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "xrnerf_tpu"}


NGP_MODULES = (
    "ops.fused_mlp", "ops.scatter_rows", "models.embedders.sh", "models.embedders.hashenc", "models.fields.ngp_mlp",
    "models.samplers.occupancy", "models.samplers.ngp_march", "models.networks.hashnerf", "datasets.hashnerf",
)

MIP_MODULES = (
    "models.embedders.mip", "models.renders.volume", "models.networks.mipnerf", "datasets.multiscale",
    "datasets.scene", "datasets.load.resize", "datasets.load.blender", "datasets.load.llff", "datasets.load.nsvf",
    "datasets.load.deepvoxels", "datasets.load.linemod",
)
KILO_MODULES = (
    "ops.compaction", "models.fields.kilonerf_field", "models.networks.kilonerf", "datasets.kilonerf",
    "core.distill", "core.renderer", "core.trainer",
)
GNR_MODULES = (
    "ops.mesh", "ops.marching", "native", "native.mesh_grid_searcher", "models.embedders.gnr_embedder",
    "models.fields.gnr_mlp", "models.renders.gnr_render", "models.networks.gnr", "datasets.genebody",
    "datasets.load.synthetic",
)
# the JAX package reads and resizes images with these; no module of the port imports them on import
IMAGE_LIBS = {"cv2", "imageio"}


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _submodules():
    import xrnerf_torch

    return sorted(
        m.name for m in pkgutil.walk_packages(xrnerf_torch.__path__, "xrnerf_torch.")
    )


def test_import_leaves_jax_out_of_sys_modules():
    """Importing the port and every submodule pulls in none of them."""
    mods = _submodules()
    assert "xrnerf_torch.ops.fused_nerf_mlp" in mods and "xrnerf_torch.run_nerf" in mods
    assert {f"xrnerf_torch.{m}" for m in NGP_MODULES} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in ['xrnerf_torch'] + {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "new = sorted(m for m in set(sys.modules) - before\n"
        f"             if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(json.dumps(new))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(open(path).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN]


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the refusal is for hosts without one")
    from xrnerf_torch import build_network
    from xrnerf_torch.core.trainer import Trainer

    cfg = dict(type="NerfNetwork", n_samples=4, n_importance=0, netdepth=2, netwidth=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_network(cfg)
    net = build_network(cfg, device="cpu")
    assert next(net.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(net, None, work_dir=None)
    tr = Trainer(net, None, work_dir=None, device="cpu")
    assert tr.device.type == "cpu" and tr.ema_network is None
    assert all(p.device.type == "cpu" for g in tr.optimizer.param_groups for p in g["params"])


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from xrnerf_torch import run_nerf

    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "model = dict(type='NerfNetwork', n_samples=4, n_importance=0, netdepth=2, netwidth=8)\n"
        "data = dict(type='SceneDataset', datadir='unused')\n"
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_nerf.main(["--config", str(cfg), "--test_only"])


@pytest.mark.parametrize("module", NGP_MODULES)
def test_ngp_module_stands_alone(module):
    """Each Instant-NGP module is among the checked sources and imports
    neither JAX nor the JAX package."""
    path = os.path.join(PORT, *module.split(".")) + ".py"
    assert path in _port_sources()
    test_source_imports_nothing_of_jax(path)


def test_ngp_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the refusal is for hosts without one")
    from xrnerf_torch import DATASETS, HOOKS, NETWORKS, build_network
    from xrnerf_torch.core.trainer import Trainer

    assert "HashNerfNetwork" in NETWORKS and "HashNerfDataset" in DATASETS and "SampleBudgetHook" in HOOKS
    cfg = dict(type="HashNerfNetwork", n_levels=2, log2_table_size=8, base_res=4, max_res=8, grid_res=8,
               n_candidates=8, n_keep=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_network(cfg)
    net = build_network(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(net, None, work_dir=None)
    tr = Trainer(net, None, work_dir=None, device="cpu")
    assert tr.network.grid_bitfield.device.type == "cpu" and bool(tr.network.grid_bitfield.all())


@pytest.mark.parametrize("module", MIP_MODULES)
def test_mip_and_loader_module_stands_alone(module):
    """Each Mip-NeRF and scene-loader module is among the checked sources
    and imports neither JAX nor the JAX package."""
    path = os.path.join(PORT, *module.split(".")) + ".py"
    assert path in _port_sources()
    test_source_imports_nothing_of_jax(path)


def test_mip_and_loader_modules_import_no_image_libs():
    """Importing them (and building the registry) leaves JAX, the JAX
    package, ``cv2`` and ``imageio`` out of ``sys.modules``."""
    mods = [f"xrnerf_torch.{m}" for m in MIP_MODULES]
    code = (
        "import importlib, json, sys\n"
        f"for m in ['xrnerf_torch'] + {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN | IMAGE_LIBS)!r})))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_mip_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the refusal is for hosts without one")
    from xrnerf_torch import DATASETS, NETWORKS, build_network
    from xrnerf_torch.core.trainer import Trainer

    assert "MipNerfNetwork" in NETWORKS and "MipMultiScaleDataset" in DATASETS
    cfg = dict(type="MipNerfNetwork", n_samples=4, max_deg_point=2, deg_view=1, netdepth=2, netwidth=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_network(cfg)
    net = build_network(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(net, None, work_dir=None)
    tr = Trainer(net, None, work_dir=None, device="cpu")
    assert tr.device.type == "cpu" and next(tr.network.parameters()).device.type == "cpu"


@pytest.mark.parametrize("module", KILO_MODULES)
def test_kilo_module_stands_alone(module):
    """Each KiloNeRF module is among the checked sources and imports neither
    JAX nor the JAX package."""
    path = os.path.join(PORT, *module.split(".")) + ".py"
    assert path in _port_sources()
    test_source_imports_nothing_of_jax(path)


def test_kilo_pipeline_tool_stands_alone():
    """``tools/torch_kilonerf_pipeline.py`` imports neither JAX nor the JAX
    package, at the top or inside its functions."""
    test_source_imports_nothing_of_jax(os.path.join(ROOT, "tools", "torch_kilonerf_pipeline.py"))


def test_kilo_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the refusal is for hosts without one")
    import numpy as np

    from xrnerf_torch import DATASETS, NETWORKS, build_network
    from xrnerf_torch.core.distill import DistillDriver
    from xrnerf_torch.datasets.kilonerf import KiloNerfDistillDataset
    from xrnerf_torch.models.networks.kilonerf import build_occupancy_grid

    for name in ("KiloNerfNetwork", "StudentNerfNetwork"):
        assert name in NETWORKS
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_network(dict(type=name, resolution=(2, 2, 2), hidden=8))
    assert "KiloNerfDataset" in DATASETS and "KiloNerfDistillDataset" in DATASETS

    def teacher(p, d):
        return p, p[:, 0]

    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistillDriver(teacher, (-1,) * 3, (1,) * 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KiloNerfDistillDataset(resolution=(2, 2, 2), teacher_fn=teacher)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_occupancy_grid(lambda p: p[:, 0], (-1,) * 3, (1,) * 3, res=(2, 2, 2), subsamples=1)
    grid = build_occupancy_grid(lambda p: p[:, 0], (-1,) * 3, (1,) * 3, res=(2, 2, 2), subsamples=1,
                                threshold=0.0, device="cpu")
    assert grid.tolist() == np.array([[[False] * 2] * 2, [[True] * 2] * 2]).tolist()


@pytest.mark.parametrize("module", GNR_MODULES)
def test_gnr_module_stands_alone(module):
    """Each GNR module (and the native mesh searcher's binding) is among the
    checked sources and imports neither JAX nor the JAX package."""
    path = os.path.join(PORT, *module.split("."))
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) else path + ".py"
    assert path in _port_sources()
    test_source_imports_nothing_of_jax(path)


def test_gnr_modules_import_no_image_libs_and_build_nothing():
    """Importing them leaves JAX, the JAX package, ``cv2`` and ``imageio``
    out of ``sys.modules``, and builds no native library."""
    mods = [f"xrnerf_torch.{m}" for m in GNR_MODULES]
    code = (
        "import importlib, json, sys\n"
        "import xrnerf_torch.native as native\n"
        "built = native.lib_path().exists()\n"
        f"for m in ['xrnerf_torch'] + {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert native._lib is None and native.lib_path().exists() == built\n"
        f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN | IMAGE_LIBS)!r})))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_gnr_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the refusal is for hosts without one")
    from xrnerf_torch import DATASETS, NETWORKS, build_network

    assert "GnrNetwork" in NETWORKS and "GeneBodyDataset" in DATASETS
    cfg = dict(type="GnrNetwork", n_samples=4, load_size=32, num_stack=1, num_hourglass=1, hourglass_dim=8,
               mlp_depth=2, mlp_width=16, skips=(0,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_network(cfg)
    net = build_network(cfg, device="cpu")
    assert next(net.parameters()).device.type == "cpu"
