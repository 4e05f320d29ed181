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
