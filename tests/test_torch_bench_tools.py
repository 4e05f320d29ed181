"""The port's micro-bench tools, ``tools/torch_bench_kilonerf.py`` and
``tools/torch_bench_ngp.py``, against the JAX repo's ``tools/bench_*.py``:

- each runs on the CPU at a tiny size with ``jax``, ``flax``, ``optax`` and
  ``xrnerf_tpu`` hidden, and prints the device line and the JAX tool's lines;
- its rays, occupancy grid and points are the JAX tool's draws for the same
  flags (the JAX tool runs with its networks stubbed, so only its draws are
  kept);
- without a card it refuses ``--device cuda``.
"""

import importlib.util
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = ("jax", "jaxlib", "flax", "optax", "xrnerf_tpu")
TOOLS = ("kilonerf", "ngp")
TINY = {
    "kilonerf": ["--hw", "16", "--chunk", "256", "--resolution", "2", "--frames", "1"],
    "ngp": ["--batch", "64", "--n_keep", "4", "--n_candidates", "16", "--components"],
}
NUM = r"([0-9][0-9,]*\.?[0-9]*)"
LINES = {
    "kilonerf": [rf"kilonerf frame 16x16 \(2\^3 nets, 384 cands, keep 32, (bf16|f32), 1 chunks of 256\): {NUM} "
                 rf"ms/frame  {NUM} Mrays/s  \(reference GPU: 365-394 ms\)"],
    "ngp": [rf"train: {NUM} ms/step  {NUM} rays/s", rf"march: {NUM} ms",
            rf"field fwd \(256 pts\): {NUM} ms  {NUM} Mpts/s", rf"field fwd\+bwd: {NUM} ms  {NUM} Mpts/s",
            rf"hashenc fwd: {NUM} ms  {NUM} Mpts/s", rf"hashenc fwd\+bwd: {NUM} ms  {NUM} Mpts/s"],
}


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool(name):
    return _load(f"tools/torch_bench_{name}.py", f"torch_bench_{name}")


def _hide_jax(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in HIDDEN:
            monkeypatch.setitem(sys.modules, name, None)
    for name in HIDDEN:
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("name", TOOLS)
def test_tool_imports_without_jax(monkeypatch, name):
    _hide_jax(monkeypatch)
    with pytest.raises(ImportError):
        import jax  # noqa: F401
    assert callable(_tool(name).main)


@pytest.mark.parametrize("name,extra", [("kilonerf", []), ("kilonerf", ["--f32"]), ("ngp", []),
                                        ("ngp", ["--pallas"])], ids=["kilonerf_bf16", "kilonerf_f32", "ngp",
                                                                     "ngp_pallas"])
def test_main_prints_its_lines_on_the_cpu_without_jax(monkeypatch, capsys, name, extra):
    tool = _tool(name)
    _hide_jax(monkeypatch)
    tool.main(TINY[name] + extra + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu" and len(lines) == 1 + len(LINES[name])
    for line, pattern in zip(lines[1:], LINES[name]):
        m = re.fullmatch(pattern, line)
        assert m, (line, pattern)
        nums = [float(g.replace(",", "")) for g in m.groups() if g not in ("bf16", "f32")]
        assert all(np.isfinite(v) and v >= 0 for v in nums) and nums[0] > 0, line
    if name == "kilonerf":
        assert ("f32" if extra else "bf16") in lines[1]


class _Recorder:
    """Stands in for the JAX tools' networks: keeps what they are given."""

    seen = {}

    def __init__(self, *args, **kw):
        _Recorder.seen.setdefault("kw", []).append(kw)

    def init(self, key, *args, rng=None, train=False, aux=None):
        _Recorder.seen.setdefault("init", []).append(args)
        if aux is not None:
            _Recorder.seen["aux"] = aux
        return {"params": {"w": jnp.zeros(1)}}

    def init_aux(self, params):
        return None

    def apply(self, variables, first, *args, **kw):
        if isinstance(first, dict):
            return {"rgb": jnp.zeros((first["rays_o"].shape[0], 3)) * variables["params"]["w"][0]}
        if args:  # NGPField(pts, dirs)
            return jnp.zeros((first.shape[0], 3)), jnp.zeros((first.shape[0],))
        return jnp.zeros((first.shape[0], 32))  # HashEncoding(pts)

    def loss(self, out, batch):
        return jnp.sum(out["rgb"]), {}


def _run_jax_tool(monkeypatch, name, argv):
    import xrnerf_tpu.models.embedders.hashenc as jhash
    import xrnerf_tpu.models.fields.ngp_mlp as jngp
    import xrnerf_tpu.models.networks.hashnerf as jhashnerf
    import xrnerf_tpu.models.networks.kilonerf as jkilo
    import xrnerf_tpu.models.samplers.ngp_march as jmarch

    _Recorder.seen = {}
    for mod, attr in ((jkilo, "KiloNerfNetwork"), (jhashnerf, "HashNerfNetwork"), (jngp, "NGPField"),
                      (jhash, "HashEncoding")):
        monkeypatch.setattr(mod, attr, _Recorder)
    monkeypatch.setattr(jmarch, "march_rays", lambda key, o, d, aux, **kw: o * 1.0)
    monkeypatch.setattr(sys, "argv", [f"bench_{name}.py"] + argv)
    _load(f"tools/bench_{name}.py", f"jax_bench_{name}").main()
    return _Recorder.seen


@pytest.mark.parametrize("flags", [[], ["--resolution", "3", "--occupied_frac", "0.4"]], ids=["default", "other"])
def test_kilonerf_draws_are_the_jax_tools(monkeypatch, flags):
    argv = ["--hw", "8", "--chunk", "128", "--frames", "1"] + flags
    seen = _run_jax_tool(monkeypatch, "kilonerf", argv)
    res = 3 if flags else 16
    batch, occ = _tool("kilonerf").draws(128, res, 0.4 if flags else 0.15)
    jbatch = seen["init"][0][0]
    assert sorted(jbatch) == sorted(batch)
    for k in batch:
        np.testing.assert_array_equal(np.asarray(jbatch[k]), batch[k], err_msg=k)
    assert occ.shape == (4 * res,) * 3 and np.array_equal(np.asarray(seen["aux"]), occ)
    assert seen["kw"][0]["resolution"] == (res,) * 3 and seen["kw"][0]["hidden"] == 32


def test_ngp_draws_are_the_jax_tools(monkeypatch):
    seen = _run_jax_tool(monkeypatch, "ngp", ["--batch", "32", "--n_keep", "3", "--components"])
    batch, pts, dirs = _tool("ngp").draws(32, 3)
    jbatch, (jpts, jdirs), (epts,) = seen["init"][0][0], seen["init"][1], seen["init"][2]
    assert sorted(jbatch) == sorted(batch)
    for k in batch:
        np.testing.assert_array_equal(np.asarray(jbatch[k]), batch[k], err_msg=k)
    for a, b in ((jpts, pts), (jdirs, dirs), (epts, pts)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("name", TOOLS)
def test_main_refuses_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _tool(name).main(["--device", "cuda"])
