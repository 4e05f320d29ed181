"""Carry NeRF weights between the JAX package's param tree and the port.

numpy only. A flax ``nn.Dense`` leaf is ``{"kernel": [din, dout], "bias":
[dout]}``; its ``nn.Linear`` counterpart is ``weight`` [dout, din] and
``bias``. Layer names are kept (``pts_0..7``, ``alpha``, ``feature``,
``views_0``, ``rgb`` under ``mlp_coarse`` / ``mlp_fine``), so a state-dict
key is the flax path joined with dots.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def nerf_state_dict_from_jax(params: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """flax ``NerfMLP``/``NerfNetwork`` params (nested dicts of arrays) ->
    the port's ``state_dict`` (flat, numpy float32)."""
    out: Dict[str, np.ndarray] = {}
    for name, sub in params.items():
        key = f"{prefix}{name}"
        if "kernel" in sub:
            out[f"{key}.weight"] = np.array(np.asarray(sub["kernel"]).T, np.float32, order="C")
            out[f"{key}.bias"] = np.array(sub["bias"], np.float32)
        else:
            out.update(nerf_state_dict_from_jax(sub, prefix=f"{key}."))
    return out


def jax_params_from_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`nerf_state_dict_from_jax` (values may be numpy
    arrays or CPU tensors)."""
    tree: Dict[str, Any] = {}
    for key, val in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        arr = np.asarray(val)
        if leaf == "weight":
            node["kernel"] = np.array(arr.T, np.float32, order="C")
        elif leaf == "bias":
            node["bias"] = np.array(arr, np.float32)
        else:
            raise KeyError(f"unexpected state-dict entry {key!r}")
    return tree
