"""Carry weights and state between the JAX package's param trees and the port.

numpy only. A flax ``nn.Dense`` leaf is ``{"kernel": [din, dout], "bias":
[dout]}``; its ``nn.Linear`` counterpart is ``weight`` [dout, din] and
``bias``. A state-dict key is the flax path joined with dots:

- vanilla NeRF: layer names are kept (``pts_0..7``, ``alpha``, ``feature``,
  ``views_0``, ``rgb`` under ``mlp_coarse`` / ``mlp_fine``);
- Instant-NGP, unfused layout: flax ``nn.Sequential`` names its layers
  ``layers_0``, ``layers_2``, ...; ``torch.nn.Sequential`` names them ``0``,
  ``2``, ..., so ``field/density_net/layers_0/kernel`` becomes
  ``field.density_net.0.weight``;
- Instant-NGP, fused layout: ``field/d_w1 .. c_b3`` are bare arrays and are
  copied as they are. The port stores the fused weights [in, out], the
  orientation flax stores and the kernels read.
- the hash table ``field/encoding/table`` is a bare array in both hash
  layouts and is copied as it is: vertex [L, T, F], brick
  [L, n_lattices, tb, 8F].

A gradient tree has the parameters' structure, so the same functions carry
gradients across for leaf-by-leaf comparison.

The occupancy grid (``OccupancyGrid(density [C, R^3] f32, bitfield [C, R^3]
bool)``) travels as the network's ``grid_density`` / ``grid_bitfield``
buffers: :func:`grid_state_from_jax` and :func:`jax_grid_from_state_dict`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

_GRID_KEYS = ("grid_density", "grid_bitfield")


def state_dict_from_jax(params: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """flax params of a ``NerfMLP`` / ``NerfNetwork`` / ``NGPField`` /
    ``HashNerfNetwork`` (nested dicts of arrays) -> the port's ``state_dict``
    entries (flat, numpy float32). ``prefix`` is put before every key
    (``"field."`` for a bare ``NGPField`` tree)."""
    out: Dict[str, np.ndarray] = {}
    for name, sub in params.items():
        if name.startswith("layers_"):
            name = name[len("layers_"):]
        key = f"{prefix}{name}"
        if not isinstance(sub, Mapping):
            out[key] = np.array(sub, np.float32)
        elif "kernel" in sub:
            out[f"{key}.weight"] = np.array(np.asarray(sub["kernel"]).T, np.float32, order="C")
            out[f"{key}.bias"] = np.array(sub["bias"], np.float32)
        else:
            out.update(state_dict_from_jax(sub, prefix=f"{key}."))
    return out



def jax_params_from_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`state_dict_from_jax` (values may be numpy arrays or
    CPU tensors). The grid buffers are left out: see
    :func:`jax_grid_from_state_dict`."""
    tree: Dict[str, Any] = {}
    for key, val in state_dict.items():
        if key in _GRID_KEYS:
            continue
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(f"layers_{p}" if p.isdigit() else p, {})
        arr = np.asarray(val)
        if leaf == "weight":
            node["kernel"] = np.array(arr.T, np.float32, order="C")
        elif leaf == "bias":
            node["bias"] = np.array(arr, np.float32)
        else:  # a bare array: the hash table, a fused-layout weight or bias
            node[leaf] = np.array(arr, np.float32)
    return tree


def grid_state_from_jax(grid) -> Dict[str, np.ndarray]:
    """``OccupancyGrid(density, bitfield)`` -> the port network's buffer entries."""
    density, bitfield = grid
    return {"grid_density": np.array(density, np.float32), "grid_bitfield": np.array(bitfield, np.bool_)}


def jax_grid_from_state_dict(state_dict: Mapping[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
    """(density [C, R^3] f32, bitfield [C, R^3] bool) from a port state dict,
    the fields of the JAX package's ``OccupancyGrid`` in order."""
    return (np.array(state_dict["grid_density"], np.float32), np.array(state_dict["grid_bitfield"], np.bool_))
