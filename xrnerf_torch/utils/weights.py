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

- a flax ``nn.Conv`` kernel ``[kd, kh, kw, in, out]`` is a ``Conv3d``
  ``weight`` ``[out, in, kd, kh, kw]`` (``transpose(4, 3, 0, 1, 2)``; a
  plain ``.T`` would reverse the spatial axes too), its bias ``bias``;
- a flax 2-D ``nn.Conv`` kernel ``[kh, kw, in, out]`` is a ``Conv2d``
  ``weight`` ``[out, in, kh, kw]`` (``transpose(3, 2, 0, 1)``, back
  ``(2, 3, 1, 0)``); a conv without a bias (GNR's ``ConvBlock``) has no
  ``bias`` entry on either side;
- a flax ``nn.GroupNorm`` ``{"scale", "bias"}`` is GNR's ``GroupNorm``
  module, whose parameters are named ``scale`` and ``bias`` too; GNRMLP's
  bare ``s`` leaf is copied as it is;
- a flax ``nn.Embed`` ``{"embedding": [n, d]}`` is an ``nn.Embedding``
  ``weight`` [n, d]. Going back, a 2-D ``weight`` with no ``bias`` beside it
  is an ``Embed`` table (every ``Linear`` of the port has a bias).

A gradient tree has the parameters' structure, so the same functions carry
gradients across for leaf-by-leaf comparison.

- KiloNeRF: ``MultiNetworkMLP`` and ``GroupedMultiMLP`` leaves are bare
  stacked arrays (``mlp/hidden_0_w`` [n_nets, in, out], ``mlp/hidden_0_b``
  [n_nets, 1, out], ...) and are copied as they are, both ways.

The occupancy grid (``OccupancyGrid(density [C, R^3] f32, bitfield [C, R^3]
bool)``) travels as the network's ``grid_density`` / ``grid_bitfield``
buffers: :func:`grid_state_from_jax` and :func:`jax_grid_from_state_dict`.
KiloNeRF's bool ``occupancy`` buffer is the JAX trainer's aux, not a
parameter, and is left out of the param tree as well.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

_GRID_KEYS = ("grid_density", "grid_bitfield", "occupancy")
# flax conv kernel [k..., in, out] <-> torch weight [out, in, k...], by the kernel's rank
_CONV_TO = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1)}
_CONV_BACK = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0)}


def state_dict_from_jax(params: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """flax params of a network of the port (nested dicts of arrays) -> the
    port's ``state_dict`` entries (flat, numpy float32). ``prefix`` is put
    before every key (``"field."`` for a bare ``NGPField`` tree)."""
    out: Dict[str, np.ndarray] = {}
    for name, sub in params.items():
        if name.startswith("layers_"):
            name = name[len("layers_"):]
        key = f"{prefix}{name}"
        if not isinstance(sub, Mapping):
            out[key] = np.array(sub, np.float32)
        elif "kernel" in sub:
            kernel = np.asarray(sub["kernel"])
            kernel = kernel.transpose(_CONV_TO[kernel.ndim]) if kernel.ndim in _CONV_TO else kernel.T
            out[f"{key}.weight"] = np.array(kernel, np.float32, order="C")
            if "bias" in sub:
                out[f"{key}.bias"] = np.array(sub["bias"], np.float32)
        elif set(sub) == {"embedding"}:
            out[f"{key}.weight"] = np.array(sub["embedding"], np.float32)
        else:
            out.update(state_dict_from_jax(sub, prefix=f"{key}."))
    return out



def jax_params_from_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`state_dict_from_jax` (values may be numpy arrays or
    CPU tensors). The grid buffers (and KiloNeRF's occupancy) are left out:
    see :func:`jax_grid_from_state_dict`."""
    tree: Dict[str, Any] = {}
    for key, val in state_dict.items():
        if key in _GRID_KEYS:
            continue
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(f"layers_{p}" if p.isdigit() else p, {})
        arr = np.asarray(val)
        if leaf == "weight" and arr.ndim in (4, 5):
            node["kernel"] = np.array(arr.transpose(_CONV_BACK[arr.ndim]), np.float32, order="C")
        elif leaf == "weight" and key[: -len("weight")] + "bias" not in state_dict:
            node["embedding"] = np.array(arr, np.float32)
        elif leaf == "weight":
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
