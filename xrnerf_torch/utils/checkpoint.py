"""Checkpoint save/restore — port of ``xrnerf_tpu/utils/checkpoint.py``.

``save`` writes ``work_dir/ckpt_{step}.pt`` with ``torch.save`` (model,
optimizer, scheduler, EMA and step, as the trainer passes them; a network's
buffers, such as Instant-NGP's occupancy grid, ride in its state dict), through a
temporary file and an atomic ``os.replace``, and keeps the last ``keep``
checkpoints. Under a process group only global rank 0 writes (the trainer
hands it full tensors: ``Trainer.save_checkpoint`` gathers the model axis's
slices first); the others return the path. ``load`` reads one back onto
``map_location``.

The JAX package's ``ckpt_N.msgpack`` files are read with ``load_raw`` (plain
nested dicts, through ``utils/flax_msgpack.py``: no ``msgpack`` or flax).
``load_weights`` puts a weights file into a network, as ``load_from`` does:
a ``.pt`` state dict (or a trainer checkpoint's ``model``) whole, or a
``.msgpack`` file's parameters only (``raw["state"]["params"]``, else
``raw["params"]``, carried across by ``utils/weights.py:
state_dict_from_jax``), leaving the buffers (the aux state that
``init_aux`` made) as they are, as the JAX trainer's ``load_from`` restores
no aux. A parameter missing on either side, or of another shape, raises.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

from ..parallel import mesh as pm
from . import flax_msgpack
from .weights import state_dict_from_jax


def save(work_dir: str, step: int, state: Dict[str, Any], keep: int = 3) -> str:
    path = os.path.join(work_dir, f"ckpt_{step}.pt")
    if not pm.is_main():
        return path
    os.makedirs(work_dir, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    _cleanup(work_dir, keep)
    return path


def _cleanup(work_dir: str, keep: int) -> None:
    for s in all_steps(work_dir)[:-keep] if keep > 0 else []:
        try:
            os.remove(os.path.join(work_dir, f"ckpt_{s}.pt"))
        except OSError:
            pass


def all_steps(work_dir: str, ext: str = ".pt") -> List[int]:
    """Steps of the ``ckpt_{step}{ext}`` files in ``work_dir`` (``.msgpack``: the JAX package's)."""
    if not os.path.isdir(work_dir):
        return []
    pattern = re.compile(rf"^ckpt_(\d+){re.escape(ext)}$")
    return sorted(int(m.group(1)) for m in map(pattern.match, os.listdir(work_dir)) if m)


def latest_path(work_dir: str, ext: str = ".pt") -> Optional[str]:
    steps = all_steps(work_dir, ext)
    return os.path.join(work_dir, f"ckpt_{steps[-1]}{ext}") if steps else None


def load(path: str, map_location=None) -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=True)


def load_raw(path: str) -> Any:
    """A JAX-package ``.msgpack`` file as plain nested dicts (``checkpoint.load_raw``'s)."""
    with open(path, "rb") as f:
        return flax_msgpack.unpackb(f.read())


def load_weights(network: torch.nn.Module, path: str, sharded: Optional[Dict[str, int]] = None,
                 mesh: Optional[pm.Mesh] = None) -> None:
    """Load a ``.pt`` or ``.msgpack`` weights file into ``network`` (see the
    module docstring); under a mesh, this rank's slices of the cut
    parameters (``sharded``: {name: dim})."""
    device = next(network.parameters()).device
    if not str(path).endswith(".msgpack"):
        sd = torch.load(path, map_location=device, weights_only=True)
        network.load_state_dict(pm.local_state(sd.get("model", sd.get("state_dict", sd)), sharded or {}, mesh))
        return
    raw = load_raw(path)
    params = {k: torch.from_numpy(v) for k, v in
              state_dict_from_jax(raw["state"]["params"] if "state" in raw else raw["params"]).items()}
    own = dict(network.named_parameters())
    missing, unexpected = sorted(set(own) - set(params)), sorted(set(params) - set(own))
    if missing or unexpected:
        raise ValueError(f"{path}: the file's parameters do not match the network's: "
                         f"missing {missing}, unexpected {unexpected}")
    params = pm.local_state(params, sharded or {}, mesh)
    wrong = [f"{k} {tuple(v.shape)} vs {tuple(own[k].shape)}" for k, v in params.items() if v.shape != own[k].shape]
    if wrong:
        raise ValueError(f"{path}: parameter shapes differ from the network's: {wrong}")
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(params[k])
