"""Checkpoint save/restore — port of ``xrnerf_tpu/utils/checkpoint.py``.

``save`` writes ``work_dir/ckpt_{step}.pt`` with ``torch.save`` (model,
optimizer, scheduler, EMA and step, as the trainer passes them; a network's
buffers, such as Instant-NGP's occupancy grid, ride in its state dict), through a
temporary file and an atomic ``os.replace``, and keeps the last ``keep``
checkpoints. Under a process group only global rank 0 writes (the trainer
hands it full tensors: ``Trainer.save_checkpoint`` gathers the model axis's
slices first); the others return the path. ``load`` reads one back onto
``map_location``. Reading the JAX
package's ``.msgpack`` checkpoints is not ported (the card's machine has
no ``msgpack``).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

from ..parallel.mesh import is_main

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")


def save(work_dir: str, step: int, state: Dict[str, Any], keep: int = 3) -> str:
    path = os.path.join(work_dir, f"ckpt_{step}.pt")
    if not is_main():
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


def all_steps(work_dir: str) -> List[int]:
    if not os.path.isdir(work_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT_RE.match, os.listdir(work_dir)) if m)


def latest_path(work_dir: str) -> Optional[str]:
    steps = all_steps(work_dir)
    return os.path.join(work_dir, f"ckpt_{steps[-1]}.pt") if steps else None


def load(path: str, map_location=None) -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=True)
