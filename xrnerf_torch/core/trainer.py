"""Trainer — the serving half of ``xrnerf_tpu/core/trainer.py:Trainer``.

Construction places the network on ``device`` (the card by default;
raises without one unless ``device="cpu"``), initialises its parameters
from ``seed`` with flax's distributions, and optionally loads a ``.pt``
state dict written by the port (``load_from``). ``render_image`` renders
full images through the chunked renderer. Training (``run``, the
optimizer, the LR schedule, EMA and resume) comes with the backward
kernel in a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logger import get_logger
from .renderer import render_image as _render_image


class Trainer:
    def __init__(
        self,
        network: torch.nn.Module,
        dataset,
        work_dir: str = "./work_dir",
        seed: int = 0,
        eval_chunk: int = 8192,
        resume_from: Optional[str] = None,
        load_from: Optional[str] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.network = network.to(self.device)
        self.dataset = dataset
        self.work_dir = work_dir
        self.eval_chunk = eval_chunk
        self.logger = get_logger(log_file=f"{work_dir}/log.txt" if work_dir else None)
        self.eval_metrics: Dict[str, Any] = {}
        self.step = 0

        if resume_from:
            raise NotImplementedError("resume is ported with training in a later slice")
        self.network.reset_parameters(torch.Generator().manual_seed(seed))
        if load_from:
            sd = torch.load(load_from, map_location=self.device, weights_only=True)
            self.network.load_state_dict(sd.get("state_dict", sd))
            self.logger.info("loaded weights from %s", load_from)

    def render_image(self, rays: Dict[str, np.ndarray], H: int, W: int):
        return _render_image(self.network, rays, H, W, chunk=self.eval_chunk)

    def run(self):
        raise NotImplementedError("training is ported in a later slice")
