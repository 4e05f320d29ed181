"""Trainer — port of ``xrnerf_tpu/core/trainer.py``: iteration-based
training with logging windows, hooks, EMA and checkpoints, and full-image
rendering for the eval hooks.

Construction places the network on ``device`` (the card by default;
raises without one unless ``device="cpu"``), initialises its parameters
from ``seed`` with flax's distributions, builds the optimizer and learning
rate schedule (same values per step as the JAX package's optax chain), and
optionally resumes a checkpoint (``resume_from``: step, model, optimizer,
scheduler, EMA) or loads weights (``load_from``: a ``.pt`` state dict, or
the model of a checkpoint; or a JAX-package ``.msgpack`` checkpoint, whose
parameters alone are read, as the JAX trainer reads them:
``utils/checkpoint.py:load_weights``).

Each step draws its randomness from a generator on the network's device
seeded from ``(seed, step)``, so a resumed run takes the steps a straight
run would.

The JAX trainer's aux protocol is here: a network with ``init_aux``
(Instant-NGP's occupancy grid) has it called at construction with the
dataset, before any checkpoint or ``load_from`` file is read, and ``run``
calls its ``update_aux`` before every step whose number is a multiple of
``network.aux_interval`` (step 0 included) with a generator of its own
stream, seeded from ``(seed, 2**31 + step)``. The network holds that state
as buffers, so its ``state_dict`` carries it into checkpoints and weight
files. Eval renders with the EMA weights and the live state, as the JAX
trainer evaluates ``(eval_params, aux)``: the EMA network's buffers are
copied from the network's after every refresh and after a checkpoint or
weight file is read. KiloNeRF's occupancy grid is such a buffer too
(``KiloNerfNetwork.init_aux`` reads the config's ``.npy``; it has no
refresh), and a network with ``param_loss()`` has that term added to every
step's loss (logged as ``param_reg``).

A network whose ``trainable_filter()`` returns a predicate on the dotted
state-dict names (AniNeRF's ``novel_pose``: ``"novel_pose_bw_mlp" in
name``) trains only the parameters that pass it: the optimizer and the
``grad_clip`` norm cover those alone, and the others get
``requires_grad_(False)``, so they take no update, as the JAX trainer's
``optax.set_to_zero`` branch gives them none. The EMA averages every
parameter, frozen ones too, as the JAX trainer's ``_ema_update`` does.

With a ``mesh`` (``parallel.mesh.make_mesh``), the run is one data-parallel
and model-parallel program that computes what one process computes on the
global batch, as the JAX trainer under its mesh does:

- each data rank fetches its rows of the step's batch
  (``train_batch(step, data rank, data size)``); the step's generator draws
  for the global batch and keeps the rank's rows;
- the loss runs on the global rows (``parallel.mesh.global_view`` gathers
  the outputs and batch keys it reads), so every rank holds the same loss
  and logs, and each rank's backward yields its rows' share of the gradient;
  the gradients are summed over the data group before the clip, whose norm
  sums the squares of model-cut parameters over the model group; a
  ``param_loss`` enters the backward of data rank 0 alone;
- parameters named by the network's ``param_spec`` are cut over the model
  group (``parallel.mesh.shard_module``); Adam and EMA state follow their
  slices; checkpoints hold full tensors written by rank 0, and a resume cuts
  them again, so one-process and multi-rank checkpoints are interchangeable;
- after every aux refresh rank 0's buffers (the occupancy grid) are
  broadcast; a stop request is agreed at the end of a log window.

The Trainer sets no process-wide flag: on the card, call
``utils.device.configure_card`` before building it (TF32 off, cuDNN's
algorithm search on), as ``run_nerf.main`` does.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..parallel import mesh as pm
from ..registry import HOOKS
from ..utils import checkpoint as ckpt
from ..utils.device import resolve_device
from ..utils.logger import get_logger
from .hooks import Hook
from .prefetch import BatchPrefetcher
from .renderer import render_image as _render_image


def build_lr_schedule(cfg: Dict[str, Any]) -> Callable[[int], float]:
    """lr at each step (``xrnerf_tpu/core/trainer.py:build_lr_schedule``):
    NeRF exponential decay ``lr * rate^(step / decay_steps)``, the mip-NeRF
    log-lerp to ``lr_final`` with delayed sine warmup, or constant."""
    lr = float(cfg.get("lr", 5e-4))
    decay_steps = int(cfg.get("lr_decay_steps", 0))
    decay_rate = float(cfg.get("lr_decay_rate", 0.1))
    lr_final = cfg.get("lr_final")
    warmup = int(cfg.get("lr_warmup_steps", 0))
    max_steps = int(cfg.get("max_steps", decay_steps or 1))

    if lr_final is not None:
        lr_final = float(lr_final)
        delay_mult = float(cfg.get("lr_delay_mult", 0.01))

        def mip(step: int) -> float:
            delay = 1.0
            if warmup > 0:
                delay = delay_mult + (1 - delay_mult) * math.sin(0.5 * math.pi * min(max(step / warmup, 0.0), 1.0))
            t = min(max(step / max_steps, 0.0), 1.0)
            return delay * math.exp(math.log(lr) * (1 - t) + math.log(lr_final) * t)

        return mip
    if decay_steps > 0:
        return lambda step: lr * decay_rate ** (step / decay_steps)
    return lambda step: lr


def build_optimizer(params, cfg: Dict[str, Any]):
    """(optimizer, LambdaLR scheduler, grad_clip or None) for the JAX
    package's ``build_optimizer`` config: ``adam`` (beta1, beta2, eps),
    ``adamw`` (weight_decay, default 1e-2), ``sgd`` (momentum, default 0.9);
    ``grad_clip`` is a global-norm clip applied before the step."""
    cfg = dict(cfg or {})
    opt_type = cfg.get("type", "adam").lower()
    sched = build_lr_schedule(cfg)
    lr = sched(0) or 1.0  # LambdaLR scales the base lr by sched(step) / lr
    if opt_type == "adam":
        betas = (float(cfg.get("beta1", 0.9)), float(cfg.get("beta2", 0.999)))
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=float(cfg.get("eps", 1e-8)))
    elif opt_type == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, weight_decay=float(cfg.get("weight_decay", 1e-2)))
    elif opt_type == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=float(cfg.get("momentum", 0.9)))
    else:
        raise ValueError(f"unknown optimizer {opt_type!r}")
    scheduler = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: sched(step) / lr)
    clip = cfg.get("grad_clip")
    return opt, scheduler, (float(clip) if clip else None)


def step_generator(device: torch.device, seed: int, step: int, rows: Optional[pm.RowShard] = None) -> torch.Generator:
    """The step's random stream (the JAX trainer's ``fold_in(base, step)``);
    with ``rows``, a rank's part of the global batch's stream."""
    g = pm.StepGenerator(device=device).manual_seed(seed * 2**32 + step)
    g.rows = rows
    return g


class Trainer:
    def __init__(
        self,
        network: torch.nn.Module,
        dataset,
        optimizer: Optional[Dict[str, Any]] = None,
        work_dir: str = "./work_dir",
        max_iters: int = 200000,
        eval_interval: int = 0,
        ckpt_interval: int = 10000,
        log_interval: int = 100,
        hooks: Optional[List[Hook]] = None,
        seed: int = 0,
        eval_chunk: int = 8192,
        resume_from: Optional[str] = None,
        load_from: Optional[str] = None,
        ema_decay: float = 0.0,
        device="cuda",
        mesh: Optional[pm.Mesh] = None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.network = network.to(self.device)
        self.dataset = dataset
        self.work_dir = work_dir
        self.max_iters = max_iters
        self.eval_interval = eval_interval
        self.ckpt_interval = ckpt_interval
        self.log_interval = log_interval
        self.hooks = list(hooks or [])
        self.seed = seed
        self.eval_chunk = eval_chunk
        self.ema_decay = ema_decay
        self.logger = get_logger(log_file=f"{work_dir}/log.txt" if work_dir else None)
        self.eval_metrics: Dict[str, Any] = {}
        self.last_logs: Dict[str, float] = {}
        self._stop = False

        self.network.reset_parameters(torch.Generator().manual_seed(seed))
        if hasattr(self.network, "init_aux"):
            self.network.init_aux(dataset)
        # {name: dim} of the parameters cut over the model axis
        self.sharded = pm.shard_module(self.network, mesh) if mesh is not None else {}
        self.trained_params = list(self.network.parameters())
        filt = self.network.trainable_filter() if hasattr(self.network, "trainable_filter") else None
        if filt is not None:
            for name, p in self.network.named_parameters():
                p.requires_grad_(bool(filt(name)))
            self.trained_params = [p for p in self.trained_params if p.requires_grad]
        opt_cfg = dict(optimizer or {})
        opt_cfg.setdefault("max_steps", max_iters)
        self.optimizer, self.scheduler, self.grad_clip = build_optimizer(self.trained_params, opt_cfg)
        names = {id(p): n for n, p in self.network.named_parameters()}
        self._trained_names = [names[id(p)] for p in self.trained_params]
        self.start_step = 0

        if resume_from:
            if str(resume_from).endswith(".msgpack"):
                raise ValueError(f"{resume_from}: a JAX-package checkpoint cannot be resumed (its optax state has no "
                                 "torch counterpart here); load its parameters with load_from")
            state = ckpt.load(resume_from, map_location=self.device)
            self.network.load_state_dict(pm.local_state(state["model"], self.sharded, mesh))
            self.optimizer.load_state_dict(self._optimizer_state(state["optimizer"], pm.take_shard))
            self.scheduler.load_state_dict(state["scheduler"])
            self.start_step = int(state["step"])
            self.logger.info("resumed from %s at step %d", resume_from, self.start_step)
        elif load_from:
            # a weights file or a trainer checkpoint (its "model"), or the JAX package's .msgpack (parameters only)
            ckpt.load_weights(self.network, load_from, self.sharded, mesh)
            self.logger.info("loaded weights from %s", load_from)
        self.step = self.start_step

        # EMA of the parameters in a second network, which eval renders with
        self.ema_network = None
        if ema_decay > 0:
            self.ema_network = copy.deepcopy(self.network).requires_grad_(False)
            if resume_from and state.get("ema") is not None:
                self.ema_network.load_state_dict(pm.local_state(state["ema"], self.sharded, mesh))
                self._sync_ema_buffers()

    # ------------------------------------------------------------------
    def request_stop(self):
        self._stop = True

    @property
    def eval_network(self) -> torch.nn.Module:
        return self.ema_network if self.ema_network is not None else self.network

    @property
    def eval_params(self) -> Dict[str, torch.Tensor]:
        return self.eval_network.state_dict()

    def render_image(self, rays: Dict[str, np.ndarray], H: int, W: int):
        return _render_image(self.eval_network, rays, H, W, chunk=self.eval_chunk, mesh=self.mesh)

    def _put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host arrays to the device: pinned memory and an asynchronous copy
        on the card, a plain conversion on the CPU."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.require(v, requirements="C"))  # keeps a 0-d array 0-d
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _update_ema(self) -> None:
        d = self.ema_decay
        with torch.no_grad():
            for e, p in zip(self.ema_network.parameters(), self.network.parameters()):
                # every leaf, frozen ones too, in the JAX trainer's form: XLA contracts
                # ``d * e + (1 - d) * p`` to fma(d, e, fl((1 - d) p)), and add's alpha
                # is that fma (a frozen leaf then keeps its bits, where the plain
                # fl(d e) + fl((1 - d) e) can move it by an ulp)
                torch.add(p.mul(1 - d), e, alpha=d, out=e)

    def _sync_ema_buffers(self) -> None:
        """The EMA copy averages parameters only; its buffers (the occupancy
        grid) follow the network's."""
        with torch.no_grad():
            for e, b in zip(self.ema_network.buffers(), self.network.buffers()):
                e.copy_(b)

    def update_aux(self, step: int) -> None:
        """Refresh the network's aux state (the occupancy grid) for ``step``
        from its own random stream, on the live network, and hand the new
        state to the EMA copy."""
        self.network.update_aux(step_generator(self.device, self.seed, 2**31 + step))
        pm.broadcast_buffers(self.network, self.mesh)
        if self.ema_network is not None:
            self._sync_ema_buffers()

    def _optimizer_state(self, state: Dict[str, Any], convert) -> Dict[str, Any]:
        """An optimizer state dict with the moments of model-cut parameters
        gathered (``pm.gather_shards``) or cut (``pm.take_shard``)."""
        if not self.sharded:
            return state
        out = {**state, "state": {}}
        for i, st in state["state"].items():
            dim = self.sharded.get(self._trained_names[int(i)])
            out["state"][i] = st if dim is None else {
                k: convert(v, dim, self.mesh) if torch.is_tensor(v) and v.dim() > dim else v for k, v in st.items()
            }
        return out

    def save_checkpoint(self, step: int) -> str:
        """Full tensors on every rank's behalf (the model group gathers its
        slices), written by rank 0."""
        return ckpt.save(self.work_dir, step, {
            "step": step,
            "model": pm.full_state(self.network.state_dict(), self.sharded, self.mesh),
            "optimizer": self._optimizer_state(self.optimizer.state_dict(), pm.gather_shards),
            "scheduler": self.scheduler.state_dict(),
            "ema": pm.full_state(self.ema_network.state_dict(), self.sharded, self.mesh)
            if self.ema_network is not None else None,
        })

    def train_step(self, batch: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns the network's logs, detached, on the device."""
        mesh = self.mesh
        self.optimizer.zero_grad(set_to_none=True)
        rows = mesh.rows if mesh is not None else None
        outputs = self.network(batch, generator=step_generator(self.device, self.seed, step, rows), train=True)
        if mesh is not None:
            outputs, batch = pm.global_view(outputs, batch, rows)
        loss, logs = self.network.loss(outputs, batch)
        if hasattr(self.network, "param_loss"):
            reg = self.network.param_loss()
            total = loss + reg
            logs = {**logs, "param_reg": reg, "loss": total}
            # a term of no row: in the backward of one data rank, so that the summed gradient holds it once
            loss = total if mesh is None or mesh.data_rank == 0 else loss
        loss.backward()
        if mesh is not None:
            pm.reduce_gradients(self.trained_params, mesh)
        if self.grad_clip is not None and mesh is not None:
            pm.clip_grad_norm_(self.trained_params, self.grad_clip,
                               [n in self.sharded for n in self._trained_names], mesh)
        elif self.grad_clip is not None:
            torch.nn.utils.clip_grad_norm_(self.trained_params, self.grad_clip)
        self.optimizer.step()
        self.scheduler.step()
        if self.ema_network is not None:
            self._update_ema()
        return {k: v.detach() for k, v in logs.items()}

    # ------------------------------------------------------------------
    def run(self) -> int:
        """Train from ``start_step`` to ``max_iters`` (or a stop request);
        returns the step reached."""
        for h in self.hooks:
            h.on_run_begin(self)
        window_logs: Dict[str, list] = {}
        t_window = time.perf_counter()
        mesh = self.mesh
        d_size = mesh.data_size if mesh is not None else 1
        fetch = self.dataset.train_batch
        if mesh is not None:  # this data rank's rows of the global batch
            fetch = lambda s: self.dataset.train_batch(s, mesh.data_rank, mesh.data_size)  # noqa: E731
        prefetcher = BatchPrefetcher(
            fetch=fetch, put=self._put_batch,
            start_step=self.start_step, max_steps=self.max_iters,
        )
        step = self.start_step
        agreed_stop = False  # under a mesh a stop request counts once the ranks agree on it
        self.network.train()
        aux_interval = getattr(self.network, "aux_interval", 0) if hasattr(self.network, "update_aux") else 0
        try:
            while step < self.max_iters and not (self._stop if mesh is None else agreed_stop):
                if aux_interval and step % aux_interval == 0:
                    self.update_aux(step)
                logs = self.train_step(prefetcher.get(step), step)
                step += 1
                self.step = step
                for k, v in logs.items():
                    window_logs.setdefault(k, []).append(v)

                if step % self.log_interval == 0:
                    # one host sync per window
                    vals = {k: float(torch.stack(v).float().mean()) for k, v in window_logs.items()}
                    dt = time.perf_counter() - t_window
                    rays_s = self.dataset.N_rand * d_size * self.log_interval / dt  # the global batch
                    self.logger.info(
                        "iter %d/%d  %s  %.0f rays/s  %.1f ms/it", step, self.max_iters,
                        "  ".join(f"{k} {v:.4f}" for k, v in vals.items()), rays_s,
                        1000 * dt / self.log_interval,
                    )
                    self.last_logs = {**vals, "rays_per_sec": rays_s, "ms_per_step": 1000 * dt / self.log_interval}
                    window_logs = {}
                    agreed_stop = pm.any_rank(self._stop, mesh, self.device)
                    t_window = time.perf_counter()

                for h in self.hooks:
                    h.after_step(self, step, logs)
                if self.eval_interval and step % self.eval_interval == 0:
                    for h in self.hooks:
                        h.on_eval(self, step)
                if self.ckpt_interval and step % self.ckpt_interval == 0:
                    self.save_checkpoint(step)
        finally:
            prefetcher.close()
        if self.ckpt_interval:
            self.save_checkpoint(step)
        for h in self.hooks:
            h.on_run_end(self)
        return step


def build_hooks(cfgs: Optional[List[Dict[str, Any]]]) -> List[Hook]:
    return [HOOKS.build(c) for c in (cfgs or [])]
