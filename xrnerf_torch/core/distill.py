"""KiloNeRF distillation driver: kd-tree node discovery + per-node student
fitting against a frozen teacher — port of ``xrnerf_tpu/core/distill.py``.

The tree walk is host Python. Each cycle takes up to ``max_num_networks``
nodes off the queue, draws their examples (numpy ``RandomState``, the same
calls in the same order as the JAX driver, so both draw the same points),
asks the teacher for targets, and fits one network per node with
``GroupedMultiMLP`` and a per-network Adam (optax's update; the step of a
node batch drawn from the saturated queue is scaled by ``saturation_lr /
lr`` on the network axis). Nodes whose test error passes ``max_error`` are
split (longest axis, random axis, or equal error mass) and queued again;
the others keep their fitted weights. The JAX driver pads every batch to
``max_num_networks`` networks so that its step compiles once; the port fits
only the batch's networks, which gives them the same updates (the networks
share nothing). The checkpoint is a pickle of the port's own ``Node`` tree;
reading one the JAX driver wrote is not supported.
"""

from __future__ import annotations

import os
import pickle
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.fields.kilonerf_field import GroupedMultiMLP
from ..utils.device import resolve_device


@dataclass
class Node:
    """kd-tree node."""

    domain_min: np.ndarray
    domain_max: np.ndarray
    split_axis: int = -1
    split_threshold: float = 0.0
    leq_child: Optional["Node"] = None
    gt_child: Optional["Node"] = None
    params: Optional[Dict[str, np.ndarray]] = None  # fitted single-network weights
    best_error: Optional[Dict[str, float]] = None


def calculate_volume(dmin, dmax) -> float:
    return float(np.prod(np.asarray(dmax) - np.asarray(dmin)))


def nodes_fixed_resolution(res: Sequence[int], dmin, dmax) -> List[Node]:
    """Initial uniform grid of root nodes."""
    res = np.asarray(res)
    dmin = np.asarray(dmin, np.float32)
    dmax = np.asarray(dmax, np.float32)
    size = (dmax - dmin) / res
    out = []
    for i in range(res[0]):
        for j in range(res[1]):
            for k in range(res[2]):
                lo = dmin + size * np.array([i, j, k])
                out.append(Node(domain_min=lo, domain_max=lo + size))
    return out


def error_metrics(out: np.ndarray, tgt: np.ndarray, quantile: float = 0.99
                  ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """out, tgt [N, E, 4] (rgb + sigma, post-activation) -> (per-network
    errors {mse, mae, mape, quantile_se}, per-point mse [N, E], saturation
    flags [N])."""
    se = (out - tgt) ** 2
    ae = np.abs(out - tgt)
    mape = ae / (np.abs(tgt) + 0.1)
    per_net = {"mse": se.mean((1, 2)), "mae": ae.mean((1, 2)), "mape": mape.mean((1, 2))}
    se_pp = se.mean(2)
    qi = int(se_pp.shape[1] * quantile)
    per_net["quantile_se"] = np.sort(se_pp, axis=1)[:, min(qi, se_pp.shape[1] - 1)]
    tol = 1e-3
    rgb, trgb = out[..., :3], tgt[..., :3]
    close0, gt0 = (np.abs(rgb) < tol).all(-1), (np.abs(trgb) < tol).all(-1)
    close1, gt1 = (np.abs(rgb - 1) < tol).all(-1), (np.abs(trgb - 1) < tol).all(-1)
    saturation = (close0 & ~gt0).any(-1) | (close1 & ~gt1).any(-1)
    return per_net, se_pp, saturation


def equal_error_split_threshold(pts, errors, axis) -> float:
    """Split coordinate with half the per-point error mass on each side."""
    order = np.argsort(pts[:, axis])
    csum = np.cumsum(errors[order])
    idx = int(np.searchsorted(csum, csum[-1] / 2.0))
    return float(pts[order][min(idx, len(order) - 1), axis])


class DistillDriver:
    """Discovery-phase driver. ``teacher_fn(pts [B, 3], dirs [B, 3]) ->
    (rgb [B, 3], sigma [B])``, post-activation, on torch tensors on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""

    def __init__(
        self,
        teacher_fn: Callable,
        domain_min: Sequence[float],
        domain_max: Sequence[float],
        work_dir: str = "",
        fixed_resolution: Optional[Sequence[int]] = None,
        max_num_networks: int = 128,
        num_examples_per_network: int = 1024,
        test_examples_per_network: int = 256,
        iters_per_batch: int = 250,
        lr: float = 2e-3,
        saturation_lr: float = 1e-4,
        max_error: float = 1e-4,
        test_error_metric: str = "quantile_se",
        tree_type: str = "kdtree_longest",
        termination_volume: float = 1.0,
        hidden: int = 32,
        n_hidden_layers: int = 2,
        multires: int = 10,
        multires_dirs: int = 4,
        seed: int = 0,
        device="cuda",
    ):
        self.teacher = teacher_fn
        self.device = resolve_device(device)
        self.work_dir = work_dir
        self.dmin = np.asarray(domain_min, np.float32)
        self.dmax = np.asarray(domain_max, np.float32)
        self.N = int(max_num_networks)
        self.E = int(num_examples_per_network)
        self.E_test = int(test_examples_per_network)
        self.iters = int(iters_per_batch)
        self.lr, self.saturation_lr = lr, saturation_lr
        self.max_error = max_error
        self.metric = test_error_metric
        self.tree_type = tree_type
        self.termination_volume = termination_volume
        self.rng = np.random.RandomState(seed)
        self.mlp_kw = dict(hidden=hidden, n_hidden_layers=n_hidden_layers, multires=multires,
                           multires_dirs=multires_dirs)
        self.teacher_rows = 0  # points sent to the teacher so far
        self.last_cycle: Dict[str, object] = {}

        ckpt = os.path.join(work_dir, "distill_checkpoint.pkl") if work_dir else ""
        if ckpt and os.path.exists(ckpt):
            with open(ckpt, "rb") as fh:
                self.cp = pickle.load(fh)
        else:
            roots = (nodes_fixed_resolution(fixed_resolution, self.dmin, self.dmax)
                     if fixed_resolution is not None else [Node(self.dmin.copy(), self.dmax.copy())])
            self.cp = {
                "root_nodes": roots,
                "nodes_to_process": deque(roots),
                "saturated_nodes_to_process": deque(),
                "fitted_volume": 0.0,
                "total_volume": calculate_volume(self.dmin, self.dmax),
                "num_networks_fitted": 0,
            }

    # ------------------------------------------------------------------
    def init_student(self, n_active: int, seed: int) -> GroupedMultiMLP:
        """A fresh student for a batch's ``n_active`` networks, its weights
        the first ``n_active`` of ``max_num_networks`` drawn from ``seed``."""
        full = GroupedMultiMLP(self.N, **self.mlp_kw)
        full.reset_parameters(torch.Generator().manual_seed(int(seed)))
        student = GroupedMultiMLP(n_active, **self.mlp_kw)
        student.load_state_dict({k: v[:n_active] for k, v in full.state_dict().items()})
        return student.to(self.device)

    @staticmethod
    def _predict(student: GroupedMultiMLP, local: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        rgb_raw, sigma_raw = student(local, dirs)
        return torch.cat([torch.sigmoid(rgb_raw), F.relu(sigma_raw)[..., None]], -1)

    def _adam_fit(self, student: GroupedMultiMLP, lr_scale: torch.Tensor, local, dirs, tgt) -> None:
        """``iters`` steps of optax's Adam (b1 0.9, b2 0.999, eps 1e-8) on the
        sum of the per-network mean squared errors, each update scaled by its
        network's ``lr_scale`` (axis 0 of every weight)."""
        params = list(student.parameters())
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        scale = [lr_scale.view(-1, *([1] * (p.dim() - 1))) for p in params]
        b1, b2, eps = 0.9, 0.999, 1e-8
        for it in range(1, self.iters + 1):
            pred = self._predict(student, local, dirs)
            loss = torch.mean((pred - tgt) ** 2, dim=(1, 2)).sum()
            grads = torch.autograd.grad(loss, params)
            c1, c2 = 1 - b1**it, 1 - b2**it
            with torch.no_grad():
                for p, g, m, v, s in zip(params, grads, mu, nu, scale):
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    p.sub_(self.lr * s * (m / c1) / ((v / c2).sqrt() + eps))

    def _examples(self, batch: List[Node], n: int):
        """Random points in each node's domain, unit directions and teacher
        targets for the batch's nodes, drawn as the JAX driver draws them
        for its ``max_num_networks`` padded rows (the directions of the
        padding rows are drawn and dropped)."""
        a = len(batch)
        pts = np.zeros((a, n, 3), np.float32)
        for i, node in enumerate(batch):
            pts[i] = self.rng.uniform(node.domain_min, node.domain_max, (n, 3)).astype(np.float32)
        dirs = self.rng.randn(self.N, n, 3).astype(np.float32)[:a]
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        with torch.no_grad():
            rgb, sigma = self.teacher(torch.from_numpy(pts.reshape(-1, 3)).to(self.device),
                                      torch.from_numpy(dirs.reshape(-1, 3)).to(self.device))
        self.teacher_rows += a * n
        tgt = torch.cat([rgb.float(), sigma.float()[:, None]], -1).reshape(a, n, 4)
        local = np.zeros_like(pts)
        for i, node in enumerate(batch):
            span = np.maximum(node.domain_max - node.domain_min, 1e-9)
            local[i] = ((pts[i] - node.domain_min) / span) * 2.0 - 1.0
        return pts, local, dirs, tgt

    def _pop_batch(self) -> Tuple[List[Node], bool]:
        q = self.cp["nodes_to_process"]
        saturated = False
        if not q:
            q = self.cp["saturated_nodes_to_process"]
            saturated = True
        return [q.popleft() for _ in range(min(self.N, len(q)))], saturated

    # ------------------------------------------------------------------
    def run_cycle(self, log=print) -> bool:
        """Fit one node batch; split or accept its nodes. True while nodes remain."""
        cp = self.cp
        if not cp["nodes_to_process"] and not cp["saturated_nodes_to_process"]:
            return False
        if cp["fitted_volume"] / cp["total_volume"] >= self.termination_volume:
            return False

        batch, from_saturated = self._pop_batch()
        n_active = len(batch)
        _, local, dirs, tgt = self._examples(batch, self.E)
        t_pts, t_local, t_dirs, t_tgt = self._examples(batch, self.E_test)
        student = self.init_student(n_active, self.rng.randint(2**31))
        lr_scale = torch.full((n_active,), self.saturation_lr / self.lr if from_saturated else 1.0,
                              device=self.device)
        dev = self.device
        self._adam_fit(student, lr_scale, torch.from_numpy(local).to(dev), torch.from_numpy(dirs).to(dev), tgt)
        with torch.no_grad():
            pred = self._predict(student, torch.from_numpy(t_local).to(dev), torch.from_numpy(t_dirs).to(dev))
        per_net, se_pp, saturation = error_metrics(pred.cpu().numpy(), t_tgt.cpu().numpy())
        best = {m: per_net[m] for m in ("mse", "mae", "mape", "quantile_se")}
        weights = {k: v.detach().cpu().numpy() for k, v in student.state_dict().items()}

        fitted = 0
        for i, node in enumerate(batch):
            split_further = best[self.metric][i] > self.max_error
            if cp["fitted_volume"] / cp["total_volume"] >= self.termination_volume:
                split_further = False
            if split_further:
                if saturation[i] and not from_saturated:
                    cp["saturated_nodes_to_process"].append(node)
                    continue
                if self.tree_type == "kdtree_random":
                    axis = self.rng.randint(3)
                else:
                    axis = int(np.argmax(node.domain_max - node.domain_min))
                node.split_axis = axis
                if self.tree_type == "kdtree_equal_error_split":
                    node.split_threshold = equal_error_split_threshold(t_pts[i], se_pp[i], axis)
                else:
                    node.split_threshold = float(
                        node.domain_min[axis] + (node.domain_max[axis] - node.domain_min[axis]) / 2)
                leq = Node(node.domain_min.copy(), node.domain_max.copy())
                leq.domain_max[axis] = node.split_threshold
                gt = Node(node.domain_min.copy(), node.domain_max.copy())
                gt.domain_min[axis] = node.split_threshold
                node.leq_child, node.gt_child = leq, gt
                target_q = cp["saturated_nodes_to_process"] if from_saturated else cp["nodes_to_process"]
                target_q.append(leq)
                target_q.append(gt)
            else:
                fitted += 1
                cp["fitted_volume"] += calculate_volume(node.domain_min, node.domain_max)
                node.best_error = {m: float(best[m][i]) for m in best}
                node.params = {k: v[i] for k, v in weights.items()}
        cp["num_networks_fitted"] += fitted
        self.last_cycle = {"networks": n_active, "fitted": fitted, "saturated": int(saturation.sum()),
                           "errors": best[self.metric]}

        log(f"distill cycle: {fitted}/{n_active} fitted, {int(saturation.sum())} saturated, "
            f"volume {cp['fitted_volume'] / cp['total_volume']:.1%}, "
            f"queue {len(cp['nodes_to_process'])}+{len(cp['saturated_nodes_to_process'])}sat")
        if self.work_dir:
            with open(os.path.join(self.work_dir, "distill_checkpoint.pkl"), "wb") as fh:
                pickle.dump(cp, fh)
        return bool(cp["nodes_to_process"] or cp["saturated_nodes_to_process"])

    def run(self, max_cycles: int = 10000, log=print):
        c = 0
        while self.run_cycle(log=log) and c < max_cycles:
            c += 1

    # ------------------------------------------------------------------
    def lookup(self, p: np.ndarray) -> Optional[Node]:
        """Point -> leaf node via the kd-tree."""
        for root in self.cp["root_nodes"]:
            if np.all(p >= root.domain_min) and np.all(p <= root.domain_max):
                node = root
                while node.leq_child is not None:
                    node = node.leq_child if p[node.split_axis] <= node.split_threshold else node.gt_child
                return node
        return None

    def assemble_grid(self, resolution: Sequence[int]) -> Dict[str, np.ndarray]:
        """Fitted per-node weights stacked onto a uniform [prod(res)]-network
        grid for the finetune field: each cell centre looks up its leaf;
        cells without a fitted leaf get zeros. Keys are the field's leaf
        names, sorted. Call it after a fit: before any node is fitted it
        raises ``RuntimeError("no fitted nodes")``, as the JAX driver does."""
        res = np.asarray(resolution)
        cell = (self.dmax - self.dmin) / res
        example = self._example_params()
        names = sorted(example)
        stacked: Dict[str, list] = {m: [] for m in names}
        for i in range(res[0]):
            for j in range(res[1]):
                for k in range(res[2]):
                    node = self.lookup(self.dmin + cell * (np.array([i, j, k]) + 0.5))
                    p = node.params if node is not None and node.params else None
                    for m in names:
                        stacked[m].append(p[m] if p is not None else np.zeros_like(example[m]))
        return {m: np.stack(v) for m, v in stacked.items()}

    def _example_params(self) -> Dict[str, np.ndarray]:
        for root in self.cp["root_nodes"]:
            stack = [root]
            while stack:
                n = stack.pop()
                if n.params is not None:
                    return n.params
                if n.leq_child is not None:
                    stack += [n.leq_child, n.gt_child]
        raise RuntimeError("no fitted nodes")
