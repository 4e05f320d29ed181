"""Ranks as a ('data', 'model') mesh, and the collectives the port runs on
it — port of ``xrnerf_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a 2-D ``jax.sharding.Mesh`` and
lets GSPMD insert the collectives, so a sharded program still computes the
global function. Here each rank is one process (one card, or a CPU process
over gloo) and the collectives are explicit; the result is held to the same
rule: D data ranks give what one process gives on the whole batch.

- ``data`` axis: each data rank holds rows ``[r n, (r + 1) n)`` of the
  step's global batch of ``D n`` rays (the datasets' ``host_id`` /
  ``num_hosts``). The step's random draws cover the global batch and each
  rank keeps its rows (:class:`StepGenerator`, :func:`draw`); the loss runs
  on the global rows (:func:`global_view`); the gradients are summed over
  the data group.
- ``model`` axis: a network's ``param_spec(name)`` names the parameters cut
  along one dimension over the model group (KiloNeRF's expert stacks,
  Instant-NGP's hash table); a rank holds its slice, computes a partial
  result and sums it over the group (:func:`reduce_from`, with
  :func:`copy_to` as its mirror).

Rank ``d * n_model + m`` sits at data index d and model index m, the model
axis innermost, as ``np.asarray(devices).reshape(n // n_model, n_model)``
lays out the JAX mesh.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(coordinator: Optional[str] = None, backend: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None, **kw) -> bool:
    """Join the process group; a no-op for a single process.

    The address, world size and rank come from the arguments
    (``coordinator="tcp://host:port"``) or from torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). Without either it returns False.
    The backend is NCCL when CUDA is present and gloo otherwise, or the one
    asked for. NCCL needs a card per rank: this raises when the host's ranks
    outnumber its cards; two ranks that share a card go over gloo. With
    NCCL the rank's card (``LOCAL_RANK``) becomes the current device.
    Returns True once the group is up."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator is None and "WORLD_SIZE" not in env:
        return False
    world_size = int(world_size if world_size is not None else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        n_cards = torch.cuda.device_count()
        if local_world > n_cards:
            raise RuntimeError(
                f"NCCL needs a card per rank: {local_world} ranks on this host, {n_cards} card(s); "
                "share a card over backend='gloo'"
            )
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=coordinator or "env://", world_size=world_size, rank=rank, **kw)
    return True


def is_main() -> bool:
    """True on global rank 0, or when no process group is up: the rank that
    writes logs, images, JSON and checkpoints."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def local_device(device="cuda") -> torch.device:
    """``device`` with a CUDA rank's own card: ``cuda:LOCAL_RANK`` under
    torchrun, the device as given otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def mesh_shape(n_ranks: int, n_model: int = 1, allow_fewer: bool = True) -> Tuple[int, int]:
    """(data size, model size) of ``n_ranks`` ranks; an ``n_model`` that does
    not divide them degrades to pure data parallelism, as the JAX
    ``make_mesh(allow_fewer=True)`` does."""
    if n_ranks % n_model != 0:
        if not allow_fewer:
            raise ValueError(f"{n_ranks} ranks not divisible by n_model={n_model}")
        n_model = 1
    return n_ranks // n_model, n_model


def mesh_ranks(n_ranks: int, n_model: int = 1, allow_fewer: bool = True) -> np.ndarray:
    """[data, model] array of the global ranks, the model axis innermost."""
    return np.arange(n_ranks).reshape(mesh_shape(n_ranks, n_model, allow_fewer))


class RowShard(NamedTuple):
    """Where a rank's rows sit in the global batch: rows
    ``[rank * n, (rank + 1) * n)`` of ``size * n``, over ``group``."""

    rank: int
    size: int
    group: Optional[object]


class Mesh:
    """The ('data', 'model') layout of the ranks, with a process group per
    axis. ``data_group`` joins the ranks of one model index (the gradient
    all-reduce); ``model_group`` the ranks of one data index (the partial
    sums), None where the model axis has one rank. Without a process group
    (one process) both groups are None and every collective is the
    identity."""

    def __init__(self, ranks: np.ndarray, rank: int, data_group=None, model_group=None):
        self.ranks = ranks
        self.rank = rank
        self.data_size, self.model_size = ranks.shape
        self.data_rank, self.model_rank = (int(i) for i in np.argwhere(ranks == rank)[0])
        self.data_group, self.model_group = data_group, model_group

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data_size, MODEL_AXIS: self.model_size}

    @property
    def rows(self) -> RowShard:
        return RowShard(self.data_rank, self.data_size, self.data_group)

    def __repr__(self) -> str:
        return f"Mesh(data={self.data_size}, model={self.model_size}, rank={self.rank})"

    def __deepcopy__(self, memo) -> "Mesh":
        return self  # a module's copy (the trainer's EMA network) shares its process groups


def make_mesh(n_model: int = 1, allow_fewer: bool = True) -> Mesh:
    """The mesh over every rank of the process group (one rank without
    one). Every rank must call it, in the same order as any other group it
    makes, since each group is made by all ranks."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(mesh_ranks(1, 1), 0)
    ranks = mesh_ranks(dist.get_world_size(), n_model, allow_fewer)
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(ranks.shape[1]):
        g = dist.new_group([int(r) for r in ranks[:, m]])
        if rank in ranks[:, m]:
            data_group = g
    if ranks.shape[1] > 1:
        for d in range(ranks.shape[0]):
            g = dist.new_group([int(r) for r in ranks[d]])
            if rank in ranks[d]:
                model_group = g
    return Mesh(ranks, rank, data_group, model_group)


def shard_batch(batch: Mapping[str, np.ndarray], rank: int, size: int) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s rows of a global batch of ``size`` equal parts (the
    JAX package places a batch with ``P('data')``); ``ctx_*`` keys and 0-d
    arrays are context every rank holds whole."""
    def part(k, v):
        if k.startswith("ctx_") or np.ndim(v) == 0:
            return v
        n = v.shape[0] // size
        return v[rank * n:(rank + 1) * n]

    return {k: part(k, v) for k, v in batch.items()}


def pad_to_multiple(batch: Mapping[str, np.ndarray], multiple: int) -> Dict[str, np.ndarray]:
    """Pad the leading dim to a multiple by repeating the last row."""
    n = next(iter(batch.values())).shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return dict(batch)
    return {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0) for k, v in batch.items()}


# --- collectives -------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` (equal shapes) concatenated along dim 0 in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts) if x.dim() else torch.stack(parts)


class _SumForward(torch.autograd.Function):
    """Sum over the group forward, identity backward: partial results of the
    model axis, whose consumers are replicated over the group so that each
    rank already holds the whole gradient (``torch.distributed.nn``'s
    all_reduce would sum that gradient again, n_model times too large)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """Identity forward, sum over the group backward: a replicated input of
    partial computations, whose gradient is the sum of the partials'."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 forward; backward keeps this rank's rows of the
    gradient, since every rank runs the same loss on the gathered rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (identity backward); ``x`` with no group."""
    return x if group is None else _SumForward.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (its gradient summed over ``group``); ``x`` with no group."""
    return x if group is None else _SumBackward.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-gather along dim 0; ``x`` with no group."""
    return x if group is None else _GatherRows.apply(x, group)


def rows_before(counts: torch.Tensor, rows: Optional[RowShard]) -> torch.Tensor:
    """Sum of ``counts`` over the data ranks below this one (zeros for one
    process): where this rank's rows start in a global order."""
    if rows is None or rows.group is None:
        return torch.zeros_like(counts)
    every = all_gather_rows(counts[None], rows.group)  # [D, ...]
    return every[: rows.rank].sum(dim=0)


def any_rank(flag: bool, mesh: Optional[Mesh], device) -> bool:
    """True where ``flag`` is on any rank (a host sync; call it rarely)."""
    if mesh is None or mesh.data_group is None and mesh.model_group is None:
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_buffers(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Global rank 0's buffers on every rank (the occupancy grid after a
    refresh)."""
    if mesh is None or not dist.is_initialized():
        return
    with torch.no_grad():
        for b in module.buffers():
            dist.broadcast(b, src=0)


# --- the step's random draws -------------------------------------------------------


class StepGenerator(torch.Generator):
    """A step's random stream. Under a mesh ``rows`` says which rows of the
    global batch this rank holds, so that :func:`draw` takes the draw one
    process makes for the whole batch and keeps these rows; networks read it
    for their batch-level rules too (KiloNeRF's capacity, Instant-NGP's
    sample budget)."""

    rows: Optional[RowShard] = None


def draw(fn: Callable, shape: Sequence[int], generator: torch.Generator, **kw) -> torch.Tensor:
    """``fn(shape, generator=generator, **kw)`` (``torch.rand``/``randn``) of a
    tensor whose dim 0 runs over the batch's rows; with a sharded generator,
    the global draw's rows of this rank."""
    rows = getattr(generator, "rows", None)
    if rows is None or rows.size == 1:
        return fn(tuple(shape), generator=generator, **kw)
    n = shape[0]
    return fn((n * rows.size, *shape[1:]), generator=generator, **kw)[rows.rank * n:(rows.rank + 1) * n]


# --- the loss on the global rows ---------------------------------------------------


class _GlobalRows(Mapping):
    """A read-only view of a rank's outputs or batch as the global batch's:
    a tensor of the rank's ``n`` rows is all-gathered over the data group on
    first read; a 0-d output is summed over it (a count, or a network's share
    of a global mean), while a 0-d batch entry, like a ``ctx_*`` key, is
    context every rank holds and passes as it is."""

    def __init__(self, local: Mapping[str, torch.Tensor], n: int, group, sum_scalars: bool):
        self._local, self._n, self._group, self._sum = local, n, group, sum_scalars
        self._done = {}

    def __getitem__(self, k):
        if k not in self._done:
            v = self._local[k]
            if not torch.is_tensor(v) or k.startswith("ctx_") or (v.dim() == 0 and not self._sum):
                self._done[k] = v
            elif v.dim() == 0:
                self._done[k] = reduce_from(v, self._group)
            elif v.shape[0] == self._n:
                self._done[k] = gather_rows(v, self._group)
            else:
                raise ValueError(f"output {k!r} {tuple(v.shape)} has no row axis of the batch's {self._n} rows")
        return self._done[k]

    def __iter__(self):
        return iter(self._local)

    def __len__(self):
        return len(self._local)

    def __contains__(self, k):
        return k in self._local


def global_view(outputs: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor], rows: RowShard):
    """(outputs, batch) as the global batch's, gathered lazily: the loss reads
    the keys it needs, each once, and a loss with a batch-level statistic
    (a denominator over the batch, a PSNR of the batch's MSE) takes it over
    the global batch."""
    n = next(v.shape[0] for k, v in batch.items() if not k.startswith("ctx_") and v.dim() > 0)
    return _GlobalRows(outputs, n, rows.group, True), _GlobalRows(batch, n, rows.group, False)


# --- model-axis placement ----------------------------------------------------------


def spec_dim(spec) -> Optional[int]:
    """The dimension a spec (a tuple of axis names or None, as a JAX
    ``PartitionSpec``) cuts on the model axis, or None."""
    if spec is None:
        return None
    spec = tuple(spec)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def sharded_dims(names: Sequence[str], param_spec, mesh: Optional[Mesh]) -> Dict[str, int]:
    """{parameter name: dim} of the parameters cut over the model axis."""
    if mesh is None or mesh.model_size == 1 or param_spec is None:
        return {}
    return {n: d for n in names if (d := spec_dim(param_spec(n))) is not None}


def take_shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of a full tensor along ``dim``."""
    size = t.shape[dim]
    if size % mesh.model_size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {mesh.model_size} model ranks")
    k = size // mesh.model_size
    return t.narrow(dim, mesh.model_rank * k, k).clone()


def gather_shards(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The full tensor from the model group's slices along ``dim``."""
    parts = [torch.empty_like(t) for _ in range(mesh.model_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=dim)


def shard_module(module: torch.nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Cut ``module``'s parameters by its ``param_spec`` to this model rank's
    slices, and hand ``mesh`` to every submodule that reads one (a
    ``mesh`` attribute). Returns the cut parameters' {name: dim}."""
    dims = sharded_dims([n for n, _ in module.named_parameters()], getattr(module, "param_spec", None), mesh)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, dim in dims.items():
            params[name].data = take_shard(params[name].data, dim, mesh)
    for m in module.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    return dims


def model_group(module) -> Optional[object]:
    """The model-axis group of a submodule's mesh, None without one."""
    mesh = getattr(module, "mesh", None)
    return None if mesh is None else mesh.model_group


def full_state(state: Mapping[str, torch.Tensor], dims: Mapping[str, int], mesh: Optional[Mesh]) -> Dict:
    """A state dict with the cut entries gathered to full tensors (every rank
    of the model group takes part)."""
    if not dims:
        return dict(state)
    return {k: gather_shards(v, dims[k], mesh) if k in dims else v for k, v in state.items()}


def local_state(state: Mapping[str, torch.Tensor], dims: Mapping[str, int], mesh: Optional[Mesh]) -> Dict:
    """A full state dict cut to this rank's slices."""
    if not dims:
        return dict(state)
    return {k: take_shard(v, dims[k], mesh) if k in dims else v for k, v in state.items()}


def reduce_gradients(params: List[torch.Tensor], mesh: Mesh) -> None:
    """Sum the gradients over the data group, in one flat buffer. Each rank's
    gradient is its rows' share of the global loss's, so the sum is the
    global gradient."""
    if mesh.data_group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def clip_grad_norm_(params: List[torch.Tensor], max_norm: float, sharded: Sequence[bool], mesh: Mesh) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` with the norm of the whole model:
    the squared norms of the parameters cut over the model axis are summed
    over the model group first. Call it after :func:`reduce_gradients`."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    sq = [torch.linalg.vector_norm(p.grad).square() for p, s in zip(params, sharded) if p.grad is not None and not s]
    cut = [torch.linalg.vector_norm(p.grad).square() for p, s in zip(params, sharded) if p.grad is not None and s]
    if cut:
        sq.append(reduce_from(torch.stack(cut).sum(), mesh.model_group))
    total = torch.stack(sq).sum().sqrt()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)
    return total
