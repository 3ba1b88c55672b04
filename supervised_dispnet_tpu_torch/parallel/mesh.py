"""Data-parallel training over processes: the port of the data axis of
``supervised_dispnet_tpu/parallel/mesh.py``.

The JAX package shards the batch axis over a ``jax.sharding.Mesh`` of the
devices one process sees, and XLA computes every reduction over the batch
over the global batch. Here each rank is a process of its own, PyTorch's
idiom:

    python -m torch.distributed.run --nproc-per-node N \\
        -m supervised_dispnet_tpu_torch.cli.train <data> -b <global batch> ...

A ``Mesh`` is this process's view of the data axis: its size (the number of
ranks), its rank, and the process group. Rank r takes the contiguous rows
``[r B / N, (r + 1) B / N)`` of each global batch of B (``Mesh.rows``). The
same rule holds every batch-wide reduction global:

- ``all_reduce_sum`` sums over the ranks forward and backward (an autograd
  function): each masked sum and count of a loss, BatchNorm's sums, the
  validation metrics' sums;
- ``all_reduce_max`` takes a detached max over the ranks: BerHu's threshold,
  QAT's activation scales;
- ``average_gradients`` averages the gradients over the ranks in one
  all-reduce a micro-step.

With these, each rank's gradient is that of its share of the mean over the
ranks of their losses, and the mean over the ranks of the gradients is the
gradient of the global batch's loss, as the JAX mesh computes it.

``make_mesh(spatial=S)`` adds the spatial axis (``parallel/spatial.py``):
the world is ``data x spatial``, rank r the data rank ``r // S`` and the
spatial rank ``r % S`` (the layout of JAX's ``reshape(n // spatial,
spatial)``). The ranks of one spatial group take the same batch rows
(``Mesh.rows`` goes by the data rank) and each takes a band of image rows.
The reductions above stay over the whole world, which is right for both
axes: every sum and max then covers every row of every image once, and a
rank's gradient is that of the ops on its own rows, with the halo
exchanges' backward carrying each halo row's gradient to the rank that
owns the row. So ``average_gradients`` still divides by the world size.

The reductions read the active mesh (``use_mesh``), which the train and
eval steps set around their forward and backward. Outside it, and on a mesh
of one rank, every function here returns its input as it is: a process
without a process group runs exactly as it would without this module.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


@dataclasses.dataclass
class Mesh:
    """The mesh as this process sees it: ``size`` ranks of the process
    group, this one ``rank``, over ``backend``, in ``size // spatial`` data
    rows of ``spatial`` ranks (``spatial_group``: this rank's row, the ranks
    that share its batch rows; ``data_group``: its column). While ``timed``
    is set, ``collective_s`` adds up the host seconds spent in the
    all-reduces and ``halo_s`` those in the halo exchanges (each waits for
    the card first, so that it does not count the work queued before it)."""

    size: int = 1
    rank: int = 0
    backend: str | None = None
    timed: bool = False
    collective_s: float = 0.0
    spatial: int = 1
    halo_s: float = 0.0
    spatial_group: object = dataclasses.field(default=None, repr=False, compare=False)
    data_group: object = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def data_size(self) -> int:
        return self.size // self.spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.spatial

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes checkpoints, logs and traces, and prints."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n``: its data
        rank's, which every rank of its spatial group shares."""
        if n % self.data_size:
            raise ValueError(f"the global batch size {n} is not divisible by the "
                             f"{self.data_size} ranks of the data axis")
        b = n // self.data_size
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the ranks in place (``op``: sum or max)."""
        reduce_op = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        if self.timed:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            t0 = time.perf_counter()
        dist.all_reduce(t, op=reduce_op)
        if self.timed:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            self.collective_s += time.perf_counter() - t0
        return t

    def exchange(self, t: torch.Tensor) -> list[torch.Tensor]:
        """``t`` of every rank of this rank's spatial group, in spatial rank
        order (one all-gather; the tensors are alike in shape on every
        rank). Raises where the exchange fails."""
        parts = [torch.empty_like(t) for _ in range(self.spatial)]
        if self.timed:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            t0 = time.perf_counter()
        dist.all_gather(parts, t.contiguous(), group=self.spatial_group)
        if self.timed:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            self.halo_s += time.perf_counter() - t0
        return parts

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank (a picklable object)."""
        if not dist.is_initialized():
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def make_mesh(spatial: int = 1) -> Mesh:
    """The mesh over the process group this process joined (one rank when
    it joined none): ``data x spatial``, with a process group for each
    spatial row and each data column where ``spatial > 1``. A world that
    ``spatial`` does not divide raises ``ValueError``, as the JAX trainer
    does."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if spatial < 1 or world % spatial:
        raise ValueError(f"--spatial-shards {spatial} must divide the {world} rank(s) of "
                         "the world (spatial partitioning)")
    if not dist.is_initialized():
        return Mesh()
    mesh = Mesh(size=world, rank=dist.get_rank(), backend=str(dist.get_backend()),
                spatial=spatial)
    if spatial > 1:
        # every rank makes every group, in the same order
        for d in range(world // spatial):
            group = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
            if d == mesh.data_rank:
                mesh.spatial_group = group
        for s in range(spatial):
            group = dist.new_group(list(range(s, world, spatial)))
            if s == mesh.spatial_rank:
                mesh.data_group = group
    return mesh


def spatial_size(mesh: Mesh | None) -> int:
    """Number of spatial shards (1 without a mesh)."""
    return 1 if mesh is None else mesh.spatial


def choose_backend(device_type: str, local_ranks: int, cards: int) -> str:
    """``nccl`` when each of the node's ``local_ranks`` has a card of its own
    (``cards`` on the node), ``gloo`` otherwise: ranks that share a card
    (NCCL refuses two ranks on one device), or the CPU."""
    return "nccl" if device_type == "cuda" and 0 < local_ranks <= cards else "gloo"


def launched() -> bool:
    """Whether this process was started by ``torch.distributed.run`` (or
    anything else that sets its environment: RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def init_from_env(device: str | torch.device = "cuda",
                  spatial: int = 1) -> tuple[torch.device, Mesh]:
    """Join the process group that the launcher's environment describes and
    return this rank's device and the mesh (``make_mesh(spatial)``); without
    that environment, the device as given and a mesh of one rank (no
    process group; ``spatial > 1`` then raises).

    Rank r of a node uses ``cuda:{LOCAL_RANK}``, or card ``LOCAL_RANK % cards``
    where the node's ranks outnumber its cards. The backend follows
    ``choose_backend``, decided once from the layout and printed by rank 0."""
    dev = torch.device(device)
    if not launched():
        if spatial > 1:
            raise ValueError(f"--spatial-shards {spatial} must divide the 1 rank of a "
                             "process the launcher did not start (spatial partitioning)")
        return dev, Mesh()
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    world = int(os.environ["WORLD_SIZE"])
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, local_ranks, cards)
    if dev.type == "cuda" and cards > 0:
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    mesh = make_mesh(spatial)
    if mesh.is_main:
        where = (f"{local_ranks} rank(s) on {cards} card(s) of this node" if dev.type == "cuda"
                 else "the CPU")
        axes = f", {mesh.data_size} data x {spatial} spatial" if spatial > 1 else ""
        print(f"=> data-parallel: {mesh.size} rank(s){axes}, backend {backend} ({where})",
              flush=True)
    return dev, mesh


def shutdown() -> None:
    """Leave the process group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


# the mesh the steps run under (``use_mesh``); None outside a step and on one
# rank. A module global, not a context variable: the backward may recompute
# (remat) in the autograd engine's own thread, and it must see the mesh too.
_ACTIVE: Mesh | None = None


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Make ``mesh`` the one the reductions read inside the block (a mesh of
    one rank, or None, leaves none active)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.size > 1 else None
    try:
        yield
    finally:
        _ACTIVE = prev


def active_mesh() -> Mesh | None:
    """The mesh of more than one rank that the current step runs under, or None."""
    return _ACTIVE


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks forward, and of the upstream gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.detach().clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone(memory_format=torch.contiguous_format)), None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the active mesh, differentiable: its
    backward sums the upstream gradient over the ranks. ``x`` itself
    without an active mesh."""
    if _ACTIVE is None:
        return x
    return _AllReduceSum.apply(x, _ACTIVE)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """``x`` (detached) maxed over the ranks of the active mesh; ``x``
    itself without an active mesh."""
    if _ACTIVE is None:
        return x
    return _ACTIVE.all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), "max")


def global_sums(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """0-d float32 sums over this rank's rows -> the same sums over the
    global batch, in one all-reduce (differentiable); unchanged without an
    active mesh."""
    if _ACTIVE is None:
        return xs
    return tuple(all_reduce_sum(torch.stack(xs)).unbind())


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """A mean over this rank's rows -> the mean over the global batch (the
    ranks' rows are equal in number), detached; unchanged without an
    active mesh."""
    mesh = _ACTIVE
    if mesh is None:
        return x
    return mesh.all_reduce_(x.detach().clone(memory_format=torch.contiguous_format)) / mesh.size


def average_gradients(grads: list[torch.Tensor], mesh: Mesh,
                      extra: torch.Tensor | None = None) -> tuple[list[torch.Tensor],
                                                                  torch.Tensor | None]:
    """The mean over the ranks of each gradient, in one all-reduce of a
    flattened buffer; returns views into it shaped as ``grads``, and, when
    given, the mean of ``extra`` (a 0-d float32 tensor, e.g. the loss)
    carried in the same buffer."""
    parts = [g.reshape(-1) for g in grads]
    if extra is not None:
        parts.append(extra.detach().reshape(1).to(parts[0].dtype if parts else torch.float32))
    flat = torch.cat(parts)
    mesh.all_reduce_(flat)
    flat.div_(mesh.size)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out, (flat[at] if extra is not None else None)


def shard_batch(batch: dict, mesh: Mesh, device: str | torch.device = "cpu") -> dict:
    """This rank's rows of a global batch (a dict of arrays or tensors with
    the batch leading), as tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        out[k] = torch.as_tensor(v[mesh.rows(len(v))]).to(device)
    return out
