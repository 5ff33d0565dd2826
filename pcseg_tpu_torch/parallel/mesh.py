"""The data axis of one process per device: the port's counterpart of
pcseg_tpu/parallel/mesh.py.

The JAX package drives every device from one process: a
``jax.sharding.Mesh`` with a ``data`` axis, the batch sharded over it,
parameters replicated, gradients combined by ``psum``. PyTorch's idiom
is one process per device on ``torch.distributed``, so here a ``Mesh`` is
this process's place in the default process group: the data axis's size
(the world size), this rank, and this rank's device. Rank r holds rows
[r·B/n, (r+1)·B/n) of each global batch of B rows, exactly the shard
JAX's ``P('data')`` gives device r, so a step here can be held against
the JAX mesh step row for row. The collectives the steps need are the
mesh's methods; where no process group is initialized the mesh has one
rank and each collective returns its input.

``make_mesh`` takes the default group as the caller (``torchrun``,
``initialize_distributed``, a test's ``FileStore``) made it. The
``model`` axis (sp, tp, gp) raises until those strategies are ported
(ROADMAP A9b-A9d).
"""

from __future__ import annotations

import dataclasses
import os
import torch
import torch.distributed as dist

from pcseg_tpu_torch.core.device import resolve_device

@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """How to carve the ranks into a logical mesh."""

    data: int = 0    # 0 = all remaining ranks
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else max(1, n_devices // model)
        if data * model > n_devices:
            raise ValueError(
                f"mesh {data}x{model} needs {data * model} devices, "
                f"have {n_devices}"
            )
        return data, model


class _PSum(torch.autograd.Function):
    """Sum all-reduce whose backward all-reduces the cotangent (psum's
    transpose: every rank's output feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the data axis. ``distributed``: whether a
    process group carries the collectives (False: one rank, and each
    collective is the identity)."""

    data: int
    rank: int
    device: torch.device
    distributed: bool

    def rows(self, b: int) -> slice:
        """This rank's rows of a global batch of ``b`` rows."""
        if b % self.data:
            raise ValueError(f"batch of {b} rows is not divisible by the "
                             f"mesh data axis ({self.data})")
        n = b // self.data
        return slice(self.rank * n, (self.rank + 1) * n)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum over the data axis."""
        return _PSum.apply(t) if self.distributed else t

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the data axis, in place, outside autograd."""
        if self.distributed:
            dist.all_reduce(t)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        if self.distributed:
            dist.broadcast(t, src)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on all), concatenated along dim 0
        in rank order."""
        if not self.distributed:
            return t
        parts = [torch.empty_like(t) for _ in range(self.data)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()


def rank_device(rank: int, device=None) -> torch.device:
    """The device of rank ``rank``: ``device`` where it names one
    ("cpu", "cuda:1"), else ``cuda:{LOCAL_RANK}`` (the launcher's), else
    ``cuda:{rank % device_count}``. No CUDA device raises
    (``core/device.resolve_device``)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else \
        rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def make_mesh(spec: MeshSpec = MeshSpec(), device=None) -> Mesh:
    """The mesh over the initialized default process group, or over one
    rank where none is. The data axis spans every rank (one process per
    device); ``spec.model`` above 1 raises NotImplementedError until the
    model-axis strategies are ported. ``device``: None for this rank's
    CUDA device (``rank_device``), ``"cpu"`` for the plain versions. A
    CUDA device becomes the current one."""
    if spec.model > 1:
        raise NotImplementedError(
            f"mesh 'model' axis of {spec.model}: the model-axis strategies "
            "(parallel/sp.py, tp.py, gp.py) are not ported yet (ROADMAP "
            "A9b-A9d)")
    distributed = dist.is_available() and dist.is_initialized()
    world, rank = ((dist.get_world_size(), dist.get_rank()) if distributed
                   else (1, 0))
    data, _ = spec.resolve(world)
    if data != world:
        raise ValueError(
            f"mesh data axis {data} on {world} ranks: with one process per "
            f"device the data axis spans every rank (data=0 or {world})")
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(data=data, rank=rank, device=dev, distributed=distributed)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of every array or tensor of ``batch`` (a tuple,
    list or dict of them, batch dim first): the shard JAX's
    ``shard_batch`` places on device ``mesh.rank``. A batch not divisible
    by the data axis raises ValueError."""
    return _tree_map(lambda x: x[mesh.rows(x.shape[0])], batch)


def psum_mean(tree, mesh: Mesh):
    """Mean over the data axis of every tensor of ``tree``
    (differentiable)."""
    return _tree_map(lambda t: mesh.psum(t) / mesh.data, tree)


def launcher_address() -> str | None:
    """``"env://"`` where a launcher (``torchrun``) set the rendezvous
    variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), else None."""
    keys = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    return "env://" if all(k in os.environ for k in keys) else None


_distributed_initialized: tuple | bool = False


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device=None) -> bool:
    """Multi-process bring-up; a no-op (False) without an address.

    ``coordinator_address``: "host:port" (``tcp://``) or an init_method
    URL ("env://", "file://..."). ``num_processes`` / ``process_id``:
    the world size and this rank; None takes the launcher's WORLD_SIZE /
    RANK. The backend is ``nccl`` where the device (``device``, None for
    CUDA) is a card, ``gloo`` on the CPU. Reached from training through
    ``train.coordinator_address`` / ``num_processes`` / ``process_id``
    (``init_from_config``). Repeating the call with
    the same arguments does nothing; other arguments raise RuntimeError
    ("already initialized"). A group the caller initialized itself is
    left as it is (False), unless the arguments name another world size
    or rank. Returns True iff this call initialized the group."""
    global _distributed_initialized
    if not coordinator_address:
        return False
    args = (coordinator_address, num_processes, process_id)
    if _distributed_initialized:
        if _distributed_initialized != args:
            raise RuntimeError(
                f"torch.distributed already initialized with "
                f"{_distributed_initialized}; cannot re-initialize with "
                f"{args} in the same process")
        return False
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if num_processes not in (None, world) or \
                process_id not in (None, rank):
            raise RuntimeError(
                f"torch.distributed already initialized with world size "
                f"{world}, rank {rank}; cannot re-initialize with {args}")
        return False
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if not url.startswith("env://") and (num_processes is None
                                         or process_id is None):
        raise ValueError(
            f"initialize_distributed({coordinator_address!r}) needs "
            "num_processes and process_id (train.num_processes / "
            "train.process_id) outside a launcher that sets WORLD_SIZE and "
            "RANK")
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend=backend, init_method=url,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    _distributed_initialized = args
    return True


def init_from_config(t_cfg, device=None) -> bool:
    """``initialize_distributed`` from a TrainConfig: its
    ``coordinator_address`` (else the launcher's ``env://``),
    ``num_processes`` (0: the launcher's) and ``process_id`` (-1: the
    launcher's). Training calls this before its first device query, as
    the JAX loop calls ``jax.distributed.initialize``."""
    return initialize_distributed(
        t_cfg.coordinator_address or launcher_address(),
        t_cfg.num_processes or None,
        t_cfg.process_id if t_cfg.process_id >= 0 else None, device=device)


def shutdown_distributed() -> None:
    """Destroy the group ``initialize_distributed`` made, and forget it,
    so that a later call may initialize one again. A group the caller
    made is left alone."""
    global _distributed_initialized
    if _distributed_initialized:
        dist.destroy_process_group()
        _distributed_initialized = False
