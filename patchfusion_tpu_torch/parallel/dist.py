"""Process groups for scale-out: the port's counterpart of
patchfusion_tpu/parallel/mesh.py.

The JAX package runs one process per host over a `jax.sharding.Mesh` of its
local devices: a `data` axis (batch-sharded training, where GSPMD inserts
the gradient psum and turns every BatchNorm into a SyncBN) and a `patch`
axis (the tile batch of the inference engine sharded over devices). The
port runs one process per device (a rank) in torch.distributed's default
group, so a JAX mesh of N local devices is N ranks here:

  * data parallelism: each rank loads its `ShardedSampler` shard; the
    fusion stage's BatchNorms and SILog reduce over the global batch
    (`all_reduce_sum`, differentiable), and the gradients are averaged
    across ranks before the clip and AdamW (engine/training.py);
  * tile parallelism: `PatchMesh` splits each pass's tiles across the
    ranks, which sum their canvases (engine/inference.py).

Launch with torchrun (`torchrun --nproc-per-node N -m
patchfusion_tpu_torch.tools.train ...`: RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) or with the JAX package's flags
(`--coordinator host:port --num-processes N --process-id R`). Without
either the world is one process and no group is created, so no collective
runs and every single-process number stays as it was.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

# a generous limit: ranks skew by minutes where one of them compiles,
# validates or writes a checkpoint while the others wait in a collective
TIMEOUT = datetime.timedelta(minutes=30)


def world_size() -> int:
    """Ranks in the default group; 1 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def local_rank() -> int:
    """This rank's index on its host (local_index)."""
    return local_index(rank(), torch.cuda.device_count())


def local_index(rank_: int, cards: int) -> int:
    """A rank's index on its host: torchrun's LOCAL_RANK where it is set,
    else (the JAX flags) the rank modulo the host's `cards`, which holds
    where every host runs one rank per card with consecutive ranks (set
    LOCAL_RANK for another layout)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank_ % max(cards, 1)


def nccl_card(rank_: int, num_processes: int, coordinator: Optional[str],
              cards: int) -> int:
    """The card an nccl rank takes (local_index), or a RuntimeError where
    it would share one: NCCL refuses two ranks of one communicator on one
    device. Two ranks share a card where the local index is past the
    host's cards, or where the JAX flags' coordinator is this host's
    loopback (so every rank is on this host) and there are more ranks
    than cards."""
    local = local_index(rank_, cards)
    host = (coordinator or "").rsplit(":", 1)[0].strip("[]")
    one_host = host in ("localhost", "127.0.0.1", "::1")
    if local >= cards or ("LOCAL_RANK" not in os.environ and one_host
                          and num_processes > cards):
        raise RuntimeError(
            f"nccl: rank {rank_} of {num_processes} has no card of its own "
            f"({cards} visible); NCCL refuses two ranks of one "
            "communicator on one device. Start at most one rank per card, "
            "or pass backend='gloo'")
    return local


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda") -> int:
    """Join the default process group; returns the world size.

    The JAX flags map to init_method tcp://<coordinator>, world_size and
    rank; with --num-processes 1 no group is created, as in the JAX
    package. Without them torchrun's environment (WORLD_SIZE, RANK,
    MASTER_ADDR, MASTER_PORT) is read, and a group is made even of one
    rank. With neither no group is created. Collectives run only where
    the group has more than one rank. The backend defaults to nccl for a
    CUDA `device` and gloo for the CPU; a rank's card is its index on its
    host (local_index: LOCAL_RANK, else the rank modulo the host's cards);
    nccl cannot hold two ranks of one communicator on one card, so where
    two ranks would share a card it raises (nccl_card; pass
    backend="gloo" to run them there). The first
    collective, a barrier, runs here, while every rank is at the
    rendezvous (the JAX package warms its collectives at init for the same
    reason, mesh.py:76-94)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if num_processes is None:
        if coordinator is not None or process_id is not None:
            raise ValueError("--coordinator and --process-id need "
                             "--num-processes")
        if "WORLD_SIZE" not in os.environ:
            return 1
        num_processes = int(os.environ["WORLD_SIZE"])
        init_method, rank_ = "env://", int(os.environ["RANK"])
    else:
        if num_processes <= 1:
            return 1
        if coordinator is None or process_id is None:
            raise ValueError(f"--num-processes {num_processes} needs "
                             "--coordinator and --process-id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"--process-id {process_id} is not in "
                             f"[0, {num_processes})")
        init_method, rank_ = f"tcp://{coordinator}", process_id
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {}
    if backend == "nccl":
        local = nccl_card(rank_, num_processes, coordinator,
                          torch.cuda.device_count())
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=rank_,
                            timeout=TIMEOUT, **kw)
    dist.barrier()
    return num_processes


def init_rank(device, coordinator: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None) -> torch.device:
    """The entry points' start: join the group the launcher describes (the
    JAX flags, or torchrun's variables; init_distributed) and return this
    rank's device (device_for_rank). Raises where CUDA is asked for and
    missing."""
    from patchfusion_tpu_torch.models.builder import check_device

    device = check_device(device)
    init_distributed(coordinator, num_processes, process_id, device=device)
    return device_for_rank(device)


def shutdown() -> None:
    """Leave the process group, where there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def device_for_rank(device) -> torch.device:
    """This rank's device: `cuda` becomes cuda:<local rank> (modulo the
    visible cards, so gloo ranks may share one; local_index) and is made
    current; a
    CPU device or an indexed CUDA device is returned as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    device = torch.device("cuda", local_rank() % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


@dataclasses.dataclass(frozen=True)
class PatchMesh:
    """The tile split of the inference engine over the default group:
    `size` ranks, this one `rank`. The port's form of the JAX package's
    1-D `patch` mesh (make_patch_mesh)."""
    size: int
    rank: int = 0


def make_patch_mesh() -> PatchMesh:
    """A PatchMesh over every rank of the default group."""
    return PatchMesh(world_size(), rank())


def resolve_cli_mesh(arg: str) -> Optional[PatchMesh]:
    """The CLI `--mesh` policy of the JAX package (mesh.py:41-55), over
    ranks: 'none' -> no split; 'patch' -> split every image's tiles across
    the ranks (a world of 1 is an error); 'auto' -> 'patch' where the world
    has more than one rank."""
    n = world_size()
    if arg == "none":
        return None
    if arg == "patch":
        if n < 2:
            raise SystemExit(f"--mesh patch needs more than one rank (found "
                             f"{n}); use --mesh none")
        return make_patch_mesh()
    if arg == "auto":
        return make_patch_mesh() if n > 1 else None
    raise ValueError(f"unknown mesh policy {arg!r}")


class _AllReduceSum(torch.autograd.Function):
    """Sum across ranks whose backward sums the upstream gradients across
    ranks too (torch.distributed.nn.functional.all_reduce, which torch
    2.13 deprecates)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks, differentiable. Every rank then computes
    the same value from it, and its backward hands each rank world times
    that rank's share of the gradient, so averaging the parameters'
    gradients across ranks (average_gradients) gives the gradient of the
    global value."""
    return _AllReduceSum.apply(x)


def all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """In-place sum across ranks, outside autograd; x itself where there
    is one rank."""
    if world_size() > 1:
        dist.all_reduce(x)
    return x


def average_gradients(params: List[torch.Tensor]) -> None:
    """Every parameter's gradient replaced by its mean over the ranks, in
    one all-reduce (the average DistributedDataParallel takes)."""
    n = world_size()
    if n == 1:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= n
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers copied into every rank's module, in
    place."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (pickled)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
