"""The partition mesh (counterpart of pg2024_dprt_tpu/parallel/mesh.py).

JAX runs one partition per device on a 1-D `jax.sharding.Mesh` and moves
paths with `all_to_all`, `ppermute` and `psum`. The port has two meshes with
the same two collectives:

  * `InProcessMesh`: all P partitions in one process on one device;
  * `RankMesh`: one partition a process (a rank of a `torch.distributed`
    process group), PyTorch's own idiom for one partition a card.

A process holds `L` partitions, the ids `mesh.local` in order (all P in
`InProcessMesh`, its rank's one in `RankMesh`), and hands the collectives
its partitions' values stacked along a leading L axis. The exchange
semantics are JAX's:

  * `all_to_all(x)`: x[s, d, ...], what partition s sends to d, arrives as
    out[d, s, ...]; the blocks are (L, P, ...), indexed by local position
    and by partition id;
  * `psum(x)`: x[l, ...] summed over this process's rows and over every
    process; the leading axis holds this process's partial values (one a
    local partition, or their sum as one row).

Everything above the mesh (parallel/exchange.py, parallel/distributed.py)
moves data between partitions only through these two.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..core.device import resolve_device

NODES_AXIS = "nodes"


@dataclass(frozen=True)
class InProcessMesh:
    size: int
    device: torch.device
    axis_name: str = NODES_AXIS

    @property
    def local(self) -> tuple:
        return tuple(range(self.size))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x[s, d, ...] -> out[d, s, ...]."""
        return x.transpose(0, 1)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """x[l, ...] summed over l."""
        return x.sum(dim=0)


@dataclass(frozen=True)
class RankMesh:
    """One partition a rank of the default process group: partition id =
    rank, P = world size. The collectives run on the tensors' own device;
    gloo takes CUDA tensors for both collectives (checked on the H100 with
    PyTorch 2.11) and stages them through the host itself."""
    size: int
    device: torch.device
    rank: int
    backend: str
    axis_name: str = NODES_AXIS

    @property
    def local(self) -> tuple:
        return (self.rank,)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(1, P, ...) -> (1, P, ...): out[0, s] is what rank s sent here.
        Bools ride as uint8, as JAX's _tree_all_to_all does."""
        if x.shape[:2] != (1, self.size):
            raise ValueError(f"a rank's all_to_all block is (1, {self.size}, ...), "
                             f"got {tuple(x.shape)}")
        send = x[0]
        if send.dtype == torch.bool:
            send = send.to(torch.uint8)
        send = send.contiguous()
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send)
        return (out.bool() if x.dtype == torch.bool else out)[None]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """x[l, ...] summed over l and over every rank."""
        y = x.sum(dim=0)
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y


def make_mesh(num_partitions: int, device=None) -> InProcessMesh:
    """A mesh of `num_partitions` partitions on `device` (CUDA unless the
    caller passes another)."""
    if num_partitions < 1:
        raise ValueError(f"a mesh needs at least one partition, got {num_partitions}")
    return InProcessMesh(int(num_partitions), resolve_device(device))


def make_rank_mesh(num_partitions: Optional[int] = None, device=None,
                   backend: Optional[str] = None) -> RankMesh:
    """The mesh of this process's rank: one partition a rank.

    The process group is the default one, as the caller initialised it;
    without one it is initialised from torchrun's environment (`env://`).
    The device is `device`, else cuda:LOCAL_RANK. The backend is NCCL for CUDA devices and gloo for CPU
    ones unless `backend` names another; gloo may run ranks on one CUDA
    device (NCCL refuses two ranks on one GPU). Nothing falls back: NCCL
    where this PyTorch has none, NCCL for a CPU device, a group of another
    backend than the one asked for, and a world size other than
    `num_partitions` raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for a gloo rank "
                               "on the CPU")
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("NCCL was asked for and this PyTorch has no NCCL; "
                           "no other backend is taken in its place")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL moves CUDA tensors only; the device is {dev}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    got = dist.get_backend()
    if got != backend:
        raise ValueError(f"the process group runs {got}, not the {backend} asked for")
    world = dist.get_world_size()
    if num_partitions is not None and num_partitions != world:
        raise ValueError(f"{num_partitions} partitions on a world of {world} ranks: "
                         f"one partition a rank")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return RankMesh(world, dev, dist.get_rank(), backend)
