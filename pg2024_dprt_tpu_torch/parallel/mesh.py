"""The partition mesh (counterpart of pg2024_dprt_tpu/parallel/mesh.py).

JAX runs one partition per device on a 1-D `jax.sharding.Mesh` and moves
paths with `all_to_all`, `ppermute` and `psum`. The port runs all P
partitions in one process on one device (NCCL refuses two ranks on one
GPU): `InProcessMesh` holds P, the device and the axis name, and gives the
collectives their in-process form. The exchange semantics are JAX's:

  * `all_to_all(x)`: x[s, d, ...], what partition s sends to d, arrives as
    out[d, s, ...] — a gather by destination;
  * `psum(x)`: x[p, ...] summed over the partitions.

The partitions' per-partition values are stacked along a leading P axis.
Everything above the mesh (parallel/exchange.py, parallel/distributed.py)
moves data between partitions only through these two, so an exchange
across several GPUs, one rank per card, would be another mesh with the
same two methods.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.device import resolve_device

NODES_AXIS = "nodes"


@dataclass(frozen=True)
class InProcessMesh:
    size: int
    device: torch.device
    axis_name: str = NODES_AXIS

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x[s, d, ...] -> out[d, s, ...]."""
        return x.transpose(0, 1)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """x[p, ...] summed over p."""
        return x.sum(dim=0)


def make_mesh(num_partitions: int, device=None) -> InProcessMesh:
    """A mesh of `num_partitions` partitions on `device` (CUDA unless the
    caller passes another)."""
    if num_partitions < 1:
        raise ValueError(f"a mesh needs at least one partition, got {num_partitions}")
    return InProcessMesh(int(num_partitions), resolve_device(device))
