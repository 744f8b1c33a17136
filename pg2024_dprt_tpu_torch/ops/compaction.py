"""Path compaction and routing by key (counterpart of
pg2024_dprt_tpu/ops/compaction.py).

One stable sort by key groups rows into contiguous per-key segments, with
invalid rows (keyed by a sentinel) at the tail. These are plain PyTorch, as
the JAX functions are plain XLA with no Pallas kernel, and integer-exact
against them. Every function works on the last dimension, so a stack of
P partitions' keys, (P, N), compacts per partition in one call.
"""
from __future__ import annotations

import torch

SENTINEL = 0x7FFFFFFF


def compact_by_key(key: torch.Tensor, valid: torch.Tensor):
    """Stable-sort row indices by (valid ? key : SENTINEL) along the last
    dimension. Returns (perm, sorted_key, sorted_valid); `perm` moves rows
    into per-key segments with the invalid rows at the tail."""
    k = torch.where(valid, key.to(torch.int64), SENTINEL)
    sorted_key, perm = torch.sort(k, dim=-1, stable=True)
    return perm, sorted_key, sorted_key != SENTINEL


def counts_per_key(key: torch.Tensor, valid: torch.Tensor, num_keys: int) -> torch.Tensor:
    """Histogram of the valid rows per key in [0, num_keys) along the last
    dimension (int64)."""
    k = torch.where(valid, key.to(torch.int64), num_keys)
    out = torch.zeros(k.shape[:-1] + (num_keys + 1,), dtype=torch.int64, device=k.device)
    out.scatter_add_(-1, k, torch.ones_like(k))
    return out[..., :num_keys]


def segment_offsets(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of per-key counts along the last dimension: each
    segment's start offset."""
    return torch.cumsum(counts, dim=-1) - counts
