"""Bit-exact TEA/LCG random numbers (counterpart of
pg2024_dprt_tpu/core/rng.py).

The JAX version computes in uint32. PyTorch's uint32 has little operator
support, so values here are int64 tensors holding uint32 values: every sum
and product is masked back to 32 bits, and right shifts of such values are
logical because the values are never negative. Seeds are therefore int64
tensors in [0, 2^32).
"""
from __future__ import annotations

import torch

from ..utils.timing import to_device

_MASK = 0xFFFFFFFF


def as_u32(x, device=None) -> torch.Tensor:
    """Python int or integer tensor -> int64 tensor of its uint32 value (a
    Python int copied to a CUDA device is a host sync, utils/timing.py)."""
    return to_device(x, torch.int64, device) & _MASK


def tea(val0, val1, rounds: int = 4) -> torch.Tensor:
    """TEA-4 hash of two uint32 values -> uint32 seed (vectorized)."""
    v0 = as_u32(val0)
    v1 = as_u32(val1, device=v0.device)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & _MASK
        v0 = (v0 + (((((v1 << 4) & _MASK) + 0xA341316C)
                     ^ ((v1 + s0) & _MASK))
                    ^ ((v1 >> 5) + 0xC8013EA4))) & _MASK
        v1 = (v1 + (((((v0 << 4) & _MASK) + 0xAD90777D)
                     ^ ((v0 + s0) & _MASK))
                    ^ ((v0 >> 5) + 0x7E95761E))) & _MASK
    return v0


def tea_int(val0: int, val1: int, rounds: int = 4) -> int:
    """tea() of two Python ints, in Python ints: the host-side form for the
    scalar salts (sample, bounce, stream ids), with no tensor op."""
    v0, v1, s0 = val0 & _MASK, val1 & _MASK, 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & _MASK
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s0)) ^ ((v1 >> 5) + 0xC8013EA4))) & _MASK
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s0)) ^ ((v0 >> 5) + 0x7E95761E))) & _MASK
    return v0


def _lcg(prev):
    """LCG step; returns (new_state, 24 random bits)."""
    nxt = (1664525 * prev + 1013904223) & _MASK
    return nxt, nxt & 0x00FFFFFF


def rnd(seed):
    """One float in [0,1) per seed; returns (new_seed, x)."""
    seed, bits = _lcg(seed)
    return seed, bits.to(torch.float32) / float(0x01000000)


def rnd2(seed):
    """Two floats in [0,1) per seed; returns (new_seed, x1, x2)."""
    seed, x1 = rnd(seed)
    seed, x2 = rnd(seed)
    return seed, x1, x2


def rnd3(seed):
    """Three floats in [0,1) per seed; returns (new_seed, x1, x2, x3)."""
    seed, x1 = rnd(seed)
    seed, x2 = rnd(seed)
    seed, x3 = rnd(seed)
    return seed, x1, x2, x3
