"""Device-buffer accounting (counterpart of pg2024_dprt_tpu/utils/memory.py):
the bytes of the tensors a renderer holds, by record. PyTorch's caching
allocator owns the memory; `torch.cuda.memory_allocated` gives its total."""
from __future__ import annotations

import dataclasses

import torch


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def buffer_bytes(tree) -> int:
    """Bytes of every tensor in a tensor, NamedTuple, dataclass, dict or
    list, nested ones included."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def memory_report(scene=None, paths=None, shadow_paths=None, models=None) -> str:
    lines = []
    total = 0
    for name, tree in (
        ("scene", scene),
        ("paths", paths),
        ("shadow_paths", shadow_paths),
        ("proxy_models", models),
    ):
        if tree is None:
            continue
        b = buffer_bytes(tree)
        total += b
        lines.append(f"{name:14s} {b / 1e6:10.2f} MB")
    lines.append(f"{'total':14s} {total / 1e6:10.2f} MB")
    return "\n".join(lines)
