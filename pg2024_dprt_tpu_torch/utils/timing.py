"""Wall-clock section timing with the reference renderer's section names
(counterpart of pg2024_dprt_tpu/utils/timing.py).

`Timing.section(name, sync_value)` adds the host seconds of its body to the
section's total; with `sync_value` (a tensor, or a tuple / list / dict of
tensors) it first waits for the card to finish the work that produced it
(`torch.cuda.synchronize` on CUDA tensors; CPU tensors are ready). For
device-side detail use utils/profile.py.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from enum import Enum

import torch


class TimedSection(Enum):
    Sample = "Sample"
    Traversal = "Traversal"
    Scan = "Scan"
    Transfer = "Transfer"          # the path exchange between partitions
    VisNNTime = "VisNNTime"
    DepthNNTime = "DepthNNTime"
    Shade = "Shade"
    Shadow = "Shadow"
    Secondary = "Secondary"


def _tensors(value):
    if torch.is_tensor(value):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)


def _block_until_ready(value):
    """Wait until the card has computed every CUDA tensor in `value`;
    returns `value`."""
    for dev in {t.device for t in _tensors(value) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return value


class Timing:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def section(self, name, sync_value=None):
        key = name.value if isinstance(name, TimedSection) else str(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                _block_until_ready(sync_value)
            dt = time.perf_counter() - t0
            self.totals[key] += dt
            self.counts[key] += 1

    def report(self) -> str:
        lines = []
        for key in sorted(self.totals):
            lines.append(
                f"{key}: {self.totals[key] * 1e3:.2f} ms over {self.counts[key]} calls"
            )
        return "\n".join(lines)
