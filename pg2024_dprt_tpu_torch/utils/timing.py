"""Spans, host-sync counts and wall-clock sections with the reference
renderer's section names (counterpart of pg2024_dprt_tpu/utils/timing.py).

`span(name)` marks one piece of the program's host work. It always opens a
profiler range of that name, so a torch.profiler trace shows it on the
clock of the device's events. While a `Timing` recorder is active
(`Timing.recording()`), it also appends (name, start_ns, end_ns, parent,
frame) to the recorder: `time.time_ns()`, the clock of the profiler's
events; the index of the span that was open when it opened (-1 for none);
and the id of its frame (a frame's root span passes its `base_sample`, and
the spans inside inherit it). With no recorder active a span is its
profiler range alone.

A span is a profiler annotation (`torch.profiler.record_function`) only
where its name is in ANNOTATED: the frame stages whose device-side extents
the benchmark reads by name (portbench/trace.py). The profiler credits a
kernel to the innermost annotation open at its launch, so an annotation
nested in a stage would take its kernels out of the stage's device-side
extent. Every other span is the profiler's plain range (a host event on the
same clock, and about a twentieth of an annotation's host cost).

`host_sync(device)` marks a place where the host waits for the card, and
counts it (`host_syncs()`, the count of this process so far). `host_read`
(a tensor's values on the host) and `to_device` (a blocking copy of host
values to a CUDA device, which first waits for the work queued before it)
go through it. Under `torch.cuda.set_sync_debug_mode` the mode is lowered
inside it alone, so a frame run under the "error" mode raises at any sync
that does not go through it.

`Timing.section(name, sync_value)` is a span of its name under this
recorder, and with `sync_value` (a tensor, or a tuple / list / dict of
tensors) it first waits for the card to finish the work that produced it
(CPU tensors are ready). `totals` / `counts` hold the seconds and the
number of every span closed under the recorder, `self_seconds()` each
name's self time: its spans' durations minus the time their child spans
cover. For device-side detail use utils/profile.py.
"""
from __future__ import annotations

import functools
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from enum import Enum

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import record_function

# the stages the benchmark reads by their device-side extents
ANNOTATED = frozenset({"neural_route", "migration", "settle_shade", "shadows", "fused_frame"})


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


_recorder = None     # the active Timing, or None
_host_syncs = 0      # host syncs of this process so far


class span:
    """One span of host work (module docstring). `frame` is the id that
    this span and the spans inside it carry; by default the enclosing
    span's."""

    __slots__ = ("name", "frame", "_range", "_rec", "_index")

    def __init__(self, name: str, frame=None):
        self.name = name
        self.frame = frame

    def __enter__(self):
        self._range = (record_function(self.name) if self.name in ANNOTATED
                       else _RecordFunctionFast(self.name))
        self._range.__enter__()
        self._rec = _recorder
        if self._rec is not None:
            self._index = self._rec._open(self.name, self.frame)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec._close(self._index)
        return self._range.__exit__(*exc)


def host_syncs() -> int:
    """Host syncs of this process so far (a count that only grows: a
    frame's is the difference across it)."""
    return _host_syncs


@contextmanager
def host_sync(device):
    """One place where the host waits for the card: counted, and allowed
    under `torch.cuda.set_sync_debug_mode`. Counted on any device: on the
    CPU the same place would wait for a card."""
    global _host_syncs
    _host_syncs += 1
    mode = torch.cuda.get_sync_debug_mode() if torch.device(device).type == "cuda" else 0
    if not mode:
        yield
        return
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def host_read(x: torch.Tensor):
    """`x.tolist()`: a Python number for a 0-d tensor, else nested lists;
    one host sync."""
    with host_sync(x.device):
        return x.tolist()


def to_device(value, dtype=None, device=None) -> torch.Tensor:
    """`torch.as_tensor(value, dtype=dtype, device=device)`. Host values (a
    Python number or sequence, a CPU tensor) copied to a CUDA device are a
    host sync: the copy waits for the work queued before it."""
    if device is not None and torch.device(device).type == "cuda" and not (
            torch.is_tensor(value) and value.is_cuda):
        with host_sync(device):
            return torch.as_tensor(value, dtype=dtype, device=device)
    return torch.as_tensor(value, dtype=dtype, device=device)


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
    """Wait until the card has computed every CUDA tensor in `value` (one
    host sync a device); returns `value`."""
    for dev in {t.device for t in _tensors(value) if t.is_cuda}:
        with host_sync(dev):
            torch.cuda.synchronize(dev)
    return value


class Timing:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        # (name, start_ns, end_ns, parent index or -1, frame id or None);
        # end_ns is None while the span is open
        self.spans = []
        self._open_spans = []

    @contextmanager
    def recording(self):
        """Make this the active recorder of spans (the one before it is
        active again on exit)."""
        global _recorder
        before, _recorder = _recorder, self
        try:
            yield self
        finally:
            _recorder = before

    def _open(self, name: str, frame) -> int:
        parent = self._open_spans[-1] if self._open_spans else -1
        if frame is None and parent >= 0:
            frame = self.spans[parent][4]
        self.spans.append((name, time.time_ns(), None, parent, frame))
        self._open_spans.append(len(self.spans) - 1)
        return len(self.spans) - 1

    def _close(self, index: int):
        name, start, _, parent, frame = self.spans[index]
        end = time.time_ns()
        self.spans[index] = (name, start, end, parent, frame)
        self._open_spans.remove(index)
        self.totals[name] += (end - start) / 1e9
        self.counts[name] += 1

    @contextmanager
    def section(self, name, sync_value=None):
        key = name.value if isinstance(name, TimedSection) else str(name)
        with self.recording(), span(key):
            try:
                yield
            finally:
                if sync_value is not None:
                    _block_until_ready(sync_value)

    def self_seconds(self) -> dict:
        """Each span name's self time in seconds over the closed spans: their
        durations minus the time their closed child spans cover."""
        out = defaultdict(float)
        for name, start, end, parent, _ in self.spans:
            if end is None:
                continue
            out[name] += (end - start) / 1e9
            if parent >= 0 and self.spans[parent][2] is not None:
                out[self.spans[parent][0]] -= (end - start) / 1e9
        return dict(out)

    def report(self) -> str:
        own = self.self_seconds()
        return "\n".join(
            f"{key}: {self.totals[key] * 1e3:.2f} ms over {self.counts[key]} calls, "
            f"self {own.get(key, 0.0) * 1e3:.2f} ms" for key in sorted(self.totals))


def spanned(name: str):
    """Decorator: every call of the function runs under `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def launch_span(name: str, rows: int):
    """The span of one kernel launch by the wrapper that counts it under
    `name` in ops/resident.py LAUNCHES: around the wrapper's host work; no
    span where the launch has no rows (no kernel runs, none is counted)."""
    return span(name) if rows else nullcontext()
