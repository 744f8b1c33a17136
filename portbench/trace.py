"""What a traced run reads from torch.profiler's device timeline.

`read_trace` turns the profiler's raw events into the numbers the
per-layer metric readers take: every device operation (kernels, copies and
sets) with its name and interval, the union of their intervals (busy), the
device ms of the operations that start inside the device-side extent of
each named range (the program's stage ranges), and the breakdown the result
line carries: the operations with the most device time, and the longest
idle gaps by the host range that was open when each began.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

# the benchmark's own host range around each frame of the window
FRAME_RANGE = "portbench.frame"


def busy_ms(spans) -> float:
    """Length of the union of (start, end) intervals, us -> ms."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


@dataclass
class Trace:
    ops: list                       # (start_us, end_us, name) of every device operation
    stage_ms: dict                  # range name -> device ms of the operations in it
    busy_s: float
    window_s: float
    frames: int
    breakdown: dict = field(default_factory=dict)

    def op_ms(self, *patterns) -> float:
        """Summed device ms of the operations whose name holds any pattern."""
        return sum(e - s for s, e, name in self.ops if any(p in name for p in patterns)) / 1e3


def read_trace(prof, stages, window_s: float, frames: int, top: int = 10) -> Trace:
    """`prof`: a finished torch.profiler.profile over the window; `stages`:
    the range names to attribute device time to."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, extents, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == cuda:
            if e.name() in stages:
                extents.append((s, t, e.name()))
            elif not e.is_user_annotation():
                ops.append((s, t, e.name()))
        elif e.is_user_annotation() and (e.name() in stages or e.name() == FRAME_RANGE):
            host.append((s, t, e.name()))
    ops.sort()
    extents.sort()
    # one stream: the extents do not overlap, so one sweep attributes the
    # operations in start order
    stage_ms, j = defaultdict(float), 0
    for s, t, _ in ops:
        while j < len(extents) and extents[j][1] <= s:
            j += 1
        if j < len(extents) and extents[j][0] <= s:
            stage_ms[extents[j][2]] += (t - s) / 1e3
    by_name = defaultdict(float)
    for s, t, name in ops:
        by_name[name] += (t - s) / 1e6
    # idle gaps between the merged busy intervals, named by the innermost
    # host range open at the gap's start (ranges nest, so few are open)
    merged = []
    for s, t, _ in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    host.sort()
    gaps, open_, k = defaultdict(float), [], 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        while k < len(host) and host[k][0] <= a:
            open_.append(host[k])
            k += 1
        open_ = [h for h in open_ if h[1] > a]
        name = min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "outside_frames"
        gaps[name] += (b - a) / 1e6
    breakdown = {
        "device_ops": [[n[:120], v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
    }
    return Trace(ops=ops, stage_ms=dict(stage_ms), busy_s=busy_ms([(s, t) for s, t, _ in ops]) / 1e3,
                 window_s=window_s, frames=frames, breakdown=breakdown)
