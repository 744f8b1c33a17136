"""Where the time of one frame goes, on the GPU (counterpart of
pg2024_dprt_tpu/utils/profile.py).

    python -m pg2024_dprt_tpu_torch.utils.profile [size] [n_tris]

Prints one JSON object for the exact-frame benchmark configuration
(scene/procedural.py::soup_frame) with two entries, "fused" (the default
config: the whole frame in one launch of the frame kernel) and "composed"
(fused_frame="off"), each from one render_image run under torch.profiler
and unprofiled runs of the same frame:
  * stages_ms: device ms of the kernels that run inside the device-side
    extent of each of the engine's record_function ranges (fused_frame; or
    camera_paths, closest_trace, shade, shadow_trace, accumulate, summed
    over bounces), and of the kernels outside every range;
  * the profiled frame's wall ms (CUDA events), the union of its kernels'
    busy intervals, and the device idle share (1 - busy / wall) against that
    wall and against the unprofiled frame's median wall ms (the profiler's
    host overhead lengthens the profiled frame);
  * the number of device events and the kernels with the most device time.
Needs CUDA.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import sys
from collections import defaultdict

import torch

from ..render.engine import render_image

STAGES = ("fused_frame", "camera_paths", "closest_trace", "shade", "shadow_trace",
          "accumulate")


def _frame_ms(fn, reps: int) -> float:
    """Median CUDA-event ms of fn() over `reps` runs."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _busy_ms(spans) -> float:
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


def frame_device_profile(scene, lights, env, camera, cfg, top: int = 8,
                         reps: int = 5) -> dict:
    """One profiled frame: per-stage device ms, wall and busy ms, idle
    shares, device events, top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    render_image(scene, lights, env, camera, cfg, base_sample=1)   # warm-up
    torch.cuda.synchronize()
    samples = iter(range(3, 3 + reps))
    unprofiled = _frame_ms(lambda: render_image(
        scene, lights, env, camera, cfg, base_sample=next(samples)), reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _frame_ms(lambda: render_image(scene, lights, env, camera, cfg,
                                              base_sample=2), 1)
    # device events are kernels and copies, plus the device-side extents of
    # the record_function ranges (user annotations); a kernel belongs to the
    # stage whose device extent holds its start (one stream, so the extents
    # do not overlap)
    spans, by_name, extents = [], defaultdict(float), []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name in STAGES or getattr(e, "is_user_annotation", False):
            if e.name in STAGES:
                extents.append((e.time_range.start, e.time_range.end, e.name))
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    stages = defaultdict(float)
    for s0, e0 in spans:
        for a, b, name in extents:
            if a <= s0 < b:
                stages[name] += (e0 - s0) / 1e3
                break
        else:
            stages["outside_ranges"] += (e0 - s0) / 1e3
    busy = _busy_ms(spans)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"stages_ms": {s: stages[s] for s in STAGES + ("outside_ranges",)},
            "profiled_wall_ms": wall, "unprofiled_wall_ms": unprofiled,
            "busy_ms": busy,
            "idle_share_profiled": (1.0 - busy / wall) if spans else None,
            "idle_share_unprofiled": (1.0 - busy / unprofiled) if spans else None,
            "device_events": len(spans),
            "top_kernels_ms": {name[:80]: v for name, v in kernels}}


def main(argv) -> int:
    from ..scene.procedural import soup_frame

    size = int(argv[1]) if len(argv) > 1 else 256
    n_tris = int(argv[2]) if len(argv) > 2 else 65536
    if not torch.cuda.is_available():
        print("profile: needs CUDA", file=sys.stderr)
        return 2
    *frame, cfg = soup_frame(size, n_tris, device="cuda")
    composed = dataclasses.replace(cfg, fused_frame="off")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "size": size,
                      "n_tris": n_tris,
                      "fused": frame_device_profile(*frame, cfg),
                      "composed": frame_device_profile(*frame, composed)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
