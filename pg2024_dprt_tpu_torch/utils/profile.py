"""Where the time of one frame goes, on the GPU (counterpart of
pg2024_dprt_tpu/utils/profile.py).

    python -m pg2024_dprt_tpu_torch.utils.profile [size] [n_tris]

Prints one JSON object for the exact-frame benchmark configuration
(scene/procedural.py::soup_frame) with two entries, "fused" (the default
config: the whole frame in one launch of the frame kernel) and "composed"
(fused_frame="off"), each `frame_device_profile` of one render_image frame.

`render_device_profile(render)` profiles any frame function (chip_smoke.py
profiles the distributed frame with it): unprofiled frames timed with CUDA
events, as many again under a `Timing` recorder (utils/timing.py), and one
frame under torch.profiler, whose raw kineto events it reads in one sweep.
Every device operation (kernel, copy, set) is credited to the span that
launched it: the innermost span open on the host when its launch call ran
(matched by the launch's correlation id). It returns
  * spans: for each span name, the device ms and the count of the device
    operations it launched innermost, the idle ms charged to it (a gap
    between busy intervals goes to the span that launched the operation
    ending the gap: the host work the device waited for), and its host
    self ms a frame from the recorded frames; and the spans a frame;
  * stages_ms: the device ms under each span name, nested spans included
    (the engine's and the distributed frame's stages among them), and
    outside every span;
  * the profiled frame's wall ms (CUDA events), the union of its device
    operations' busy intervals, and the device idle share (1 - busy / wall)
    against that wall and against the unprofiled frames' median wall ms
    (the profiler's host overhead lengthens the profiled frame); the
    recorded frames' median wall ms beside it (the recorder's cost);
  * the number of device operations and those with the most device time.
Needs CUDA.

`profile_sample` is the reference's per-stage report: the host seconds of
the Traversal, Shade and Shadow stages of each bounce of one composed
sample, as Timing sections, with the card waited for between stages. It
runs on the device of its inputs, the CPU included.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import sys
from collections import defaultdict

import torch

from ..ops.trace_api import trace_closest_cutout, trace_occlusion_cutout
from ..render.engine import render_image
from ..render.pathgen import generate_camera_paths
from ..render.shade import shade
from .timing import TimedSection, Timing, _block_until_ready

OUTSIDE = "outside_spans"


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
    """One profiled frame of render_image: `render_device_profile`'s
    numbers."""
    return render_device_profile(
        lambda s: render_image(scene, lights, env, camera, cfg, base_sample=s), top, reps)


def read_device_events(events, span_names) -> tuple:
    """From raw kineto events: (device operations as (start_us, end_us,
    name, launch_us), host spans as (start_us, end_us, name)). A host span
    is a CPU event that is a profiler annotation or whose name is in
    `span_names`; an operation's launch time is its launch call's (the
    CPU event of its correlation id whose name starts with "cu"), or its
    own start where none is found."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, launches, host = [], {}, []
    for e in events:
        s, t = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                ops.append((s, t, e.name(), e.correlation_id()))
        elif e.is_user_annotation() or e.name() in span_names:
            host.append((s, t, e.name()))
        elif e.name().startswith("cu"):
            launches[e.correlation_id()] = s
    return [(s, t, n, launches.get(c, s)) for s, t, n, c in ops], host


def credit(ops, host) -> tuple:
    """One sweep over the operations in launch order and the host spans in
    start order (spans nest on the one host thread): (per innermost span
    [device ms, operations, idle ms], device ms under each span name nested
    spans included). Each operation carries the idle gap that ends at its
    start."""
    gap_before, end = {}, None
    for i in sorted(range(len(ops)), key=lambda i: ops[i][0]):
        s, t = ops[i][0], ops[i][1]
        if end is not None and s > end:
            gap_before[i] = s - end
        end = t if end is None else max(end, t)
    own = defaultdict(lambda: [0.0, 0, 0.0])
    under = defaultdict(float)
    host = sorted(host)
    stack, k = [], 0
    for i in sorted(range(len(ops)), key=lambda i: ops[i][3]):
        s, t, _, at = ops[i]
        while k < len(host) and host[k][0] <= at:
            while stack and stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] <= at:
            stack.pop()
        row = own[stack[-1][2] if stack else OUTSIDE]
        row[0] += (t - s) / 1e3
        row[1] += 1
        row[2] += gap_before.get(i, 0.0) / 1e3
        for name in {h[2] for h in stack} or {OUTSIDE}:
            under[name] += (t - s) / 1e3
    return own, under


def render_device_profile(render, top: int = 8, reps: int = 5) -> dict:
    """The numbers of the module docstring for any frame: `render(base_sample)`
    renders one frame."""
    from torch.profiler import ProfilerActivity, profile

    render(1)   # warm-up
    torch.cuda.synchronize()
    samples = iter(range(3, 3 + 2 * reps))
    unprofiled = _frame_ms(lambda: render(next(samples)), reps)
    timing = Timing()
    with timing.recording():
        recorded = _frame_ms(lambda: render(next(samples)), reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _frame_ms(lambda: render(2), 1)
    ops, host = read_device_events(prof.profiler.kineto_results.events(), set(timing.totals))
    own, under = credit(ops, host)
    host_self = timing.self_seconds()
    by_name = defaultdict(float)
    for s, t, name, _ in ops:
        by_name[name] += (t - s) / 1e3
    busy = _busy_ms([(s, t) for s, t, _, _ in ops])
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = {name: {**dict(zip(("device_ms", "device_ops", "idle_ms"),
                               own.get(name, (0.0, 0, 0.0)))),
                    "host_self_ms": host_self.get(name, 0.0) * 1e3 / reps}
             for name in sorted(set(own) | set(host_self))}
    return {"spans": spans, "spans_per_frame": len(timing.spans) / reps,
            "stages_ms": dict(under),
            "profiled_wall_ms": wall, "unprofiled_wall_ms": unprofiled,
            "recorded_wall_ms": recorded, "busy_ms": busy,
            "idle_share_profiled": (1.0 - busy / wall) if ops else None,
            "idle_share_unprofiled": (1.0 - busy / unprofiled) if ops else None,
            "device_events": len(ops),
            "top_kernels_ms": {name[:80]: v for name, v in kernels}}


def profile_sample(scene, lights, env, camera, cfg, sample_count: int = 0) -> Timing:
    """Host seconds of each stage of one composed sample (JAX's stages in
    JAX's order): per bounce the closest-hit trace (Traversal), shading
    (Shade) and the shadow test with its accumulation (Shadow), each
    fenced."""
    timing = Timing()
    npix = cfg.frame_buffer_size
    paths = generate_camera_paths(camera, sample_count)
    dev = paths.origin.device
    direct = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    env_img = torch.zeros((npix, 3), dtype=torch.float32, device=dev)

    for bounce in range(cfg.bounces):
        with timing.section(TimedSection.Traversal):
            hits, _ = trace_closest_cutout(scene, paths.origin, paths.direction, cfg.t_epsilon,
                                           paths.tmax, paths.is_valid, tracer=cfg.tracer)
            _block_until_ready(hits)

        with timing.section(TimedSection.Shade):
            next_paths, shadow_paths, env_add = shade(scene, lights, env, paths, hits,
                                                      sample_count, bounce,
                                                      cfg.shadow_path_count, npix)
            _block_until_ready(env_add)
        env_img = env_img + env_add

        with timing.section(TimedSection.Shadow):
            occ, _ = trace_occlusion_cutout(scene, shadow_paths.origin, shadow_paths.direction,
                                            cfg.t_epsilon, shadow_paths.tmax * (1.0 - 1e-3),
                                            shadow_paths.is_valid, tracer=cfg.tracer)
            contrib = torch.where((shadow_paths.is_valid & ~occ)[:, None],
                                  shadow_paths.throughput / cfg.shadow_path_count, 0.0)
            direct = direct.index_add(0, shadow_paths.pixel_index, contrib)
            _block_until_ready(direct)

        paths = next_paths

    return timing


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
