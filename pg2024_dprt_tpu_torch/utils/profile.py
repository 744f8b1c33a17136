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
`render_device_profile` gives the same numbers for any frame function and
its stage ranges (chip_smoke.py profiles the distributed frame with it).
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
    """One profiled frame of render_image: per-stage device ms, wall and
    busy ms, idle shares, device events, top kernels by device time."""
    return render_device_profile(
        lambda s: render_image(scene, lights, env, camera, cfg, base_sample=s), STAGES,
        top, reps)


def render_device_profile(render, stages=STAGES, top: int = 8, reps: int = 5) -> dict:
    """The same for any frame: `render(base_sample)` renders one frame, and
    `stages` names the record_function ranges it runs (the distributed
    frame's are parallel/distributed.py's STAGES)."""
    from torch.profiler import ProfilerActivity, profile

    render(1)   # warm-up
    torch.cuda.synchronize()
    samples = iter(range(3, 3 + reps))
    unprofiled = _frame_ms(lambda: render(next(samples)), reps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _frame_ms(lambda: render(2), 1)
    # device events are kernels and copies, plus the device-side extents of
    # the record_function ranges (user annotations); a kernel belongs to the
    # stage whose device extent holds its start (one stream, so the extents
    # do not overlap)
    spans, by_name, extents = [], defaultdict(float), []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name in stages or getattr(e, "is_user_annotation", False):
            if e.name in stages:
                extents.append((e.time_range.start, e.time_range.end, e.name))
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    stage_ms = defaultdict(float)
    for s0, e0 in spans:
        for a, b, name in extents:
            if a <= s0 < b:
                stage_ms[name] += (e0 - s0) / 1e3
                break
        else:
            stage_ms["outside_ranges"] += (e0 - s0) / 1e3
    busy = _busy_ms(spans)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"stages_ms": {s: stage_ms[s] for s in tuple(stages) + ("outside_ranges",)},
            "profiled_wall_ms": wall, "unprofiled_wall_ms": unprofiled,
            "busy_ms": busy,
            "idle_share_profiled": (1.0 - busy / wall) if spans else None,
            "idle_share_unprofiled": (1.0 - busy / unprofiled) if spans else None,
            "device_events": len(spans),
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
