"""Resident-table closest-hit and any-hit trace (counterpart of
pg2024_dprt_tpu/ops/pallas_resident.py::trace_resident).

Five kernels written by hand for Hopper, in csrc/resident_trace.cu:
  * `resident_closest` (K1) replaces the closest-hit Pallas kernels
    _kernel (flat and instanced), _kernel_hbm, _kernel_tiny and
    _kernel_tiny_t;
  * `resident_anyhit` (K2) replaces _occl_kernel (flat and instanced),
    _occl_kernel_hbm, _occl_kernel_tiny and _occl_kernel_tiny_t;
  * `grouped_closest` (K9) and `grouped_anyhit` (K10) replace
    _kernel_grouped[_hbm] and _occl_kernel_grouped[_hbm]: K1's and K2's
    functions through the two-level cull over groups of CL_GROUP clusters,
    which large scenes take (`trace_grouped`);
  * `schedule_keys` (K8) replaces _sched_kernel: the per-ray sort key of the
    wavefront sort (`sort_rays=True`, `schedule_order`), which puts rays that
    visit the same clusters next to each other before K1, K2 or the fused
    route kernel runs on them.
The source's header says what each computes, how, and what bounds it. Every
kernel takes instanced scenes (scene/geometry.py device_scene_from_instances):
a cluster's triangles are tested in its instance's object space and a hit
carries the virtual id instance * num_base_tris + base canonical id.

Beside each kernel is its plain PyTorch version: a dense Moller-Trumbore
over ray chunks x triangle-slot chunks with the same formulas and no cull
(per instance, on the rays transformed with the kernels' arithmetic, for an
instanced scene). K9 and K10 compute K1's and K2's contract, so their plain
versions are K1's and K2's. A wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
`LAUNCHES` counts the kernel launches of each wrapper (those of
ops/frame.py, ops/march.py, ops/mlp.py, ops/route.py, ops/shade.py and
ops/tracer.py as well; the route kernel counts each of its two entry points, and its
multi-geo launches once more under route_multigeo). Each counted launch
runs under a span of its key (utils/timing.py `launch_span`) around the
wrapper's host work; route_multigeo has no span of its own.

The closest-hit winner is the lexicographic minimum of (t, slot) with slot =
cluster * C + lane, so kernel and plain version agree whatever order the
kernel visits clusters in. The TPU kernels' packed t|lane keys spend the
low log2(C) mantissa bits of t on the lane, so the JAX package may pick
another of two triangles whose t agree to within 2^log2(C) ulps; such
near-ties are the only place the two packages' ids may differ.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from ..core.types import HitRecord
from ..utils.timing import launch_span, to_device
from . import _build

F32_MAX = 3.402823466e38

# kernel launches of each wrapper (reset by callers that count a run)
LAUNCHES = {"resident_closest": 0, "resident_anyhit": 0, "grouped_closest": 0,
            "grouped_anyhit": 0, "schedule_keys": 0, "frame_sample": 0,
            "proxy_march": 0, "mlp_pair": 0, "mlp_dense": 0,
            "route_secondary": 0, "route_shadow": 0, "route_multigeo": 0,
            "pair_closest": 0, "pair_anyhit": 0, "pair_woop": 0, "shade_paths": 0}

# the group fan-out the grouped kernels read (scene/geometry.py CL_GROUP)
GROUP = 8
# The dispatch rule (`use_grouped`): the grouped modes of the frame kernel
# K3, the fused route K7 and the schedule keys K8 (their warp walks, or
# K8's group cull) from GROUPED_MIN_CLUSTERS clusters on; trace_resident's
# grouped kernels (`trace_grouped`) K9 from CLOSEST_GROUPED_MIN_CLUSTERS and
# K10 from ANYHIT_GROUPED_MIN_CLUSTERS on. The JAX package's rule is a
# budget of the TPU's fast memory and means nothing on this card. Measured
# on an H100 at 700 W (scripts/torch_grouped_probe.py --parts flat, and
# --parts rule for K3 / K7; PERF.md): device ms of the grouped kernel over
# the flat one by its rule (below 1: the grouped kernel wins) on camera /
# incoherent / datagen rays, first-shadow rays for K10 / K2, and CUDA
# events around the calls for K3 and K7 (secondary):
#   K    scene (C, rays)        K9/K1        K10/K2       K3      K7
#   1    cornell (128, 1,024)   0.98         1.21         -       -
#   1    cornell (128, 65,536)  5.4-5.8      2.9          2.0-2.5 1.04-1.09
#   32   soup (2048)            0.48-0.73    1.24         -       -
#   45   statue 0 (128)         1.04-1.13    1.09         -       -
#   47   soup (2048)            -            -            0.62    0.68
#   49   statue 2 (128)         1.15         -            -       -
#   62   soup (128)             0.94-1.08    1.12         -       -
#   90   soup (128)             0.80-0.97    1.16         -       -
#   129  soup (128)             0.76-0.92    1.13         -       -
#   185  64k frame (512)        0.61         1.12-1.15    0.35-0.39 0.75-0.82
#   239  soup (128)             0.61-0.88    1.14         -       -
#   368  soup (128)             0.58-0.79    1.03         -       -
#   533  soup (128)             0.48-0.72    1.02         -       -
#   735  soup (128)             -            0.58-0.73    0.19    0.48
# K3, K7 and K8 walk as they did, and win from 47, the smallest K measured
# above 1. The trace kernels K1 / K2 walk a ray with a team of lanes (the
# flat team walks), which moved their crossover: K9 wins the closest hit
# from K between 62 and 90, K10 the any-hit above 533 (at C = 128: every
# scene under 262,144 triangles; larger ones have K >= 512). On the 64k
# frame composed, the rule's K9 + K2 took 1.079 ms of device time a frame
# against 1.159 for K9 + K10.
GROUPED_MIN_CLUSTERS = 47
CLOSEST_GROUPED_MIN_CLUSTERS = 64
ANYHIT_GROUPED_MIN_CLUSTERS = 512
# K1 / K2 walk each ray with a team of lanes (csrc/resident_trace.cuh, the
# flat team walks: CLOSEST_TEAM lanes for K1, ANYHIT_TEAM for K2), or at
# one cluster on a large launch with a lane a ray (the thread walks
# closest_hit / any_hit). Measured on the same card (probe flat; PERF.md):
# teams of 8 win the closest hit at C = 128 under 47 clusters (1.4-2.2x
# over warp teams on camera rays at K = 1-12; on the statues of K = 45-46
# 0.86-0.89 of the warp teams' time on camera rays, a tie on datagen rays),
# warp teams the any-hit from K = 2 (1.2x at K = 2, 2.2-3.4x at K = 24-46).
# At one cluster (cornell at 1,024 .. 65,536 camera rays) teams win up to
# 16,384 rays (K1 0.0087 against 0.0108 ms; K2 a tie) and a lane a ray
# from 32,761 (K1 0.0118 against 0.0153, K2 0.0100 against 0.0169): there
# a team repeats its ray's set-up on every lane and the launch fills the
# card without teams. Each kernel is built in its two walks only: the lane
# walk in the body of the narrow teams' instance slowed both (PERF.md).
CLOSEST_TEAM = 8   # kClosestTeam in csrc/resident_trace.cu
ANYHIT_TEAM = 32   # kAnyhitTeam
LANE_MAX_CLUSTERS = 1
CLOSEST_LANE_MIN_RAYS = 24576
ANYHIT_LANE_MIN_RAYS = 16384

# the schedule key holds two cluster indices of this many bits
SCHEDULE_CLUSTER_BITS = 12
_NO_KEY = 0x7FFFFFFF

# elements per (ray, slot) chunk of the plain versions' dense test
_PLAIN_CHUNK = {"cpu": 1 << 21, "cuda": 1 << 25}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_grouped(scene, grouped=None, min_clusters=None) -> bool:
    """Whether `scene` takes the grouped kernels. `grouped` True/False
    forces either (True on a scene without group tables runs the flat
    kernels, as in JAX); None applies the port's rule: the scene has group
    tables and at least `min_clusters` clusters (GROUPED_MIN_CLUSTERS, the
    rule of K3, K7 and K8, unless given)."""
    if scene.cl_gboxes is None or scene.cl_mboxes is None:
        return False
    if grouped is None:
        limit = GROUPED_MIN_CLUSTERS if min_clusters is None else min_clusters
        return scene.num_clusters >= limit
    return bool(grouped)


def trace_grouped(scene, any_hit: bool = False, grouped=None) -> bool:
    """`use_grouped` for trace_resident: K9 from CLOSEST_GROUPED_MIN_CLUSTERS
    clusters on, K10 (`any_hit`) from ANYHIT_GROUPED_MIN_CLUSTERS."""
    return use_grouped(scene, grouped, ANYHIT_GROUPED_MIN_CLUSTERS if any_hit
                       else CLOSEST_GROUPED_MIN_CLUSTERS)


def flat_lanes(k: int, n: int, any_hit: bool = False) -> int:
    """The lanes that walk each ray of K1 (or K2, `any_hit`) on a launch of
    N rows over K clusters: 1 (a lane a ray), or CLOSEST_TEAM (K1) /
    ANYHIT_TEAM (K2)."""
    least = ANYHIT_LANE_MIN_RAYS if any_hit else CLOSEST_LANE_MIN_RAYS
    if k <= LANE_MAX_CLUSTERS and n >= least:
        return 1
    return ANYHIT_TEAM if any_hit else CLOSEST_TEAM


def trace_resident(scene, origin, direction, t_min, t_max, active,
                   any_hit: bool = False, sort_rays: bool = False, grouped=None):
    """Closest hit -> (HitRecord, dropped) or, with any_hit=True,
    ((N,) bool occluded, dropped). dropped is always 0: nothing has a static
    budget to drop from (the JAX contract). t_min/t_max are scalars or (N,).
    sort_rays runs the kernel on the wavefront in schedule order
    (`schedule_order`) and returns the result in the caller's order;
    `grouped` picks the flat (K1/K2) or the grouped (K9/K10) kernels by
    `trace_grouped`. The result is the same per ray either way."""
    n = origin.shape[0]
    t_min = to_device(t_min, torch.float32, origin.device).expand(n)
    t_max = to_device(t_max, torch.float32, origin.device).expand(n)
    rays = (origin, direction, t_min, t_max, active)
    perm = schedule_order(scene, *rays) if sort_rays else None
    if perm is not None:
        rays = tuple(x[perm] for x in rays)
    if trace_grouped(scene, any_hit, grouped):
        out = grouped_anyhit(scene, *rays) if any_hit else grouped_closest(scene, *rays)
    else:
        out = resident_anyhit(scene, *rays) if any_hit else resident_closest(scene, *rays)
    if perm is not None:
        out = unsorted(out, perm) if any_hit else HitRecord(*(unsorted(x, perm) for x in out))
    return out, 0


# --------------------------------------------------------------------------
# kernel wrappers

def resident_closest(scene, o, d, tmin, tmax, active) -> HitRecord:
    """Closest hit of (N,) rays: K1 for CUDA tensors, the plain version for
    CPU tensors."""
    if o.device.type == "cpu":
        return resident_closest_plain(scene, o, d, tmin, tmax, active)
    return _closest("resident_closest", scene, o, d, tmin, tmax, active)


def grouped_closest(scene, o, d, tmin, tmax, active) -> HitRecord:
    """Closest hit through the two-level cull: K9 for CUDA tensors, the
    plain version (K1's contract) for CPU tensors."""
    if o.device.type == "cpu":
        return resident_closest_plain(scene, o, d, tmin, tmax, active)
    return _closest("grouped_closest", scene, o, d, tmin, tmax, active)


def resident_anyhit(scene, o, d, tmin, tmax, active) -> torch.Tensor:
    """(N,) bool occluded: K2 for CUDA tensors, the plain version for CPU
    tensors."""
    if o.device.type == "cpu":
        return resident_anyhit_plain(scene, o, d, tmin, tmax, active)
    return _anyhit("resident_anyhit", scene, o, d, tmin, tmax, active)


def grouped_anyhit(scene, o, d, tmin, tmax, active) -> torch.Tensor:
    """(N,) bool occluded through the two-level cull: K10 for CUDA tensors,
    the plain version (K2's contract) for CPU tensors."""
    if o.device.type == "cpu":
        return resident_anyhit_plain(scene, o, d, tmin, tmax, active)
    return _anyhit("grouped_anyhit", scene, o, d, tmin, tmax, active)


def _closest(name, scene, o, d, tmin, tmax, active) -> HitRecord:
    with launch_span(name, o.shape[0]):
        grouped = name == "grouped_closest"
        rays, tab, n, k, c = _kernel_inputs(scene, o, d, tmin, tmax, active, grouped)
        t = torch.empty(n, dtype=torch.float32, device=o.device)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        tri = torch.empty(n, dtype=torch.int32, device=o.device)
        hit = torch.empty(n, dtype=torch.bool, device=o.device)
        xf, kb, tb = instancing_args(scene, tab)
        rc = getattr(_lib(), name)(
            *map(_ptr, rays), n, _ptr(tab["cl_boxes"]), _ptr(tab["cl_mt_table"]),
            _ptr(tab["cl_tri_map"]), _ptr(tab["cl_count"]), _ptr(tab["scene_aabb"]),
            k, c, xf, kb, tb, *(group_args(tab) if grouped else (flat_lanes(k, n),)),
            _ptr(t), _ptr(u), _ptr(v), _ptr(tri), _ptr(hit), _stream(o))
        _check(rc, name)
        if n:
            LAUNCHES[name] += 1
    return HitRecord(t=t, tri_index=tri, u=u, v=v, is_hit=hit)


def _anyhit(name, scene, o, d, tmin, tmax, active) -> torch.Tensor:
    with launch_span(name, o.shape[0]):
        grouped = name == "grouped_anyhit"
        rays, tab, n, k, c = _kernel_inputs(scene, o, d, tmin, tmax, active, grouped)
        occ = torch.empty(n, dtype=torch.bool, device=o.device)
        xf, kb, _ = instancing_args(scene, tab)
        rc = getattr(_lib(), name)(
            *map(_ptr, rays), n, _ptr(tab["cl_boxes"]), _ptr(tab["cl_mt_table"]),
            _ptr(tab["cl_count"]), _ptr(tab["scene_aabb"]), k, c, xf, kb,
            *(group_args(tab) if grouped else (flat_lanes(k, n, True),)), _ptr(occ),
            _stream(o))
        _check(rc, name)
        if n:
            LAUNCHES[name] += 1
    return occ


def schedule_keys(scene, o, d, tmin, tmax, active) -> torch.Tensor:
    """(N,) int32 cluster-schedule sort keys, (first entered cluster << 12) |
    second entered cluster: K8 for CUDA tensors, the plain version for CPU
    tensors. Needs K < 4096. K8 tests the group boxes first, and only the
    members of the groups a ray enters, where `use_grouped` takes the
    grouped kernels; the keys are the same."""
    if scene.num_clusters >= 1 << SCHEDULE_CLUSTER_BITS:
        raise ValueError(f"{scene.num_clusters} clusters: the schedule key holds "
                         f"{SCHEDULE_CLUSTER_BITS}-bit cluster indices")
    if o.device.type == "cpu":
        return schedule_keys_plain(scene, o, d, tmin, tmax, active)
    with launch_span("schedule_keys", o.shape[0]):
        grouped = use_grouped(scene)
        rays, tab, n, k, _ = _kernel_inputs(scene, o, d, tmin, tmax, active, grouped)
        key = torch.empty(n, dtype=torch.int32, device=o.device)
        xf, kb, _ = instancing_args(scene, tab)
        rc = _lib().schedule_keys(*map(_ptr, rays), n, _ptr(tab["cl_boxes"]),
                                  _ptr(tab["scene_aabb"]), k, xf, kb,
                                  *(group_args(tab) if grouped else (None, None, 0)),
                                  _ptr(key), _stream(o))
        _check(rc, "schedule_keys")
        if n:
            LAUNCHES["schedule_keys"] += 1
    return key


def schedule_order(scene, o, d, tmin, tmax, active):
    """(N,) int64 permutation that puts a wavefront in schedule order (one
    key, one stable sort; inactive rays last): by `schedule_keys` where the
    key can hold the scene's cluster indices (K < 4096), else by
    `morton_key`."""
    if scene.num_clusters < 1 << SCHEDULE_CLUSTER_BITS:
        key = schedule_keys(scene, o, d, tmin, tmax, active)
    else:
        key = torch.where(active, morton_key(scene, o, d), 0xFFFFFFFF)
    return torch.sort(key, stable=True)[1]


def unsorted(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Undo `x = y[perm]`."""
    return torch.empty_like(x).index_copy_(0, perm, x)


def _checked(name: str, x: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    """`x`, contiguous, if it has the dtype, shape and device a kernel reads;
    raises otherwise (broadcast or strided inputs are materialized, since the
    kernels index densely)."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return x.contiguous()


# results derived from tensors, by kind and the tensors' ids (`stamped`)
_STAMPED: dict = {}
_STAMPED_MAX = 64


def stamped(kind, tensors, make):
    """make(), kept under `kind` and the ids of `tensors` beside weak
    references to them and their versions: a later call with the same
    tensor objects, none written in place since, returns the kept result;
    a replaced tensor or an in-place write makes it anew. An error of make()
    keeps nothing. The newest _STAMPED_MAX results are kept."""
    key = (kind, *map(id, tensors))
    versions = [t._version for t in tensors]
    kept = _STAMPED.get(key)
    if (kept is not None and kept[1] == versions
            and all(ref() is t for ref, t in zip(kept[0], tensors))):
        return kept[2]
    value = make()
    _STAMPED.pop(key, None)
    if len(_STAMPED) >= _STAMPED_MAX:
        del _STAMPED[next(iter(_STAMPED))]
    _STAMPED[key] = ([weakref.ref(t) for t in tensors], versions, value)
    return value


def scene_tables(scene, device, grouped: bool = False):
    """The cluster tables the kernels read, validated, by name, with K and
    C: an instanced scene's `cl_xf` too, and with `grouped` the group
    tables. Raises on tables the kernels cannot index (shapes that disagree,
    int32 overflow of slots or virtual ids). The checks run once per set of
    tables, and the contiguous copies of strided tables (an instanced
    scene's boxes) are made once: both are kept (`stamped`), and a table
    replaced or written in place since is checked and copied again."""
    names = ["cl_boxes", "cl_mt_table", "cl_tri_map", "cl_count", "scene_aabb"]
    names += ["cl_xf"] if scene.instanced else []
    names += ["cl_gboxes", "cl_mboxes"] if grouped else []
    tensors = [getattr(scene, name) for name in names]
    if any(t is None for t in tensors):
        return _validated_tables(scene, device, grouped)     # raises

    def validate():
        tab, k, c = _validated_tables(scene, device, grouped)
        # keep the copies only: the scene's own tables stay its to free
        return {name: x for name, x in tab.items() if x is not getattr(scene, name)}, k, c

    copies, k, c = stamped(("scene_tables", str(device), grouped, scene.num_base_tris),
                           tensors, validate)
    return {name: copies.get(name, t) for name, t in zip(names, tensors)}, k, c


def _validated_tables(scene, device, grouped):
    kb, _, c = scene.cl_mt_table.shape
    k = scene.num_clusters
    if k * c >= 2**31:
        raise ValueError("slot count exceeds int32")
    spec = {"cl_boxes": (torch.float32, (8, k)),
            "cl_mt_table": (torch.float32, (kb, 16, c)),
            "cl_tri_map": (torch.int32, (k * c,)),
            "cl_count": (torch.int32, (k,)),
            "scene_aabb": (torch.float32, (2, 3))}
    if scene.instanced:
        ni = scene.cl_xf.shape[0]
        if ni * kb != k:
            raise ValueError(f"{k} instance clusters are not {ni} instances x {kb}")
        if ni * scene.num_base_tris >= 2**31:
            raise ValueError("virtual triangle ids exceed int32")
        spec["cl_xf"] = (torch.float32, (ni, 1, 16))
    if grouped:
        if scene.cl_gboxes is None or scene.cl_mboxes is None:
            raise ValueError("the grouped kernels need the group tables")
        kg = (ni * -(-kb // GROUP)) if scene.instanced else -(-k // GROUP)
        spec["cl_gboxes"] = (torch.float32, (8, kg))
        spec["cl_mboxes"] = (torch.float32, (kg, GROUP, 8))
    return {name: _checked(name, getattr(scene, name), dtype, shape, device)
            for name, (dtype, shape) in spec.items()}, k, c


def instancing_args(scene, tab):
    """(xf pointer, KB, TB) of the C entry points: (None, 0, 0) for a flat
    scene."""
    if "cl_xf" not in tab:
        return None, 0, 0
    return _ptr(tab["cl_xf"]), tab["cl_mt_table"].shape[0], scene.num_base_tris


def group_args(tab):
    """(gboxes pointer, mboxes pointer, Kg) of the grouped entry points. K9
    and K10 read each member box as two 16-byte loads, so a member table
    that does not start on 16 bytes (a view into a larger buffer) is copied
    first; `tab` keeps the copy alive until the launch."""
    if tab["cl_mboxes"].data_ptr() % 16:
        tab["cl_mboxes"] = tab["cl_mboxes"].clone()
    return _ptr(tab["cl_gboxes"]), _ptr(tab["cl_mboxes"]), tab["cl_gboxes"].shape[1]


def _kernel_inputs(scene, o, d, tmin, tmax, active, grouped: bool = False):
    """Validate what the trace kernels read; raise on anything they do not
    take. Returns (rays, tables, N, K, C): the five ray tensors and the scene
    tables by name, all contiguous. The caller holds them until the launch is
    enqueued; after that the caching allocator orders any reuse of their
    memory behind the stream. The ray checks run on every call: a
    wavefront's tensors are new at every bounce, and keeping their checks
    (`stamped`) cost more host time than it saved (PERF.md)."""
    if o.device.type != "cuda":
        raise ValueError(f"rays on {o.device}: the kernels take CUDA tensors")
    n = o.shape[0]
    if n >= 2**31:
        raise ValueError("ray count exceeds int32")
    rays = [_checked(name, x, dtype, shape, o.device) for name, x, dtype, shape in (
        ("origin", o, torch.float32, (n, 3)),
        ("direction", d, torch.float32, (n, 3)),
        ("t_min", tmin, torch.float32, (n,)),
        ("t_max", tmax, torch.float32, (n,)),
        ("active", active, torch.bool, (n,)))]
    tab, k, c = scene_tables(scene, o.device, grouped)
    return rays, tab, n, k, c


def _lib():
    lib = _build.load("resident_trace")
    if not getattr(lib, "_pg_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        rays = [p, p, p, p, p, i]
        inst = [p, i]                       # xf, KB
        groups = [p, p, i]                  # gboxes, mboxes, Kg
        closest = rays + [p, p, p, p, p, i, i] + inst + [i]   # ... TB
        anyhit = rays + [p, p, p, p, i, i] + inst
        lib.resident_closest.argtypes = closest + [i] + [p] * 5 + [p]   # lanes, ...
        lib.grouped_closest.argtypes = closest + groups + [p] * 5 + [p]
        lib.resident_anyhit.argtypes = anyhit + [i, p, p]
        lib.grouped_anyhit.argtypes = anyhit + groups + [p, p]
        for fn in (lib.resident_closest, lib.grouped_closest, lib.resident_anyhit,
                   lib.grouped_anyhit):
            fn.restype = i
        lib.schedule_keys.argtypes = rays + [p, p, i] + inst + groups + [p, p]
        lib.schedule_keys.restype = i
        lib._pg_typed = True
    return lib


def _ptr(x: torch.Tensor) -> int:
    return x.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


# --------------------------------------------------------------------------
# plain PyTorch versions (same formulas, dense, no cull)

def ray_limits(scene, o, d, tmin, tmax, active):
    """(inv_dir, tmin, tmax) as the kernels see them: guarded 1/d, inactive
    rays closed (tmin = F32_MAX, tmax = 0), tmax capped at the scene-AABB
    exit (_load_ray_rows)."""
    g = torch.where(d.abs() < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d)
    inv = 1.0 / g
    t0 = (scene.scene_aabb[0] - o) * inv
    t1 = (scene.scene_aabb[1] - o) * inv
    ex = torch.clamp(torch.maximum(t0, t1).amin(dim=-1), max=F32_MAX)
    cap = torch.clamp(ex, min=0.0) * 1.001 + 1e-4
    tmin = torch.where(active, tmin, F32_MAX)
    tmax = torch.where(active, torch.minimum(tmax, cap), 0.0)
    return inv, tmin, tmax


def cluster_enters_plain(scene, o, inv, tmax, boxes=None):
    """(N, K) exact slab enter distances (+inf where the ray does not enter
    the cluster before tmax) — the kernels' cull, as a dense matrix; with
    `boxes` ((8, Kg) group boxes) the group cull of K9/K10."""
    boxes = scene.cl_boxes if boxes is None else boxes
    enter = torch.zeros((o.shape[0], boxes.shape[1]), dtype=torch.float32, device=o.device)
    exit_ = torch.full_like(enter, float("inf"))
    for ax in range(3):
        t0 = (boxes[ax][None, :] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        t1 = (boxes[3 + ax][None, :] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        enter = torch.maximum(enter, torch.minimum(t0, t1))
        exit_ = torch.minimum(exit_, torch.maximum(t0, t1))
    exit_g = exit_ * 1.0000004 + 1e-7
    ok = (boxes[6][None, :] > 0.0) & (enter <= exit_g) & (exit_g > 0.0) \
        & (enter < tmax[:, None])
    return torch.where(ok, torch.clamp(enter, min=0.0), float("inf"))


def schedule_keys_plain(scene, o, d, tmin, tmax, active) -> torch.Tensor:
    """Plain version of K8: the dense enter matrix, each cluster ranked by
    (enter bits with the low 12 bits cleared) | cluster, the two smallest
    ranks' clusters packed as (first << 12) | second; 0xFFF for a half with
    no entered cluster, 0x7FFFFFFF for an inactive ray."""
    inv, _, tcap = ray_limits(scene, o, d, tmin, tmax, active)
    cmask = (1 << SCHEDULE_CLUSTER_BITS) - 1
    lanes = torch.arange(scene.num_clusters, dtype=torch.int32, device=o.device)[None, :]
    rc, _ = _chunks(o, scene.num_clusters)
    keys = []
    for r0 in range(0, o.shape[0], rc):
        r = slice(r0, r0 + rc)
        en = cluster_enters_plain(scene, o[r], inv[r], tcap[r])
        rank = torch.where(torch.isfinite(en), (en.view(torch.int32) & ~cmask) | lanes, _NO_KEY)
        k1 = rank.amin(dim=1)
        first = torch.where(k1 != _NO_KEY, k1 & cmask, cmask)
        k2 = torch.where(lanes == first[:, None], _NO_KEY, rank).amin(dim=1)
        second = torch.where(k2 != _NO_KEY, k2 & cmask, cmask)
        keys.append((first << SCHEDULE_CLUSTER_BITS) | second)
    key = torch.cat(keys) if keys else torch.empty(0, dtype=torch.int32, device=o.device)
    return torch.where(active, key, _NO_KEY).to(torch.int32)


def morton_key(scene, o, d) -> torch.Tensor:
    """(N,) int64 24-bit sort key for scenes whose cluster indices the
    schedule key cannot hold: interleaved 6-bit-per-axis origin cells (major)
    and interleaved 2-bit-per-axis direction bins (minor). Plain PyTorch, as
    it is plain XLA in the JAX package (pallas_tracer.py::_morton_key)."""
    lo, hi = scene.scene_aabb[0], scene.scene_aabb[1]
    span = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(((o - lo) / span) * 63.0, 0.0, 63.0).to(torch.int64)
    dq = torch.clamp((d * 0.5 + 0.5) * 3.0, 0.0, 3.0).to(torch.int64)

    def spread(x):  # up to 8 bits -> every third bit
        x = (x | (x << 8)) & 0x00F00F
        x = (x | (x << 4)) & 0x0C30C3
        x = (x | (x << 2)) & 0x249249
        return x

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    dmorton = spread(dq[:, 0]) | (spread(dq[:, 1]) << 1) | (spread(dq[:, 2]) << 2)
    return (morton << 6) | dmorton


def _mt_dense(o, d, tmin, tab):
    """Triple-product MT of rays (R,) against triangle slots (12, S):
    ((R, S) t, (R, S) accept-without-tmax). Same arithmetic as the kernels'
    mt_test."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nx, ny, nz = (
        tab[q][None, :] for q in range(12))
    rdx, rdy, rdz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    sx = o[:, 0:1] - v0x
    sy = o[:, 1:2] - v0y
    sz = o[:, 2:3] - v0z
    mx = sy * rdz - sz * rdy
    my = sz * rdx - sx * rdz
    mz = sx * rdy - sy * rdx
    det = -(rdx * nx + rdy * ny + rdz * nz)
    u = e2x * mx + e2y * my + e2z * mz
    v = -(e1x * mx + e1y * my + e1z * mz)
    t_raw = nx * sx + ny * sy + nz * sz
    adet = det.abs()
    ok = adet > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    t = t_raw * inv_det
    neg = det < 0.0
    su = torch.where(neg, -u, u)
    sv = torch.where(neg, -v, v)
    accept = ok & (su >= 0.0) & (sv >= 0.0) & (su + sv <= adet) & (t > tmin[:, None])
    return t, accept


def _slot_table(scene):
    """(12, K*C) component rows of every triangle slot, slot-major."""
    k, _, c = scene.cl_mt_table.shape
    return scene.cl_mt_table[:, :12].permute(1, 0, 2).reshape(12, k * c)


def _chunks(o, s):
    """Ray and slot chunk sizes for the dense test."""
    budget = _PLAIN_CHUNK[o.device.type]
    sc = max(1, min(s, budget // 64))
    rc = max(1, budget // sc)
    return rc, sc


def object_rays(xf, o, d):
    """Rays in the object space of the instances whose transform rows are
    `xf` ((16,) for one instance, or (N, 16) one row per ray), with the
    kernels' arithmetic (csrc/resident_trace.cuh object_ray): explicit
    products and sums left to right, no matmul, the direction not
    normalized, so object t equals world t."""
    m = lambda j: xf[..., j:j + 1]
    ol, dl = [], []
    for i in range(3):
        m0, m1, m2 = m(3 * i), m(3 * i + 1), m(3 * i + 2)
        ol.append(o[:, 0:1] * m0 + o[:, 1:2] * m1 + o[:, 2:3] * m2 + m(9 + i))
        dl.append(d[:, 0:1] * m0 + d[:, 1:2] * m1 + d[:, 2:3] * m2)
    return torch.cat(ol, dim=1), torch.cat(dl, dim=1)


def _instances(scene, o, d):
    """Per instance: (instance, object-space o, d, (KB*C,) bool mask of the
    slots of non-empty clusters); one entry (0, o, d, None) for a flat
    scene, whose padding slots reject themselves (zero normal)."""
    if not scene.instanced:
        yield 0, o, d, None
        return
    kb, _, c = scene.cl_mt_table.shape
    ok = (scene.cl_count > 0).reshape(-1, kb)
    for i in range(scene.cl_xf.shape[0]):
        if bool(ok[i].any()):
            yield (i, *object_rays(scene.cl_xf[i, 0], o, d),
                   ok[i].repeat_interleave(c))


def resident_closest_plain(scene, o, d, tmin, tmax, active) -> HitRecord:
    """Plain version of K1 (and K9): dense MT, lexicographic (t, slot)
    minimum with slot = (instance * KB + cluster) * C + lane, exact
    refinement and re-validation of the winner."""
    _, tmin, tmax = ray_limits(scene, o, d, tmin, tmax, active)
    tab = _slot_table(scene)
    n, s = o.shape[0], tab.shape[1]
    best_t = torch.full((n,), F32_MAX, dtype=torch.float32, device=o.device)
    best_slot = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    rc, sc = _chunks(o, s)
    for inst, oi, di, ok in _instances(scene, o, d):
        for r0 in range(0, n, rc):
            r = slice(r0, min(n, r0 + rc))
            for s0 in range(0, s, sc):
                t, acc = _mt_dense(oi[r], di[r], tmin[r], tab[:, s0:s0 + sc])
                acc = acc & (t < tmax[r, None])
                if ok is not None:
                    acc = acc & ok[None, s0:s0 + sc]
                t = torch.where(acc, t, float("inf"))
                tm, j = t.min(dim=1)             # first minimal slot on ties
                better = tm < best_t[r]          # earlier slots win ties
                best_t[r] = torch.where(better, tm, best_t[r])
                best_slot[r] = torch.where(better, j + s0 + inst * s, best_slot[r])
    return _refine(scene, tab, o, d, best_slot)


def _refine(scene, tab, o, d, slot) -> HitRecord:
    """Exact MT (p = d x e2, q = s x e1) for each ray's winning slot, in the
    winner's object space for an instanced scene, and barycentric
    re-validation (pallas_resident.py:2400-2455)."""
    found = slot >= 0
    safe = slot.clamp(min=0)
    s = tab.shape[1]
    if scene.instanced:
        inst = safe // s
        xf = scene.cl_xf[:, 0][inst]                        # (N, 16)
        o, d = object_rays(xf, o, d)
    w = tab[:, safe % s]                                    # (12, N)
    v0, e1, e2 = w[0:3].T, w[3:6].T, w[6:9].T
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    px = dy * e2[:, 2] - dz * e2[:, 1]
    py = dz * e2[:, 0] - dx * e2[:, 2]
    pz = dx * e2[:, 1] - dy * e2[:, 0]
    det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
    ok = det.abs() > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tx, ty, tz = o[:, 0] - v0[:, 0], o[:, 1] - v0[:, 1], o[:, 2] - v0[:, 2]
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1[:, 2] - tz * e1[:, 1]
    qy = tz * e1[:, 0] - tx * e1[:, 2]
    qz = tx * e1[:, 1] - ty * e1[:, 0]
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv
    slack = 1e-5
    hit = found & ok & (u >= -slack) & (v >= -slack) \
        & (u + v <= 1.0 + 2.0 * slack) & (t > 0.0)
    tri = scene.cl_tri_map[safe]
    if scene.instanced:
        # virtual id: instance * num_base_tris + base canonical id
        tri = torch.round(xf[:, 13]).to(torch.int32) * scene.num_base_tris + tri
    return HitRecord(
        t=torch.where(hit, t, F32_MAX),
        tri_index=torch.where(hit, tri, -1).to(torch.int32),
        u=torch.where(hit, u, 0.0),
        v=torch.where(hit, v, 0.0),
        is_hit=hit,
    )


def resident_anyhit_plain(scene, o, d, tmin, tmax, active) -> torch.Tensor:
    """Plain version of K2 (and K10): any accepted slot with tmin < t <
    capped tmax, in any instance."""
    _, tmin, tmax = ray_limits(scene, o, d, tmin, tmax, active)
    tab = _slot_table(scene)
    n, s = o.shape[0], tab.shape[1]
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    rc, sc = _chunks(o, s)
    for _, oi, di, ok in _instances(scene, o, d):
        for r0 in range(0, n, rc):
            r = slice(r0, min(n, r0 + rc))
            for s0 in range(0, s, sc):
                t, acc = _mt_dense(oi[r], di[r], tmin[r], tab[:, s0:s0 + sc])
                acc = acc & (t < tmax[r, None])
                if ok is not None:
                    acc = acc & ok[None, s0:s0 + sc]
                occ[r] |= acc.any(dim=1)
    return occ
