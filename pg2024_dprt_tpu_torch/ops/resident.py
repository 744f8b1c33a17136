"""Resident-table closest-hit and any-hit trace (counterpart of
pg2024_dprt_tpu/ops/pallas_resident.py::trace_resident).

Two kernels written by hand for Hopper, in csrc/resident_trace.cu:
  * `resident_closest` (K1) replaces the closest-hit Pallas kernels
    _kernel, _kernel_tiny and _kernel_tiny_t;
  * `resident_anyhit` (K2) replaces _occl_kernel, _occl_kernel_tiny and
    _occl_kernel_tiny_t.
The source's header says what each computes, how, and what bounds it.

Beside each kernel is its plain PyTorch version: a dense Moller-Trumbore
over ray chunks x triangle-slot chunks with the same formulas and no cull.
A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `LAUNCHES` counts the kernel
launches of each wrapper (the frame kernel's, ops/frame.py, as well).

The closest-hit winner is the lexicographic minimum of (t, slot) with slot =
cluster * C + lane, so kernel and plain version agree whatever order the
kernel visits clusters in. The TPU kernels' packed t|lane keys spend the
low log2(C) mantissa bits of t on the lane, so the JAX package may pick
another of two triangles whose t agree to within 2^log2(C) ulps; such
near-ties are the only place the two packages' ids may differ.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.types import HitRecord
from . import _build

F32_MAX = 3.402823466e38

# kernel launches of each wrapper (reset by callers that count a run)
LAUNCHES = {"resident_closest": 0, "resident_anyhit": 0, "frame_sample": 0}

# elements per (ray, slot) chunk of the plain versions' dense test
_PLAIN_CHUNK = {"cpu": 1 << 21, "cuda": 1 << 25}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def trace_resident(scene, origin, direction, t_min, t_max, active,
                   any_hit: bool = False, sort_rays: bool = False):
    """Closest hit -> (HitRecord, dropped) or, with any_hit=True,
    ((N,) bool occluded, dropped). dropped is always 0: nothing has a static
    budget to drop from (the JAX contract). t_min/t_max are scalars or (N,)."""
    if sort_rays:
        raise NotImplementedError(
            "sort_rays (the cluster-schedule sort, _sched_kernel) is not ported yet")
    n = origin.shape[0]
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=origin.device).expand(n)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device).expand(n)
    if any_hit:
        return resident_anyhit(scene, origin, direction, t_min, t_max, active), 0
    return resident_closest(scene, origin, direction, t_min, t_max, active), 0


# --------------------------------------------------------------------------
# kernel wrappers

def resident_closest(scene, o, d, tmin, tmax, active) -> HitRecord:
    """Closest hit of (N,) rays: K1 for CUDA tensors, the plain version for
    CPU tensors."""
    if o.device.type == "cpu":
        return resident_closest_plain(scene, o, d, tmin, tmax, active)
    rays, tab, n, k, c = _kernel_inputs(scene, o, d, tmin, tmax, active)
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    hit = torch.empty(n, dtype=torch.bool, device=o.device)
    rc = _lib().resident_closest(
        *map(_ptr, rays), n, _ptr(tab["cl_boxes"]), _ptr(tab["cl_mt_table"]),
        _ptr(tab["cl_tri_map"]), _ptr(tab["cl_count"]), _ptr(tab["scene_aabb"]),
        k, c, _ptr(t), _ptr(u), _ptr(v), _ptr(tri), _ptr(hit), _stream(o))
    _check(rc, "resident_closest")
    if n:
        LAUNCHES["resident_closest"] += 1
    return HitRecord(t=t, tri_index=tri, u=u, v=v, is_hit=hit)


def resident_anyhit(scene, o, d, tmin, tmax, active) -> torch.Tensor:
    """(N,) bool occluded: K2 for CUDA tensors, the plain version for CPU
    tensors."""
    if o.device.type == "cpu":
        return resident_anyhit_plain(scene, o, d, tmin, tmax, active)
    rays, tab, n, k, c = _kernel_inputs(scene, o, d, tmin, tmax, active)
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    rc = _lib().resident_anyhit(
        *map(_ptr, rays), n, _ptr(tab["cl_boxes"]), _ptr(tab["cl_mt_table"]),
        _ptr(tab["cl_count"]), _ptr(tab["scene_aabb"]), k, c, _ptr(occ),
        _stream(o))
    _check(rc, "resident_anyhit")
    if n:
        LAUNCHES["resident_anyhit"] += 1
    return occ


def _checked(name: str, x: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    """`x`, contiguous, if it has the dtype, shape and device a kernel reads;
    raises otherwise (broadcast or strided inputs are materialized, since the
    kernels index densely)."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return x.contiguous()


def scene_tables(scene, device):
    """The cluster tables the kernels read, validated, by name, with K and C."""
    k, _, c = scene.cl_mt_table.shape
    if k * c >= 2**31:
        raise ValueError("slot count exceeds int32")
    spec = {"cl_boxes": (torch.float32, (8, k)),
            "cl_mt_table": (torch.float32, (k, 16, c)),
            "cl_tri_map": (torch.int32, (k * c,)),
            "cl_count": (torch.int32, (k,)),
            "scene_aabb": (torch.float32, (2, 3))}
    return {name: _checked(name, getattr(scene, name), dtype, shape, device)
            for name, (dtype, shape) in spec.items()}, k, c


def _kernel_inputs(scene, o, d, tmin, tmax, active):
    """Validate what the trace kernels read; raise on anything they do not
    take. Returns (rays, tables, N, K, C): the five ray tensors and the scene
    tables by name, all contiguous. The caller holds them until the launch is
    enqueued; after that the caching allocator orders any reuse of their
    memory behind the stream."""
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
    tab, k, c = scene_tables(scene, o.device)
    return rays, tab, n, k, c


def _lib():
    lib = _build.load("resident_trace")
    if not getattr(lib, "_pg_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.resident_closest.argtypes = [p, p, p, p, p, i, p, p, p, p, p, i, i,
                                         p, p, p, p, p, p]
        lib.resident_closest.restype = i
        lib.resident_anyhit.argtypes = [p, p, p, p, p, i, p, p, p, p, i, i, p, p]
        lib.resident_anyhit.restype = i
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


def cluster_enters_plain(scene, o, inv, tmax):
    """(N, K) exact slab enter distances (+inf where the ray does not enter
    the cluster before tmax) — the kernels' cull, as a dense matrix."""
    boxes = scene.cl_boxes
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


def resident_closest_plain(scene, o, d, tmin, tmax, active) -> HitRecord:
    """Plain version of K1: dense MT, lexicographic (t, slot) minimum,
    exact refinement and re-validation of the winner."""
    _, tmin, tmax = ray_limits(scene, o, d, tmin, tmax, active)
    tab = _slot_table(scene)
    n, s = o.shape[0], tab.shape[1]
    best_t = torch.full((n,), F32_MAX, dtype=torch.float32, device=o.device)
    best_slot = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    rc, sc = _chunks(o, s)
    for r0 in range(0, n, rc):
        r = slice(r0, min(n, r0 + rc))
        for s0 in range(0, s, sc):
            t, ok = _mt_dense(o[r], d[r], tmin[r], tab[:, s0:s0 + sc])
            ok = ok & (t < tmax[r, None])
            t = torch.where(ok, t, float("inf"))
            tm, j = t.min(dim=1)             # first minimal slot on ties
            better = tm < best_t[r]          # earlier chunks win ties
            best_t[r] = torch.where(better, tm, best_t[r])
            best_slot[r] = torch.where(better, j + s0, best_slot[r])
    return _refine(scene, tab, o, d, best_slot)


def _refine(scene, tab, o, d, slot) -> HitRecord:
    """Exact MT (p = d x e2, q = s x e1) for each ray's winning slot, and
    barycentric re-validation (pallas_resident.py:2400-2455)."""
    found = slot >= 0
    w = tab[:, slot.clamp(min=0)]                           # (12, N)
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
    tri = scene.cl_tri_map[slot.clamp(min=0)]
    return HitRecord(
        t=torch.where(hit, t, F32_MAX),
        tri_index=torch.where(hit, tri, -1).to(torch.int32),
        u=torch.where(hit, u, 0.0),
        v=torch.where(hit, v, 0.0),
        is_hit=hit,
    )


def resident_anyhit_plain(scene, o, d, tmin, tmax, active) -> torch.Tensor:
    """Plain version of K2: any accepted slot with tmin < t < capped tmax."""
    _, tmin, tmax = ray_limits(scene, o, d, tmin, tmax, active)
    tab = _slot_table(scene)
    n, s = o.shape[0], tab.shape[1]
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    rc, sc = _chunks(o, s)
    for r0 in range(0, n, rc):
        r = slice(r0, min(n, r0 + rc))
        for s0 in range(0, s, sc):
            t, ok = _mt_dense(o[r], d[r], tmin[r], tab[:, s0:s0 + sc])
            occ[r] |= (ok & (t < tmax[r, None])).any(dim=1)
    return occ
