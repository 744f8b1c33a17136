"""Proxy-AABB march (counterpart of pg2024_dprt_tpu/ops/pallas_march.py and
of render/proxy_stages.py::march_proxies_xla, its oracle).

Per ray: slab-test all P proxy boxes, then take up to `max_hits` hits front
to back. A hit inside the interval (t_lo + eps, t_cap) is the box's entry
point when the segment start is outside the box, else its exit point with
`is_inside` set; an inside-hit of a box already recorded advances the march
without a record (the dedup). Each record carries the nets' five features:
the hit point normalized to the box and the direction's phi / 2pi, theta / pi
(in object space when the table is instanced, negated on an inside hit).

The kernel, K4 `proxy_march` in csrc/proxy_march.cu, is written by hand for
Hopper and replaces pallas_march.py::_march_kernel; beside it is its plain
PyTorch version, `march_proxies_plain`, a transcription of the oracle. Both
write the oracle's layout (row n * max_hits + slot, valid rows front-packed
per ray) and take the lexicographic (t, row) minimum at each step, so they
agree on ties. The wrapper runs the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.

The dedup mask has 32 bits, so a table of more than 32 rows raises. A row
records at most once a ray, so a ray has at most min(max_hits, P) records;
the kernel stages that many a ray and writes the rest of its max_hits rows
empty, so it takes any max_hits, as the plain version does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import math as cmath
from ..core.types import NNQuery
from ..utils.timing import launch_span
from . import _build
from .resident import F32_MAX, LAUNCHES, _check, _checked, _ptr, _stream, stamped

MAX_PROXY_ROWS = 32


def _check_table(proxies):
    p = proxies.num_partitions
    if p > MAX_PROXY_ROWS:
        raise ValueError(f"{p} proxy rows: the march's dedup mask holds {MAX_PROXY_ROWS}")
    if p < 1:
        raise ValueError("the proxy table is empty")
    return p


def row_ids(proxies):
    """((P,) node of each row, (P,) object of each row), int32: the row
    index itself unless the table carries the instancing fields."""
    p = proxies.num_partitions
    dev = proxies.aabb_min.device
    ar = torch.arange(p, dtype=torch.int32, device=dev)
    node = proxies.node_id.to(torch.int32) if proxies.node_id is not None else ar
    obj = proxies.obj_id.to(torch.int32) if proxies.obj_id is not None else ar
    return node, obj


def proxy_march(proxies, origin, direction, t_cap, active, my_node: int,
                max_hits: int, eps: float) -> NNQuery:
    """March (N,) rays through the proxy table: K4 for CUDA tensors, the
    plain version for CPU tensors. Returns an NNQuery of N * max_hits rows."""
    if origin.device.type == "cpu":
        return march_proxies_plain(proxies, origin, direction, t_cap, active,
                                   my_node, max_hits, eps)
    if origin.device.type != "cuda":
        raise ValueError(f"rays on {origin.device}: the kernel takes CUDA tensors")
    dev = origin.device
    n = origin.shape[0]
    if max_hits < 0:
        raise ValueError(f"max_hits {max_hits} < 0")
    if 5 * n * max_hits >= 2**31:
        raise ValueError("query feature count exceeds int32")
    with launch_span("proxy_march", n * max_hits):
        f32 = torch.float32
        rays = [_checked(name, x, dt, shape, dev) for name, x, dt, shape in (
            ("origin", origin, f32, (n, 3)), ("direction", direction, f32, (n, 3)),
            ("t_cap", t_cap, f32, (n,)), ("active", active, torch.bool, (n,)))]
        table = ProxyTableArgs.of(proxies, dev)
        out = query_columns(n * max_hits, dev)
        rc = _lib().proxy_march(
            *map(_ptr, rays), n, *table.pointers, table.p, int(my_node), int(max_hits),
            float(eps), *(_ptr(out[name]) for name in _KERNEL_COLUMNS), _stream(origin))
        _check(rc, "proxy_march")
        if n and max_hits:
            LAUNCHES["proxy_march"] += 1
    zeros = out.pop("zeros")
    return NNQuery(pixel_index=zeros, shadow_path_id=zeros, **out)


# the kernel's output columns in the order of its C interface; "zeros" is
# the query's pixel_index and shadow_path_id
_KERNEL_COLUMNS = ("features", "aabb_id", "node_id", "hit_sequence", "is_inside", "is_valid",
                   "path_index", "aabb_t", "max_length", "t_ratio", "normalized_t", "zeros")
_FLOAT_COLUMNS = ("features", "aabb_t", "max_length", "t_ratio", "normalized_t")
_INT_COLUMNS = ("aabb_id", "node_id", "hit_sequence", "path_index", "zeros")


def query_columns(q: int, device) -> dict:
    """The march's output columns for q query rows (`_KERNEL_COLUMNS`), as
    views into one allocation, each starting on 16 bytes: the float
    columns (features five words a row), the int32 columns, the two flag
    columns."""
    qp = -(-q // 16) * 16
    words = torch.empty(14 * qp + qp // 2, dtype=torch.int32, device=device)
    floats = words[:9 * qp].view(torch.float32).split([5 * qp, qp, qp, qp, qp])
    ints = words[9 * qp:14 * qp].split([qp] * 5)
    flags = words[14 * qp:].view(torch.bool).split([qp, qp])
    out = dict(zip(_FLOAT_COLUMNS, floats), **dict(zip(_INT_COLUMNS, ints)),
               is_inside=flags[0], is_valid=flags[1])
    if qp != q:
        out = {name: x[:5 * q if name == "features" else q] for name, x in out.items()}
    out["features"] = out["features"].view(q, 5)
    return out


class ProxyTableArgs:
    """A proxy table as the kernels read it: validated, contiguous tensors
    kept alive until the launch is enqueued, and their pointers in the order
    of the C interface (boxes min, boxes max, max_length, row node, row
    object, then world_to_obj, obj_min, obj_span or nulls). The wrappers
    take it from `of`, which makes it once per table."""

    @classmethod
    def of(cls, proxies, device) -> "ProxyTableArgs":
        """The arguments of `proxies` on `device`, made once per table and
        kept (ops/resident.py `stamped`): a table tensor replaced or written
        in place since makes them anew, and a table the kernels do not take
        raises on every call."""
        fields = (proxies.aabb_min, proxies.aabb_max, proxies.max_length, proxies.node_id,
                  proxies.obj_id, proxies.world_to_obj, proxies.obj_min, proxies.obj_span)
        present = tuple(t is not None for t in fields)
        return stamped(("proxy_table", str(device), present),
                       [t for t in fields if t is not None], lambda: cls(proxies, device))

    def __init__(self, proxies, device):
        p = _check_table(proxies)
        f32 = torch.float32
        node, obj = row_ids(proxies)
        self.p = p
        self.keep = [
            _checked("aabb_min", proxies.aabb_min, f32, (p, 3), device),
            _checked("aabb_max", proxies.aabb_max, f32, (p, 3), device),
            _checked("max_length", proxies.max_length, f32, (p,), device),
            _checked("node_id", node, torch.int32, (p,), device),
            _checked("obj_id", obj, torch.int32, (p,), device)]
        if proxies.instanced:
            self.keep += [
                _checked("world_to_obj", proxies.world_to_obj, f32, (p, 3, 4), device),
                _checked("obj_min", proxies.obj_min, f32, (p, 3), device),
                _checked("obj_span", proxies.obj_span, f32, (p, 3), device)]
            self.pointers = [_ptr(x) for x in self.keep]
        else:
            self.pointers = [_ptr(x) for x in self.keep] + [None] * 3


def _lib():
    lib = _build.load("proxy_march")
    if not getattr(lib, "_pg_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.proxy_march.argtypes = ([p] * 4 + [i] + [p] * 8 + [i, i, i, f]
                                    + [p] * 12 + [p])
        lib.proxy_march.restype = i
        lib._pg_typed = True
    return lib


# --------------------------------------------------------------------------
# plain PyTorch version

def march_proxies_plain(proxies, origin, direction, t_cap, active, my_node,
                        max_hits: int, eps: float) -> NNQuery:
    """Plain version of K4: the oracle's program over all rays at once."""
    p = _check_table(proxies)
    n = origin.shape[0]
    dev = origin.device
    f32 = torch.float32

    inv_dir = 1.0 / torch.where(
        direction.abs() < 1e-12, torch.where(direction >= 0, 1e-12, -1e-12), direction)
    row_node, row_obj = row_ids(proxies)
    allowed = (row_node != int(my_node)) & (proxies.max_length > 0.0)      # (P,)
    # disallowed rows (own partition, empty partitions with inverted
    # infinite boxes) take no part in the arithmetic
    bmin_t = torch.where(allowed[:, None], proxies.aabb_min, 0.0)
    bmax_t = torch.where(allowed[:, None], proxies.aabb_max, 0.0)

    # (N, P) slab tests once; marching only moves the interval
    t_enter = torch.full((n, p), -float("inf"), dtype=f32, device=dev)
    t_exit = torch.full((n, p), float("inf"), dtype=f32, device=dev)
    for ax in range(3):
        t0 = (bmin_t[None, :, ax] - origin[:, ax:ax + 1]) * inv_dir[:, ax:ax + 1]
        t1 = (bmax_t[None, :, ax] - origin[:, ax:ax + 1]) * inv_dir[:, ax:ax + 1]
        t_enter = torch.maximum(t_enter, torch.minimum(t0, t1))
        t_exit = torch.minimum(t_exit, torch.maximum(t0, t1))
    box_ok = (t_exit >= t_enter) & allowed[None, :] & active[:, None]
    box_span = torch.clamp(bmax_t - bmin_t, min=1e-12)                      # (P, 3)

    t_lo = torch.zeros((n,), dtype=f32, device=dev)
    seen = torch.zeros((n,), dtype=torch.int64, device=dev)   # bitmask of recorded rows
    slot = torch.zeros((n,), dtype=torch.int64, device=dev)   # next output slot per ray
    rows = torch.arange(n, device=dev)

    out_feat = torch.zeros((n, max_hits, 5), dtype=f32, device=dev)
    out_row = torch.full((n, max_hits), -1, dtype=torch.int64, device=dev)
    out_inside = torch.zeros((n, max_hits), dtype=torch.bool, device=dev)
    out_t = torch.zeros((n, max_hits), dtype=f32, device=dev)
    out_seq = torch.zeros((n, max_hits), dtype=torch.int32, device=dev)
    out_ratio = torch.ones((n, max_hits), dtype=f32, device=dev)

    live = active
    for _ in range(max_hits):
        lo = (t_lo + eps)[:, None]
        inside = t_enter <= lo            # segment start inside this box
        cand = torch.where(inside, t_exit, t_enter)
        ok = box_ok & live[:, None] & (cand > lo) & (cand < t_cap[:, None])
        cand_masked = torch.where(ok, cand, F32_MAX)
        best = torch.argmin(cand_masked, dim=1)        # first minimal row on ties
        best_t = cand_masked[rows, best]
        found = best_t < F32_MAX
        best_inside = inside[rows, best] & found
        dup = best_inside & (((seen >> best) & 1) > 0)
        record = found & (~dup)

        point = origin + best_t[:, None] * direction
        if proxies.instanced:
            # object-space features and the world/object depth scale; for an
            # affine instance the scale is constant along the ray: 1 / |M d|
            m = proxies.world_to_obj[best]                          # (N, 3, 4)
            p_l = torch.stack([
                m[:, i, 0] * point[:, 0] + m[:, i, 1] * point[:, 1]
                + m[:, i, 2] * point[:, 2] + m[:, i, 3] for i in range(3)], dim=-1)
            d_l = torch.stack([
                m[:, i, 0] * direction[:, 0] + m[:, i, 1] * direction[:, 1]
                + m[:, i, 2] * direction[:, 2] for i in range(3)], dim=-1)
            ratio = 1.0 / torch.clamp(cmath.norm(d_l), min=1e-12)
            span = torch.clamp(proxies.obj_span[best], min=1e-12)
            local = (p_l - proxies.obj_min[best]) / span
            feat_dir = torch.where(best_inside[:, None], -d_l, d_l)
        else:
            ratio = torch.ones((n,), dtype=f32, device=dev)
            local = (point - bmin_t[best]) / box_span[best]
            feat_dir = torch.where(best_inside[:, None], -direction, direction)
        phi, theta = cmath.spherical_for_train(cmath.normalize(feat_dir))
        feats = torch.cat([local, (phi / (2.0 * math.pi))[:, None],
                           (theta / math.pi)[:, None]], dim=-1)

        w = record.nonzero(as_tuple=True)[0]
        k = slot[w]
        out_feat[w, k] = feats[w]
        out_row[w, k] = best[w]
        out_inside[w, k] = best_inside[w]
        out_t[w, k] = best_t[w]
        out_seq[w, k] = k.to(torch.int32)
        out_ratio[w, k] = ratio[w]

        seen = torch.where(record, seen | (1 << best), seen)
        slot = torch.where(record, slot + 1, slot)
        t_lo = torch.where(found, best_t, t_lo)
        live = live & found & (slot < max_hits)

    q = n * max_hits
    row_f = out_row.reshape(q)
    valid_f = row_f >= 0
    rows_safe = row_f.clamp(min=0)
    ml = proxies.max_length[rows_safe]
    ratio_f = out_ratio.reshape(q)
    t_f = out_t.reshape(q)
    zeros = torch.zeros((q,), dtype=torch.int32, device=dev)
    return NNQuery(
        features=out_feat.reshape(q, 5),
        # the nets' grouping key is the OBJECT id (instances share a net)
        aabb_id=torch.where(valid_f, row_obj[rows_safe], -1),
        pixel_index=zeros,
        shadow_path_id=zeros,
        hit_sequence=out_seq.reshape(q),
        is_inside=out_inside.reshape(q),
        is_valid=valid_f,
        path_index=torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(max_hits),
        aabb_t=t_f,
        max_length=ml,
        t_ratio=ratio_f,
        # object-space entry depth for the inside-hit comparison
        normalized_t=t_f / torch.clamp(ratio_f * ml, min=1e-12),
        # the routing target is the owning partition of the hit row
        node_id=torch.where(valid_f, row_node[rows_safe], -1),
    )
