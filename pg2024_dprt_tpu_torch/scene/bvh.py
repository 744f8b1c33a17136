"""Host-side BVH construction (binned SAH) flattened for lockstep traversal.

A numpy copy of pg2024_dprt_tpu/scene/bvh.py (the port imports nothing of
the JAX package). Both packages must build the same tree from the same
triangles: the cluster tables, and so every trace result, follow from it.
We emit a *threaded* BVH: nodes in DFS preorder with
skip links, so device traversal needs no stack — every ray carries a single
`node` cursor and each step is a masked gather + slab test, which vectorizes
across a whole wavefront on the VPU.

Layout:
  nodes in depth-first preorder; for an inner node i the left child is i+1
  and `first[i]` holds the right child index; `skip[i]` is the node visited
  when the subtree is skipped (-1 terminates). Leaves store `first` = offset
  into the reordered triangle array, `count` in [1, max_leaf].

A pure-Python/numpy builder is the portable default; `native/bvh_builder.cpp`
provides a C++ drop-in (same output arrays) for large scenes; the port's
scene/native_bvh.py compiles that same source into its own build directory.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..utils.timing import spanned

MAX_LEAF = 4
_SAH_BINS = 16


class FlatBVH(NamedTuple):
    bounds_min: np.ndarray  # (M, 3) f32
    bounds_max: np.ndarray  # (M, 3) f32
    first: np.ndarray       # (M,) i32  inner: right-child index; leaf: tri offset
    count: np.ndarray       # (M,) i32  0 for inner nodes
    skip: np.ndarray        # (M,) i32  -1 = traversal done
    tri_order: np.ndarray   # (T,) i32  permutation of input triangles

    @property
    def num_nodes(self) -> int:
        return self.bounds_min.shape[0]


@spanned("scene.bvh")
def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, max_leaf: int = MAX_LEAF,
              use_native: bool = True) -> FlatBVH:
    """Build from triangle vertex arrays (T,3). Returns flattened arrays.

    Large scenes route through the C++ builder (native/bvh_builder.cpp via
    scene/native_bvh.py); this python implementation is the portable
    fallback and the oracle the native build is tested against."""
    t = v0.shape[0]
    if use_native and t >= 4096:
        from .native_bvh import build_bvh_native

        native = build_bvh_native(v0, v1, v2, max_leaf)
        if native is not None:
            return native
    if t == 0:
        # Degenerate empty BVH: single empty leaf whose AABB never hits.
        inf = np.float32(np.inf)
        return FlatBVH(
            bounds_min=np.full((1, 3), inf, np.float32),
            bounds_max=np.full((1, 3), -inf, np.float32),
            first=np.zeros((1,), np.int32),
            count=np.zeros((1,), np.int32),
            skip=np.full((1,), -1, np.int32),
            tri_order=np.zeros((0,), np.int32),
        )

    tri_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = ((tri_min + tri_max) * 0.5).astype(np.float32)

    order = np.arange(t, dtype=np.int32)

    # Recursive build into a tree of tuples, then flatten in preorder.
    # Node tuple: ("leaf", lo, hi, bmin, bmax) or ("inner", left, right, bmin, bmax)
    def build_range(lo: int, hi: int):
        idx = order[lo:hi]
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        n = hi - lo
        if n <= max_leaf:
            return ("leaf", lo, hi, bmin, bmax)

        cmin = centroid[idx].min(axis=0)
        cmax = centroid[idx].max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        if extent[axis] <= 1e-12:
            mid = lo + n // 2
        else:
            # Binned SAH along the widest centroid axis.
            c = centroid[idx, axis]
            scale = _SAH_BINS / max(float(extent[axis]), 1e-12)
            bins = np.minimum(((c - cmin[axis]) * scale).astype(np.int32), _SAH_BINS - 1)
            bin_counts = np.bincount(bins, minlength=_SAH_BINS)
            bin_min = np.full((_SAH_BINS, 3), np.inf, np.float32)
            bin_max = np.full((_SAH_BINS, 3), -np.inf, np.float32)
            for b in range(_SAH_BINS):
                sel = bins == b
                if sel.any():
                    bin_min[b] = tri_min[idx[sel]].min(axis=0)
                    bin_max[b] = tri_max[idx[sel]].max(axis=0)

            def accum_area(mins, maxs, counts):
                area = np.zeros(_SAH_BINS, np.float32)
                cur_min = np.full(3, np.inf, np.float32)
                cur_max = np.full(3, -np.inf, np.float32)
                total = 0
                totals = np.zeros(_SAH_BINS, np.int64)
                for b in range(_SAH_BINS):
                    if counts[b] > 0:
                        cur_min = np.minimum(cur_min, mins[b])
                        cur_max = np.maximum(cur_max, maxs[b])
                    total += counts[b]
                    totals[b] = total
                    d = np.maximum(cur_max - cur_min, 0.0)
                    area[b] = 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]) if total else 0.0
                return area, totals

            l_area, l_count = accum_area(bin_min, bin_max, bin_counts)
            r_area, r_count = accum_area(bin_min[::-1], bin_max[::-1], bin_counts[::-1])
            r_area, r_count = r_area[::-1], r_count[::-1]
            # Cost of splitting after bin b (left = bins 0..b).
            cost = np.full(_SAH_BINS - 1, np.inf, np.float32)
            for b in range(_SAH_BINS - 1):
                nl, nr = l_count[b], r_count[b + 1]
                if nl and nr:
                    cost[b] = l_area[b] * nl + r_area[b + 1] * nr
            best = int(np.argmin(cost))
            if not np.isfinite(cost[best]):
                mid = lo + n // 2
            else:
                left_sel = bins <= best
                mid = lo + int(left_sel.sum())
                # Partition the order slice in place.
                order[lo:hi] = np.concatenate([idx[left_sel], idx[~left_sel]])
                if mid == lo or mid == hi:
                    mid = lo + n // 2
        if mid == lo or mid == hi:
            mid = lo + n // 2
            # median fallback: sort by centroid on the split axis
            c = centroid[order[lo:hi], axis]
            perm = np.argsort(c, kind="stable")
            order[lo:hi] = order[lo:hi][perm]

        left = build_range(lo, mid)
        right = build_range(mid, hi)
        return ("inner", left, right, bmin, bmax)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        root = build_range(0, t)
    finally:
        sys.setrecursionlimit(old_limit)

    # Flatten in DFS preorder with skip links. Placeholder -3 marks "exits the
    # enclosing left subtree"; each inner node patches its left subtree's exit
    # spine to its right-child index once that index is known.
    bounds_min, bounds_max, first, count, skip = [], [], [], [], []

    def emit2(node, skip_to: int):
        i = len(first)
        bounds_min.append(node[-2])
        bounds_max.append(node[-1])
        if node[0] == "leaf":
            first.append(node[1])
            count.append(node[2] - node[1])
            skip.append(skip_to)
        else:
            first.append(0)
            count.append(0)
            skip.append(skip_to)
            emit2(node[1], -3)  # placeholder, patched once right index is known
            right_idx = len(first)
            first[i] = right_idx
            # fix the left subtree root's skip (and any -3 leftovers in it)
            for j in range(i + 1, right_idx):
                if skip[j] == -3:
                    skip[j] = right_idx
            emit2(node[2], skip_to)

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))
    emit2(root, -1)

    return FlatBVH(
        bounds_min=np.asarray(bounds_min, np.float32),
        bounds_max=np.asarray(bounds_max, np.float32),
        first=np.asarray(first, np.int32),
        count=np.asarray(count, np.int32),
        skip=np.asarray(skip, np.int32),
        tri_order=order.astype(np.int32),
    )
