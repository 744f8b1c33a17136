"""Cluster decomposition of a BVH (numpy copy of
pg2024_dprt_tpu/scene/clusters.py).

The resident trace kernels (ops/resident.py) read the scene as a flat list
of clusters: the SAH BVH is cut into <= K treelets ("clusters") of <= C
triangles each. Because BVH subtrees own contiguous ranges of the reordered
triangle array, each cluster is a contiguous triangle run; re-laid out
cluster-major with padding, the clusters form a dense (K, C) grid.

The cut minimizes cluster count subject to the C bound by greedily splitting
the largest cluster (a BFS cut of the SAH tree keeps clusters spatially
tight, so ray x cluster-AABB culling stays effective).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .bvh import FlatBVH
from ..utils.timing import spanned


class ClusterTable(NamedTuple):
    aabb_min: np.ndarray   # (K, 3) f32
    aabb_max: np.ndarray   # (K, 3) f32
    first: np.ndarray      # (K,) i32 offset into the cluster-major tri arrays
    count: np.ndarray      # (K,) i32 valid triangles in the cluster
    tri_map: np.ndarray    # (K*C,) i32 cluster-major slot -> BVH-order tri (-1 pad)
    tris_per_cluster: int  # C


@spanned("scene.clusters")
def build_clusters(bvh: FlatBVH, max_tris: int = 128, max_clusters: int = 0) -> ClusterTable:
    """Cut the flattened BVH into clusters. Returns a table padded so every
    cluster owns exactly `max_tris` slots in the cluster-major layout."""
    c = max_tris
    if max_clusters <= 0:
        # always enough to satisfy the max_tris bound (plus split slack)
        max_clusters = max(1024, 4 * (bvh.tri_order.shape[0] // max(c, 1) + 1))

    if bvh.tri_order.shape[0] == 0:
        inf = np.float32(np.inf)
        return ClusterTable(
            aabb_min=np.full((1, 3), inf, np.float32),
            aabb_max=np.full((1, 3), -inf, np.float32),
            first=np.zeros((1,), np.int32),
            count=np.zeros((1,), np.int32),
            tri_map=np.full((c,), -1, np.int32),
            tris_per_cluster=c,
        )

    # subtree triangle range of node i: leaves store (first, count); an inner
    # node's range is the union of its subtree's leaves, which is contiguous.
    n = bvh.num_nodes
    lo = np.zeros(n, np.int64)
    hi = np.zeros(n, np.int64)
    # compute ranges bottom-up: iterate nodes in reverse preorder
    for i in range(n - 1, -1, -1):
        if bvh.count[i] > 0:
            lo[i] = bvh.first[i]
            hi[i] = bvh.first[i] + bvh.count[i]
        else:
            left, right = i + 1, bvh.first[i]
            lo[i] = min(lo[left], lo[right])
            hi[i] = max(hi[left], hi[right])

    # BFS cut: split largest cluster until all <= c (or node is a leaf)
    cut = [0]
    while True:
        sizes = [hi[i] - lo[i] for i in cut]
        order = int(np.argmax(sizes))
        if sizes[order] <= c or len(cut) >= max_clusters:
            break
        node = cut[order]
        if bvh.count[node] > 0:  # oversized leaf (can't split) — keep as is
            # move on: mark by swapping to front? find next largest splittable
            splittable = [
                (hi[i] - lo[i], i, j)
                for j, i in enumerate(cut)
                if bvh.count[i] == 0 and (hi[i] - lo[i]) > c
            ]
            if not splittable:
                break
            _, node, order = max(splittable)
        cut.pop(order)
        cut.extend([node + 1, int(bvh.first[node])])

    cut.sort(key=lambda i: lo[i])
    k = len(cut)
    oversized = max(int(hi[i] - lo[i]) for i in cut)
    if oversized > c:
        raise ValueError(
            f"cluster cut failed: largest cluster {oversized} > max_tris {c} "
            f"(raise max_clusters)"
        )

    aabb_min = bvh.bounds_min[cut]
    aabb_max = bvh.bounds_max[cut]
    first = np.arange(k, dtype=np.int32) * c
    count = np.minimum((hi[cut] - lo[cut]).astype(np.int32), c)

    tri_map = np.full(k * c, -1, np.int32)
    for j, node in enumerate(cut):
        cnt = int(count[j])
        tri_map[j * c : j * c + cnt] = np.arange(lo[node], lo[node] + cnt, dtype=np.int32)

    return ClusterTable(
        aabb_min=aabb_min.astype(np.float32),
        aabb_max=aabb_max.astype(np.float32),
        first=first,
        count=count,
        tri_map=tri_map,
        tris_per_cluster=c,
    )
