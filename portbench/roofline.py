"""The least work of a frame, and the time the card needs for it at its
published peaks (one NVIDIA H100 SXM: 67 TFLOP/s in float32 outside the
tensor cores, 3.35 TB/s of HBM).

The work of the fused frame K3 is counted from the reference's own paths
(the sampled pixels' wavefronts, each bounce's closest-hit rays with their
nearest hit and its shadow ray with its occlusion) over the reference's own
clusters of the scene: `CLUSTER` triangles a cluster in Morton order of
their centroids, `GROUP` clusters a group. Per ray, the least cull is the
smaller of the flat cull (every cluster box once) and the two-level cull
(every group box, then the member boxes of each group the ray must open),
and the needed ray-triangle tests are every triangle of every cluster the
ray enters before its nearest hit (a closest-hit ray), or before its end
(an unoccluded shadow ray); an occluded shadow ray needs one box and one
triangle. 40 operations a ray-triangle test, 30 a slab test. Bytes: 28 a
pixel (its id in, the image out), 48 a triangle of a needed cluster, 32 a
cluster box, 100 a distinct triangle hit, 48 a light and 4 a sky texel. The
sampled paths' counts scale to the frame by pixels over sampled pixels, so
the count reads the same whatever implements the frame.
"""
from __future__ import annotations

import torch

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
MT_OPS = 40
SLAB_OPS = 30
CLUSTER = 512
GROUP = 8


def clusters(scene):
    """((lo (K, 3), hi (K, 3), triangles (K,)) of the clusters, (lo, hi,
    member clusters) of the groups) of the reference scene's triangles in
    Morton order of their centroids."""
    tab = scene.tab.to(torch.float32)
    v0 = tab[0:3].T
    v1, v2 = v0 + tab[3:6].T, v0 + tab[6:9].T
    lo_t = torch.minimum(torch.minimum(v0, v1), v2)
    hi_t = torch.maximum(torch.maximum(v0, v1), v2)
    c = (lo_t + hi_t) * 0.5
    q = ((c - scene.box[0]) / torch.clamp(scene.box[1] - scene.box[0], min=1e-12) * 1023).long()
    q = q.clamp(0, 1023)
    key = torch.zeros_like(q[:, 0])
    for bit in range(10):
        for ax in range(3):
            key |= ((q[:, ax] >> bit) & 1) << (3 * bit + ax)
    order = torch.argsort(key)
    t = order.shape[0]
    k = -(-t // CLUSTER)
    kg = -(-k // GROUP)

    def padded(x, rows, fill):
        return torch.cat([x, x.new_full((rows - x.shape[0], 3), fill)])

    clo = padded(lo_t[order], k * CLUSTER, float("inf")).reshape(k, CLUSTER, 3).amin(1)
    chi = padded(hi_t[order], k * CLUSTER, -float("inf")).reshape(k, CLUSTER, 3).amax(1)
    count = torch.full((k,), float(CLUSTER), device=clo.device)
    count[-1] = t - (k - 1) * CLUSTER
    glo = padded(clo, kg * GROUP, float("inf")).reshape(kg, GROUP, 3).amin(1)
    ghi = padded(chi, kg * GROUP, -float("inf")).reshape(kg, GROUP, 3).amax(1)
    members = torch.clamp(k - torch.arange(kg, device=clo.device) * GROUP, max=GROUP).float()
    return (clo, chi, count), (glo, ghi, members)


def _enters(o, inv, tmax, lo, hi):
    """(N, K) slab enter distances, +inf where the ray does not enter the
    box before tmax."""
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    enter = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
    exit_ = torch.maximum(t0, t1).amin(-1) * 1.0000004 + 1e-7
    ok = (enter <= exit_) & (exit_ > 0.0) & (enter < tmax[:, None])
    return torch.where(ok, enter, float("inf"))


def _limits(box, o, d, tmax, active):
    g = torch.where(d.abs() < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d)
    inv = 1.0 / g
    ex = torch.maximum((box[0] - o) * inv, (box[1] - o) * inv).amin(-1)
    cap = torch.clamp(ex, min=0.0) * 1.001 + 1e-4
    return inv, torch.where(active, torch.minimum(tmax, cap), 0.0)


def wave_work(scene, cl, rays, lim, need_all):
    """(tests, slabs, needed-cluster mask) of one wavefront: `lim` the
    distance each ray must search to (its hit, or its end), `need_all` the
    rays that must search to it (not occluded shadow rays)."""
    (clo, chi, count), (glo, ghi, members) = cl
    o, d, _, tmax, active = (x.to(torch.float32) if x.is_floating_point() else x for x in rays)
    inv, tcap = _limits(scene.box.to(torch.float32), o, d, tmax, active)
    lim = torch.minimum(lim.to(torch.float32), tcap)
    rows = active & need_all
    en = _enters(o, inv, tcap, clo, chi)
    need = (en <= lim[:, None]) & rows[:, None]
    tests = float((need.to(torch.float32) * count[None]).sum())
    en_g = _enters(o, inv, tcap, glo, ghi)
    need_g = (en_g <= lim[:, None]) & rows[:, None]
    two = glo.shape[0] + (need_g.to(torch.float32) * members[None]).sum(1)
    slabs = float(torch.clamp(two, max=clo.shape[0])[rows].sum())
    n_occ = int((active & ~need_all).sum())
    return tests + n_occ, slabs + n_occ, need.any(0)


def frame_work(scene, trace_log, pixels: int, lights: int, sky_texels: int) -> dict:
    """Operations and bytes of one frame of `pixels` pixels from the
    reference's `trace_log` of its sampled paths."""
    cl = clusters(scene)
    tests = slabs = 0.0
    needed = torch.zeros(cl[0][0].shape[0], dtype=torch.bool, device=scene.tab.device)
    hit_tris, paths = set(), 0
    for wave in trace_log:
        if wave["bounce"] == 0:
            paths += wave["closest"][0].shape[0]
        for rays, lim, need_all in ((wave["closest"], wave["t"], torch.ones_like(wave["hit"])),
                                    (wave["shadow"], wave["shadow"][3], ~wave["occluded"])):
            t, s, nd = wave_work(scene, cl, rays, lim, need_all)
            tests, slabs = tests + t, slabs + s
            needed |= nd
        hit_tris.update(wave["tri"][wave["hit"]].tolist())
    scale = pixels / max(paths, 1)
    counts = cl[0][2]
    nbytes = (28 * pixels + 48 * float(counts[needed].sum()) + 32 * counts.shape[0] + 24
              + 100 * min(len(hit_tris) * scale, scene.tab.shape[1]) + 48 * lights + 4 * sky_texels)
    return {"tests": tests * scale, "slabs": slabs * scale, "bytes": nbytes}


def bound_ms(work: dict):
    """(least ms, what bounds it): the larger of the bytes over HBM bandwidth
    and the float32 operations over the float32 peak."""
    byte_s = work["bytes"] / HBM_BYTES_PER_S
    op_s = (work["tests"] * MT_OPS + work["slabs"] * SLAB_OPS) / FP32_FLOP_PER_S
    return max(byte_s, op_s) * 1e3, ("operations" if op_s >= byte_s else "bytes")
