"""The reference's scene of a kind whose inputs are triangle meshes (dicts
of float32 (T, 3) arrays v0, v1, v2, a base_color and a name): the kinds
`soup` and `rooms`, and any later kind made of such meshes.

Everything here is worked out from the meshes the benchmark made, and from
nothing the program built: each mesh's partition (a median split of the mesh
box centres, as the configuration's `partitions` asks), each partition's
box (its triangles' bounds), and a `RefScene` of every triangle with the
queries the path tracer asks of it: `closest` (Moller-Trumbore closest hits
with an exact re-validation of the winner), `occluded` and `surface`. Each
query tests every ray against every triangle, so no acceleration structure
of the program's is trusted.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .pathtrace import active_only, cross, dot, normalize, safe_inv

# elements of one dense (rays x triangles) block of the trace
BLOCK_ELEMENTS = {"cuda": 1 << 26, "cpu": 1 << 20}


# --------------------------------------------------------------------------
# partitions of the meshes

def median_split(centres: np.ndarray, parts: int):
    """Index lists of a recursive median split of (N, 3) centres along
    their widest axis."""
    def split(idx, k):
        if k == 1:
            return [idx.tolist()]
        c = centres[idx]
        axis = int(np.argmax(c.max(0) - c.min(0))) if len(idx) > 1 else 0
        order = idx[np.argsort(c[:, axis], kind="stable")]
        mid = min(max(int(round(len(order) * (k // 2) / k)), 0), len(order))
        return split(order[:mid], k // 2) + split(order[mid:], k - k // 2)
    return split(np.arange(centres.shape[0]), parts)


def mesh_partitions(meshes, parts: int):
    """Each mesh's partition."""
    lo = [np.minimum(np.minimum(m["v0"].min(0), m["v1"].min(0)), m["v2"].min(0)) for m in meshes]
    hi = [np.maximum(np.maximum(m["v0"].max(0), m["v1"].max(0)), m["v2"].max(0)) for m in meshes]
    centres = np.array([(a.astype(np.float32) + b.astype(np.float32)) * 0.5 for a, b in zip(lo, hi)])
    owner = np.zeros(len(meshes), np.int64)
    for p, idx in enumerate(median_split(centres, parts)):
        owner[idx] = p
    return owner


def partition_boxes(meshes, owner, parts: int, device):
    """((P, 3) lo, (P, 3) hi, (P,) diagonal) of each partition's triangles."""
    lo = np.full((parts, 3), np.inf, np.float32)
    hi = np.full((parts, 3), -np.inf, np.float32)
    for m, p in zip(meshes, owner):
        tmin = np.minimum(np.minimum(m["v0"], m["v1"]), m["v2"]).min(0)
        tmax = np.maximum(np.maximum(m["v0"], m["v1"]), m["v2"]).max(0)
        lo[p], hi[p] = np.minimum(lo[p], tmin), np.maximum(hi[p], tmax)
    diag = np.linalg.norm(np.maximum(hi - lo, 0.0), axis=-1).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    return t(lo), t(hi), t(diag)


# --------------------------------------------------------------------------
# the scene as the reference holds it

@dataclass
class RefScene:
    """Every triangle of the scene (or of one partition), in the benchmark's
    mesh order: `tab` (12, T) rows v0, e1 = v1 - v0, e2 = v2 - v0, n = e1 x
    e2; `normal` (T, 3) the unit geometric normal, `albedo` (T, 3);
    `part` (T,) the partition of each triangle; `box` (2, 3) its vertices'
    bounds."""

    tab: torch.Tensor
    normal: torch.Tensor
    albedo: torch.Tensor
    part: torch.Tensor
    box: torch.Tensor

    def select(self, mask) -> "RefScene":
        return RefScene(self.tab[:, mask], self.normal[mask], self.albedo[mask],
                        self.part[mask], self.box)

    def closest(self, o, d, tmin, tmax, active):
        """(t, tri, u, v, hit): the nearest accepted triangle in (tmin, tmax),
        re-validated by the exact edge test with a slack of 1e-5; an inactive
        ray has none."""
        return active_only(_closest, lambda o: (torch.finfo(o.dtype).max, -1, 0.0, 0.0, False))(
            self, o, d, tmin, tmax, active)

    def occluded(self, o, d, tmin, tmax, active):
        """Whether any triangle is accepted in (tmin, tmax); an inactive ray is
        not occluded."""
        return active_only(_occluded, lambda o: (False,))(self, o, d, tmin, tmax, active)

    def surface(self, o, d, t, tri, u, v, hit):
        """(point, interpolated unit normal, albedo) at each hit."""
        safe = tri.clamp(min=0)
        n0 = self.normal[safe]
        uu, vv = u[:, None], v[:, None]
        ww = 1.0 - uu - vv
        nrm = normalize(ww * n0 + uu * n0 + vv * n0)
        point = o + torch.where(hit, t, torch.zeros_like(t))[:, None] * d
        return point, nrm, self.albedo[safe]


def ref_scene(meshes, parts, device, dtype=torch.float32) -> RefScene:
    """`meshes`: dicts of float32 (T, 3) arrays v0, v1, v2 and a base_color;
    `parts`: each mesh's partition."""
    v0, v1, v2 = (np.concatenate([m[k] for m in meshes]).astype(np.float32)
                  for k in ("v0", "v1", "v2"))
    e1, e2 = v1 - v0, v2 - v0
    n = np.cross(e1, e2).astype(np.float32)
    gn = np.cross(v1 - v0, v2 - v0)
    gn = (gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-12)).astype(np.float32)
    albedo = np.concatenate([np.tile(np.asarray(m["base_color"], np.float32), (m["v0"].shape[0], 1))
                             for m in meshes])
    part = np.concatenate([np.full(m["v0"].shape[0], p, np.int64) for m, p in zip(meshes, parts)])
    lo = np.minimum(np.minimum(v0, v1), v2).min(0)
    hi = np.maximum(np.maximum(v0, v1), v2).max(0)
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)
    return RefScene(tab=f(np.concatenate([v0, e1, e2, n], axis=1).T), normal=f(gn),
                    albedo=f(albedo), part=torch.as_tensor(part, device=device),
                    box=f(np.stack([lo, hi])))


def reference_scene(meshes, scene: dict, neural: bool, device, dtype=torch.float32):
    """(RefScene of `meshes`, the partition boxes where `neural`, else None):
    the reference's scene of a configuration's `scene` entry whose inputs
    are triangle meshes, its floats in `dtype`."""
    parts = scene.get("partitions", 0)
    owner = mesh_partitions(meshes, parts) if parts else np.zeros(len(meshes), np.int64)
    ref = ref_scene(meshes, owner, device, dtype)
    return ref, (partition_boxes(meshes, owner, parts, device) if neural else None)


# --------------------------------------------------------------------------
# tracing: every ray against every triangle

def _limits(box, o, d, tmin, tmax, active):
    """The ray's interval: inactive rays closed, tmax capped just past the
    scene box's exit."""
    inv = safe_inv(d)
    t0 = (box[0] - o) * inv
    t1 = (box[1] - o) * inv
    ex = torch.clamp(torch.maximum(t0, t1).amin(dim=-1), max=torch.finfo(o.dtype).max)
    cap = torch.clamp(ex, min=0.0) * 1.001 + 1e-4
    big = torch.full_like(tmin, torch.finfo(tmin.dtype).max)
    return (torch.where(active, tmin, big),
            torch.where(active, torch.minimum(tmax, cap), torch.zeros_like(tmax)))


def _mt(o, d, tmin, tab):
    """(R, S) distances and acceptance of rays against triangle columns
    (triple-product Moller-Trumbore)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nx, ny, nz = (tab[q][None, :] for q in range(12))
    rdx, rdy, rdz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    sx, sy, sz = o[:, 0:1] - v0x, o[:, 1:2] - v0y, o[:, 2:3] - v0z
    mx = sy * rdz - sz * rdy
    my = sz * rdx - sx * rdz
    mz = sx * rdy - sy * rdx
    det = -(rdx * nx + rdy * ny + rdz * nz)
    u = e2x * mx + e2y * my + e2z * mz
    v = -(e1x * mx + e1y * my + e1z * mz)
    t_raw = nx * sx + ny * sy + nz * sz
    adet = det.abs()
    ok = adet > 1e-12
    t = t_raw * torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                            torch.zeros_like(det))
    neg = det < 0.0
    su = torch.where(neg, -u, u)
    sv = torch.where(neg, -v, v)
    return t, ok & (su >= 0.0) & (sv >= 0.0) & (su + sv <= adet) & (t > tmin[:, None])


def _blocks(o, s):
    budget = BLOCK_ELEMENTS.get(o.device.type, BLOCK_ELEMENTS["cpu"])
    sc = max(1, min(s, budget // 64))
    return max(1, budget // sc), sc


def _closest(scene: RefScene, o, d, tmin, tmax, active):
    tmin, tmax = _limits(scene.box, o, d, tmin, tmax, active)
    n, s = o.shape[0], scene.tab.shape[1]
    best_t = torch.full((n,), float("inf"), dtype=o.dtype, device=o.device)
    best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    rc, sc = _blocks(o, s)
    for r0 in range(0, n, rc):
        r = slice(r0, min(n, r0 + rc))
        for s0 in range(0, s, sc):
            t, acc = _mt(o[r], d[r], tmin[r], scene.tab[:, s0:s0 + sc])
            t = torch.where(acc & (t < tmax[r, None]), t, float("inf"))
            tm, j = t.min(dim=1)
            better = tm < best_t[r]
            best_t[r] = torch.where(better, tm, best_t[r])
            best[r] = torch.where(better, j + s0, best[r])
    found = best >= 0
    w = scene.tab[:, best.clamp(min=0)]
    v0, e1, e2 = w[0:3].T, w[3:6].T, w[6:9].T
    p = cross(d, e2)
    det = dot(e1, p)
    ok = det.abs() > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    s_ = o - v0
    u = dot(s_, p) * inv
    q = cross(s_, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    slack = 1e-5
    hit = found & ok & (u >= -slack) & (v >= -slack) & (u + v <= 1.0 + 2.0 * slack) & (t > 0.0)
    zero = torch.zeros_like(t)
    return (torch.where(hit, t, torch.full_like(t, torch.finfo(t.dtype).max)), torch.where(hit, best, -1),
            torch.where(hit, u, zero), torch.where(hit, v, zero), hit)


def _occluded(scene: RefScene, o, d, tmin, tmax, active):
    tmin, tmax = _limits(scene.box, o, d, tmin, tmax, active)
    n, s = o.shape[0], scene.tab.shape[1]
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    rc, sc = _blocks(o, s)
    for r0 in range(0, n, rc):
        r = slice(r0, min(n, r0 + rc))
        for s0 in range(0, s, sc):
            t, acc = _mt(o[r], d[r], tmin[r], scene.tab[:, s0:s0 + sc])
            occ[r] |= (acc & (t < tmax[r, None])).any(dim=1)
    return occ
