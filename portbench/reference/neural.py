"""The plain reference of the partitioned frame: exact migration, and the
paper's neural proxies from bounce 1 on.

A configuration with partitions has its kind's reference split the scene
into partitions and give each partition's box (for meshes: a median split
of the mesh box centres, and each partition's triangles' bounds;
triangles.py); the frame here asks the scene only through its queries
(pathtrace.py). Exact mode renders what one device renders (the nearest
hit over every partition, the shadow ray against every partition), so it
is `pathtrace.render_pixels`. Neural mode (`render_pixels_neural`) follows
each path's partition: bounce 0 settles on the partition of the nearest
hit; from bounce 1 on a path traces only its own partition and marches the
other partitions' boxes (up to `max_hits` entries), where a vis / depth
net pair per partition predicts a hit; the nearest predicted hit nearer
than the local one moves the path to that partition, which traces it
again; a path with no local and no predicted hit takes the sky. Shadow
rays are tested against their own partition and the nets of the boxes on
the way to the light.

Plain PyTorch; the nets take bf16 operands and accumulate in float32, as
the configuration states (a control passes another rounding of the
operands); every other float is in the scene's dtype.

`render_pixels_neural` can also report, per pixel, whether a net's
predicted hit decided its path (a route to another partition, or a shadow
ray blocked): the pixels the check draws part of its sample from, so that
it sees the nets and K7's decisions.
"""
from __future__ import annotations

import math

import torch

from .pathtrace import (View, normalize, safe_inv, shade, sky_radiance, spherical,
                        camera_rays)

F32_EPS = 1.1920929e-7
LEAKY_SLOPE = 0.01


# --------------------------------------------------------------------------
# the proxy march

def march(boxes, o, d, t_cap, active, my_node: int, max_hits: int, eps: float) -> dict:
    """Up to `max_hits` proxy-box entries (or exits, from inside a box) per
    ray in (eps, t_cap), nearest first, skipping the ray's own partition.
    Row n * max_hits + k is ray n's k-th: its 5 features (the point in the
    box's unit cube, phi / 2pi, theta / pi of the direction, negated from
    inside), partition, distance and whether it started inside."""
    lo_all, hi_all, diag = boxes
    p = lo_all.shape[0]
    n, dev, dt = o.shape[0], o.device, o.dtype
    lo_all, hi_all = lo_all.to(dt), hi_all.to(dt)
    inv = safe_inv(d)
    allowed = (torch.arange(p, device=dev) != int(my_node)) & (diag > 0.0)
    bmin = torch.where(allowed[:, None], lo_all, 0.0)
    bmax = torch.where(allowed[:, None], hi_all, 0.0)
    t_enter = torch.full((n, p), -float("inf"), dtype=dt, device=dev)
    t_exit = torch.full((n, p), float("inf"), dtype=dt, device=dev)
    for ax in range(3):
        t0 = (bmin[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        t1 = (bmax[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        t_enter = torch.maximum(t_enter, torch.minimum(t0, t1))
        t_exit = torch.minimum(t_exit, torch.maximum(t0, t1))
    box_ok = (t_exit >= t_enter) & allowed[None, :] & active[:, None]
    span = torch.clamp(bmax - bmin, min=1e-12)
    t_lo = torch.zeros((n,), dtype=dt, device=dev)
    seen = torch.zeros((n,), dtype=torch.int64, device=dev)
    slot = torch.zeros((n,), dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    feat = torch.zeros((n, max_hits, 5), dtype=dt, device=dev)
    row = torch.full((n, max_hits), -1, dtype=torch.int64, device=dev)
    inside_q = torch.zeros((n, max_hits), dtype=torch.bool, device=dev)
    t_q = torch.zeros((n, max_hits), dtype=dt, device=dev)
    live = active
    for _ in range(max_hits):
        lo_t = (t_lo + eps)[:, None]
        inside = t_enter <= lo_t
        cand = torch.where(inside, t_exit, t_enter)
        ok = box_ok & live[:, None] & (cand > lo_t) & (cand < t_cap[:, None])
        top = torch.finfo(dt).max
        cand = torch.where(ok, cand, torch.full_like(cand, top))
        best = torch.argmin(cand, dim=1)
        best_t = cand[rows, best]
        found = best_t < top
        best_inside = inside[rows, best] & found
        record = found & ~(best_inside & (((seen >> best) & 1) > 0))
        point = o + best_t[:, None] * d
        local = (point - bmin[best]) / span[best]
        phi, theta = spherical(normalize(torch.where(best_inside[:, None], -d, d)))
        f = torch.cat([local, (phi / (2.0 * math.pi))[:, None], (theta / math.pi)[:, None]], dim=-1)
        w = record.nonzero(as_tuple=True)[0]
        k = slot[w]
        feat[w, k] = f[w]
        row[w, k] = best[w]
        inside_q[w, k] = best_inside[w]
        t_q[w, k] = best_t[w]
        seen = torch.where(record, seen | (1 << best), seen)
        slot = torch.where(record, slot + 1, slot)
        t_lo = torch.where(found, best_t, t_lo)
        live = live & found & (slot < max_hits)
    q = n * max_hits
    row = row.reshape(q)
    valid = row >= 0
    ml = diag.to(dt)[row.clamp(min=0)]
    t_q = t_q.reshape(q)
    return dict(features=feat.reshape(q, 5), part=torch.where(valid, row, -1), valid=valid,
                inside=inside_q.reshape(q), aabb_t=t_q, max_length=ml,
                normalized_t=t_q / torch.clamp(ml, min=1e-12))


# --------------------------------------------------------------------------
# the nets

def _leaky(x):
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


def bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def fp8(x):
    """The nets' operands one precision below bfloat16 (float8 e4m3)."""
    return x.to(torch.float8_e4m3fn).to(torch.float32)


def net(params: dict, x, depth: int, operand=bf16):
    """One PROD net: origin (3) and direction (2) encoders to width w / 2
    each, `depth` residual blocks over their concatenation, the global
    skip, a head of one hidden layer; a LeakyReLU output. Every product
    takes `operand`-rounded operands (bf16) and sums in float32."""
    def lin(h, name):
        return torch.matmul(operand(h), operand(params[name])) + params[name.replace("_w", "_b")]

    x = operand(x.to(torch.float32))
    ho = _leaky(lin(_leaky(lin(x[:, :3], "enc_o_w0")), "enc_o_w1"))
    hd = _leaky(lin(_leaky(lin(x[:, 3:], "enc_d_w0")), "enc_d_w1"))
    out1 = torch.cat([ho, hd], dim=-1)
    h = out1
    for i in range(depth):
        h = _leaky(h + lin(h, f"res_w{i}"))
    h = _leaky(lin(out1 + h, "head_w0"))
    return _leaky(lin(h, "head_w1"))[:, 0]


def predict(nets: dict, depth: int, features, part, valid, operand=bf16):
    """(vis, depth) of each valid query by its partition's pair; 0 elsewhere."""
    vis = torch.zeros(features.shape[0], dtype=torch.float32, device=features.device)
    dep = torch.zeros_like(vis)
    for p in range(next(iter(nets["vis"].values())).shape[0]):
        rows = (valid & (part == p)).nonzero(as_tuple=True)[0]
        if rows.numel():
            x = features[rows]
            vis[rows] = net({k: v[p] for k, v in nets["vis"].items()}, x, depth, operand)
            dep[rows] = net({k: v[p] for k, v in nets["depth"].items()}, x, depth, operand)
    return vis, dep


# --------------------------------------------------------------------------
# the frame

def route(q: dict, vis, dep, live, local_hit, local_t, my_node: int, max_hits: int):
    """(each ray's partition after the nets, whether a net's predicted hit
    chose it): the nearest predicted visible hit nearer than the local one,
    else this partition on a local hit, else -1."""
    dt = local_t.dtype
    vis, dep = vis.to(dt), dep.to(dt)
    pred_hit = q["valid"] & (vis > 0.5)
    pred_len = q["max_length"] * dep
    pred_t = torch.where(q["inside"], torch.where(pred_len > q["aabb_t"], 0.0, q["aabb_t"] - pred_len),
                         q["aabb_t"] + pred_len)
    pred_t = torch.where(pred_hit & (pred_t > F32_EPS), pred_t, torch.full_like(pred_t, torch.finfo(dt).max))
    n = live.shape[0]
    pred_t = pred_t.reshape(n, max_hits)
    first = torch.argmin(pred_t, dim=1, keepdim=True)
    best_t = pred_t.gather(1, first)[:, 0]
    best_node = q["part"].reshape(n, max_hits).gather(1, first)[:, 0]
    use_pred = live & (best_t < local_t)
    return torch.where(use_pred, best_node, torch.where(local_hit, int(my_node), -1)), use_pred


def shadow_weight(q: dict, vis, dep, survives, max_hits: int):
    """1 where the shadow ray survives its partition and no net on the way
    predicts an occluder (a query from inside its box only nearer than
    where it entered), else 0."""
    occ = q["valid"] & (vis > 0.5) & (~q["inside"] | (dep.to(q["normalized_t"].dtype)
                                                     <= q["normalized_t"]))
    blocked = occ.reshape(-1, max_hits).any(dim=1)
    return torch.where(survives, 1.0 - blocked.to(torch.float32), 0.0), survives & blocked


def _query_log(info, kind, local, q, vis, o, d, eps, max_hits):
    """Adds to `info[kind]` each valid query's vis output and whether its
    ray really hits that partition's triangles (what a trained vis net
    predicts)."""
    rows = q["valid"].nonzero(as_tuple=True)[0]
    ray, part = rows // max_hits, q["part"][rows]
    truth = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    big = torch.full((rows.shape[0],), torch.finfo(o.dtype).max, dtype=o.dtype, device=o.device)
    for p in range(len(local)):
        m = part == p
        if bool(m.any()):
            truth[m] = local[p].occluded(o[ray[m]], d[ray[m]], eps[ray[m]], big[m],
                                         torch.ones_like(m[m]))
    info.setdefault(kind, []).append((vis[rows], truth))


def render_pixels_neural(view: View, scene, boxes, nets: dict, net_depth: int,
                         max_hits: int, pix, sample: int, operand=bf16, info=None):
    """(P, 3) value of each pixel in `pix` for one sample of the neural
    partitioned frame, the nets' operands rounded by `operand`. With a dict
    `info`, also `info["decided"]`: (P,) whether a net's predicted hit
    decided the pixel's path at some bounce; and under "secondary" and
    "shadow" each query's vis output and true visibility."""
    dt = view.origin.dtype
    n, dev = pix.shape[0], pix.device
    parts = boxes[0].shape[0]
    local = [scene.select(scene.part == p) for p in range(parts)]
    eps_v = view.t_epsilon
    o, d = camera_rays(view, pix, sample)
    o = o.contiguous()
    tp = torch.ones((n, 3), dtype=dt, device=dev)
    live = torch.ones((n,), dtype=torch.bool, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    big = torch.full((n,), torch.finfo(dt).max, dtype=dt, device=dev)
    eps = torch.full((n,), eps_v, dtype=dt, device=dev)
    direct = torch.zeros((n, 3), dtype=dt, device=dev)
    env = torch.zeros((n, 3), dtype=dt, device=dev)
    decided = torch.zeros((n,), dtype=torch.bool, device=dev)
    for bounce in range(view.bounces):
        t = big.clone()
        tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
        u = torch.zeros((n,), dtype=dt, device=dev)
        v = torch.zeros_like(u)
        hit = torch.zeros_like(live)
        if bounce == 0:
            t, tri, u, v, hit = scene.closest(o, d, eps, big, live)
            node = torch.where(hit, scene.part[tri.clamp(min=0)], node)
            owner_tri = tri
        else:
            dest = torch.full((n,), -1, dtype=torch.int64, device=dev)
            for p in range(parts):
                at = live & (node == p)
                if not bool(at.any()):
                    continue
                lt, _, _, _, lh = local[p].closest(o, d, eps, big, at)
                lh = at & lh
                lt = torch.where(lh, lt, big)
                q = march(boxes, o, d, lt, at, p, max_hits, eps_v)
                vis, dep = predict(nets, net_depth, q["features"], q["part"], q["valid"], operand)
                to, by_net = route(q, vis, dep, at, lh, lt, p, max_hits)
                dest = torch.where(at, to, dest)
                decided |= at & by_net
                if info is not None:
                    _query_log(info, "secondary", local, q, vis, o, d, eps, max_hits)
            routed = live & (dest >= 0)
            env = env + torch.where((live & ~routed)[:, None], tp * sky_radiance(view, d), 0.0)
            live = routed
            node = torch.where(routed, dest, node)
            owner_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
            for p in range(parts):
                at = live & (node == p)
                if not bool(at.any()):
                    continue
                tp_, trp, up_, vp_, hp = local[p].closest(o, d, eps, big, at)
                hp = at & hp
                t, u, v = (torch.where(hp, a, b) for a, b in ((tp_, t), (up_, u), (vp_, v)))
                owner_tri = torch.where(hp, trp, owner_tri)
                hit = hit | hp
        if bounce == 0:
            shade_scene_tri = [(scene, owner_tri)]
        else:
            shade_scene_tri = [(local[p], torch.where(node == p, owner_tri, -1)) for p in range(parts)]
        miss = live & ~hit
        env = env + torch.where(miss[:, None], tp * sky_radiance(view, d), 0.0)
        hit = live & hit
        point = torch.zeros_like(o)
        nrm = torch.zeros_like(o)
        albedo = torch.zeros_like(o)
        for sc, tr in shade_scene_tri:
            m = hit & (tr >= 0)
            pt_, nr_, al_ = sc.surface(o, d, t, tr, u, v, m)
            point = torch.where(m[:, None], pt_, point)
            nrm = torch.where(m[:, None], nr_, nrm)
            albedo = torch.where(m[:, None], al_, albedo)
        sh = shade(view, pix, sample, bounce, d, tp, hit, point, nrm, albedo)
        weight = torch.zeros((n,), dtype=torch.float32, device=dev)
        tmax_s = sh.shadow_dist * (1.0 - 1e-3)
        for p in range(parts):
            at = sh.shadow_live & (node == p)
            if not bool(at.any()):
                continue
            occ = local[p].occluded(sh.point, sh.shadow_dir, eps, tmax_s, at)
            survives = at & ~occ
            q = march(boxes, sh.point, sh.shadow_dir, tmax_s, survives, p, max_hits, eps_v)
            vis, dep = predict(nets, net_depth, q["features"], q["part"], q["valid"], operand)
            w, blocked = shadow_weight(q, vis, dep, survives, max_hits)
            weight = torch.where(at, w, weight)
            decided |= at & blocked
            if info is not None:
                _query_log(info, "shadow", local, q, vis, sh.point, sh.shadow_dir, eps, max_hits)
        direct = direct + sh.shadow_contrib * weight.to(dt)[:, None] / view.shadow_path_count
        o, d, tp, live = sh.point, sh.next_dir, sh.next_throughput, sh.next_live
    if info is not None:
        info["decided"] = decided
    return (direct + env).to(torch.float32)
