"""The port's curve primitives (round cubic B-spline hair: scene/curves.py,
ops/curve_intersect.py, ops/curve_exact.py) and every place they enter the
frame, against the JAX package on the same numpy inputs.

Tolerances: the piece tables, the partitioner's owners, boxes and grids, and
the curve test's flags, pieces, segments, t and normals are exact (both
packages run the same float64 numpy flattening and the same f32 operations
in the same order); traces that merge curves with triangle hits are exact
in flags and ids and within 1e-5 in t and the barycentrics; the exact sphere-traced intersector
within 1e-4 in t (its matmuls and reductions round differently); frames
within rtol 1e-3 / atol 1e-4, the bar of tests/test_torch_render.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg2024_dprt_tpu.core import Camera as JCamera
from pg2024_dprt_tpu.models import random_proxy_models as j_random_models
from pg2024_dprt_tpu.ops import curve_exact as jexact
from pg2024_dprt_tpu.ops import trace_api as j_api
from pg2024_dprt_tpu.ops.curve_intersect import intersect_curves as j_intersect
from pg2024_dprt_tpu.ops.curve_intersect import occlude_curves as j_occlude
from pg2024_dprt_tpu.parallel import make_mesh as j_make_mesh
from pg2024_dprt_tpu.parallel import render_image_distributed as j_render_dist
from pg2024_dprt_tpu.render import RenderConfig as JConfig
from pg2024_dprt_tpu.render import render_image as j_render
from pg2024_dprt_tpu.render.shade import surface_attributes as j_surface
from pg2024_dprt_tpu.scene import MeshGeometry as JMesh
from pg2024_dprt_tpu.scene import build_partitioned_scene as j_partition
from pg2024_dprt_tpu.scene import device_scene_from_meshes as j_build
from pg2024_dprt_tpu.scene.curves import CurveSet as JCurveSet
from pg2024_dprt_tpu.scene.lights import EnvironmentMap as JEnv
from pg2024_dprt_tpu.scene.lights import LightTable as JLights
from pg2024_dprt_tpu.scene.procedural import two_room_scene as j_rooms
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.core import Camera, HitRecord
from pg2024_dprt_tpu_torch.ops import curve_exact as texact
from pg2024_dprt_tpu_torch.ops import trace_api as t_api
from pg2024_dprt_tpu_torch.ops.curve_intersect import intersect_curves, occlude_curves
from pg2024_dprt_tpu_torch.parallel import make_mesh, render_image_distributed
from pg2024_dprt_tpu_torch.render import RenderConfig, render_image
from pg2024_dprt_tpu_torch.render.proxy_stages import _use_fused_route
from pg2024_dprt_tpu_torch.render.shade import surface_attributes
from pg2024_dprt_tpu_torch.scene.curves import _BSPLINE as BSPLINE
from pg2024_dprt_tpu_torch.scene.curves import CurveSet

CPU = "cpu"
T = lambda a: torch.as_tensor(np.array(a))
J = lambda a: jnp.asarray(np.asarray(a))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run puts several test files side by side
    on the CPU's cores (tests/test_torch_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(rec):
    return {k: np.asarray(v) for k, v in rec._asdict().items() if isinstance(v, jax.Array)}


def _assert_curves_equal(got: CurveSet, want):
    for name in CurveSet._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _strand(seed=11, points=7):
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.randn(points, 3) * 0.3, axis=0)


def _curly_strand(n_pts=8):
    """tests/test_curve_exact.py's curved strand with varying radius, as
    (S, 4, 3) windows and (S, 4) radii."""
    t = np.linspace(0, 1.5 * np.pi, n_pts)
    pts = np.stack([np.cos(t) * 0.4, t * 0.15, np.sin(t) * 0.4], axis=-1)
    rad = 0.06 + 0.03 * np.sin(t * 2.0)
    windows = np.stack([pts[i:i + 4] for i in range(n_pts - 3)])
    rwin = np.stack([rad[i:i + 4] for i in range(n_pts - 3)])
    return windows, rwin


def _aim_rays(windows, n, seed=1):
    """tests/test_curve_exact.py's rays: from a sphere of radius 2 around
    random spline points, aimed at them."""
    rng = np.random.RandomState(seed)
    u = rng.rand(n)
    seg = rng.randint(0, windows.shape[0], n)
    w = np.stack([np.ones_like(u), u, u * u, u ** 3], -1) @ BSPLINE
    target = np.einsum("nc,ncd->nd", w, windows[seg])
    phi = rng.rand(n) * 2 * np.pi
    cz = rng.rand(n) * 2 - 1
    sz = np.sqrt(1 - cz ** 2)
    o = target + 2.0 * np.stack([sz * np.cos(phi), cz, sz * np.sin(phi)], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


# ---------------------------------------------------------------------------
# flattening


@pytest.mark.parametrize("case", ["strand", "strand_l3", "per_point_radius",
                                  "bspline_tol", "bspline_tol_fine"])
def test_flattening_equals_jax(case):
    """from_strand / from_bspline piece tables equal JAX's bit for bit, with
    and without tolerance= (which picks the piece count)."""
    pts = _strand()
    if case.startswith("strand"):
        l = 3 if case == "strand_l3" else 8
        want = JCurveSet.from_strand(pts, 0.05, pieces_per_segment=l, color=(0.1, 0.2, 0.3))
        got = CurveSet.from_strand(pts, 0.05, pieces_per_segment=l, color=(0.1, 0.2, 0.3),
                                   device=CPU)
    elif case == "per_point_radius":
        rad = np.linspace(0.08, 0.01, pts.shape[0])
        want = JCurveSet.from_strand(pts, rad)
        got = CurveSet.from_strand(pts, rad, device=CPU)
    else:
        win, rad = _curly_strand()
        tol = 1e-3 if case == "bspline_tol" else 1e-4
        want = JCurveSet.from_bspline(win, rad, tolerance=tol)
        got = CurveSet.from_bspline(win, rad, tolerance=tol, device=CPU)
        assert got.num_pieces == win.shape[0] * texact.pieces_for_tolerance(win, rad, tol)
    _assert_curves_equal(got, want)
    lo, hi = got.aabb()
    jlo, jhi = want.aabb()
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    with pytest.raises(ValueError):
        CurveSet.from_strand(pts[:3], 0.05, device=CPU)


# ---------------------------------------------------------------------------
# the curve test


def _wavefront(pts, n=2048, seed=5):
    """Seeded rays aimed near the strand, some inactive, some stopped short
    by tmax, and one along the axis of the first piece."""
    rng = np.random.RandomState(seed)
    c = pts.mean(0)
    o = (c + rng.randn(n, 3) * 2.0).astype(np.float32)
    tgt = pts[rng.randint(0, pts.shape[0], n)] + rng.randn(n, 3) * 0.08
    d = tgt - o
    tmax = np.where(rng.rand(n) < 0.2, rng.rand(n) * 2.0, 1e30)
    act = rng.rand(n) < 0.9
    o[0] = pts[0] - (pts[1] - pts[0])          # along the axis into the cap
    d[0] = pts[1] - pts[0]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32), tmax.astype(np.float32), act


@pytest.mark.parametrize("with_normal", [True, False])
def test_intersect_and_occlude_equal_jax(with_normal):
    """intersect_curves and occlude_curves equal JAX's on every field, bit
    for bit; a small pair budget (many chunks) gives the unchunked result
    bit for bit; an empty set gives no hits."""
    pts = _strand(points=12)
    jc = JCurveSet.from_strand(pts, 0.06)
    tc = CurveSet.from_strand(pts, 0.06, device=CPU)
    o, d, tmax, act = _wavefront(pts)
    want = j_intersect(jc, J(o), J(d), 1e-3, J(tmax), J(act), with_normal=with_normal)
    got = intersect_curves(tc, T(o), T(d), 1e-3, T(tmax), T(act), with_normal=with_normal)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    hit = got.is_hit.numpy()
    assert 200 < hit.sum() < act.sum() and not hit[~act].any()
    assert (got.piece.numpy()[hit] >= 0).all() and (got.piece.numpy()[~hit] == -1).all()
    chunked = intersect_curves(tc, T(o), T(d), 1e-3, T(tmax), T(act),
                               with_normal=with_normal, pair_budget=500)
    for f in got._fields:
        assert torch.equal(getattr(chunked, f), getattr(got, f)), f
    jo = j_occlude(jc, J(o), J(d), 1e-3, J(tmax), J(act))
    to = occlude_curves(tc, T(o), T(d), 1e-3, T(tmax), T(act))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert torch.equal(occlude_curves(tc, T(o), T(d), 1e-3, T(tmax), T(act), pair_budget=77), to)
    empty = CurveSet(*(x[:0] if x.dim() and x is not tc.color else x for x in tc))
    none = intersect_curves(empty, T(o), T(d), 1e-3, T(tmax), T(act), with_normal=with_normal)
    assert not none.is_hit.any() and (none.piece == -1).all() and (none.seg == -1).all()
    assert not occlude_curves(empty, T(o), T(d), 1e-3, T(tmax), T(act)).any()


def test_round_cone_tmax_and_active():
    """JAX's tmax / active case: the second ray's tmax stops short, the third
    is inactive; the hit is at t = 1.8."""
    cs = CurveSet(T([[0.0, 0, 0]]).float(), T([[1.0, 0, 0]]).float(), T([0.2]).float(),
                  T([0.2]).float(), T([0]).int(), T([0.5, 0.5, 0.5]).float())
    o = T([[-2.0, 0.0, 0.0]] * 3).float()
    d = T([[1.0, 0.0, 0.0]] * 3).float()
    tmax = T([10.0, 1.0, 10.0]).float()
    act = T([True, True, False])
    hit = intersect_curves(cs, o, d, 1e-3, tmax, act)
    assert hit.is_hit.tolist() == [True, False, False]
    assert abs(float(hit.t[0]) - 1.8) < 1e-4
    assert occlude_curves(cs, o, d, 1e-3, tmax, act).tolist() == [True, False, False]


# ---------------------------------------------------------------------------
# the exact intersector and the bounds


def test_curve_exact_equals_jax():
    """The bounds equal JAX's (numpy in both); the exact sphere-traced hit
    agrees with JAX's in flags and segments and within 1e-4 in t, and the
    cone hit of from_bspline(tolerance=1e-3) lies within the bound of it."""
    win, rad = _curly_strand()
    for l in (1, 4, 9):
        np.testing.assert_array_equal(texact.tessellation_error_bound(win, rad, l),
                                      jexact.tessellation_error_bound(win, rad, l))
    for tol in (1e-2, 1e-3, 1e-5):
        assert texact.pieces_for_tolerance(win, rad, tol) == jexact.pieces_for_tolerance(
            win, rad, tol)
    for eps in (1e-3, 1e-4):
        assert texact.scan_count_for(win, rad, eps) == jexact.scan_count_for(win, rad, eps)

    tol = 1e-3
    cones = CurveSet.from_bspline(win, rad, tolerance=tol, device=CPU)
    n = 96
    o, d = _aim_rays(win, n)
    want = jexact.intersect_bspline_exact(win, rad, J(o), J(d), 1e-3, 1e30)
    got = texact.intersect_bspline_exact(win, rad, T(o), T(d), 1e-3, 1e30)
    hit = np.asarray(want["is_hit"])
    np.testing.assert_array_equal(got["is_hit"].numpy(), hit)
    np.testing.assert_array_equal(got["seg"].numpy()[hit], np.asarray(want["seg"])[hit])
    np.testing.assert_allclose(got["t"].numpy()[hit], np.asarray(want["t"])[hit], atol=1e-4)
    assert hit.sum() > 60

    # every cone hit point lies within the bound of the exact surface
    # (tests/test_curve_exact.py test_tessellation_bound_holds)
    ch = intersect_curves(cones, T(o), T(d), 1e-3, 1e30, torch.ones(n, dtype=torch.bool))
    assert int(ch.is_hit.sum()) > 60
    x = T(o) + ch.t[:, None] * T(d)
    _, dist = texact._closest_u(T(win).float(), T(rad).float(),
                                x[:, None, :].expand(n, win.shape[0], 3))
    bound = texact.tessellation_error_bound(
        win, rad, texact.pieces_for_tolerance(win, rad, tol)).max()
    assert float(dist.amin(dim=1)[ch.is_hit].abs().max()) <= bound + 1e-3


# ---------------------------------------------------------------------------
# the trace entry points


def _wall_and_strand():
    """JAX's composite scene: a wall at z = 0 and a thick strand at z = 1."""
    p = np.asarray([[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]], np.float32)
    v0, v1, v2 = np.stack([p[0], p[0]]), np.stack([p[1], p[2]]), np.stack([p[2], p[3]])
    strand = np.asarray([[-3.0, 0, 1], [-1, 0, 1], [1, 0, 1], [3, 0, 1]])
    return (v0, v1, v2), strand


def _wavefront_at_wall(n=1024, seed=4):
    rng = np.random.RandomState(seed)
    o = np.concatenate([rng.uniform(-4, 4, (n, 1)), rng.uniform(-1.0, 1.0, (n, 1)),
                        np.full((n, 1), 3.0)], 1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    d[:, :2] += rng.normal(0, 0.1, (n, 2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(rng.rand(n) < 0.3, 2.5, 1e30).astype(np.float32)
    return o, d, tmax, rng.rand(n) > 0.1


@pytest.mark.parametrize("tracer", ["resident", "stackless", "cluster"])
def test_trace_entry_points_merge_curves(tracer):
    """trace_closest_checked / trace_occlusion_checked on a curve scene, for
    every back end, against JAX's composite (stackless): the nearer of
    triangle and curve, curve winners as -2 - piece with u = v = 0, the
    curve any-hit ORed into occlusion."""
    (v0, v1, v2), strand = _wall_and_strand()
    js = j_build([JMesh(v0=v0, v1=v1, v2=v2)], curves=JCurveSet.from_strand(strand, 0.3))
    ts = tscene.device_scene_from_meshes(
        [tscene.MeshGeometry(v0=v0, v1=v1, v2=v2)],
        curves=CurveSet.from_strand(strand, 0.3, device=CPU), device=CPU)
    o, d, tmax, act = _wavefront_at_wall()
    jh, jd = j_api.trace_closest_checked(js, J(o), J(d), 1e-3, J(tmax), J(act),
                                         tracer="stackless")
    th, td = t_api.trace_closest_checked(ts, T(o), T(d), 1e-3, T(tmax), T(act), tracer=tracer)
    assert int(td) == int(jd) == 0
    for f in ("is_hit", "tri_index"):
        np.testing.assert_array_equal(getattr(th, f).numpy(), np.asarray(getattr(jh, f)),
                                      err_msg=f)
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(th, f).numpy(), np.asarray(getattr(jh, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    curve = th.tri_index.numpy() <= -2
    assert curve.sum() > 50 and (th.tri_index.numpy() >= 0).sum() > 50
    assert (th.u.numpy()[curve] == 0).all() and (th.v.numpy()[curve] == 0).all()
    jo, _ = j_api.trace_occlusion_checked(js, J(o), J(d), 1e-3, J(tmax), J(act),
                                          tracer="stackless")
    to, _ = t_api.trace_occlusion_checked(ts, T(o), T(d), 1e-3, T(tmax), T(act), tracer=tracer)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_cutout_retrace_keeps_curve_hits_opaque():
    """A strand in front of a cutout-textured wall through
    trace_closest_cutout equals JAX's: the re-trace skips transparent
    triangles only (tri_index >= 0). Every triangle's uv0 lies on a
    transparent texel, so a curve hit, whose gathered alpha is triangle 0's
    at u = v = 0, reads transparent: without the guard the re-trace would
    pass through the hair."""
    (v0, v1, v2), strand = _wall_and_strand()
    img = np.ones((16, 16, 4), np.float32)
    for rows in (slice(0, 3), slice(13, 16)):
        for cols in (slice(0, 3), slice(13, 16)):
            img[rows, cols, 3] = 0.0
    uv0 = np.zeros((2, 2), np.float32)
    uv1 = np.asarray([[1, 0], [1, 1]], np.float32)
    uv2 = np.asarray([[1, 1], [0, 1]], np.float32)
    jm = JMesh(v0=v0, v1=v1, v2=v2, uv0=uv0, uv1=uv1, uv2=uv2, texture_index=0)
    js = j_build([jm], textures=[img], curves=JCurveSet.from_strand(strand, 0.3))
    arrays = _arrays(js)
    arrays["albedo_textures"] = _arrays(js.albedo_textures)
    arrays["curves"] = _arrays(js.curves)
    scene = tscene.device_scene_from_arrays(arrays, device=CPU)
    assert scene.has_cutout and scene.curves.num_pieces == 8
    o, d, tmax, act = _wavefront_at_wall()
    jh, jd = j_api.trace_closest_cutout(js, J(o), J(d), 1e-3, 1e30, J(act), tracer="stackless")
    th, td = t_api.trace_closest_cutout(scene, T(o), T(d), 1e-3, 1e30, T(act))
    assert int(td) == int(jd) == 0
    for f in ("is_hit", "tri_index"):
        np.testing.assert_array_equal(getattr(th, f).numpy(), np.asarray(getattr(jh, f)),
                                      err_msg=f)
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(th, f).numpy(), np.asarray(getattr(jh, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    curve = th.tri_index <= -2
    assert curve.sum() > 50
    assert (t_api._hit_alpha(scene, th)[curve] < 0.05).all()
    jo, _ = j_api.trace_occlusion_cutout(js, J(o), J(d), 1e-3, 1e30, J(act), tracer="stackless")
    to, _ = t_api.trace_occlusion_cutout(scene, T(o), T(d), 1e-3, 1e30, T(act))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


# ---------------------------------------------------------------------------
# shading and the single-device frame


def _floor_scene():
    """test_curves.py's strand over a floor, lights, env and camera, in both
    packages."""
    p = np.asarray([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32)
    v0, v1, v2 = np.stack([p[0], p[0]]), np.stack([p[1], p[2]]), np.stack([p[2], p[3]])
    strand = np.asarray([[-1.2, 0.5, 0], [-0.4, 0.7, 0], [0.4, 0.7, 0], [1.2, 0.5, 0]])
    lt = np.asarray([[[-0.5, 2.5, -0.5], [0.5, 2.5, -0.5], [0.0, 2.5, 0.5]]], np.float32)
    le = np.asarray([[40.0, 40.0, 40.0]], np.float32)
    cam = ([0, 1.2, 3.0], [0, 0.5, 0], [0, 1, 0], 45.0, 48, 48)
    jax_side = (j_build([JMesh(v0=v0, v1=v1, v2=v2, base_color=(0.7, 0.7, 0.7))],
                        curves=JCurveSet.from_strand(strand, 0.15, color=(0.8, 0.2, 0.1))),
                JLights.from_arrays(lt, le), JEnv.constant((0.2, 0.25, 0.3)),
                JCamera.look_at(*cam))
    mesh = tscene.MeshGeometry(v0=v0, v1=v1, v2=v2, base_color=(0.7, 0.7, 0.7))
    port_side = (tscene.device_scene_from_meshes(
        [mesh], curves=CurveSet.from_strand(strand, 0.15, color=(0.8, 0.2, 0.1), device=CPU),
        device=CPU),
        tscene.LightTable.from_arrays(lt, le, device=CPU),
        tscene.EnvironmentMap.constant((0.2, 0.25, 0.3), device=CPU),
        Camera.look_at(*cam, device=CPU))
    return jax_side, port_side


def test_surface_attributes_on_curve_hits():
    """surface_attributes on the same hits (curve and triangle winners and
    misses): the cone normal, the strand colour and the diffuse BSDF on
    curve winners, as JAX's, before the inside flip."""
    (js, _, _, jc), (ts, _, _, tc) = _floor_scene()
    from pg2024_dprt_tpu.render.pathgen import generate_camera_paths as j_paths

    jp = j_paths(jc, 0)
    jh, _ = j_api.trace_closest_checked(js, jp.origin, jp.direction, 1e-3, jp.tmax,
                                        jp.is_valid, tracer="stackless")
    hits = HitRecord(*(T(x) for x in jh))
    assert (hits.tri_index <= -2).sum() > 100 and (hits.tri_index >= 0).sum() > 100
    want = j_surface(js, jp.origin, jp.direction, jh)
    got = surface_attributes(ts, T(jp.origin), T(jp.direction), hits)
    for f in ("albedo", "bsdf_type", "is_inside"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("point", "normal"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    curve = hits.tri_index <= -2
    np.testing.assert_array_equal(got.albedo[curve].numpy(),
                                  np.broadcast_to([0.8, 0.2, 0.1], (int(curve.sum()), 3))
                                  .astype(np.float32))


@pytest.mark.parametrize("nee_mode", ["ris", "sum"])
def test_curve_frame_matches_jax(nee_mode):
    """render_image of the strand over the floor (48 x 48, 2 bounces)
    against JAX render_image, tracer_diag 0; the strand changes the image;
    fused_frame="on" raises (the fused frame has no curve stage) and "auto"
    composes."""
    (js, jl, je, jc), (ts, tl, te, tc) = _floor_scene()
    jcfg = JConfig(width=48, height=48, spp=1, bounces=2, nee_mode=nee_mode, fused_frame="off")
    cfg = RenderConfig(width=48, height=48, spp=1, bounces=2, nee_mode=nee_mode)
    want, jst = j_render(js, jl, je, jc, jcfg, return_stats=True)
    got, st = render_image(ts, tl, te, tc, cfg, return_stats=True, device=CPU)
    assert st["tracer_diag"] == jst["tracer_diag"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    bare = render_image(ts._replace(curves=None), tl, te, tc, cfg, device=CPU)
    assert int(((got - bare).abs().sum(-1) > 1e-3).sum()) > 40
    with pytest.raises(ValueError):
        render_image(ts, tl, te, tc, dataclasses.replace(cfg, fused_frame="on"), device=CPU)


# ---------------------------------------------------------------------------
# the partitioner and the distributed frame

SIDE = 24
CAM = ([2.0, 1.6, 5.2], [2.0, 0.8, 0.3], [0, 1, 0], 55.0, SIDE, SIDE)
ENV = (0.22, 0.24, 0.3)
CTRL = np.asarray([[0.2, 0.9, 0.5], [1.0, 1.4, 0.5], [2.2, 1.5, 0.4],
                   [3.4, 1.2, 0.5], [4.0, 0.8, 0.6]])


def _rooms(parts):
    """tests/test_distributed_curves.py's scene: two rooms and one strand
    arcing across both, in both packages."""
    jmeshes, jlights = j_rooms(num_rooms=2, tris_per_room=96, seed=5)
    tm = [tscene.MeshGeometry(v0=m.v0, v1=m.v1, v2=m.v2, base_color=m.base_color, name=m.name)
          for m in jmeshes]
    _, tlights = tscene.two_room_scene(num_rooms=2, tris_per_room=96, seed=5, device=CPU)
    jc = JCurveSet.from_strand(CTRL, radius=0.12, color=(0.8, 0.25, 0.1))
    tc = CurveSet.from_strand(CTRL, radius=0.12, color=(0.8, 0.25, 0.1), device=CPU)
    return jmeshes, jlights, jc, tm, tlights, tc


@pytest.mark.parametrize("parts", [2, 4])
def test_partitioned_curves_equal_jax(parts):
    """build_partitioned_scene(curves=): each partition holds JAX's pieces
    (its non-padding rows) in JAX's order, the proxy boxes are JAX's widened
    boxes with JAX's max_length, and the visibility grids (triangle and
    piece boxes) equal JAX's."""
    jmeshes, _, jc, tm, _, tc = _rooms(parts)
    want = j_partition(jmeshes, parts, curves=jc, visibility_grids=True, grid_res=(8, 8, 8))
    got = tscene.build_partitioned_scene(tm, parts, curves=tc, visibility_grids=True,
                                         grid_res=(8, 8, 8), device=CPU)
    owners = 0
    for p, scene in enumerate(got.scenes):
        jp0 = np.asarray(want.stacked.curves.p0[p])
        real = np.isfinite(jp0).all(axis=1)
        assert real[:real.sum()].all()           # JAX pads at the end only
        if scene.curves is None:
            assert not real.any()
            continue
        owners += 1
        m = int(real.sum())
        row = {f: np.asarray(getattr(want.stacked.curves, f)[p]) for f in CurveSet._fields}
        _assert_curves_equal(scene.curves, JCurveSet(*(row[f][:m] if f != "color" else row[f]
                                                       for f in CurveSet._fields)))
    assert owners >= 2
    for f in ("aabb_min", "aabb_max", "max_length", "vis_grid"):
        np.testing.assert_array_equal(getattr(got.proxies, f).numpy(),
                                      np.asarray(getattr(want.proxies, f)), err_msg=f)
    bare = tscene.build_partitioned_scene(tm, parts, device=CPU)
    assert (got.proxies.max_length >= bare.proxies.max_length).all()
    assert (got.proxies.max_length > bare.proxies.max_length).any()


@pytest.fixture(scope="module")
def jax_rooms_frame():
    jmeshes, jlights, jc, _, _, _ = _rooms(2)
    cfg = JConfig(width=SIDE, height=SIDE, spp=1, bounces=2)
    img, stats = j_render_dist(j_partition(jmeshes, 2, curves=jc),
                               j_random_models(jax.random.PRNGKey(0), 2), jlights,
                               JEnv.constant(ENV), JCamera.look_at(*CAM), cfg, j_make_mesh(2),
                               return_stats=True)
    return np.asarray(img), stats


def test_distributed_curve_frame_matches_jax(jax_rooms_frame):
    """render_image_distributed in exact mode at P = 2 on the rooms and the
    strand against JAX's shard_map frame: the image within the frame
    tolerance, the stats equal."""
    _, _, _, tm, tlights, tc = _rooms(2)
    cfg = RenderConfig(width=SIDE, height=SIDE, spp=1, bounces=2)
    got, stats = render_image_distributed(
        tscene.build_partitioned_scene(tm, 2, curves=tc, device=CPU), None, tlights,
        tscene.EnvironmentMap.constant(ENV, device=CPU), Camera.look_at(*CAM, device=CPU),
        cfg, mesh=make_mesh(2, device=CPU), return_stats=True)
    want, want_stats = jax_rooms_frame
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    for k in ("tracer_diag", "migration_truncated", "migration_overflow_waits"):
        assert stats[k] == want_stats[k], k
    assert stats["paths_moved"] > 0


def test_distributed_curve_frame_p4_and_grids_match_single_device():
    """The port at P = 4, with and without visibility grids, equals its own
    single-device curve frame; the strand changes the image."""
    _, _, _, tm, tlights, tc = _rooms(4)
    cfg = RenderConfig(width=SIDE, height=SIDE, spp=1, bounces=2)
    env = tscene.EnvironmentMap.constant(ENV, device=CPU)
    cam = Camera.look_at(*CAM, device=CPU)
    single = render_image(tscene.device_scene_from_meshes(tm, curves=tc, device=CPU), tlights,
                          env, cam, cfg, device=CPU)
    bare = render_image(tscene.device_scene_from_meshes(tm, device=CPU), tlights, env, cam,
                        cfg, device=CPU)
    assert not torch.allclose(single, bare)
    mesh = make_mesh(4, device=CPU)
    for grids in (False, True):
        part = tscene.build_partitioned_scene(tm, 4, curves=tc, visibility_grids=grids,
                                              grid_res=(8, 8, 8), device=CPU)
        got = render_image_distributed(
            part, None, tlights, env, cam,
            dataclasses.replace(cfg, use_visibility_grids=grids), mesh=mesh)
        np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=1e-3, atol=1e-4)


def test_neural_stage_gate_composes_curve_scenes():
    """The fused route kernel's gate rejects curve scenes (its in-kernel
    trace has no curve stage); on CPU tensors it rejects every scene."""
    from pg2024_dprt_tpu_torch.models import random_proxy_models
    from pg2024_dprt_tpu_torch.models.mlp import MLPConfig

    _, _, _, tm, _, tc = _rooms(2)
    small = MLPConfig(width=32, depth=1)
    models = random_proxy_models(3, 2, small, small, device=CPU)
    part = tscene.build_partitioned_scene(tm, 2, curves=tc, device=CPU)
    for scene in part.scenes:
        assert not _use_fused_route(scene, models, "auto", part.proxies)


def test_jax_curve_scene_converts_whole():
    """A JAX curve scene through device_scene_from_arrays (curves as the
    dict of its CurveSet's fields) traces as the port's own build."""
    (js, _, _, jc), (ts, _, _, tc) = _floor_scene()
    arrays = _arrays(js)
    arrays["curves"] = _arrays(js.curves)
    carried = tscene.device_scene_from_arrays(arrays, device=CPU)
    _assert_curves_equal(carried.curves, js.curves)
    o = T(np.asarray(jc.origin)).expand(64, 3).contiguous()
    rng = np.random.RandomState(1)
    d = T(rng.randn(64, 3).astype(np.float32) * 0.2 + [0.0, -0.25, -1.0]).float()
    d = d / d.norm(dim=-1, keepdim=True)
    act = torch.ones(64, dtype=torch.bool)
    a, _ = t_api.trace_closest_checked(carried, o, d, 1e-3, 1e30, act)
    b, _ = t_api.trace_closest_checked(ts, o, d, 1e-3, 1e30, act)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.tri_index <= -2).any()
