"""Two-level instancing and the grouped trace in the port, against the JAX
package on the CPU (Pallas in interpret mode, as tests/test_instanced_geometry.py
runs it).

The port runs its plain versions here: a dense Moller-Trumbore per instance
on the rays transformed with the kernels' arithmetic. The CUDA kernels
(K1/K2 instanced, K9/K10 grouped, K3's grouped mode) are held against these
plain versions by tests/test_torch_kernels_gpu.py, on the card.

Tolerances: the scene tables equal JAX's field by field; hit flags and
occlusion equal; t rtol 1e-5 (both transform the ray into object space with
float32 sums in another order); ids equal except at near-ties, where the
two winners' t agree within 2^-14 relative (the TPU kernels' packed t|lane
keys); images rtol 1e-3 / atol 1e-4 (tests/test_torch_render.py); stage
outputs as tests/test_torch_route.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pg2024_dprt_tpu.render.proxy_stages as jps
from pg2024_dprt_tpu.core import Camera as JCamera
from pg2024_dprt_tpu.core.types import HitRecord as JHitRecord
from pg2024_dprt_tpu.core.types import PathState as JPathState
from pg2024_dprt_tpu.models import mlp as jmlp
from pg2024_dprt_tpu.models import proxy as jproxy
from pg2024_dprt_tpu.ops.pallas_resident import trace_resident as j_trace
from pg2024_dprt_tpu.ops.traversal import traverse_bvh
from pg2024_dprt_tpu.render import RenderConfig as JConfig
from pg2024_dprt_tpu.render import render_image as j_render
from pg2024_dprt_tpu.render.shade import surface_attributes as j_attrs
from pg2024_dprt_tpu.scene import cornell_box as j_cornell
from pg2024_dprt_tpu.scene import device_scene_from_meshes as j_build
from pg2024_dprt_tpu.scene import random_tri_soup
from pg2024_dprt_tpu.scene.geometry import ProxyTable as JProxyTable
from pg2024_dprt_tpu.scene.geometry import _instance_tables as j_instance_tables
from pg2024_dprt_tpu.scene.geometry import device_scene_from_instances as j_instances
from pg2024_dprt_tpu.scene.lights import EnvironmentMap as JEnv
from pg2024_dprt_tpu.scene.lights import LightTable as JLights
from pg2024_dprt_tpu_torch import models as tmodels
from pg2024_dprt_tpu_torch import ops as tops
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.core import Camera, HitRecord
from pg2024_dprt_tpu_torch.core.types import PathState
from pg2024_dprt_tpu_torch.models import mlp as tmlp
from pg2024_dprt_tpu_torch.ops import resident as tres
from pg2024_dprt_tpu_torch.render import RenderConfig, render_image
from pg2024_dprt_tpu_torch.render import proxy_stages as tps
from pg2024_dprt_tpu_torch.render.shade import surface_attributes
from pg2024_dprt_tpu_torch.scene import geometry as tgeo

T_MIN = 1e-3
TABLES = ("cl_boxes", "cl_aabb_min", "cl_aabb_max", "cl_count", "cl_tri_map", "cl_xf",
          "cl_gboxes", "cl_mboxes", "scene_aabb", "cl_mt_table")


def _arrays(rec):
    return {k: np.asarray(v) for k, v in rec._asdict().items() if isinstance(v, jax.Array)}


def _transforms(ni, seed):
    """Random affines: rotation * per-axis scale + translation
    (tests/test_instanced_geometry.py)."""
    rng = np.random.RandomState(seed)
    m = np.zeros((ni, 3, 4), np.float32)
    for i in range(ni):
        r, _ = np.linalg.qr(rng.randn(3, 3))
        m[i, :, :3] = (r @ np.diag(0.5 + rng.rand(3) * 1.5)).astype(np.float32)
        m[i, :, 3] = (rng.rand(3) * 6.0 - 3.0).astype(np.float32)
    return m


def _pair(meshes, m, tpc):
    """The JAX instanced scene and the port's, carried across."""
    js = j_instances(meshes, m, tris_per_cluster=tpc)
    return js, tscene.device_scene_from_arrays(_arrays(js), device="cpu")


def _aimed_rays(m, n, seed, jitter=0.5):
    """Rays from a box around the instances, aimed at random points inside
    random instances (so the comparison meets real hits)."""
    rng = np.random.RandomState(seed)
    o = (rng.rand(n, 3) * 10.0 - 5.0).astype(np.float32)
    centers = np.einsum("iab,b->ia", m[:, :, :3], np.full(3, 0.5, np.float32)) + m[:, :, 3]
    pick = rng.randint(0, m.shape[0], n)
    target = centers[pick] + (rng.rand(n, 3).astype(np.float32) - 0.5) * jitter
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, rng


def _assert_hits_match(got, want):
    hit = np.asarray(want.is_hit)
    np.testing.assert_array_equal(got.is_hit.numpy(), hit)
    gt, wt = got.t.numpy(), np.asarray(want.t)
    np.testing.assert_allclose(gt[hit], wt[hit], rtol=1e-5)
    mismatch = hit & (got.tri_index.numpy() != np.asarray(want.tri_index))
    near_tie = np.abs(gt - wt) <= 2.0 ** -14 * np.maximum(1.0, np.abs(wt))
    assert near_tie[mismatch].all()
    assert (got.tri_index.numpy()[~hit] == -1).all()


# ---------------------------------------------------------------------------
# the scene build

@pytest.mark.parametrize("case", ["instanced", "n_valid", "c2048"])
def test_instance_tables_match_jax(case):
    """device_scene_from_instances / _instance_tables build JAX's tables
    field by field, also with padding instances (n_valid < I) and at
    2048-slot clusters."""
    tpc = 2048 if case == "c2048" else 64
    meshes = [random_tri_soup(4096 if case == "c2048" else 1500, seed=3)]
    m = _transforms(3, seed=5)
    if case == "n_valid":
        base_j = j_build(meshes, tris_per_cluster=tpc)
        want, (jw0, jw1, jne) = j_instance_tables(base_j, m, n_valid=2)
        base_t = tscene.device_scene_from_meshes(meshes, tris_per_cluster=tpc, device="cpu")
        got, (tw0, tw1, tne) = tgeo._instance_tables(
            {k: v.numpy() for k, v in base_t._asdict().items() if torch.is_tensor(v)}, m,
            n_valid=2)
        for name, arr in want.items():
            if arr is not None:
                np.testing.assert_array_equal(got[name], np.asarray(arr), err_msg=name)
        for a, b in ((tw0, jw0), (tw1, jw1), (tne, jne)):
            np.testing.assert_array_equal(a, b)
        kb = base_t.num_clusters
        assert (got["cl_count"][2 * kb:] == 0).all() and not tne[2 * kb:].any()
        return
    js = j_instances(meshes, m, tris_per_cluster=tpc)
    ts = tscene.device_scene_from_instances(meshes, m, tris_per_cluster=tpc, device="cpu")
    for name in TABLES:
        want = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert ts.instanced and ts.num_clusters == 3 * ts.cl_mt_table.shape[0]
    assert ts.num_base_tris == js.num_base_tris and ts.tris_per_cluster == tpc
    # instanced scenes carry no textures, so they have no cutouts
    assert ts.albedo_textures is None and not ts.textured and not ts.has_cutout


@pytest.mark.parametrize("tpc", [16, 128])
def test_flat_group_tables_match_jax(tpc):
    """Every flat scene gets JAX's group tables (the last group padded with
    empty members)."""
    meshes = [random_tri_soup(3000, seed=1)]
    js = j_build(meshes, tris_per_cluster=tpc)
    ts = tscene.device_scene_from_meshes(meshes, tris_per_cluster=tpc, device="cpu")
    for name in ("cl_gboxes", "cl_mboxes"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    assert not ts.instanced and ts.cl_gboxes.shape[1] == -(-ts.num_clusters // tgeo.CL_GROUP)


# ---------------------------------------------------------------------------
# the traces

@pytest.mark.parametrize("mode", [dict(grouped=False), dict(grouped=True, hbm_table=False),
                                  dict(grouped=True, hbm_table=True)])
def test_instanced_traces_match_jax(mode):
    """The plain instanced closest hit and any-hit against JAX
    trace_resident flat, grouped and grouped with the table streamed."""
    meshes = [random_tri_soup(1500, seed=3)]
    m = _transforms(3, seed=11)
    js, ts = _pair(meshes, m, 64)
    o, d, rng = _aimed_rays(m, 1024, 13)
    act = rng.rand(1024) > 0.1
    tmax = np.where(rng.rand(1024) > 0.5, 3.4e38, 4.0).astype(np.float32)
    jargs = (jnp.asarray(o), jnp.asarray(d), T_MIN, jnp.asarray(tmax), jnp.asarray(act))
    targs = tuple(map(torch.as_tensor, (o, d))) + (T_MIN,) + tuple(
        map(torch.as_tensor, (tmax, act)))
    want, _ = j_trace(js, *jargs, **mode)
    got, dropped = tops.trace_resident(ts, *targs, grouped=mode["grouped"])
    assert dropped == 0
    _assert_hits_match(got, want)
    assert got.is_hit.sum() > 200
    # ids are virtual: instance * num_base_tris + base id
    inst = got.tri_index[got.is_hit] // ts.num_base_tris
    assert set(inst.tolist()) == {0, 1, 2}
    occ_want, _ = j_trace(js, *jargs, any_hit=True, **mode)
    occ, _ = tops.trace_resident(ts, *targs, any_hit=True, grouped=mode["grouped"])
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_want))


def _oracle(base, m, o, d, tmax, act):
    """Per-instance loop of the JAX stackless BVH traversal on rays moved to
    object space (unnormalized direction), min-combined."""
    inv_lin = np.linalg.inv(m[:, :, :3])
    inv_tr = -np.einsum("iab,ib->ia", inv_lin, m[:, :, 3])
    best_t = np.asarray(tmax, np.float32).copy()
    best_tri = np.full(o.shape[0], -1, np.int64)
    hit = np.zeros(o.shape[0], bool)
    tb = int(base.v0.shape[0])
    for i in range(m.shape[0]):
        h = traverse_bvh(base, jnp.asarray(o @ inv_lin[i].T + inv_tr[i]),
                         jnp.asarray(d @ inv_lin[i].T), T_MIN, jnp.asarray(best_t),
                         jnp.asarray(act))
        closer = np.asarray(h.is_hit) & (np.asarray(h.t) < best_t)
        best_t = np.where(closer, np.asarray(h.t), best_t)
        best_tri = np.where(closer, i * tb + np.asarray(h.tri_index, np.int64), best_tri)
        hit |= closer
    return best_t, best_tri, hit


@pytest.mark.parametrize("ni,n_tris,tpc,seed", [(4, 1500, 64, 5), (2, 4096, 2048, 17)])
def test_instanced_trace_matches_per_instance_oracle(ni, n_tris, tpc, seed):
    """The port's instanced trace against an explicit per-instance loop
    over the base scene (also at 2048-slot clusters); one shared table."""
    meshes = [random_tri_soup(n_tris, seed=seed % 7)]
    m = _transforms(ni, seed=seed)
    ts = tscene.device_scene_from_instances(meshes, m, tris_per_cluster=tpc, device="cpu")
    base = j_build(meshes, tris_per_cluster=tpc)
    assert ts.cl_mt_table.shape == tuple(np.asarray(base.cl_mt_table).shape)
    n = 1024
    o, d, rng = _aimed_rays(m, n, seed + 2, jitter=0.6)
    act = rng.rand(n) > 0.15
    tmax = np.where(rng.rand(n) > 0.5, 3.4e38, 4.0).astype(np.float32)
    want_t, want_tri, want_hit = _oracle(base, m, o, d, tmax, act)
    got, _ = tops.trace_resident(ts, torch.as_tensor(o), torch.as_tensor(d), T_MIN,
                                 torch.as_tensor(tmax), torch.as_tensor(act))
    gh = got.is_hit.numpy()
    assert (gh == want_hit).mean() > 0.995
    both = gh & want_hit
    assert both.sum() > 64
    dt = np.abs(got.t.numpy()[both] - want_t[both]) / np.maximum(1.0, want_t[both])
    assert dt.max() < 1e-3
    assert ((got.tri_index.numpy()[both] == want_tri[both]) | (dt < 1e-4)).all()
    occ, _ = tops.trace_resident(ts, torch.as_tensor(o), torch.as_tensor(d), T_MIN,
                                 torch.as_tensor(tmax), torch.as_tensor(act), any_hit=True)
    assert (occ.numpy() == want_hit).mean() > 0.995


@pytest.mark.parametrize("instanced", [False, True])
def test_grouped_trace_equals_flat_on_cpu(instanced):
    """trace_resident(grouped=True) equals grouped=False on CPU tensors, by
    the default rule too, in and out of schedule order. On the CPU both
    routes end in the same plain version, so this covers the dispatch and
    the schedule sort only; K9 == K1 and K10 == K2 are held on the card by
    tests/test_torch_kernels_gpu.py."""
    meshes = [random_tri_soup(1200, seed=8)]
    if instanced:
        m = _transforms(2, seed=9)
        ts = tscene.device_scene_from_instances(meshes, m, tris_per_cluster=32, device="cpu")
        o, d, rng = _aimed_rays(m, 512, 4)
    else:
        ts = tscene.device_scene_from_meshes(meshes, tris_per_cluster=32, device="cpu")
        rng = np.random.RandomState(4)
        o = (rng.rand(512, 3) * 1.4 - 0.2).astype(np.float32)
        d = rng.randn(512, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = torch.as_tensor(rng.rand(512) > 0.1)
    rays = (torch.as_tensor(o), torch.as_tensor(d), T_MIN, 1e30, act)
    for any_hit in (False, True):
        flat, _ = tops.trace_resident(ts, *rays, any_hit=any_hit, grouped=False)
        for kw in (dict(grouped=True), dict(), dict(grouped=True, sort_rays=True)):
            got, _ = tops.trace_resident(ts, *rays, any_hit=any_hit, **kw)
            for a, b in ([(got, flat)] if any_hit else zip(got, flat)):
                assert torch.equal(a, b)
        assert int((flat if any_hit else flat.is_hit).sum()) > 20


def test_grouped_dispatch_rule():
    """The default takes the grouped kernels from GROUPED_MIN_CLUSTERS
    clusters on, and only for a scene with group tables; True / False
    force either, True without group tables runs flat (as in JAX)."""
    ts = tscene.device_scene_from_meshes([random_tri_soup(300, seed=2)],
                                         tris_per_cluster=16, device="cpu")
    k = ts.num_clusters
    assert not tres.use_grouped(ts) and tres.use_grouped(ts, True)
    assert not tres.use_grouped(ts, False)
    bare = ts._replace(cl_gboxes=None, cl_mboxes=None)
    assert not tres.use_grouped(bare, True) and not tres.use_grouped(bare)
    saved = tres.GROUPED_MIN_CLUSTERS
    try:
        tres.GROUPED_MIN_CLUSTERS = k
        assert tres.use_grouped(ts) and not tres.use_grouped(ts, False)
        tres.GROUPED_MIN_CLUSTERS = k + 1
        assert not tres.use_grouped(ts)
    finally:
        tres.GROUPED_MIN_CLUSTERS = saved
    # an instanced scene counts its instance-level clusters
    m = np.zeros((3, 3, 4), np.float32)
    m[:, :, :3] = np.eye(3)
    m[:, 0, 3] = [0.0, 2.0, 4.0]
    inst = tscene.device_scene_from_instances([random_tri_soup(300, seed=2)], m,
                                              tris_per_cluster=16, device="cpu")
    assert inst.num_clusters == 3 * k
    try:
        tres.GROUPED_MIN_CLUSTERS = 2 * k
        assert tres.use_grouped(inst) and not tres.use_grouped(ts)
    finally:
        tres.GROUPED_MIN_CLUSTERS = saved
    # the threshold sits where it was measured (ops/resident.py): the soup
    # frame's 64k soup at 2048 a cluster (K = 47) takes the grouped kernels,
    # the same soup at 4096 a cluster (K = 24) the flat ones
    soup = random_tri_soup(65536, seed=0)
    at = {tpc: tscene.device_scene_from_meshes([soup], tris_per_cluster=tpc, device="cpu")
          for tpc in (2048, 4096)}
    assert at[2048].num_clusters == tres.GROUPED_MIN_CLUSTERS == 47
    assert tres.use_grouped(at[2048]) and not tres.use_grouped(at[4096])


@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_group_args_hold_the_member_boxes_the_kernels_read(kind):
    """K9/K10 read member m of group g as the 8 floats at (g * 8 + m) * 8
    of cl_mboxes, two 16-byte loads, and its cluster id as cid0 + m with
    cid0 = mboxes[g, 0, 7] (instanced) or g * 8 (flat): every non-empty
    member box is that cluster's box in cl_boxes, every other member is
    flagged empty, and the grouped entry points get a 16-byte-aligned copy
    of a member table that starts off 16 bytes (a view into a larger
    buffer), equal to it, and the table itself when it is aligned."""
    mesh = random_tri_soup(700, seed=4)
    if kind == "flat":
        ts = tscene.device_scene_from_meshes([mesh], tris_per_cluster=16, device="cpu")
    else:
        ts = tscene.device_scene_from_instances([mesh], _transforms(3, 8), tris_per_cluster=16,
                                                device="cpu")
    cpu = torch.device("cpu")
    tab, k, _ = tres.scene_tables(ts, cpu, grouped=True)
    gptr, mptr, kg = tres.group_args(tab)
    assert mptr == tab["cl_mboxes"].data_ptr() and mptr % 16 == 0
    assert gptr == tab["cl_gboxes"].data_ptr() and kg == ts.cl_gboxes.shape[1]
    assert torch.equal(tab["cl_mboxes"], ts.cl_mboxes)
    flat_boxes = tab["cl_mboxes"].reshape(-1)
    seen = torch.zeros(k, dtype=torch.bool)
    for g in range(kg):
        cid0 = int(round(float(flat_boxes[g * 64 + 7]))) if kind == "instanced" else 8 * g
        for m in range(tres.GROUP):
            box = flat_boxes[(g * 8 + m) * 8:(g * 8 + m) * 8 + 7]
            if float(box[6]) > 0.0:
                assert torch.equal(box, ts.cl_boxes[:7, cid0 + m])
                seen[cid0 + m] = True
            else:
                assert cid0 + m >= k or float(ts.cl_boxes[6, cid0 + m]) == 0.0
    assert torch.equal(seen, ts.cl_boxes[6] > 0.0)
    buf = torch.zeros(ts.cl_mboxes.numel() + 1)
    view = buf[1:].view(ts.cl_mboxes.shape)
    view.copy_(ts.cl_mboxes)
    assert view.data_ptr() % 16 != 0
    tab2, _, _ = tres.scene_tables(ts._replace(cl_mboxes=view), cpu, grouped=True)
    _, mptr2, _ = tres.group_args(tab2)
    assert mptr2 % 16 == 0 and mptr2 == tab2["cl_mboxes"].data_ptr() != view.data_ptr()
    assert torch.equal(tab2["cl_mboxes"], ts.cl_mboxes)


def test_scene_tables_refuse_what_the_kernels_cannot_index():
    """The kernels' table check takes instanced shapes and raises where the
    shapes disagree or virtual ids would overflow int32."""
    m = _transforms(2, seed=3)
    ts = tscene.device_scene_from_instances([random_tri_soup(400, seed=1)], m,
                                            tris_per_cluster=32, device="cpu")
    tab, k, c = tres.scene_tables(ts, torch.device("cpu"), grouped=True)
    assert k == 2 * ts.cl_mt_table.shape[0] and c == 32
    assert tuple(tab["cl_xf"].shape) == (2, 1, 16) and tab["cl_tri_map"].shape[0] == k * c
    assert tres.instancing_args(ts, {k_: v for k_, v in tab.items() if k_ != "cl_xf"}) == (
        None, 0, 0)
    with pytest.raises(ValueError, match="instances"):
        tres.scene_tables(ts._replace(cl_xf=ts.cl_xf[:1]), torch.device("cpu"))
    huge = ts._replace(tri_shade=torch.zeros((2**30 + 1, 1)))
    with pytest.raises(ValueError, match="virtual"):
        tres.scene_tables(huge, torch.device("cpu"))
    with pytest.raises(ValueError, match="group"):
        tres.scene_tables(ts._replace(cl_mboxes=None), torch.device("cpu"), grouped=True)


def test_resolve_tracer_on_instanced_scenes():
    m = _transforms(2, seed=3)
    ts = tscene.device_scene_from_instances([random_tri_soup(200, seed=1)], m,
                                            tris_per_cluster=32, device="cpu")
    for name in ("stackless", "cluster"):
        with pytest.raises(ValueError, match="instanced"):
            tops.resolve_tracer(name, ts)
        with pytest.raises(ValueError):
            tops.trace_closest_checked(ts, torch.zeros((2, 3)), torch.ones((2, 3)), T_MIN, 1e30,
                                       torch.ones(2, dtype=torch.bool), tracer=name)
    assert tops.resolve_tracer("auto", ts) == "resident" == tops.resolve_tracer("resident", ts)
    with pytest.raises(ValueError, match="unknown tracer"):
        tops.resolve_tracer("residnet", ts)


# ---------------------------------------------------------------------------
# shading and the frame

def _cornell_instances():
    meshes, _ = j_cornell()
    m = np.zeros((2, 3, 4), np.float32)
    m[0, :, :3] = np.eye(3)
    m[1, :, :3] = np.eye(3) * 0.5
    m[1, :, 3] = [1.6, 0.0, 0.0]
    return meshes, m


def test_instanced_surface_attributes_match_jax():
    """Virtual ids decode to the base row, and the normal goes to world
    space through the instance's rotation and scale."""
    meshes = [random_tri_soup(800, seed=4)]
    m = _transforms(3, seed=21)
    js, ts = _pair(meshes, m, 64)
    o, d, rng = _aimed_rays(m, 512, 23)
    act = np.ones(512, bool)
    got, _ = tops.trace_resident(ts, torch.as_tensor(o), torch.as_tensor(d), T_MIN, 1e30,
                                 torch.as_tensor(act))
    assert got.is_hit.sum() > 100
    hits = JHitRecord(*(jnp.asarray(getattr(got, f).numpy()) for f in got._fields))
    want = j_attrs(js, jnp.asarray(o), jnp.asarray(d), hits)
    mine = surface_attributes(ts, torch.as_tensor(o), torch.as_tensor(d), got)
    for f in ("point", "normal", "albedo"):
        np.testing.assert_allclose(getattr(mine, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    for f in ("bsdf_type", "is_inside"):
        np.testing.assert_array_equal(getattr(mine, f).numpy(), np.asarray(getattr(want, f)))


def test_auto_light_matches_jax():
    """The port's copy of the CLI's auto-light rule gives JAX's light table
    over a scene box, bit for bit."""
    from pg2024_dprt_tpu.render.__main__ import auto_light as j_auto_light

    lo = np.asarray([-0.1, 0.0, -0.2], np.float32)
    hi = np.asarray([7.7, 1.1, 3.3], np.float32)
    want = j_auto_light(lo, hi, 8.0)
    got = tscene.auto_light(lo, hi, 8.0, device="cpu")
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_instanced_render_matches_jax():
    """The instanced cornell (two instances, one scaled) through the port's
    render_image against JAX's composed render: fused_frame="auto" composes
    (the frame gate rejects instanced scenes), "on" raises."""
    meshes, m = _cornell_instances()
    js = j_instances(meshes, m)
    quad = np.asarray([[[0.2, 0.98, 0.2], [0.8, 0.98, 0.2], [0.8, 0.98, 0.8]],
                       [[0.2, 0.98, 0.2], [0.8, 0.98, 0.8], [0.2, 0.98, 0.8]]], np.float32)
    le = np.full((2, 3), 12.0, np.float32)
    cam_args = ([1.0, 0.6, 3.2], [0.8, 0.5, 0.0], [0, 1, 0], 55.0, 24, 24)
    want = np.asarray(j_render(js, JLights.from_arrays(quad, le), JEnv.constant((0.1, 0.1, 0.12)),
                               JCamera.look_at(*cam_args),
                               JConfig(width=24, height=24, spp=1, bounces=2,
                                       tracer="resident", fused_frame="off")))
    ts = tscene.device_scene_from_arrays(_arrays(js), device="cpu")
    side = (ts, tscene.LightTable.from_arrays(quad, le, device="cpu"),
            tscene.EnvironmentMap.constant((0.1, 0.1, 0.12), device="cpu"),
            Camera.look_at(*cam_args, device="cpu"))
    cfg = RenderConfig(width=24, height=24, spp=1, bounces=2)
    got = render_image(*side, cfg, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert got.max() > 1e-3
    assert not tops.fused_frame_supported(ts, side[1], side[2], cfg)
    with pytest.raises(ValueError, match="fused frame"):
        render_image(*side, dataclasses.replace(cfg, fused_frame="on"), device="cpu")


# ---------------------------------------------------------------------------
# the proxy stages on instanced local geometry

SMALL = tmlp.MLPConfig(width=64, depth=2)
OFFS = np.asarray([[-1.05, 0, 0], [1.05, 0, 0], [0, -1.05, 0], [0, 1.05, 0],
                   [0, 0, -1.05], [0, 0, 1.05], [-1.05, -1.05, 0], [1.05, 1.05, 0]],
                  np.float32)


def _jmodels(m):
    to_jax = lambda p: {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    cfg = lambda c: jmlp.MLPConfig(**dataclasses.asdict(c))
    return jproxy.ProxyModels(to_jax(m.vis_params), to_jax(m.depth_params), m.num_objects,
                              cfg(m.vis_cfg), cfg(m.depth_cfg))


@pytest.mark.parametrize("stage", ["secondary", "shadow"])
def test_proxy_stages_on_instanced_local_geometry_match_jax(stage):
    """secondary_route / shadow_direct_light_nn over an instanced local
    scene compose (schedule sort, instance-aware trace, march, nets) and
    agree with the JAX composed stages."""
    m = np.zeros((2, 3, 4), np.float32)
    m[:, :, :3] = np.eye(3) * 0.5
    m[1, :, 3] = [0.5, 0.0, 0.5]
    js, ts = _pair([random_tri_soup(600, seed=6)], m, 32)
    boxes = dict(aabb_min=OFFS, aabb_max=OFFS + 1.0,
                 max_length=np.full((8,), np.sqrt(3.0), np.float32))
    jt = JProxyTable(**{k: jnp.asarray(v) for k, v in boxes.items()})
    tt = tscene.proxy_table_from_arrays(boxes, device="cpu")
    models = tmodels.random_proxy_models(5, 8, SMALL, SMALL, device="cpu")
    shift = lambda p, b: {k: (v + b if k == "head_b1" else v) for k, v in p.items()}
    models = dataclasses.replace(models, vis_params=shift(models.vis_params, 10.0),
                                 depth_params=shift(models.depth_params, -10.0))
    assert not tps._use_fused_route(ts, models, "auto", tt, 3)
    n = 512
    rng = np.random.RandomState(7)
    o = rng.rand(n, 3).astype(np.float32) * 1.4 - 0.2
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    valid = rng.rand(n) > 0.1
    tmax = (np.full(n, 3.4e38, np.float32) if stage == "secondary"
            else (rng.rand(n) * 2.5 + 0.3).astype(np.float32))
    thr = np.ones((n, 3), np.float32)
    pix = np.arange(n, dtype=np.int32)
    jp = JPathState.empty(n)._replace(
        origin=jnp.asarray(o), direction=jnp.asarray(d), tmax=jnp.asarray(tmax),
        throughput=jnp.asarray(thr), pixel_index=jnp.asarray(pix), is_valid=jnp.asarray(valid))
    tp = PathState.empty(n, device="cpu")._replace(
        origin=torch.as_tensor(o), direction=torch.as_tensor(d), tmax=torch.as_tensor(tmax),
        throughput=torch.as_tensor(thr), pixel_index=torch.as_tensor(pix).to(torch.int64),
        is_valid=torch.as_tensor(valid))
    if stage == "shadow":
        want, _ = jps.shadow_direct_light_nn(js, jt, _jmodels(models), jp, jnp.int32(8), 3,
                                             1e-3, 1, n)
        got, diag = tps.shadow_direct_light_nn(ts, tt, models, tp, 8, 3, 1e-3, 1, n)
        assert diag == 0 and 0.0 < float(got.sum())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        return
    jenv, tenv = JEnv.constant((0.4, 0.5, 0.7)), tscene.EnvironmentMap.constant(
        (0.4, 0.5, 0.7), device="cpu")
    wp, we, _ = jps.secondary_route(js, jt, _jmodels(models), jenv, jp, jnp.int32(8), 3,
                                    1e-3, n)
    gp, ge, gd = tps.secondary_route(ts, tt, models, tenv, tp, 8, 3, 1e-3, n)
    for f in ("target_node", "current_node", "is_hit", "is_valid"):
        np.testing.assert_array_equal(getattr(gp, f).numpy(), np.asarray(getattr(wp, f)),
                                      err_msg=f)
    np.testing.assert_allclose(gp.tmax.numpy(), np.asarray(wp.tmax), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), rtol=1e-5, atol=1e-6)
    assert gd == 0 and int((gp.target_node == 8).sum()) > 20
