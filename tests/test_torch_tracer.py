"""Port streaming pair tracer (ops/tracer.py) vs the JAX package's
pallas_tracer.py, run in interpret mode, on identical tables carried across
with scene/convert.py and rays made from a seed with numpy; its scene tables
against JAX's build; the tracer API's names.

The port runs its plain versions here; the CUDA kernels K11-K13 are held
against those by tests/test_torch_kernels_gpu.py on the card.

Tolerances: the pair lists (pair_tile, pair_cluster, pair_flags,
pair_enter, tile_fit, dropped) and the cull under them exact, integer for
integer; `dropped` and hit/occlusion flags exact; t rtol 1e-5, except on at
most 1 % of the hits where either side's winner is an edge hit (min
barycentric < 1e-5: a ray through a silhouette edge takes the edge triangle
on one side and the surface behind on the other); u/v rtol 1e-4
/ atol 1e-5 where both picked the same triangle (the Woop test's u and v are
sums of products that XLA's CPU dot may order differently); ids exact except
at near-ties (the two winners' t within 2^-20 relative, where another slot
order or an ulp picks the other triangle).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg2024_dprt_tpu.core import Camera as JCamera
from pg2024_dprt_tpu.ops.pallas_tracer import _interval_cull as j_cull
from pg2024_dprt_tpu.ops.pallas_tracer import _prep_pairs as j_prep
from pg2024_dprt_tpu.ops.pallas_tracer import trace_pallas
from pg2024_dprt_tpu.ops.trace_api import _pallas_escalating
from pg2024_dprt_tpu.ops.traversal import intersect_brute_force as j_brute
from pg2024_dprt_tpu.scene import cornell_box as j_cornell
from pg2024_dprt_tpu.scene import device_scene_from_meshes as j_build
from pg2024_dprt_tpu.scene import native_bvh as j_native
from pg2024_dprt_tpu.scene import random_tri_soup
from pg2024_dprt_tpu_torch import ops as tops
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.ops import tracer as ttracer
from pg2024_dprt_tpu_torch.ops.trace_api import _pairs_escalating
from pg2024_dprt_tpu_torch.scene import native_bvh as t_native

T_MIN = 1e-3
# the DeviceScene fields the pair, stackless and cluster back ends read
NEW_TABLES = ("cl_tri_table", "cl_woop_table", "node_min", "node_max", "node_first",
              "node_count", "node_skip", "v0", "v1", "v2", "tri_valid")


def _arrays(rec):
    return {k: np.asarray(v) for k, v in rec._asdict().items() if isinstance(v, jax.Array)}


@pytest.mark.parametrize("kind,tpc", [("cornell", None), ("soup700", 64), ("soup4096", None)])
def test_pair_tracer_tables_match_jax(kind, tpc):
    """The new tables of the port's own build equal JAX's, field by field,
    exactly (4,096 triangles take the native builder in both packages)."""
    if kind == "cornell":
        jm, tm = j_cornell()[0], tscene.cornell_box(device="cpu")[0]
    else:
        n = int(kind[4:])
        jm, tm = [random_tri_soup(n, seed=20)], [tscene.random_tri_soup(n, seed=20)]
        if n >= 4096:
            assert j_native.available() and t_native.available()
    js = j_build(jm, tris_per_cluster=tpc)
    ts = tscene.device_scene_from_meshes(tm, tris_per_cluster=tpc, device="cpu")
    for name in NEW_TABLES:
        want = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # degenerate and padding slots: zero Woop rows, tmap -1
    w = ts.cl_woop_table.view(ts.num_clusters, 4, 4, -1)
    pad = ts.cl_tri_map.view(ts.num_clusters, -1) < 0
    assert (w[:, 3, 3][pad] == -1).all() and (w[:, :, :3].permute(0, 3, 1, 2)[pad] == 0).all()


def _scenes(meshes, tpc):
    js = j_build(meshes, tris_per_cluster=tpc)
    return js, tscene.device_scene_from_arrays(_arrays(js), device="cpu")


def _case(kind):
    """(JAX scene, port scene, o, d, tmax, active, trace keywords) of the
    cases of tests/test_pallas_tracer.py, at most 1,024 rays."""
    rng = np.random.RandomState({"soup": 21, "limited": 23, "anyhit": 25, "starved": 31,
                                 "cornell": 0}[kind])
    if kind == "cornell":
        js, ts = _scenes(j_cornell()[0], 16)
        cam = JCamera.look_at([0.5, 0.5, 2.4], [0.5, 0.5, 0.0], [0, 1, 0], 40.0, 32, 32)
        pix = jnp.arange(1024, dtype=jnp.int32)
        o, d = (np.array(a) for a in cam.generate_rays(pix // 32, pix % 32, jnp.zeros(1024),
                                                          jnp.zeros(1024)))
        return js, ts, o, d, np.full(1024, 1e30, np.float32), np.ones(1024, bool), \
            dict(tile_rays=256, region=32)
    tris, seed, tpc, n = {"soup": (700, 20, 64, 1024), "limited": (300, 22, 64, 512),
                          "anyhit": (500, 24, 64, 1024), "starved": (700, 30, 16, 512)}[kind]
    js, ts = _scenes([random_tri_soup(tris, seed=seed)], tpc)
    o = rng.rand(n, 3).astype(np.float32)
    if kind in ("soup", "starved"):
        o = (o * 1.4 - 0.2).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    act = np.ones(n, bool)
    if kind in ("limited", "anyhit"):
        act = rng.rand(n) > (0.5 if kind == "limited" else 0.3)
    kw = dict(region=8) if kind == "starved" else dict(tile_rays=256, region=64)
    return js, ts, o, d, np.full(n, 1e30, np.float32), act, kw


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


def _edge(h):
    u, v = np.asarray(h.u), np.asarray(h.v)
    return np.minimum(np.minimum(u, v), 1.0 - u - v) < 1e-5


def _assert_hits_match(got, want):
    hit = np.asarray(want.is_hit)
    np.testing.assert_array_equal(got.is_hit.numpy(), hit)
    gt, wt = got.t.numpy(), np.asarray(want.t)
    # a ray through a silhouette edge may take the edge triangle on one side
    # and the surface behind it on the other (an ulp of u + v)
    other = hit & ~np.isclose(gt, wt, rtol=1e-5, atol=0.0)
    assert (_edge(got) | _edge(want))[other].all()
    assert other.sum() <= max(1, hit.sum() // 100)
    miss = ~hit
    hit = hit & ~other
    mismatch = hit & (got.tri_index.numpy() != np.asarray(want.tri_index))
    near_tie = np.abs(gt - wt) <= 2.0 ** -20 * np.maximum(1.0, np.abs(wt))
    assert near_tie[mismatch].all()
    same = hit & ~mismatch
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[same],
                                   np.asarray(getattr(want, f))[same], rtol=1e-4, atol=1e-5)
    assert (got.tri_index.numpy()[miss] == -1).all()
    assert (gt[miss] == np.float32(3.402823466e38)).all()


@pytest.mark.parametrize("kind", ["soup", "cornell", "starved"])
def test_prep_pairs_is_integer_exact(kind):
    """interval_cull and prep_pairs against JAX's _interval_cull and
    _prep_pairs on the same padded rays: every array equal."""
    js, ts, o, d, tmax, act, kw = _case(kind)
    tm = kw.get("tile_rays", ttracer.TILE_RAYS)
    pp = ttracer.PAIRS_PER_STEP
    tiles = -(-o.shape[0] // tm)
    budget = -(-(tiles * kw["region"]) // pp) * pp
    possible, enter = j_cull(js, *_j(o, d, tmax, act), tiles, tm)
    want = j_prep(possible, enter, tiles, budget, pp)
    t_possible, t_enter = ttracer.interval_cull(ts, *_t(o, d, tmax, act), tiles, tm)
    np.testing.assert_array_equal(t_possible.numpy(), np.asarray(possible))
    ok = np.asarray(possible)
    np.testing.assert_array_equal(t_enter.numpy()[ok], np.asarray(enter)[ok])
    got = ttracer.prep_pairs(t_possible, t_enter, tiles, budget, pp)
    for name, w in zip(("pair_tile", "pair_cluster", "pair_flags", "pair_enter", "tile_fit",
                        "dropped"), want):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(w), err_msg=name)
    assert (int(got.dropped) > 0) == (kind == "starved")


@pytest.mark.parametrize("kind,mode", [("soup", "closest"), ("cornell", "closest"),
                                       ("limited", "closest"), ("anyhit", "anyhit"),
                                       ("soup", "woop"), ("soup", "sorted"),
                                       ("starved", "closest"), ("anyhit", "anyhit_at_t")])
def test_trace_pairs_matches_trace_pallas(kind, mode):
    """trace_pairs against trace_pallas in interpret mode on the cases of
    tests/test_pallas_tracer.py, the Woop body and the sorted wavefront, and
    the starved budget (region 8), where both drop the same pairs and force
    the same tiles to miss; and the any-hit trace with each ray's t_max at
    its closest t (the port's), where t < t_max fails at equality: the
    port occludes no ray, and JAX's flags differ from its only on rays
    whose closest t JAX rounds otherwise, within the t tolerance (on this
    case 2 of 3 of JAX's t differ from the port's by a few ulps)."""
    js, ts, o, d, tmax, act, kw = _case(kind)
    if mode == "anyhit_at_t":
        hits, _ = tops.trace_pairs(ts, *_t(o, d), T_MIN, *_t(tmax, act), **kw)
        jhits, _ = trace_pallas(js, *_j(o, d), T_MIN, *_j(tmax, act), **kw)
        hit = hits.is_hit.numpy()
        np.testing.assert_array_equal(hit, np.asarray(jhits.is_hit))
        assert int(hit.sum()) > 30
        tmax = np.where(hit, hits.t.numpy(), tmax).astype(np.float32)
    any_hit = mode.startswith("anyhit")
    kw = dict(kw, woop=mode == "woop", sort_rays=mode == "sorted", any_hit=any_hit)
    want, jd = trace_pallas(js, *_j(o, d), T_MIN, *_j(tmax, act), **kw)
    got, td = tops.trace_pairs(ts, *_t(o, d), T_MIN, *_t(tmax, act), **kw)
    assert td == int(jd)
    assert (td > 0) == (kind == "starved")
    if mode == "anyhit_at_t":
        assert not got.any()
        near = hit & np.isclose(np.asarray(jhits.t), tmax, rtol=1e-5)
        assert not (np.asarray(want) & ~near).any()
        return
    if any_hit:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 30 < int(got.sum()) < int(act.sum())
        return
    _assert_hits_match(got, want)
    assert not got.is_hit.numpy()[~act].any()
    assert int(got.is_hit.sum()) >= 5


def test_pairs_escalating_matches_jax_and_leaves_no_residue():
    """The starved budget drops pairs; the escalating entry re-traces at 4x
    and 16x until nothing is dropped, as _pallas_escalating does, and then
    agrees with the oracle."""
    js, ts, o, d, tmax, act, _ = _case("starved")
    want, jres = _pallas_escalating(js, *_j(o, d), T_MIN, *_j(tmax, act), region=8)
    got, res = _pairs_escalating(ts, *_t(o, d), T_MIN, *_t(tmax, act), region=8)
    assert res == int(jres) == 0
    _assert_hits_match(got, want)
    oracle = tops.intersect_brute_force(ts, *_t(o, d), T_MIN, *_t(tmax, act))
    np.testing.assert_array_equal(got.is_hit.numpy(), oracle.is_hit.numpy())
    occ, res = _pairs_escalating(ts, *_t(o, d), T_MIN, *_t(tmax, act), region=8,
                                 any_hit=True)
    assert res == 0
    np.testing.assert_array_equal(occ.numpy(), oracle.is_hit.numpy())


@pytest.mark.parametrize("kind", ["soup", "cornell", "starved"])
def test_pair_tracer_misses_only_what_its_pair_list_leaves_out(kind):
    """Every ray the oracle hits and trace_pairs misses (or hits farther
    away) lies in a tile that did not fit the budget, or the oracle's
    cluster is not among its tile's listed pairs (culled, or dropped past
    the budget): the kernels' walk itself loses nothing. The counts are
    what chip_smoke.py phase 8 reports at full width."""
    _, ts, o, d, tmax, act, kw = _case(kind)
    rays = _t(o, d, np.full(o.shape[0], T_MIN, np.float32), tmax, act)
    prep = ttracer.prepare_pairs(ts, *rays, **kw)
    got, dropped = tops.trace_pairs(ts, *rays, **kw)
    want = tops.intersect_brute_force(ts, *rays)
    tm = kw.get("tile_rays", ttracer.TILE_RAYS)
    tile = torch.arange(o.shape[0]) // tm
    pairs = prep.pairs
    listed = torch.zeros_like(prep.possible)
    real = (pairs.pair_flags & 2) != 0
    listed[pairs.pair_tile[real].long(), pairs.pair_cluster[real].long()] = True
    slot_of = {int(tri): i for i, tri in enumerate(ts.cl_tri_map.tolist()) if tri >= 0}
    cl = torch.tensor([slot_of.get(int(i), 0) for i in want.tri_index]) // ts.tris_per_cluster
    apart = got.is_hit & want.is_hit & ~torch.isclose(got.t, want.t, rtol=1e-5)
    lost = want.is_hit & (~got.is_hit | apart)
    explained = ~pairs.tile_fit[tile] | ~listed[tile, cl]
    assert not bool((lost & ~explained).any())
    assert not bool((got.is_hit & ~want.is_hit).any())
    assert (dropped > 0) == bool(lost.any()) == (kind == "starved")


@pytest.mark.parametrize("tile_rays,region", [(64, 64), (128, 128)])
def test_plain_kernels_follow_the_slot_order(tile_rays, region):
    """On a scene of coincident copies of every triangle (equal t in two
    clusters) the earlier slot of a tile wins, as in the TPU kernel; the
    closest-hit and Woop plain versions agree on flags, and the any-hit one
    is their is_hit."""
    mesh = random_tri_soup(150, seed=7)
    twice = tscene.MeshGeometry(*(np.concatenate([a, a]) for a in (mesh.v0, mesh.v1, mesh.v2)))
    js, ts = _scenes([twice], 16)
    rng = np.random.RandomState(8)
    n = 512
    o = (rng.rand(n, 3) * 1.4 - 0.2).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rays = (*_t(o, d), T_MIN, torch.full((n,), 1e30), torch.ones(n, dtype=torch.bool))
    kw = dict(tile_rays=tile_rays, region=region)
    want, jd = trace_pallas(js, *_j(o, d), T_MIN, jnp.full((n,), 1e30), jnp.ones(n, bool), **kw)
    got, td = tops.trace_pairs(ts, *rays, **kw)
    assert td == int(jd) == 0
    np.testing.assert_array_equal(got.tri_index.numpy(), np.asarray(want.tri_index))
    woop, _ = tops.trace_pairs(ts, *rays, woop=True, **kw)
    occ, _ = tops.trace_pairs(ts, *rays, any_hit=True, **kw)
    np.testing.assert_array_equal(woop.is_hit.numpy(), got.is_hit.numpy())
    np.testing.assert_array_equal(occ.numpy(), got.is_hit.numpy())
    assert int(got.is_hit.sum()) >= 5


@pytest.mark.parametrize("name", ["auto", "resident", "stackless", "cluster", "pallas",
                                  "residnet"])
@pytest.mark.parametrize("instanced", [False, True])
def test_resolve_tracer_case_table(name, instanced):
    """Every name on a flat and an instanced scene: "auto" is resident on
    every device; stackless and cluster trace flat scenes and refuse
    instanced ones; "pallas" is the retired pair tracer, rejected as in
    JAX; anything else is unknown. The dispatched back ends agree on a
    cornell wavefront."""
    meshes = j_cornell()[0]
    if instanced:
        m = np.zeros((2, 3, 4), np.float32)
        m[:, :, :3] = np.eye(3)
        m[1, :, 3] = [1.5, 0.0, 0.0]
        ts = tscene.device_scene_from_instances(meshes, m, tris_per_cluster=16, device="cpu")
    else:
        ts = tscene.device_scene_from_meshes(meshes, tris_per_cluster=16, device="cpu")
    want = {"auto": "resident", "resident": "resident", "stackless": "stackless",
            "cluster": "cluster"}.get(name)
    if name == "pallas":
        with pytest.raises(ValueError, match="retired"):
            tops.resolve_tracer(name, ts)
    elif name == "residnet":
        with pytest.raises(ValueError, match="unknown tracer"):
            tops.resolve_tracer(name, ts)
    elif instanced and want != "resident":
        with pytest.raises(ValueError, match="instanced"):
            tops.resolve_tracer(name, ts)
    else:
        assert tops.resolve_tracer(name, ts) == want
        n = 64
        rng = np.random.RandomState(3)
        o = torch.as_tensor(rng.rand(n, 3).astype(np.float32) * 0.8 + 0.1)
        d = torch.nn.functional.normalize(torch.as_tensor(rng.randn(n, 3).astype(np.float32)),
                                          dim=-1)
        act = torch.ones(n, dtype=torch.bool)
        hits, diag = tops.trace_closest_checked(ts, o, d, T_MIN, 1e30, act, tracer=name)
        occ, diag2 = tops.trace_occlusion_checked(ts, o, d, T_MIN, 1e30, act, tracer=name)
        ref = tops.trace_resident(ts, o, d, T_MIN, 1e30, act)[0]
        assert diag == diag2 == 0 and int(hits.is_hit.sum()) > n // 2
        np.testing.assert_array_equal(hits.is_hit.numpy(), ref.is_hit.numpy())
        np.testing.assert_array_equal(occ.numpy(), ref.is_hit.numpy())
        np.testing.assert_allclose(hits.t.numpy(), ref.t.numpy(), rtol=1e-5)


@pytest.mark.parametrize("port_tracer,jax_tracer", [("stackless", "stackless"),
                                                     ("cluster", "cluster"),
                                                     ("auto", "stackless")])
def test_trace_closest_and_occlusion_match_jax(port_tracer, jax_tracer):
    """The two public entry points without diag (the first results of the
    _checked entries) against JAX's on the soup case: hits by the module's
    criterion, occlusion flags exact. The port's "auto" is the resident
    plain version, held against JAX's stackless walk."""
    from pg2024_dprt_tpu.ops.trace_api import trace_closest as j_closest
    from pg2024_dprt_tpu.ops.trace_api import trace_occlusion as j_occlusion

    js, ts, o, d, tmax, act, _ = _case("soup")
    tmax = np.where(np.arange(len(tmax)) % 3 == 0, 0.4, tmax).astype(np.float32)
    got = tops.trace_closest(ts, *_t(o, d), T_MIN, *_t(tmax, act), tracer=port_tracer)
    want = j_closest(js, *_j(o, d), T_MIN, *_j(tmax, act), tracer=jax_tracer)
    assert int(np.asarray(want.is_hit).sum()) > 20
    _assert_hits_match(got, want)
    occ = tops.trace_occlusion(ts, *_t(o, d), T_MIN, *_t(tmax, act), tracer=port_tracer)
    want_occ = np.asarray(j_occlusion(js, *_j(o, d), T_MIN, *_j(tmax, act),
                                      tracer=jax_tracer))
    np.testing.assert_array_equal(occ.numpy(), want_occ)
    np.testing.assert_array_equal(occ.numpy(), got.is_hit.numpy())
