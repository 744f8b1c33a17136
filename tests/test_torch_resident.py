"""Port resident trace vs the JAX resident Pallas kernels (interpret mode on
the CPU), on identical cluster tables (carried across with
scene/convert.py). The port runs its plain versions here; the CUDA kernels
are held against those plain versions by tests/test_torch_kernels_gpu.py,
which runs only where a GPU and nvcc are present.

Tolerances: hit/occlusion flags exact; t/u/v rtol 1e-4 / atol 1e-5 (as
tests/test_pallas_resident.py); triangle ids exact wherever the JAX t is
unique — the TPU kernels' packed t|lane keys spend up to log2(C) low
mantissa bits of t on the lane, so ids may differ only where the two
winners' t agree within 2^-14 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pg2024_dprt_tpu.core import Camera as JCamera
from pg2024_dprt_tpu.ops.pallas_resident import schedule_keys as j_schedule_keys
from pg2024_dprt_tpu.ops.pallas_resident import trace_resident as j_trace
from pg2024_dprt_tpu.ops.pallas_tracer import _morton_key as j_morton_key
from pg2024_dprt_tpu.scene import cornell_box, device_scene_from_meshes, random_tri_soup
from pg2024_dprt_tpu.scene.procedural import statue_mesh
from pg2024_dprt_tpu_torch import ops as tops
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.ops import resident as tres
from pg2024_dprt_tpu_torch.scene import device_scene_from_arrays

T_MIN = 1e-3


def _scenes(meshes, tpc):
    js = device_scene_from_meshes(meshes, tris_per_cluster=tpc)
    arrays = {k: np.asarray(v) for k, v in js._asdict().items() if isinstance(v, jax.Array)}
    return js, device_scene_from_arrays(arrays, device="cpu")


def _random_rays(n, seed, lo=-0.2, span=1.4):
    rng = np.random.RandomState(seed)
    o = (rng.rand(n, 3) * span + lo).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, rng


def _both(js, ts, o, d, tmax, act, any_hit=False):
    want, dropped = j_trace(js, jnp.asarray(o), jnp.asarray(d), T_MIN, jnp.asarray(tmax),
                            jnp.asarray(act), any_hit=any_hit, tile_rays=128)
    assert int(dropped) == 0
    got, dropped = tops.trace_resident(ts, torch.as_tensor(o), torch.as_tensor(d), T_MIN,
                                       torch.as_tensor(tmax), torch.as_tensor(act),
                                       any_hit=any_hit)
    assert dropped == 0
    return got, want


def _assert_hits_match(got, want):
    hit = np.asarray(want.is_hit)
    np.testing.assert_array_equal(got.is_hit.numpy(), hit)
    mismatch = hit & (got.tri_index.numpy() != np.asarray(want.tri_index))
    # barycentrics are per triangle: compare them where both picked the same one
    for f, m in (("t", hit), ("u", hit & ~mismatch), ("v", hit & ~mismatch)):
        np.testing.assert_allclose(getattr(got, f).numpy()[m], np.asarray(getattr(want, f))[m],
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    gt, wt = got.t.numpy(), np.asarray(want.t)
    near_tie = np.abs(gt - wt) <= 2.0 ** -14 * np.maximum(1.0, np.abs(wt))
    assert near_tie[mismatch].all()
    assert mismatch.sum() <= max(2, hit.sum() // 100)
    assert (got.tri_index.numpy()[~hit] == -1).all()
    assert (gt[~hit] == np.float32(3.402823466e38)).all()


@pytest.mark.parametrize("tpc", [64, None])
def test_closest_soup_random_rays(tpc):
    js, ts = _scenes([random_tri_soup(700, seed=20)], tpc)
    o, d, _ = _random_rays(2048, 21)
    got, want = _both(js, ts, o, d, np.full(2048, 1e30, np.float32), np.ones(2048, bool))
    _assert_hits_match(got, want)
    assert got.is_hit.sum() > 80


@pytest.mark.parametrize("tpc", [16, None])
def test_closest_cornell_camera(tpc):
    """Cornell camera rays: tpc=16 runs JAX's culled kernel, the default
    (one cluster, 36 triangles) its transposed tiny kernel."""
    meshes, _ = cornell_box()
    js, ts = _scenes(meshes, tpc)
    cam = JCamera.look_at([0.5, 0.5, 2.4], [0.5, 0.5, 0.0], [0, 1, 0], 40.0, 32, 32)
    pix = jnp.arange(1024, dtype=jnp.int32)
    o, d = cam.generate_rays(pix // 32, pix % 32, jnp.zeros(1024), jnp.zeros(1024))
    o, d = np.array(o), np.array(d)
    got, want = _both(js, ts, o, d, np.full(1024, 1e30, np.float32), np.ones(1024, bool))
    _assert_hits_match(got, want)
    assert got.is_hit.sum() > 900


def test_closest_finite_tmax_and_inactive():
    js, ts = _scenes([random_tri_soup(500, seed=40)], 32)
    o, d, rng = _random_rays(1024, 41, lo=0.0, span=1.0)
    tmax = (rng.rand(1024) * 0.8 + 0.05).astype(np.float32)
    act = rng.rand(1024) > 0.3
    got, want = _both(js, ts, o, d, tmax, act)
    _assert_hits_match(got, want)
    assert not got.is_hit.numpy()[~act].any()


@pytest.mark.parametrize("tpc", [32, None])
def test_anyhit_matches_jax(tpc):
    """Occlusion flags exact against JAX's any-hit kernels, with finite
    per-ray tmax and an activity mask."""
    js, ts = _scenes([random_tri_soup(600, seed=50)], tpc)
    o, d, rng = _random_rays(1024, 51, lo=0.0, span=1.0)
    tmax = (rng.rand(1024) * 2.0 + 0.02).astype(np.float32)
    act = rng.rand(1024) > 0.2
    got, want = _both(js, ts, o, d, tmax, act, any_hit=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 30 < got.sum() < act.sum()


def test_trace_api_rejects_unported_backends():
    meshes, _ = cornell_box()
    _, ts = _scenes(meshes, None)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    act = torch.ones(4, dtype=torch.bool)
    # every back end of the JAX package is ported now; the retired pair
    # tracer is rejected by name, as in JAX
    for name in ("stackless", "cluster"):
        hits, diag = tops.trace_closest_checked(ts, o + 0.5, d, T_MIN, 1e30, act, tracer=name)
        assert diag == 0 and hits.is_hit.all()
    with pytest.raises(ValueError, match="retired"):
        tops.resolve_tracer("pallas")
    sorted_hits, diag = tops.trace_resident(ts, o + 0.5, d, T_MIN, 1e30, act, sort_rays=True)
    assert diag == 0 and sorted_hits.is_hit.all()
    hits, diag = tops.trace_closest_checked(ts, o + 0.5, d, T_MIN, 1e30, act)
    assert diag == 0 and hits.is_hit.all()


def _prepass(o, d, tmax, act):
    """The (8, N) packed rays the JAX schedule-key kernel reads."""
    return jnp.asarray(np.concatenate(
        [o.T, d.T, np.where(act, T_MIN, 3.402823466e38)[None, :],
         np.where(act, tmax, 0.0)[None, :]], axis=0).astype(np.float32))


@pytest.mark.parametrize("tris,tpc,seed,finite", [
    (700, 16, 20, False), (2000, 32, 23, True), (36, None, 26, False)])
def test_schedule_keys_match_the_pallas_kernel(tris, tpc, seed, finite):
    """The plain version of the schedule-key kernel against the JAX Pallas
    kernel in interpret mode: equal keys on every ray (both rank a cluster
    by its enter bits with the low 12 bits cleared, then by index). One
    cluster only: the second half of every key is 0xFFF."""
    js, ts = _scenes([random_tri_soup(tris, seed=seed)], tpc)
    n = 512
    o, d, rng = _random_rays(n, seed + 1)
    tmax = (rng.rand(n) * 1.5 + 0.05).astype(np.float32) if finite else np.full(n, 1e30, np.float32)
    act = rng.rand(n) > (0.25 if finite else -1.0)
    want = np.asarray(j_schedule_keys(js.cl_boxes, _prepass(o, d, tmax, act), interpret=True))
    want = np.where(act, want, 0x7FFFFFFF)
    rays = (torch.as_tensor(o), torch.as_tensor(d), torch.full((n,), T_MIN),
            torch.as_tensor(tmax), torch.as_tensor(act))
    got = tops.schedule_keys(ts, *rays)               # CPU tensors: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tops.schedule_keys_plain(ts, *rays))
    first, second = got[rays[4]] >> 12, got[rays[4]] & 0xFFF
    k = ts.num_clusters
    entered = first != 0xFFF
    assert entered.sum() > n // 4 and (first[entered] < k).all()
    if k == 1:
        assert (second == 0xFFF).all()
    else:
        two = second != 0xFFF
        assert two.sum() > n // 8 and (second[two] != first[two]).all()
    assert (got[~rays[4]] == 0x7FFFFFFF).all()


def test_schedule_order_sorts_by_key_and_keeps_results():
    """sort_rays runs the trace on the wavefront in schedule order and
    returns every ray's own result: equal to the unsorted trace, closest and
    any-hit. A scene with more clusters than the key holds sorts by the
    morton key (equal to the JAX package's)."""
    js, ts = _scenes([random_tri_soup(900, seed=30)], 32)
    n = 640
    o, d, rng = _random_rays(n, 31)
    tmax = (rng.rand(n) * 2.0 + 0.05).astype(np.float32)
    act = rng.rand(n) > 0.2
    to, td, tt, ta = (torch.as_tensor(x) for x in (o, d, tmax, act))
    rays = (to, td, torch.full((n,), T_MIN), tt, ta)
    perm = tops.schedule_order(ts, *rays)
    key = tops.schedule_keys(ts, *rays)
    assert sorted(perm.tolist()) == list(range(n))
    assert (key[perm][1:] >= key[perm][:-1]).all() and not ta[perm][int(ta.sum()):].any()
    np.testing.assert_array_equal(tres.morton_key(ts, to, td).numpy(),
                                  np.asarray(j_morton_key(js, jnp.asarray(o), jnp.asarray(d))))
    many = ts._replace(cl_mt_table=ts.cl_mt_table.new_zeros((4096, 16, 16)))
    m_perm = tops.schedule_order(many, *rays)
    m_key = torch.where(ta, tres.morton_key(ts, to, td), 0xFFFFFFFF)[m_perm]
    assert not torch.equal(m_perm, perm) and (m_key[1:] >= m_key[:-1]).all()
    plain, _ = tops.trace_resident(ts, to, td, T_MIN, tt, ta)
    occ, _ = tops.trace_resident(ts, to, td, T_MIN, tt, ta, any_hit=True)
    got, dropped = tops.trace_resident(ts, to, td, T_MIN, tt, ta, sort_rays=True)
    assert dropped == 0
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    got, _ = tops.trace_resident(ts, to, td, T_MIN, tt, ta, any_hit=True, sort_rays=True)
    assert torch.equal(got, occ)
    assert plain.is_hit.sum() > 20 and occ.sum() > 20


def test_schedule_keys_refuse_more_clusters_than_the_key_holds():
    _, ts = _scenes([random_tri_soup(300, seed=33)], 16)
    big = ts._replace(cl_mt_table=ts.cl_mt_table.new_zeros((4096, 16, 16)))
    rays = (torch.zeros((4, 3)), torch.ones((4, 3)), torch.zeros(4), torch.ones(4),
            torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="4096"):
        tops.schedule_keys(big, *rays)


def _group_scenes():
    """A flat soup and an instanced one (3 placements, so groups are cut
    per instance) at 32 triangles a cluster, built once."""
    from pg2024_dprt_tpu_torch.scene import device_scene_from_instances
    from pg2024_dprt_tpu_torch.scene import device_scene_from_meshes as t_scene
    from pg2024_dprt_tpu_torch.scene import random_tri_soup as t_soup

    if not _GROUP_SCENES:
        xf = np.tile(np.eye(4, dtype=np.float32)[None, :3], (3, 1, 1))
        xf[1, 0, 3], xf[2, 1, 3] = 1.3, -1.1
        _GROUP_SCENES["flat"] = t_scene([t_soup(2500, seed=40)], tris_per_cluster=32,
                                        device="cpu")
        _GROUP_SCENES["instanced"] = device_scene_from_instances(
            [t_soup(1100, seed=41)], xf, tris_per_cluster=32, device="cpu")
    return _GROUP_SCENES


_GROUP_SCENES = {}


@pytest.mark.parametrize("kind", ["flat", "instanced"])
@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), finite=st.booleans())
def test_group_enter_bounds_its_members_enter(kind, seed, finite):
    """The premise of the schedule keys' group cull (K8's grouped mode):
    with the plain slab arithmetic, every cluster a ray enters lies in a
    group it enters, no earlier than the group box (so the group's enter
    bits, masked or not, never exceed a member's); the member boxes are the
    cluster boxes bit for bit, each non-empty cluster in one group."""
    s = _group_scenes()[kind]
    mb = s.cl_mboxes
    kg = mb.shape[0]
    cid0 = mb[:, 0, 7].round().long() if s.instanced else torch.arange(kg) * 8
    member = cid0[:, None] + torch.arange(8)[None, :]
    flagged = mb[:, :, 6] > 0
    clusters = member[flagged]
    assert sorted(clusters.tolist()) == torch.nonzero(s.cl_boxes[6] > 0)[:, 0].tolist()
    assert torch.equal(mb[flagged][:, :7], s.cl_boxes[:7, clusters].T)
    group_of = torch.empty(s.num_clusters, dtype=torch.long)
    group_of[clusters] = torch.arange(kg)[:, None].expand(kg, 8)[flagged]
    n = 256
    lo, hi = s.scene_aabb[0].numpy(), s.scene_aabb[1].numpy()
    o, d, rng = _random_rays(n, seed % (2**32), lo=lo - 0.3, span=(hi - lo) + 0.6)
    tmax = (rng.rand(n) * 2.0 + 0.05).astype(np.float32) if finite else np.full(n, 3.4e38,
                                                                                 np.float32)
    o, d, tmax = torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)
    act = torch.ones(n, dtype=torch.bool)
    inv, _, tcap = tres.ray_limits(s, o, d, torch.full((n,), T_MIN), tmax, act)
    en = tres.cluster_enters_plain(s, o, inv, tcap)
    eg = tres.cluster_enters_plain(s, o, inv, tcap, boxes=s.cl_gboxes)
    entered = torch.isfinite(en)
    assert entered.any()
    eg_of = eg[:, group_of]                          # each cluster's group enter
    assert torch.isfinite(eg_of[entered]).all()
    assert (eg_of[entered].view(torch.int32) <= en[entered].view(torch.int32)).all()


def _entry_rays(n, seed, lo, hi):
    """n seeded rays that enter the box [lo, hi] (train/datagen.py's recipe:
    the origin on a random face, the direction toward a random interior
    point), drawn with numpy."""
    rng = np.random.RandomState(seed)
    p = lo + rng.rand(n, 3) * (hi - lo)
    face = rng.randint(0, 6, n)
    axis = face // 2
    p[np.arange(n), axis] = np.where(face % 2 == 1, hi[axis], lo[axis])
    d = lo + rng.rand(n, 3) * (hi - lo) - p
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p.astype(np.float32), d.astype(np.float32), rng


@pytest.mark.parametrize("any_hit", [False, True])
def test_statue_matches_jax(any_hit):
    """A statue of the paper's A-B row (statue_mesh(32, seed=0): K = 45
    clusters of C = 128, the most the flat kernels K1/K2 take by the
    dispatch rule): 384 seeded rays entering its box, a tenth inactive,
    closest hit with unbounded tmax and any-hit with finite tmax; the port's
    plain version against JAX's trace_resident at the file's tolerances."""
    js, ts = _scenes([statue_mesh(32, seed=0)], None)
    assert ts.num_clusters == 45 and ts.tris_per_cluster == 128
    lo, hi = ts.scene_aabb.numpy()
    n = 384
    o, d, rng = _entry_rays(n, 62, lo, hi)
    act = rng.rand(n) > 0.1
    if any_hit:
        tmax = (rng.rand(n) * 0.8 + 0.05).astype(np.float32)
        got, want = _both(js, ts, o, d, tmax, act, any_hit=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 20 < got.sum() < act.sum()
    else:
        got, want = _both(js, ts, o, d, np.full(n, 1e30, np.float32), act)
        _assert_hits_match(got, want)
        assert got.is_hit.sum() > n // 2 and not got.is_hit.numpy()[~act].any()


@pytest.mark.parametrize("k,n,any_hit,lanes", [
    (1, 1024, False, 8), (1, 1024, True, 32), (1, 65536, False, 1), (1, 65536, True, 1),
    (2, 65536, False, 8), (2, 65536, True, 32), (46, 65536, False, 8), (45, 65536, True, 32),
    (47, 1024, False, 8), (1, 4096, False, 8), (1, 4096, True, 32), (185, 65536, True, 32)])
def test_flat_team_width_rule(k, n, any_hit, lanes):
    """The lanes that walk a ray of K1/K2 by the measured rule
    (ops/resident.py flat_lanes): a lane a ray up to LANE_MAX_CLUSTERS
    clusters from CLOSEST_LANE_MIN_RAYS (K1) or ANYHIT_LANE_MIN_RAYS (K2)
    rows; else teams of CLOSEST_TEAM (K1) or ANYHIT_TEAM (K2) lanes."""
    assert (tres.CLOSEST_TEAM, tres.ANYHIT_TEAM, tres.LANE_MAX_CLUSTERS) == (8, 32, 1)
    assert 4096 < tres.ANYHIT_LANE_MIN_RAYS <= 65536
    assert 4096 < tres.CLOSEST_LANE_MIN_RAYS <= 65536
    assert tres.flat_lanes(k, n, any_hit) == lanes


# (seed, K) of the eight statues of the A-B row, statue_mesh(32, seed)
STATUE_K = [(0, 45), (1, 46), (2, 49), (3, 47), (4, 46), (5, 49), (6, 48), (7, 48)]


@pytest.mark.parametrize("seed,k", STATUE_K)
def test_dispatch_rule_on_the_statue_row(seed, k):
    """The dispatch rule's constants where they were measured
    (ops/resident.py): on the statues of the A-B row, K3, K7 and K8 take
    their grouped modes from K = 47 on, while trace_resident keeps K1 under
    64 clusters and K2 under 512 (`trace_grouped`); K1 walks them with
    teams of 8 lanes, K2 with warp teams (`flat_lanes`)."""
    ts = tscene.device_scene_from_meshes([tscene.statue_mesh(32, seed=seed)], device="cpu")
    assert ts.num_clusters == k and ts.tris_per_cluster == 128
    assert (tres.GROUPED_MIN_CLUSTERS, tres.CLOSEST_GROUPED_MIN_CLUSTERS,
            tres.ANYHIT_GROUPED_MIN_CLUSTERS) == (47, 64, 512)
    assert tres.use_grouped(ts) == (k >= 47)
    assert not tres.trace_grouped(ts) and not tres.trace_grouped(ts, True)
    assert tres.trace_grouped(ts, True, grouped=True) and not tres.use_grouped(ts, False)
    assert tres.flat_lanes(k, 65536) == 8 and tres.flat_lanes(k, 65536, any_hit=True) == 32
