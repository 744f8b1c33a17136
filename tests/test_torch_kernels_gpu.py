"""The port's CUDA kernels against their plain PyTorch versions.

This file imports torch and the port only (no JAX), so it also runs on a
machine without JAX, where the repository's conftest.py cannot load:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_gpu.py

Tests marked `cuda` skip without a GPU; the CUDA kernels have no CPU mode.
Tolerance for the trace kernels K1/K2: exact. They are built without FMA
contraction and pick the same lexicographic (t, slot) winner as the plain
versions. Tolerance for the frame kernel K3: a last-bit difference of
sinf/cosf/acosf/atan2f against PyTorch's kernels can flip a hit at an edge,
an RIS pick or a roulette survival, and that pixel then differs by far more
than rounding; so at most 0.1 % of the pixels may lie outside
|a - b| / max(|a|, 1e-2) < 1e-3, and the frame means agree within 1e-3.
"""
import numpy as np
import pytest
import torch

from pg2024_dprt_tpu_torch import ops as tops
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.core import Camera
from pg2024_dprt_tpu_torch.render import RenderConfig
from pg2024_dprt_tpu_torch.scene import device_scene_from_meshes, random_tri_soup

T_MIN = 1e-3
# canonical ids past 2^24 are not exact in float32: the kernels must carry
# them through cl_tri_map (int32), never through cl_mt_table's row 12
ID_OFFSET = 2**24 + 3


def _case(device, n=8192):
    scene = device_scene_from_meshes([random_tri_soup(5000, seed=60)],
                                     tris_per_cluster=128, device=device)
    rng = np.random.RandomState(61)
    o = (rng.rand(n, 3) * 1.4 - 0.2).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = (rng.rand(n) * 2.0).astype(np.float32)
    act = rng.rand(n) > 0.1
    on = lambda a: torch.as_tensor(a, device=device)
    rays = (on(o), on(d), torch.full((n,), T_MIN, device=device), on(tmax), on(act))
    return scene, rays


def _offset_ids(scene):
    tm = scene.cl_tri_map
    return scene._replace(cl_tri_map=torch.where(tm >= 0, tm + ID_OFFSET, tm))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernels have no CPU mode)")


def test_ids_past_2p24_are_exact_on_cpu():
    """The plain closest hit returns canonical ids from cl_tri_map exactly,
    also past 2^24 where float32 cannot hold them."""
    scene, rays = _case("cpu", n=2048)
    base = tops.resident_closest(scene, *rays)
    big = tops.resident_closest(_offset_ids(scene), *rays)
    assert big.tri_index.dtype == torch.int32
    hit = base.is_hit
    assert hit.sum() > 100
    assert torch.equal(big.is_hit, hit)
    assert torch.equal(big.tri_index[hit], base.tri_index[hit] + ID_OFFSET)
    assert (big.tri_index[~hit] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("offset_ids", [False, True])
def test_kernels_match_plain_on_gpu(offset_ids):
    """K1 and K2 on the card equal their plain versions on the card, field by
    field (so moving their device functions into the shared header changed
    no result), and each wrapper counts exactly its own launch."""
    _need_cuda()
    scene, rays = _case("cuda")
    if offset_ids:
        scene = _offset_ids(scene)
    before = dict(tops.LAUNCHES)
    got = tops.resident_closest(scene, *rays)
    want = tops.resident_closest_plain(scene, *rays)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.is_hit.sum() > 100
    if offset_ids:
        assert (got.tri_index[got.is_hit] >= ID_OFFSET).all()
    occ = tops.resident_anyhit(scene, *rays)
    assert torch.equal(occ, tops.resident_anyhit_plain(scene, *rays))
    assert tops.LAUNCHES["resident_closest"] == before["resident_closest"] + 1
    assert tops.LAUNCHES["resident_anyhit"] == before["resident_anyhit"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("tpc,n_tris", [(128, 5000), (16, 3000), (None, 30)])
def test_schedule_keys_kernel_matches_plain_on_gpu(tpc, n_tris):
    """K8 on the card equals its plain version on every ray (integer keys;
    the same slab arithmetic without FMA contraction), counts its own launch,
    and the sorted traces return every ray's own result."""
    _need_cuda()
    _, rays = _case("cuda")
    scene = device_scene_from_meshes([random_tri_soup(n_tris, seed=60)],
                                     tris_per_cluster=tpc, device="cuda")
    before = dict(tops.LAUNCHES)
    key = tops.schedule_keys(scene, *rays)
    torch.cuda.synchronize()
    assert tops.LAUNCHES == {**before, "schedule_keys": before["schedule_keys"] + 1}
    assert key.dtype == torch.int32
    assert torch.equal(key, tops.schedule_keys_plain(scene, *rays))
    act = rays[4]
    assert (key[~act] == 0x7FFFFFFF).all() and ((key[act] >> 12) != 0xFFF).sum() > 1000
    if scene.num_clusters == 1:
        assert ((key[act] & 0xFFF) == 0xFFF).all()
    perm = tops.schedule_order(scene, *rays)
    assert (key[perm][1:] >= key[perm][:-1]).all()
    o, d, tmin, tmax, _ = rays
    for any_hit in (False, True):
        want, _ = tops.trace_resident(scene, o, d, tmin, tmax, act, any_hit=any_hit)
        got, _ = tops.trace_resident(scene, o, d, tmin, tmax, act, any_hit=any_hit,
                                     sort_rays=True)
        for a, b in ([(got, want)] if any_hit else zip(got, want)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    """A CUDA wrapper launches its kernel or raises: wrong dtypes or rays on
    another device than the scene raise before any launch."""
    _need_cuda()
    scene, (o, d, tmin, tmax, act) = _case("cuda", n=256)
    before = dict(tops.LAUNCHES)
    with pytest.raises(ValueError):
        tops.resident_closest(scene, o.double(), d, tmin, tmax, act)
    with pytest.raises(ValueError):
        tops.resident_anyhit(scene, o, d, tmin, tmax, act.to(torch.int32))
    cpu_scene = scene._replace(cl_mt_table=scene.cl_mt_table.cpu())
    with pytest.raises(ValueError):
        tops.resident_closest(cpu_scene, o, d, tmin, tmax, act)
    assert tops.LAUNCHES == before


def _frame_case(kind, device):
    """(scene, lights, env, camera, cfg) of a small frame: a 5000-triangle
    soup under an area light with a lat-long sky, or the checkerboard-floor
    cornell with the water box."""
    if kind == "soup":
        scene = device_scene_from_meshes([random_tri_soup(5000, seed=60)],
                                         tris_per_cluster=128, device=device)
        lt = np.asarray([[[0.3, 2.0, 0.3], [0.7, 2.0, 0.3], [0.7, 2.0, 0.7]],
                         [[0.1, 2.0, 0.1], [0.3, 2.0, 0.1], [0.3, 2.0, 0.3]]], np.float32)
        lights = tscene.LightTable.from_arrays(
            lt, np.asarray([[60, 60, 60], [20, 50, 20]], np.float32), device=device)
        sky = np.random.default_rng(0).uniform(0.0, 1.0, (16, 32, 3)).astype(np.float32)
        env = tscene.EnvironmentMap.from_image(sky, rotation_offset=2.007, device=device)
        cam = Camera.look_at([0.5, 0.5, 3.0], [0.5, 0.5, 0.5], [0, 1, 0], 45.0, 64, 64,
                             device=device)
        return scene, lights, env, cam, dict(width=64, height=64, bounces=3)
    meshes, lights = tscene.textured_cornell_box(with_water_sphere=True, device=device)
    scene = device_scene_from_meshes(
        meshes, textures=[tscene.checkerboard(tiles=4)], device=device)
    env = tscene.EnvironmentMap.constant((0.2, 0.3, 0.4), device=device)
    cam = Camera.look_at([0.5, 0.9, 2.2], [0.5, 0.2, 0.0], [0, 1, 0], 45.0, 32, 32,
                         device=device)
    return scene, lights, env, cam, dict(width=32, height=32, bounces=3)


def _frames_agree(got, want):
    for a, b in zip(got[:2], want[:2]):
        rel = (a - b).abs() / a.abs().clamp(min=1e-2)
        outliers = int((rel >= 1e-3).any(dim=1).sum())
        assert outliers <= 1e-3 * a.shape[0], outliers
        assert abs(float(a.mean()) - float(b.mean())) <= 1e-3 * abs(float(b.mean())) + 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["soup", "textured_cornell"])
@pytest.mark.parametrize("nee_mode,rr", [("ris", 0), ("sum", 2)])
def test_frame_kernel_matches_plain_on_gpu(kind, nee_mode, rr):
    """K3 on the card against its plain version on the card, 3 spp in one
    launch; the wrapper counts exactly one launch and none of K1/K2."""
    _need_cuda()
    scene, lights, env, cam, kw = _frame_case(kind, "cuda")
    cfg = RenderConfig(spp=3, nee_mode=nee_mode, russian_roulette=rr, **kw)
    before = dict(tops.LAUNCHES)
    got = tops.render_frame_fused(scene, lights, env, cam, 5, cfg, spp=3)
    after = dict(tops.LAUNCHES)
    want = tops.render_frame_fused_plain(scene, lights, env, cam, 5, cfg, spp=3)
    torch.cuda.synchronize()
    assert after == {**before, "frame_sample": before["frame_sample"] + 1}
    assert float(got[0].max()) > 0.0 and float(got[1].max()) > 0.0
    _frames_agree(got, want)


@pytest.mark.cuda
def test_frame_kernel_is_deterministic():
    """Two K3 launches with the same arguments give bit-identical images."""
    _need_cuda()
    scene, lights, env, cam, kw = _frame_case("soup", "cuda")
    cfg = RenderConfig(spp=2, **kw)
    a = tops.render_frame_fused(scene, lights, env, cam, 1, cfg, spp=2)
    b = tops.render_frame_fused(scene, lights, env, cam, 1, cfg, spp=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_frame_wrapper_refuses_what_the_kernel_does_not_take():
    """A table on another device than the camera, or a camera and a config
    of different sizes, raise before any launch."""
    _need_cuda()
    scene, lights, env, cam, kw = _frame_case("soup", "cuda")
    cfg = RenderConfig(**kw)
    before = dict(tops.LAUNCHES)
    with pytest.raises(ValueError):
        tops.render_frame_fused(scene._replace(tri_shade=scene.tri_shade.cpu()),
                                lights, env, cam, 0, cfg)
    with pytest.raises(ValueError):
        tops.render_frame_fused(scene, lights, env, cam, 0, RenderConfig(width=16, height=16))
    assert tops.LAUNCHES == before


# --------------------------------------------------------------------------
# the neural-proxy kernels: K4 proxy_march, K5 mlp_pair, K6 mlp_dense, K7 route
# (K7's secondary entry point after K8 schedule_keys and the sort)
#
# Tolerances. K4 is built without FMA contraction and takes the same (t, row)
# minimum as its plain version: ids, flags and the hit sequence are equal, t
# within rtol 1e-5 / atol 1e-6, features within rtol 1e-4 / atol 2e-5 (acosf /
# atan2f against PyTorch's kernels; phi / 2pi is compared modulo 1). K5/K6 sum
# bf16-rounded products in another order than the plain version, and one
# flipped bf16 rounding of an activation moves an output by about 2^-8
# relative: rtol / atol 2e-2. K7's decisions sit on thresholds of net outputs,
# so its nets' vis bias is shifted by +-10 and then nodes and flags are equal.

from pg2024_dprt_tpu_torch import models as tmodels  # noqa: E402
from pg2024_dprt_tpu_torch.models import mlp as tmlp  # noqa: E402
from pg2024_dprt_tpu_torch.render import proxy_stages as tps  # noqa: E402
from pg2024_dprt_tpu_torch.core.types import PathState  # noqa: E402

MH = 3
EPS = 1e-3
SMALL = tmlp.MLPConfig(width=64, depth=2)
UNIT_OFFS = np.asarray(
    [[-1.05, 0, 0], [1.05, 0, 0], [0, -1.05, 0], [0, 1.05, 0],
     [0, 0, -1.05], [0, 0, 1.05], [-1.05, -1.05, 0], [1.05, 1.05, 0]], np.float32)


def _proxy_table(kind, device):
    if kind == "instanced":
        rng = np.random.RandomState(11)
        p = 16
        offs = rng.rand(p, 3).astype(np.float32) * 3.0 - 1.0
        sc = 0.4 + rng.rand(p).astype(np.float32) * 0.8
        m = np.zeros((p, 3, 4), np.float32)
        for i in range(p):
            m[i, :, :3] = np.eye(3, dtype=np.float32) / sc[i]
            m[i, :, 3] = -offs[i] / sc[i]
        arrays = dict(aabb_min=offs, aabb_max=offs + sc[:, None],
                      max_length=np.full((p,), np.sqrt(3.0), np.float32),
                      obj_id=(np.arange(p) % 4).astype(np.int32),
                      node_id=(np.arange(p) % 8).astype(np.int32), world_to_obj=m,
                      obj_min=np.zeros((p, 3), np.float32), obj_span=np.ones((p, 3), np.float32))
    else:
        lo, hi = UNIT_OFFS.copy(), UNIT_OFFS + 1.0
        ml = np.full((8,), np.sqrt(3.0), np.float32)
        if kind == "empty_partition":
            lo[2], hi[2], ml[2] = np.inf, -np.inf, 0.0
        arrays = dict(aabb_min=lo, aabb_max=hi, max_length=ml)
    return tscene.proxy_table_from_arrays(arrays, device=device)


def _march_rays(n, device, capped):
    rng = np.random.RandomState(5)
    o = (rng.rand(n, 3) * 3.0 - 1.0).astype(np.float32)   # many origins inside a box
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_cap = (0.3 + rng.rand(n) * 3.0).astype(np.float32) if capped else np.full(n, 3.4e38, np.float32)
    act = rng.rand(n) > (0.3 if capped else -1.0)
    on = lambda a: torch.as_tensor(a, device=device)
    return on(o), on(d), on(t_cap), on(act)


def _queries_agree(got, want):
    for f in ("aabb_id", "node_id", "hit_sequence", "is_inside", "is_valid", "path_index",
              "pixel_index", "shadow_path_id"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("aabb_t", "max_length", "t_ratio", "normalized_t"):
        assert torch.allclose(getattr(got, f), getattr(want, f), rtol=1e-5, atol=1e-6), f
    gf, wf = got.features, want.features
    assert torch.allclose(gf[:, [0, 1, 2, 4]], wf[:, [0, 1, 2, 4]], rtol=1e-4, atol=2e-5)
    dphi = (gf[:, 3] - wf[:, 3]).abs()
    assert bool((torch.minimum(dphi, 1.0 - dphi) <= 2e-5 + 1e-4 * wf[:, 3].abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind,capped,my_node", [
    ("unit", False, 8), ("unit", True, 2), ("empty_partition", False, 0),
    ("instanced", False, 31), ("instanced", True, 3)])
def test_march_kernel_matches_plain_on_gpu(kind, capped, my_node):
    """K4 on the card against its plain version on the card, every row."""
    _need_cuda()
    table = _proxy_table(kind, "cuda")
    rays = _march_rays(20000, "cuda", capped)
    before = dict(tops.LAUNCHES)
    got = tops.proxy_march(table, *rays, my_node, MH, EPS)
    want = tops.march_proxies_plain(table, *rays, my_node, MH, EPS)
    torch.cuda.synchronize()
    assert tops.LAUNCHES == {**before, "proxy_march": before["proxy_march"] + 1}
    _queries_agree(got, want)
    assert got.is_valid.sum() > 1000 and got.is_inside.sum() > 100
    assert bool(torch.isfinite(got.features).all())


# rows of each object in the "edges" batch of the MLP kernel test: chunk
# edges of K5 / K6 (one row, an m16 tile, one past it, a 64-row chunk, one
# past it, several chunks) and an object without rows
EDGE_ROWS = (1, 16, 17, 64, 65, 300, 0)


def _mlp_case(cfg, vis_cfg, q, o_count, device, layout="random"):
    m = tmodels.random_proxy_models(7, o_count, vis_cfg, cfg, device=device)
    # every object's depth net stands 0.5 above the one before it, so that
    # another object's weights show in the result
    m.depth_params["head_b1"].add_(0.5 * torch.arange(o_count, device=device)[:, None])
    rng = np.random.RandomState(8)
    on = lambda a: torch.as_tensor(a, device=device)
    feats = on(rng.rand(q, cfg.in_features).astype(np.float32))
    if layout == "edges":
        # the objects' rows in ray order among filler rows that are invalid
        # or whose object has no net
        n_fill = q - sum(EDGE_ROWS)
        fill_obj = rng.randint(-1, o_count + 1, n_fill)
        fill_valid = (rng.rand(n_fill) > 0.5) & ((fill_obj < 0) | (fill_obj >= o_count))
        obj = np.concatenate([np.full(c, o) for o, c in enumerate(EDGE_ROWS)] + [fill_obj])
        valid = np.concatenate([np.ones(sum(EDGE_ROWS), bool), fill_valid])
        perm = rng.permutation(q)
        return m, feats, on(obj[perm].astype(np.int32)), on(valid[perm])
    if layout == "one_object":
        return m, feats, on(np.zeros(q, np.int32)), on(rng.rand(q) > 0.2)
    obj = on(rng.randint(-1, o_count + 1, q).astype(np.int32))    # some out of range
    valid = on(rng.rand(q) > 0.3)
    return m, feats, obj, valid


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["mlp_pair", "mlp_dense"])
@pytest.mark.parametrize("width,depth,head,q,o_count,in_features,layout", [
    (64, 2, 64, 1777, 5, 5, "random"), (256, 4, 64, 4099, 8, 5, "random"),
    (128, 1, 32, 300, 3, 5, "random"), (64, 0, 16, 33, 1, 5, "random"),
    (24, 2, 20, 901, 4, 3, "random"), (24, 1, 20, 901, 4, 8, "random"),
    (64, 1, 20, 700, len(EDGE_ROWS), 5, "edges"), (64, 2, 64, 517, 3, 5, "one_object")])
def test_mlp_kernels_match_plain_on_gpu(kernel, width, depth, head, q, o_count, in_features,
                                        layout):
    """K5 / K6 on the card against their plain version on the card; the vis
    net ends in a sigmoid and the depth net in a LeakyReLU, so a swap would
    show. Invalid rows and rows whose object has no net are zero. Padded
    shapes (width 24: encoders of 3 and 12, head 20, 3 and 8 inputs) and the
    chunk edges of EDGE_ROWS (all of them in one K6 block: the batch is under
    one part) and a batch of one object. K5 and K6 give every row the same
    bits."""
    _need_cuda()
    cfg = tmlp.MLPConfig(width=width, depth=depth, head_hidden=head, in_features=in_features)
    vis_cfg = tmlp.MLPConfig(width=width, depth=depth, head_hidden=head,
                             in_features=in_features, final_activation="sigmoid")
    m, feats, obj, valid = _mlp_case(cfg, vis_cfg, q, o_count, "cuda", layout)
    if layout == "edges":
        assert tops.mlp.dense_parts(q, o_count, feats.device) == 1
        live = valid & (obj >= 0) & (obj < o_count)
        assert torch.bincount(obj[live].long(), minlength=o_count).tolist() == list(EDGE_ROWS)
    fn = {"mlp_pair": tops.grouped_mlp_pair, "mlp_dense": tops.grouped_mlp_dense}[kernel]
    before = dict(tops.LAUNCHES)
    vis, depth_ = fn(m, feats, obj, valid)
    torch.cuda.synchronize()
    assert tops.LAUNCHES == {**before, kernel: before[kernel] + 1}
    other = {"mlp_pair": tops.grouped_mlp_dense, "mlp_dense": tops.grouped_mlp_pair}[kernel]
    o_vis, o_depth = other(m, feats, obj, valid)
    assert torch.equal(o_vis, vis) and torch.equal(o_depth, depth_)
    p_vis, p_depth = tops.grouped_mlp_pair_plain(m, feats, obj, valid)
    assert torch.allclose(vis, p_vis, rtol=2e-2, atol=2e-2)
    assert torch.allclose(depth_, p_depth, rtol=2e-2, atol=2e-2)
    dead = ~valid | (obj < 0) | (obj >= o_count)
    assert (vis[dead] == 0).all() and (depth_[dead] == 0).all()
    assert 0.0 < float(vis[~dead].min()) and float(vis.max()) < 1.0
    # a wrong object's nets would show: the plain version with the object
    # ids rotated by one differs by far more than the tolerance
    if o_count > 1:
        _, r_depth = tops.grouped_mlp_pair_plain(m, feats, (obj + 1) % o_count, valid)
        assert (~torch.isclose(depth_, r_depth, rtol=2e-2, atol=2e-2))[~dead].float().mean() > 0.9
    # the packed copy kept on the record is reused, and made anew when a
    # param is written in place: the kernel then follows the plain version
    again = fn(m, feats, obj, valid)
    assert torch.equal(again[0], vis) and torch.equal(again[1], depth_)
    m.depth_params["head_b1"].add_(0.75)
    moved = fn(m, feats, obj, valid)
    assert torch.equal(moved[0], vis)
    assert torch.allclose(moved[1], tops.grouped_mlp_pair_plain(m, feats, obj, valid)[1],
                          rtol=2e-2, atol=2e-2)
    assert not torch.allclose(moved[1], depth_, rtol=2e-2, atol=2e-2)


def _trace_kernel(scene, query):
    """The trace kernel the dispatch rule picks for the composed stage."""
    return ("grouped_" if tops.trace_grouped(scene, query == "anyhit")
            else "resident_") + query


def _route_case(device, vis_bias, depth_bias=0.0, n=6000, shadow=False, kind="unit"):
    import dataclasses

    scene = device_scene_from_meshes([random_tri_soup(5000, seed=60)],
                                     tris_per_cluster=128, device=device)
    table = _proxy_table(kind, device)
    n_obj = 4 if kind == "instanced" else 8
    m = tmodels.random_proxy_models(3, n_obj, SMALL, SMALL, device=device)
    shift = lambda d, b: {k: (v + b if k == "head_b1" else v) for k, v in d.items()}
    m = dataclasses.replace(m, vis_params=shift(m.vis_params, vis_bias),
                            depth_params=shift(m.depth_params, depth_bias))
    rng = np.random.RandomState(9)
    on = lambda a: torch.as_tensor(a, device=device)
    o = (rng.rand(n, 3) * 1.4 - 0.2).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = (rng.rand(n) * 2.5 + 0.3).astype(np.float32) if shadow else np.full(n, 3.4e38, np.float32)
    paths = PathState.empty(n, device=device)._replace(
        origin=on(o), direction=on(d), tmax=on(tmax),
        throughput=on(rng.rand(n, 3).astype(np.float32)),
        pixel_index=on((np.arange(n) % 997).astype(np.int64)), is_valid=on(rng.rand(n) > 0.1))
    return scene, table, m, paths


@pytest.mark.cuda
@pytest.mark.parametrize("vis_bias", [10.0, -10.0])
@pytest.mark.parametrize("kind,my_id", [("unit", 8), ("instanced", 3)])
def test_route_kernel_secondary_matches_plain_and_composed_on_gpu(vis_bias, kind, my_id,
                                                                  monkeypatch):
    """K7 (secondary) against its plain version and, through the stage,
    against the composed path (K1 + K4 + K6)."""
    _need_cuda()
    scene, table, m, paths = _route_case("cuda", vis_bias, kind=kind)
    live = paths.is_valid
    args = (paths.origin, paths.direction, EPS, paths.tmax, live, my_id, MH, EPS)
    before = dict(tops.LAUNCHES)
    dec = tops.route_fused(scene, table, m, *args)
    torch.cuda.synchronize()
    assert tops.LAUNCHES == {**before, "schedule_keys": before["schedule_keys"] + 1,
                             "route_secondary": before["route_secondary"] + 1}
    # in the caller's order, without the schedule sort: the same decisions
    unsorted = tops.route_fused(scene, table, m, *args, sort_rays=False)
    assert tops.LAUNCHES["schedule_keys"] == before["schedule_keys"] + 1
    for key in dec:
        assert torch.equal(dec[key], unsorted[key]), key
    ref = tops.route_fused_plain(scene, table, m, *args)
    for key in ("has_node", "env_miss", "no_route", "local_hit"):
        assert torch.equal(dec[key], ref[key]), key
    assert torch.equal(dec["settled_node"].to(torch.int64), ref["settled_node"])
    assert torch.allclose(dec["new_t"], ref["new_t"], rtol=2e-3, atol=2e-3)
    assert dec["local_hit"].sum() > 100 and dec["env_miss"].sum() > 10
    if vis_bias > 0:
        assert (dec["has_node"] & ~dec["local_hit"]).sum() > 100

    env = tscene.EnvironmentMap.constant((0.4, 0.5, 0.7), device="cuda")
    tops.reset_launch_counts()
    fused, env_f, _ = tps.secondary_route(scene, table, m, env, paths, my_id, MH, EPS, 997)
    assert {k: v for k, v in tops.LAUNCHES.items() if v} == {
        "schedule_keys": 1, "route_secondary": 1}
    tops.reset_launch_counts()
    monkeypatch.setattr(tps, "_use_fused_route", lambda *a: False)
    composed, env_c, _ = tps.secondary_route(scene, table, m, env, paths, my_id, MH, EPS, 997)
    assert {k: v for k, v in tops.LAUNCHES.items() if v} == {
        "schedule_keys": 1, _trace_kernel(scene, "closest"): 1, "proxy_march": 1,
        "mlp_dense": 1}
    for f in ("target_node", "current_node", "is_hit", "is_valid", "visited_mask"):
        assert torch.equal(getattr(fused, f), getattr(composed, f)), f
    assert torch.allclose(fused.tmax, composed.tmax, rtol=2e-3, atol=2e-3)
    assert torch.allclose(env_f, env_c, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("vis_bias,depth_bias", [(10.0, -10.0), (10.0, 10.0), (-10.0, 0.0)])
def test_route_kernel_shadow_matches_plain_and_composed_on_gpu(vis_bias, depth_bias,
                                                               monkeypatch):
    """K7 (shadow) against its plain version and, through the stage, against
    the composed path (K2 + K4 + K6)."""
    _need_cuda()
    scene, table, m, paths = _route_case("cuda", vis_bias, depth_bias, shadow=True)
    args = (paths.origin, paths.direction, EPS, paths.tmax * (1.0 - 1e-3), paths.is_valid,
            8, MH, EPS)
    before = dict(tops.LAUNCHES)
    dec = tops.shadow_route_fused(scene, table, m, *args)
    torch.cuda.synchronize()
    assert tops.LAUNCHES == {**before, "route_shadow": before["route_shadow"] + 1}
    ref = tops.shadow_route_fused_plain(scene, table, m, *args)
    in_order = tops.shadow_route_fused(scene, table, m, *args, sort_rays=True)
    for key in ("weight", "occluded_local", "survives"):
        assert torch.equal(dec[key], ref[key]), key
        assert torch.equal(dec[key], in_order[key]), key
    assert dec["survives"].sum() > 100 and dec["occluded_local"].sum() > 100
    tops.reset_launch_counts()
    fused, _ = tps.shadow_direct_light_nn(scene, table, m, paths, 8, MH, EPS, 4, 997)
    assert {k: v for k, v in tops.LAUNCHES.items() if v} == {"route_shadow": 1}
    tops.reset_launch_counts()
    monkeypatch.setattr(tps, "_use_fused_route", lambda *a: False)
    composed, _ = tps.shadow_direct_light_nn(scene, table, m, paths, 8, MH, EPS, 4, 997)
    assert {k: v for k, v in tops.LAUNCHES.items() if v} == {
        "schedule_keys": 1, _trace_kernel(scene, "anyhit"): 1, "proxy_march": 1,
        "mlp_dense": 1}
    assert torch.allclose(fused, composed, rtol=1e-5, atol=1e-6)
    assert float(fused.sum()) > 0.0


def _multigeo_case(kind, vis_bias, depth_bias, width, depth, shadow=False):
    import dataclasses

    scene, table, _, paths = _route_case("cuda", 0.0, kind=kind, shadow=shadow)
    cfg = tmlp.MLPConfig(width=width, depth=depth, in_features=6, multi_geo=True,
                         final_activation="none")
    rng = np.random.RandomState(17)
    vis = tmlp.init_mlp(rng, cfg, device="cuda")
    dep = tmlp.init_mlp(rng, dataclasses.replace(cfg, final_activation="leaky_relu"),
                        device="cuda")
    vis["head_b2"] = vis["head_b2"] + vis_bias
    dep["head_b2"] = dep["head_b2"] + depth_bias
    m = tmodels.multigeo_proxy_models(
        vis, dep, 8, cfg, dataclasses.replace(cfg, final_activation="leaky_relu"))
    return scene, table, m, paths


@pytest.mark.cuda
@pytest.mark.parametrize("vis_bias,depth_bias,shadow", [
    (10.0, 0.0, False), (-10.0, 0.0, False), (10.0, -10.0, True), (10.0, 10.0, True)])
@pytest.mark.parametrize("kind,width,depth", [("unit", 64, 2), ("instanced", 64, 2),
                                              ("unit", 512, 3)])
def test_route_kernel_multigeo_matches_plain_and_composed_on_gpu(
        vis_bias, depth_bias, shadow, kind, width, depth, monkeypatch):
    """K7's multi-geo mode (one shared 6-feature net pair) against its plain
    version and, through the stage, against the composed path (K8 + the
    trace kernel + K4 + plain apply_multigeo). The heads are shifted by +-10
    so that no decision sits at a threshold."""
    _need_cuda()
    scene, table, m, paths = _multigeo_case(kind, vis_bias, depth_bias, width, depth, shadow)
    my_id = 3 if kind == "instanced" else 8
    t_max = paths.tmax * (1.0 - 1e-3) if shadow else paths.tmax
    args = (paths.origin, paths.direction, EPS, t_max, paths.is_valid, my_id, MH, EPS)
    entry = tops.shadow_route_fused if shadow else tops.route_fused
    plain = tops.shadow_route_fused_plain if shadow else tops.route_fused_plain
    tops.reset_launch_counts()
    dec = entry(scene, table, m, *args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in tops.LAUNCHES.items() if v}
    assert launches == ({"route_shadow": 1, "route_multigeo": 1} if shadow else
                        {"schedule_keys": 1, "route_secondary": 1, "route_multigeo": 1})
    ref = plain(scene, table, m, *args)
    for key, val in dec.items():
        if key == "new_t":
            assert torch.allclose(val, ref[key], rtol=2e-3, atol=2e-3)
        else:
            assert torch.equal(val.to(ref[key].dtype), ref[key]), key
    tops.reset_launch_counts()
    if shadow:
        fused, _ = tps.shadow_direct_light_nn(scene, table, m, paths, my_id, MH, EPS, 4, 997)
        assert {k: v for k, v in tops.LAUNCHES.items() if v} == {
            "route_shadow": 1, "route_multigeo": 1}
        monkeypatch.setattr(tps, "_use_fused_route", lambda *a: False)
        composed, _ = tps.shadow_direct_light_nn(scene, table, m, paths, my_id, MH, EPS, 4,
                                                 997)
        assert torch.allclose(fused, composed, rtol=1e-5, atol=1e-6)
        assert dec["survives"].sum() > 100
        return
    env = tscene.EnvironmentMap.constant((0.4, 0.5, 0.7), device="cuda")
    fused, env_f, _ = tps.secondary_route(scene, table, m, env, paths, my_id, MH, EPS, 997)
    assert {k: v for k, v in tops.LAUNCHES.items() if v} == {
        "schedule_keys": 1, "route_secondary": 1, "route_multigeo": 1}
    tops.reset_launch_counts()
    monkeypatch.setattr(tps, "_use_fused_route", lambda *a: False)
    composed, env_c, _ = tps.secondary_route(scene, table, m, env, paths, my_id, MH, EPS, 997)
    assert {k: v for k, v in tops.LAUNCHES.items() if v} == {
        "schedule_keys": 1, _trace_kernel(scene, "closest"): 1, "proxy_march": 1}
    for f in ("target_node", "current_node", "is_hit", "is_valid", "visited_mask"):
        assert torch.equal(getattr(fused, f), getattr(composed, f)), f
    assert torch.allclose(fused.tmax, composed.tmax, rtol=2e-3, atol=2e-3)
    assert torch.allclose(env_f, env_c, rtol=1e-5, atol=1e-6)
    if vis_bias > 0:
        assert (dec["has_node"] & ~dec["local_hit"]).sum() > 100


def _grouped_route_case(stage, edge):
    """(scene, table, models, paths) of the grouped-route test: a soup of
    K around the dispatch rule's threshold (2,050 triangles at 16 a
    cluster); `edge` "sparse" is a 65,536-row buffer with 0.6 % of its rows
    active, "ragged" 6,001 rows (not a multiple of 32 or of a tile), the
    rest 4,096 rows."""
    n = {"sparse": 65536, "ragged": 6001}.get(edge, 4096)
    shadow = stage.endswith("shadow")
    if stage.startswith("multigeo"):
        _, table, m, paths = _multigeo_case("unit", 10.0, -10.0 if shadow else 0.0, 64, 2,
                                            shadow=shadow)
    else:
        _, table, m, _ = _route_case("cuda", 10.0, -10.0)
    rng = np.random.RandomState(90)
    on = lambda a: torch.as_tensor(a, device="cuda")
    o = (rng.rand(n, 3) * 1.4 - 0.2).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = (rng.rand(n) * 2.5 + 0.3).astype(np.float32) if shadow else np.full(n, 3.4e38,
                                                                               np.float32)
    live = rng.rand(n) < 0.006 if edge == "sparse" else rng.rand(n) > 0.1
    paths = PathState.empty(n, device="cuda")._replace(
        origin=on(o), direction=on(d), tmax=on(tmax),
        throughput=on(rng.rand(n, 3).astype(np.float32)),
        pixel_index=on((np.arange(n) % 997).astype(np.int64)), is_valid=on(live))
    scene = device_scene_from_meshes([random_tri_soup(2050, seed=60)], tris_per_cluster=16,
                                     device="cuda")
    return scene, table, m, paths


ROUTE_GROUPED_CASES = [(stage, edge) for stage in ("secondary", "shadow", "multigeo",
                                                   "multigeo_shadow")
                       for edge in ("sparse", "ragged", "above_rule", "below_rule")]


@pytest.mark.cuda
@pytest.mark.parametrize("stage,edge", ROUTE_GROUPED_CASES)
def test_route_kernel_grouped_mode_equals_flat_and_plain_on_gpu(stage, edge, monkeypatch):
    """K7 through the warp walks (grouped=True) against its flat mode
    (grouped=False) and its plain version: the traces equal K1 / K2 bit for
    bit, so every decision and weight is equal on every ray (the heads'
    biases are shifted by 10 so that no decision sits at a threshold of the
    plain version's nets). With the rule's threshold at the scene's K
    ("above_rule") or one above it ("below_rule"), the default dispatch
    takes the grouped or the flat trace, and its decisions are the same."""
    _need_cuda()
    scene, table, m, paths = _grouped_route_case(stage, edge)
    shadow = stage.endswith("shadow")
    t_max = paths.tmax * (1.0 - 1e-3) if shadow else paths.tmax
    args = (paths.origin, paths.direction, EPS, t_max, paths.is_valid, 8, MH, EPS)
    entry = tops.shadow_route_fused if shadow else tops.route_fused
    plain = tops.shadow_route_fused_plain if shadow else tops.route_fused_plain
    k = scene.num_clusters
    monkeypatch.setattr(tres, "GROUPED_MIN_CLUSTERS", k + 1 if edge == "below_rule" else k)
    assert tops.use_grouped(scene) == (edge != "below_rule")
    tops.reset_launch_counts()
    by_rule = entry(scene, table, m, *args)
    grouped = entry(scene, table, m, *args, grouped=True)
    flat = entry(scene, table, m, *args, grouped=False)
    torch.cuda.synchronize()
    name = "route_shadow" if shadow else "route_secondary"
    assert tops.LAUNCHES[name] == 3
    assert tops.LAUNCHES["route_multigeo"] == (3 if m.multi_geo else 0)
    for key in flat:
        assert torch.equal(grouped[key], flat[key]), key
        assert torch.equal(by_rule[key], flat[key]), key
    ref = plain(scene, table, m, *args)
    for key, val in grouped.items():
        if key == "new_t":
            assert torch.allclose(val, ref[key], rtol=2e-3, atol=2e-3)
        else:
            assert torch.equal(val.to(ref[key].dtype), ref[key]), key
    live = int(paths.is_valid.sum())
    if edge == "sparse":
        assert 0 < live < paths.capacity // 100
    hit = grouped["occluded_local"] if shadow else grouped["local_hit"]
    assert int(hit.sum()) > (2 if edge == "sparse" else 100)


@pytest.mark.cuda
def test_proxy_wrappers_refuse_what_the_kernels_do_not_take():
    """A CUDA wrapper launches its kernel or raises before any launch."""
    _need_cuda()
    scene, table, m, paths = _route_case("cuda", 0.0, n=256)
    rays = (paths.origin, paths.direction, paths.tmax, paths.is_valid)
    before = dict(tops.LAUNCHES)
    with pytest.raises(ValueError):
        tops.proxy_march(table, rays[0].double(), *rays[1:], 8, MH, EPS)
    with pytest.raises(ValueError):
        tops.proxy_march(table.to("cpu"), *rays, 8, MH, EPS)
    feats = torch.rand((64, 5), device="cuda")
    obj = torch.zeros((64,), dtype=torch.int32, device="cuda")
    ok = torch.ones((64,), dtype=torch.bool, device="cuda")
    import dataclasses

    wide = tmlp.MLPConfig(width=128, depth=2)
    for fn in (tops.grouped_mlp_pair, tops.grouped_mlp_dense):
        with pytest.raises(ValueError):
            fn(dataclasses.replace(m, vis_cfg=wide), feats, obj, ok)
        with pytest.raises(ValueError):
            fn(m, feats.double(), obj, ok)
        with pytest.raises(ValueError):
            fn(dataclasses.replace(m, num_objects=7), feats, obj, ok)
        with pytest.raises(ValueError):
            fn(m.to("cpu"), feats, obj, ok)
    args = (paths.origin, paths.direction, EPS, paths.tmax, paths.is_valid, 8, MH, EPS)
    with pytest.raises(ValueError):
        tops.route_fused(scene, table, m.to("cpu"), *args)
    # a proxy row without a net pair, a tile beyond shared memory: the wrapper
    # raises, and the stage's gate sends them to the composed path instead
    seven = tmodels.random_proxy_models(3, 7, SMALL, SMALL, device="cuda")
    with pytest.raises(ValueError):
        tops.route_fused(scene, table, seven, *args)
    with pytest.raises(ValueError):
        tops.shadow_route_fused(scene, table, m, *args[:6], 64, EPS)
    assert not tps._use_fused_route(scene, seven, "auto", table, MH)
    assert not tps._use_fused_route(scene, m, "auto", table, 64)
    assert tps._use_fused_route(scene, m, "auto", table, MH)
    assert tops.LAUNCHES == before


# --------------------------------------------------------------------------
# large scenes: K1/K2 on instanced scenes, K9 grouped_closest, K10
# grouped_anyhit, K3's grouped mode. Tolerance: exact. K9/K10 visit every
# cluster K1/K2 would (a group box contains its members) and keep the same
# (t, slot) winner; the instanced transform is the same explicit sum in the
# kernels and the plain versions, built without FMA contraction.

from pg2024_dprt_tpu_torch.ops import resident as tres  # noqa: E402


def _large_case(kind, tpc, device, n=4096, edge=None):
    """A flat soup or three instances of one (rotation * scale +
    translation), cut at `tpc` triangles per cluster, with rays aimed into
    it (a quarter of them capped short). `edge` bends it to one edge of the
    warp-per-ray kernels K9/K10: "ties" duplicates every triangle (every hit
    is a tie at equal t, won by the lower slot), "sparse" activates under
    1 % of the n rows, "past_2p24" places 257 instances of a 65,536-triangle
    soup (virtual ids past 2^24) and aims half the rays at the last one."""
    rng = np.random.RandomState(70 + tpc)
    n_tris = 6 * tpc if tpc >= 512 else 3000
    mesh = random_tri_soup(n_tris, seed=71, jitter=0.2)
    if edge == "ties":
        mesh = tscene.MeshGeometry(v0=np.concatenate([mesh.v0, mesh.v0]),
                                   v1=np.concatenate([mesh.v1, mesh.v1]),
                                   v2=np.concatenate([mesh.v2, mesh.v2]))
    if kind == "flat":
        scene = device_scene_from_meshes([mesh], tris_per_cluster=tpc, device=device)
        centers = np.full((1, 3), 0.5, np.float32)
    else:
        ni = 3
        m = np.zeros((ni, 3, 4), np.float32)
        if edge == "past_2p24":
            mesh = random_tri_soup(1 << 16, seed=72)
            ni = 2**24 // mesh.num_triangles + 1
            m = np.zeros((ni, 3, 4), np.float32)
            m[:, :, :3] = np.eye(3, dtype=np.float32)
            m[:, 0, 3] = 1.5 * (np.arange(ni) % 16)
            m[:, 2, 3] = 1.5 * (np.arange(ni) // 16)
        else:
            for i in range(ni):
                r, _ = np.linalg.qr(rng.randn(3, 3))
                m[i, :, :3] = r @ np.diag(0.6 + rng.rand(3))
                m[i, :, 3] = [1.5 * i, 0.3 * i, -0.5 * i]
        scene = tscene.device_scene_from_instances([mesh], m, tris_per_cluster=tpc,
                                                   device=device)
        centers = np.einsum("iab,b->ia", m[:, :, :3], np.full(3, 0.5, np.float32)) + m[:, :, 3]
    o = (rng.rand(n, 3) * 8.0 - 4.0).astype(np.float32)
    pick = rng.randint(0, centers.shape[0], n)
    if edge == "past_2p24":
        pick[: n // 2] = centers.shape[0] - 1
        o += centers[pick]  # origins around the instance each ray aims at
    target = centers[pick] + rng.rand(n, 3).astype(np.float32) - 0.5
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.rand(n) < 0.25, 3.0, 3.4e38).astype(np.float32)
    u = rng.rand(n)
    live = u < 0.006 if edge == "sparse" else u > 0.05
    on = lambda a: torch.as_tensor(a, device=device)
    rays = (on(o), on(d), torch.full((n,), T_MIN, device=device), on(tmax), on(live))
    return scene, rays


# (kind, tpc, rays, edge): the six K / C corners, then the edges of the
# warp-per-ray design: fewer rays than a block holds teams, a 65,536-row
# buffer with under 1 % of its rows active, ties at equal t, ragged cluster
# counts (C = 48, counts not multiples of 32), virtual ids past 2^24
GROUPED_CASES = [(kind, tpc, 4096, None) for kind in ("flat", "instanced")
                 for tpc in (64, 512, 2048)] + [
    ("flat", 64, 3, "few"), ("instanced", 64, 65536, "sparse"), ("flat", 64, 4096, "ties"),
    ("instanced", 64, 4096, "ties"), ("instanced", 48, 4096, "ragged"),
    ("instanced", 512, 1024, "past_2p24")]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tpc,n,edge", GROUPED_CASES,
                         ids=[f"{k}-{t}" + (f"-{e}" if e else "")
                              for k, t, _, e in GROUPED_CASES])
def test_grouped_kernels_equal_flat_and_plain_on_gpu(kind, tpc, n, edge):
    """K9 equals K1 and K10 equals K2 on every ray, field by field; K1/K2
    (instanced too) equal their plain versions; instanced ids are virtual;
    each wrapper counts its own launch."""
    _need_cuda()
    scene, rays = _large_case(kind, tpc, "cuda", n=n, edge=edge)
    assert scene.instanced == (kind == "instanced") and scene.tris_per_cluster == tpc
    before = dict(tops.LAUNCHES)
    k1 = tops.resident_closest(scene, *rays)
    k9 = tops.grouped_closest(scene, *rays)
    k2 = tops.resident_anyhit(scene, *rays)
    k10 = tops.grouped_anyhit(scene, *rays)
    torch.cuda.synchronize()
    assert tops.LAUNCHES == {**before, **{name: before[name] + 1 for name in (
        "resident_closest", "grouped_closest", "resident_anyhit", "grouped_anyhit")}}
    for f in k1._fields:
        assert torch.equal(getattr(k9, f), getattr(k1, f)), f
    assert torch.equal(k10, k2)
    want = tops.resident_closest_plain(scene, *rays)
    for f in k1._fields:
        assert torch.equal(getattr(k1, f), getattr(want, f)), f
    assert torch.equal(k2, tops.resident_anyhit_plain(scene, *rays))
    live = int(rays[4].sum())
    if edge == "few":
        assert n == 3 and live >= 1
    elif edge == "sparse":
        assert 0 < live < n // 100 and k1.is_hit.sum() > 0
    else:
        assert k1.is_hit.sum() > 300 * n // 4096 and k2.sum() > k1.is_hit.sum() // 2
    if edge == "ragged":
        assert bool((scene.cl_count[scene.cl_count > 0] % 32 != 0).any())
    if edge == "ties":
        # every triangle is there twice: the winner is the lower slot of the
        # two (the plain version's first minimal slot), whichever lane or
        # cluster holds it
        assert k1.is_hit.sum() > 100
    if edge == "past_2p24":
        assert int(k1.tri_index.max()) >= 2**24
    elif kind == "instanced" and edge is None:
        inst = k1.tri_index[k1.is_hit] // scene.num_base_tris
        assert set(inst.tolist()) == {0, 1, 2}


# (width, height, nee_mode, roulette): the 64x64 soup frame, then a frame of
# 45 x 37 = 1,665 pixels, not a multiple of 32, whose last warp holds lanes
# past the last pixel, in both NEE modes with and without roulette
K3_GROUPED_CASES = [(64, 64, "ris", 0), (45, 37, "ris", 0), (45, 37, "ris", 2),
                    (45, 37, "sum", 0), (45, 37, "sum", 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("width,height,nee_mode,rr", K3_GROUPED_CASES)
def test_frame_kernel_grouped_mode_is_bit_identical_on_gpu(width, height, nee_mode, rr):
    """K3 with the warp walks gives the flat mode's image bit for bit: the
    lanes of a warp reach every trace together (ended paths, zero-weight
    light candidates and lanes past the last pixel only skip their turn)."""
    _need_cuda()
    scene, lights, env, cam, _ = _frame_case("soup", "cuda")
    if (width, height) != (cam.width, cam.height):
        cam = Camera.look_at([0.5, 0.5, 3.0], [0.5, 0.5, 0.5], [0, 1, 0], 45.0, width, height,
                             device="cuda")
    cfg = RenderConfig(width=width, height=height, bounces=3, spp=2, nee_mode=nee_mode,
                       russian_roulette=rr)
    flat = tops.render_frame_fused(scene, lights, env, cam, 1, cfg, spp=2, grouped=False)
    grouped = tops.render_frame_fused(scene, lights, env, cam, 1, cfg, spp=2, grouped=True)
    assert torch.equal(flat[0], grouped[0]) and torch.equal(flat[1], grouped[1])
    assert float(flat[0].sum()) > 0.0 and float(flat[1].sum()) > 0.0


@pytest.mark.cuda
def test_grouped_routing_through_launches_on_gpu():
    """trace_resident and the composed frame take K9 from
    CLOSEST_GROUPED_MIN_CLUSTERS clusters on and K10 from
    ANYHIT_GROUPED_MIN_CLUSTERS on, K1/K2 below; the frame kernel never
    launches on an instanced scene."""
    from pg2024_dprt_tpu_torch.render import render_image

    _need_cuda()
    scene, rays = _large_case("instanced", 64, "cuda", n=1024)
    k = scene.num_clusters
    saved = (tres.CLOSEST_GROUPED_MIN_CLUSTERS, tres.ANYHIT_GROUPED_MIN_CLUSTERS)
    try:
        for limits, closest, anyhit in (((k, k), "grouped_closest", "grouped_anyhit"),
                                        ((k, k + 1), "grouped_closest", "resident_anyhit"),
                                        ((k + 1, k + 1), "resident_closest", "resident_anyhit")):
            tres.CLOSEST_GROUPED_MIN_CLUSTERS, tres.ANYHIT_GROUPED_MIN_CLUSTERS = limits
            tops.reset_launch_counts()
            tops.trace_resident(scene, *rays)
            tops.trace_resident(scene, *rays, any_hit=True)
            torch.cuda.synchronize()
            assert {n: v for n, v in tops.LAUNCHES.items() if v} == {closest: 1, anyhit: 1}
            lt = np.asarray([[[0.0, 3.0, 0.0], [2.0, 3.0, 0.0], [2.0, 3.0, 2.0]]], np.float32)
            lights = tscene.LightTable.from_arrays(lt, np.full((1, 3), 40.0, np.float32),
                                                   device="cuda")
            env = tscene.EnvironmentMap.constant((0.4, 0.5, 0.7), device="cuda")
            cam = Camera.look_at([1.5, 1.0, 6.0], [1.5, 0.3, 0.0], [0, 1, 0], 50.0, 32, 32,
                                 device="cuda")
            tops.reset_launch_counts()
            img = render_image(scene, lights, env, cam, RenderConfig(width=32, height=32,
                                                                     bounces=3))
            torch.cuda.synchronize()
            assert {n: v for n, v in tops.LAUNCHES.items() if v} == {closest: 3, anyhit: 3}
            assert bool(torch.isfinite(img).all()) and float(img.max()) > 0.0
    finally:
        tres.CLOSEST_GROUPED_MIN_CLUSTERS, tres.ANYHIT_GROUPED_MIN_CLUSTERS = saved


@pytest.mark.cuda
def test_route_kernel_refuses_instanced_local_geometry_on_gpu():
    """K7 reads the table per instance-level cluster without a transform:
    its wrapper raises on an instanced scene before any launch, and the
    stages' gate composes such a scene."""
    _need_cuda()
    scene, _ = _large_case("instanced", 64, "cuda", n=256)
    _, table, m, paths = _route_case("cuda", 10.0)
    args = (paths.origin, paths.direction, EPS, paths.tmax, paths.is_valid, 8, MH, EPS)
    before = dict(tops.LAUNCHES)
    for fn in (tops.route_fused, tops.shadow_route_fused):
        with pytest.raises(ValueError, match="instanced"):
            fn(scene, table, m, *args)
    assert tops.LAUNCHES == before
    assert not tps._use_fused_route(scene, m, "auto", table, MH)


# ---------------------------------------------------------------------------
# the streaming pair tracer (K11 pair_closest, K12 pair_anyhit, K13
# pair_woop): each kernel equals its plain version ray for ray

def _pair_case(device, tpc, n, region, tile_rays, camera, twice=False, dead_tile=None):
    """A soup and its packed pair list, as trace_pairs prepares them.
    twice: two coincident copies of every triangle (equal t in two lanes or
    two clusters, so the slot and lane order must decide); dead_tile: a tile
    whose rays are all inactive."""
    from pg2024_dprt_tpu_torch.ops import tracer as ttr

    mesh = random_tri_soup(5000, seed=60)
    if twice:
        mesh = tscene.MeshGeometry(*(np.concatenate([a, a]) for a in (mesh.v0, mesh.v1,
                                                                       mesh.v2)))
    scene = device_scene_from_meshes([mesh], tris_per_cluster=tpc, device=device)
    if camera:
        side = int(np.sqrt(n))
        cam = Camera.look_at([0.5, 0.5, 3.0], [0.5, 0.5, 0.5], [0, 1, 0], 45.0, side, side,
                             device=device)
        pix = torch.arange(side * side, device=device)
        zeros = torch.zeros(side * side, device=device)
        o, d = cam.generate_rays(pix // side, pix % side, zeros, zeros)
        rays = (o, d, torch.full((o.shape[0],), T_MIN, device=device),
                torch.full((o.shape[0],), 3.4e38, device=device),
                torch.ones(o.shape[0], dtype=torch.bool, device=device))
    else:
        _, rays = _case(device, n=n)
    if dead_tile is not None:
        active = rays[4].clone()
        active[dead_tile * tile_rays:(dead_tile + 1) * tile_rays] = False
        rays = (*rays[:4], active)
    prep = ttr.prepare_pairs(scene, *rays, tile_rays=tile_rays, region=region)
    packed, pairs = prep.packed, prep.pairs
    return scene, rays, packed, pairs


# (triangles a cluster, region, tile_rays, camera wavefront, coincident
# copies, all-inactive tile); scripts/torch_grouped_probe.py --parts pairs
# compares two trees' kernels on these cases too
PAIR_CASES = [
    (128, 96, 512, True, False, None), (128, 96, 256, False, False, None),
    (64, 8, 512, False, False, None), (2048, 16, 128, True, False, None),
    (128, 96, 1024, True, False, 1), (100, 96, 32, False, False, None),
    (37, 192, 64, False, False, None), (16, 96, 128, True, True, None),
    (128, 96, 32, True, True, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("tpc,region,tile_rays,camera,twice,dead_tile", PAIR_CASES)
def test_pair_kernels_match_plain_on_gpu(tpc, region, tile_rays, camera, twice, dead_tile):
    """K11, K12 and K13 against their plain versions on the same pair list:
    every output equal (t bit for bit). region 8 leaves tiles unfit (forced
    misses); 2,048 triangles a cluster: 16 staged chunks a slot in K11 /
    K13's walk and 64 in K12's (one share); 100 a cluster:
    shares and chunks that are not whole; 37: 4-byte copies and the
    scalar tail; coincident copies of every triangle: ties at equal t that
    the slot, then the lane order decides; tile_rays 32 and 1,024, and a
    tile whose rays are all inactive (its outputs: tmax 0, no hit)."""
    _need_cuda()
    from pg2024_dprt_tpu_torch.ops import tracer as ttr

    scene, _, packed, pairs = _pair_case("cuda", tpc, 4096, region, tile_rays, camera, twice,
                                         dead_tile)
    for name, kern, mode in (("pair_closest", ttr.pair_closest, "closest"),
                             ("pair_woop", ttr.pair_woop, "woop"),
                             ("pair_anyhit", ttr.pair_anyhit, "anyhit")):
        tops.reset_launch_counts()
        got = kern(scene, packed, pairs, tile_rays)
        torch.cuda.synchronize()
        assert {n: v for n, v in tops.LAUNCHES.items() if v} == {name: 1}
        want = ttr.pair_trace_plain(scene, packed, pairs, tile_rays, mode=mode)
        if mode == "anyhit":
            assert torch.equal(got, want)
            assert int(got.sum()) > 50
            continue
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
        assert int((got[1] >= 0).sum()) > 50
        if dead_tile is not None:
            dead = slice(dead_tile * tile_rays, (dead_tile + 1) * tile_rays)
            assert bool((got[0][dead] == 0).all()) and bool((got[1][dead] == -1).all())
    if region == 8:
        assert int(pairs.dropped) > 0 and not bool(pairs.tile_fit.all())


def _wall_case(device, tile_rays=512):
    """The soup behind a quad that covers the upper part of a 64x64 camera
    view: the quad's cluster is every upper tile's first slot, and tiles 1
    and 2 (rows 8-23) have every ray occluded there, with later slots
    listed."""
    from pg2024_dprt_tpu_torch.ops import tracer as ttr

    q = np.array([[-1.0, 0.55, 1.6], [2.0, 0.55, 1.6], [2.0, 2.0, 1.6], [-1.0, 2.0, 1.6]],
                 np.float32)
    wall = tscene.MeshGeometry(v0=q[[0, 0]], v1=q[[1, 2]], v2=q[[2, 3]])
    scene = device_scene_from_meshes([random_tri_soup(5000, seed=60), wall],
                                     tris_per_cluster=128, device=device)
    side = 64
    cam = Camera.look_at([0.5, 0.5, 3.0], [0.5, 0.5, 0.5], [0, 1, 0], 45.0, side, side,
                         device=device)
    pix = torch.arange(side * side, device=device)
    zeros = torch.zeros(side * side, device=device)
    o, d = cam.generate_rays(pix // side, pix % side, zeros, zeros)
    n = o.shape[0]
    rays = (o, d, torch.full((n,), T_MIN, device=device), torch.full((n,), 3.4e38, device=device),
            torch.ones(n, dtype=torch.bool, device=device))
    return scene, rays


def _first_slot_only(pairs):
    """The pair list with each tile's first listed slot and no other."""
    flags = pairs.pair_flags.clone()
    listed = (flags & 2) != 0
    pos = torch.arange(flags.shape[0], device=flags.device)
    first = torch.full_like(pairs.tile_offset, flags.shape[0])
    idx = torch.where(listed, pos, flags.shape[0]).to(torch.int32)
    first = first.scatter_reduce(0, pairs.pair_tile.long(), idx, reduce="amin")
    later = listed & (pos != first[pairs.pair_tile.long()])
    flags[later] -= 2
    return pairs._replace(pair_flags=flags)


def _listed_slots(pairs, tile):
    return int(((pairs.pair_flags & 2) != 0)[pairs.pair_tile == tile].sum())


# K12's edges: (name, triangles a cluster, camera wavefront)
ANYHIT_EDGES = [("tmax_at_t", 128, True), ("tmax_at_t", 128, False),
                ("tmax_above_t", 128, True), ("tmax_above_t", 128, False),
                ("first_slot", 128, True), ("no_hit", 128, True),
                ("tmax_above_t", 2048, True)]


def anyhit_edge_case(device, edge, tpc, camera):
    """(scene, packed, pairs, tile_rays, expected flags or None) of one of
    K12's edges, checked on the plain versions. tmax_at_t: each ray's
    packed tmax set to its plain closest t, so t < tmax fails at equality
    and no ray is occluded; tmax_above_t: the next float above that t for
    the hit rays, so that every hit ray is occluded (at 2,048 triangles a
    cluster, where K12's first design staged an 80 KB row); first_slot:
    tiles whose every ray is occluded by their first listed slot, with
    later slots listed; no_hit: a tile whose rays start past the scene
    (tmin 10) walks its listed slots and hits nothing."""
    from pg2024_dprt_tpu_torch.ops import tracer as ttr

    tm = 512
    if edge in ("first_slot", "no_hit"):
        scene, rays = _wall_case(device)
        if edge == "no_hit":
            tmin = rays[2].clone()
            tmin[5 * tm:6 * tm] = 10.0
            rays = (rays[0], rays[1], tmin, *rays[3:])
        prep = ttr.prepare_pairs(scene, *rays, tile_rays=tm, region=96)
        packed, pairs = prep.packed, prep.pairs
        want = ttr.pair_trace_plain(scene, packed, pairs, tm, mode="anyhit")
        if edge == "first_slot":
            first = ttr.pair_trace_plain(scene, packed, _first_slot_only(pairs), tm,
                                         mode="anyhit")
            for tile in (1, 2):
                assert bool(first[tile * tm:(tile + 1) * tm].all())
                assert _listed_slots(pairs, tile) >= 10
        else:
            assert not bool(want[5 * tm:6 * tm].any()) and _listed_slots(pairs, 5) >= 10
        return scene, packed, pairs, tm, None
    scene, _, packed, pairs = _pair_case(device, tpc, 4096, 96, tm, camera)
    t, tri = ttr.pair_trace_plain(scene, packed, pairs, tm)[:2]
    hit = tri >= 0
    assert int(hit.sum()) > 200
    packed = packed.clone()
    if edge == "tmax_at_t":
        packed[:, 7] = t
        want = torch.zeros_like(hit)
    else:
        packed[:, 7] = torch.where(hit, torch.nextafter(t, torch.full_like(t, float("inf"))),
                                   packed[:, 7])
        want = hit
    assert torch.equal(ttr.pair_trace_plain(scene, packed, pairs, tm, mode="anyhit"), want)
    return scene, packed, pairs, tm, want


@pytest.mark.cuda
@pytest.mark.parametrize("edge,tpc,camera", ANYHIT_EDGES)
def test_pair_anyhit_edges_match_plain_on_gpu(edge, tpc, camera):
    """K12 against its plain version where its walk decides most: a hit
    exactly at tmax (no ray occluded) and just below it (every hit ray
    occluded; these two also hold the enter skip to its assumption at the
    tightest bound), tiles occluded whole by their first slot (the later
    pieces and shares find the rays published), a tile that walks its
    listed slots with no hit, and 2,048 triangles a cluster (64 chunks a
    slot)."""
    _need_cuda()
    from pg2024_dprt_tpu_torch.ops import tracer as ttr

    scene, packed, pairs, tm, want = anyhit_edge_case("cuda", edge, tpc, camera)
    tops.reset_launch_counts()
    got = ttr.pair_anyhit(scene, packed, pairs, tm)
    torch.cuda.synchronize()
    assert {n: v for n, v in tops.LAUNCHES.items() if v} == {"pair_anyhit": 1}
    assert torch.equal(got, ttr.pair_trace_plain(scene, packed, pairs, tm, mode="anyhit"))
    if want is not None:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_pair_tracer_matches_resident_and_escalates_on_gpu():
    """trace_pairs on CUDA tensors launches K11 / K12 once each; its hits
    agree with K1's and K2's except on a few rays (the pair tracer's cull
    misses and edge hits, where its Moller-Trumbore rounds otherwise than
    K1's triple product); the escalating entry leaves no residue and
    launches at most 3 times."""
    _need_cuda()
    from pg2024_dprt_tpu_torch.ops.trace_api import _pairs_escalating

    scene, rays, _, _ = _pair_case("cuda", 128, 4096, 96, 512, False)
    tops.reset_launch_counts()
    hits, dropped = tops.trace_pairs(scene, *rays, region=96)
    occ, _ = tops.trace_pairs(scene, *rays, region=96, any_hit=True)
    torch.cuda.synchronize()
    assert {n: v for n, v in tops.LAUNCHES.items() if v} == {"pair_closest": 1,
                                                             "pair_anyhit": 1}
    ref = tops.resident_closest(scene, *rays)
    n_hit = int(ref.is_hit.sum())
    assert n_hit > 100
    assert int((hits.is_hit != ref.is_hit).sum()) <= 1e-3 * n_hit + 2
    assert int((occ != tops.resident_anyhit(scene, *rays)).sum()) <= 1e-3 * n_hit + 2
    both = hits.is_hit & ref.is_hit
    far = ~torch.isclose(hits.t[both], ref.t[both], rtol=1e-4)
    assert int(far.sum()) <= 1e-3 * n_hit + 2
    tops.reset_launch_counts()
    esc, res = _pairs_escalating(scene, *rays, region=8)
    torch.cuda.synchronize()
    assert res == 0 and 2 <= tops.LAUNCHES["pair_closest"] <= 3
    assert int((esc.is_hit != ref.is_hit).sum()) <= 1e-3 * n_hit + 2


@pytest.mark.cuda
def test_pair_wrappers_refuse_what_the_kernels_do_not_take():
    _need_cuda()
    from pg2024_dprt_tpu_torch.ops import tracer as ttr

    scene, _, packed, pairs = _pair_case("cuda", 128, 1024, 32, 512, False)
    before = dict(tops.LAUNCHES)
    with pytest.raises(ValueError, match="tile_rays"):
        ttr.pair_closest(scene, packed, pairs, 500)
    with pytest.raises(ValueError):
        ttr.pair_woop(scene, packed.double(), pairs, 512)
    with pytest.raises(ValueError):
        ttr.pair_anyhit(scene, packed, pairs._replace(pair_flags=pairs.pair_flags.long()), 512)
    with pytest.raises(ValueError):
        ttr.pair_closest(scene._replace(cl_tri_table=None), packed, pairs, 512)
    assert tops.LAUNCHES == before


# K8 as a warp per live ray: synthetic box tables of exactly K clusters (the
# key reads only the boxes and the scene box), each case against the plain
# version on every ray
KEY_CASES = [  # (name, K, rays, live share)
    ("k1", 1, 4096, 0.9), ("k33", 33, 4096, 0.9), ("k735", 735, 8192, 0.9),
    ("k3028", 3028, 8192, 0.9), ("ties", 200, 4096, 0.9), ("sparse", 735, 65536, 0.02),
    ("no_live_ray", 735, 4096, 0.0), ("n1001", 735, 1001, 0.7), ("instanced", None, 8192, 0.9)]


def _key_case(name, k, n, share, device):
    rng = np.random.RandomState(70)
    on = lambda a: torch.as_tensor(a, device=device)
    if name == "instanced":
        xf = np.tile(np.eye(4, dtype=np.float32)[None, :3], (3, 1, 1))
        xf[1, 0, 3], xf[2, 1, 3] = 1.2, -1.2
        scene = tscene.device_scene_from_instances([random_tri_soup(3000, seed=71)], xf,
                                                   tris_per_cluster=32, device=device)
        lo, span = np.array([-0.5, -1.5, -0.5], np.float32), np.array([3.0, 4.0, 2.0], np.float32)
    else:
        base = device_scene_from_meshes([random_tri_soup(30, seed=60)], device=device)
        boxes = np.zeros((8, k), np.float32)
        if name == "ties":
            # equal boxes shifted along x by about 500 ulps of their enter
            # distance: eight to a 2^12-ulp rank bucket, met out of index order
            shift = rng.permutation(k).astype(np.float32) * 3e-5
            boxes[0], boxes[3] = 0.3 + shift, 0.6 + shift
            boxes[1], boxes[4] = 0.3, 0.7
            boxes[2], boxes[5] = 0.3, 0.7
        else:
            size = 0.02 if k > 100 else 0.2
            lo = rng.rand(3, k).astype(np.float32)
            boxes[:3], boxes[3:6] = lo, lo + size + rng.rand(3, k).astype(np.float32) * 2 * size
        boxes[6] = rng.rand(k) > 0.05                 # some empty clusters
        boxes[6, 0] = 1.0
        # group tables as scene/geometry.py cuts them: 8 consecutive
        # clusters a group (the random boxes of a group overlap)
        kg = -(-k // 8)
        mboxes = np.zeros((kg * 8, 8), np.float32)
        mboxes[:k, :7] = boxes[:7].T
        mboxes = mboxes.reshape(kg, 8, 8)
        full = mboxes[:, :, 6:7] > 0
        gboxes = np.zeros((8, kg), np.float32)
        gboxes[:3] = np.where(full, mboxes[:, :, :3], np.inf).min(1).T
        gboxes[3:6] = np.where(full, mboxes[:, :, 3:6], -np.inf).max(1).T
        gboxes[6] = full[:, :, 0].any(1)
        gboxes[:6, gboxes[6] == 0] = 0.0
        scene = base._replace(
            cl_boxes=on(boxes), cl_mt_table=torch.zeros((k, 16, 1), device=device),
            cl_tri_map=torch.zeros((k,), dtype=torch.int32, device=device),
            cl_count=torch.ones((k,), dtype=torch.int32, device=device),
            scene_aabb=on(np.stack([boxes[:3].min(1), boxes[3:6].max(1)])),
            cl_gboxes=on(gboxes), cl_mboxes=on(mboxes))
        lo, span = np.full(3, -0.2, np.float32), np.full(3, 1.4, np.float32)
    o = lo + rng.rand(n, 3).astype(np.float32) * span
    d = rng.randn(n, 3).astype(np.float32)
    if name == "ties":
        o[:, 0], d[:, 0] = -0.5, 4.0 + np.abs(d[:, 0])
        o[:, 1:] = 0.35 + rng.rand(n, 2).astype(np.float32) * 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(rng.rand(n) > 0.3, 3.4e38, rng.rand(n) * 2.0).astype(np.float32)
    act = rng.rand(n) < share
    return scene, (on(o), on(d), torch.full((n,), T_MIN, device=device), on(tmax), on(act))


@pytest.mark.cuda
@pytest.mark.parametrize("name,k,n,share", KEY_CASES, ids=[c[0] for c in KEY_CASES])
def test_schedule_keys_warp_per_ray_matches_plain_on_gpu(name, k, n, share):
    """K8 (a warp per ray) equals its plain version on every ray, in its
    grouped mode (the rule's at K >= 47: group boxes first, then the members
    of the entered groups; the groups of the random boxes overlap) and in
    its flat mode (a scene without group tables): K = 1, K not a multiple of
    32, K = 3,028, ranks tied within 2^12 ulps (the cluster index decides),
    2 % live rows of 65,536, no live ray, N not a multiple of the block, an
    instanced scene (groups cut per instance); it counts its own launch and
    the schedule order sorts by its keys."""
    _need_cuda()
    scene, rays = _key_case(name, k, n, share, "cuda")
    assert k is None or scene.num_clusters == k
    assert tops.use_grouped(scene) == (scene.num_clusters >= tops.resident.GROUPED_MIN_CLUSTERS)
    before = dict(tops.LAUNCHES)
    key = tops.schedule_keys(scene, *rays)
    torch.cuda.synchronize()
    assert tops.LAUNCHES == {**before, "schedule_keys": before["schedule_keys"] + 1}
    want = tops.schedule_keys_plain(scene, *rays)
    assert key.dtype == torch.int32 and torch.equal(key, want)
    flat = scene._replace(cl_gboxes=None, cl_mboxes=None)
    assert torch.equal(tops.schedule_keys(flat, *rays), want)
    act = rays[4]
    assert (key[~act] == 0x7FFFFFFF).all()
    if share > 0:
        entered = (key[act] >> 12) != 0xFFF
        assert entered.sum() > 50
        if scene.num_clusters > 1:
            assert ((key[act] & 0xFFF) != 0xFFF).sum() > 0
    if name == "ties":
        # the first two clusters of most rays share a rank bucket
        first, second = key[act] >> 12, key[act] & 0xFFF
        assert (first < second).float().mean() > 0.3
    perm = tops.schedule_order(scene, *rays)
    assert (key[perm][1:] >= key[perm][:-1]).all()


# K4 with its table in shared memory and the block's records staged and
# written per output array: random overlapping boxes (repeated inside hits,
# so the dedup acts), a row of the caller's node, an empty partition's
# inverted box; max_hits past the 768 staged slots of a block (a ray stages
# min(max_hits, P) records and every further row is written empty)
MARCH_EDGES = [  # (P, my_node, N, max_hits)
    (1, 5, 20000, 3), (8, 2, 1001, 3), (32, 7, 65536, 3), (32, 31, 4099, 8),
    (8, 3, 2000, 300), (8, 8, 0, 3), (8, 8, 300, 0),
    (8, 3, 2000, 769), (32, 7, 1001, 1000), (16, 2, 500, 4096)]


def _edge_table(p, device):
    rng = np.random.RandomState(12)
    lo = rng.rand(p, 3).astype(np.float32) * 2.0 - 0.5
    hi = lo + 0.3 + rng.rand(p, 3).astype(np.float32) * 1.2
    ml = np.linalg.norm(hi - lo, axis=1).astype(np.float32)
    if p > 1:
        lo[p // 2], hi[p // 2], ml[p // 2] = np.inf, -np.inf, 0.0
    return tscene.proxy_table_from_arrays(
        dict(aabb_min=lo, aabb_max=hi, max_length=ml, node_id=np.arange(p) % 8,
             obj_id=(np.arange(p) * 3) % max(p // 2, 1)), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("p,my_node,n,max_hits", MARCH_EDGES)
def test_march_kernel_edges_match_plain_on_gpu(p, my_node, n, max_hits):
    """K4 against its plain version on every row and field (the zero
    pixel_index / shadow_path_id included): P = 1, 8, 16, 32, the caller's
    node's rows skipped, an empty partition, N = 0, N not a multiple of the
    block, max_hits 0, 8, 300 (fewer rays a block) and 769, 1000, 4096 (more
    rows a ray than a block stages)."""
    _need_cuda()
    table = _edge_table(p, "cuda")
    rng = np.random.RandomState(13)
    o = rng.rand(n, 3).astype(np.float32) * 3.0 - 1.0
    inside = table.aabb_min.cpu().numpy()[0] + 0.5 * rng.rand(n, 3).astype(np.float32)
    o[::3] = inside[::3]
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
    t_cap = np.where(rng.rand(n) > 0.5, 3.4e38, 0.2 + rng.rand(n) * 3.0).astype(np.float32)
    on = lambda a: torch.as_tensor(a, device="cuda")
    rays = (on(o), on(d), on(t_cap), on(rng.rand(n) > 0.2))
    before = dict(tops.LAUNCHES)
    got = tops.proxy_march(table, *rays, my_node, max_hits, EPS)
    torch.cuda.synchronize()
    launched = int(n > 0 and max_hits > 0)
    assert tops.LAUNCHES == {**before, "proxy_march": before["proxy_march"] + launched}
    want = tops.march_proxies_plain(table, *rays, my_node, max_hits, EPS)
    assert all(tuple(getattr(got, f).shape) == tuple(getattr(want, f).shape)
               for f in want._fields)
    _queries_agree(got, want)
    assert (got.pixel_index == 0).all() and (got.shadow_path_id == 0).all()
    if n >= 1000 and max_hits:
        assert got.is_valid.sum() > n // 8 and got.is_inside.sum() > 0
        hit_rows = got.aabb_id[got.is_valid]
        assert not (got.node_id[got.is_valid] == my_node).any() and hit_rows.numel()


# --------------------------------------------------------------------------
# K1 / K2 as flat team walks (a team of 8 or 32 lanes a ray). Tolerance:
# exact. The teams visit the thread walks' clusters in their order and keep
# the same (t, slot) winner, so both widths equal the plain versions and
# K9 / K10 bit for bit.

# (name, triangles of random_tri_soup(n, seed=0), triangles a cluster): the
# K sweep of scripts/torch_grouped_probe.py --parts flat (K = 1 .. 46 at C =
# 128, K = 32 at C = 2048) and a soup of large triangles (K = 733 clusters
# of 16), whose rays often enter more clusters than a team's candidate
# buffer holds
TEAM_CASES = [(f"k{k}_c{c}", n, c) for k, n, c in (
    (1, 70, 128), (2, 140, 128), (4, 280, 128), (6, 480, 128), (12, 1008, 128),
    (24, 2080, 128), (36, 3440, 128), (45, 4036, 128), (46, 4140, 128), (32, 40000, 2048))]
TEAM_CASES += [("overflow", 8000, 16), ("instanced", 0, 64), ("instanced_ragged", 0, 48)]


def _team_rays(scene, n, device, seed=81):
    """n random rays over the scene box (a quarter capped short, a tenth
    inactive)."""
    rng = np.random.RandomState(seed)
    lo, hi = (x.cpu().numpy() for x in scene.scene_aabb)
    o = (lo - 0.2 + rng.rand(n, 3) * (hi - lo + 0.4)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(rng.rand(n) < 0.25, 0.3, 3.4e38).astype(np.float32)
    on = lambda a: torch.as_tensor(a, device=device)
    return (on(o), on(d), torch.full((n,), T_MIN, device=device), on(tmax),
            on(rng.rand(n) > 0.1))


def _walk(team):
    """flat_lanes forcing K1 and K2 into their team walks (`team`) or a
    lane a ray."""
    return lambda k, n, any_hit=False: ((tres.ANYHIT_TEAM if any_hit else tres.CLOSEST_TEAM)
                                        if team else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("team", [False, True], ids=["lane", "team"])
@pytest.mark.parametrize("name,n_tris,tpc", TEAM_CASES, ids=[c[0] for c in TEAM_CASES])
def test_flat_team_walks_match_plain_on_gpu(name, n_tris, tpc, team, monkeypatch):
    """K1 and K2 in both walks (a lane a ray, a team a ray) equal their
    plain versions field by field over the K sweep, past the candidate
    buffer and on instanced scenes (virtual ids, ragged counts), and each
    counts its own launch."""
    _need_cuda()
    monkeypatch.setattr(tres, "flat_lanes", _walk(team))
    if name.startswith("instanced"):
        scene, rays = _large_case("instanced", tpc, "cuda",
                                  edge="ragged" if name.endswith("ragged") else None)
    else:
        jitter = 0.4 if name == "overflow" else 0.08
        scene = device_scene_from_meshes([random_tri_soup(n_tris, seed=0, jitter=jitter)],
                                         tris_per_cluster=tpc, device="cuda")
        rays = _team_rays(scene, 8192, "cuda")
    if name == "overflow":
        inv, _, tcap = tres.ray_limits(scene, *rays)
        entered = torch.isfinite(tres.cluster_enters_plain(scene, rays[0], inv, tcap)).sum(1)
        assert int((entered > 64).sum()) > 100
    before = dict(tops.LAUNCHES)
    k1 = tops.resident_closest(scene, *rays)
    k2 = tops.resident_anyhit(scene, *rays)
    torch.cuda.synchronize()
    assert tops.LAUNCHES == {**before, "resident_closest": before["resident_closest"] + 1,
                             "resident_anyhit": before["resident_anyhit"] + 1}
    want = tops.resident_closest_plain(scene, *rays)
    for f in k1._fields:
        assert torch.equal(getattr(k1, f), getattr(want, f)), f
    assert torch.equal(k2, tops.resident_anyhit_plain(scene, *rays))
    assert k1.is_hit.sum() > 0 and k2.sum() >= k1.is_hit.sum() // 4


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2, 3])
def test_flat_team_walks_equal_grouped_on_statues_on_gpu(seed, monkeypatch):
    """On statues of the A-B row with K >= 47 (statue_mesh(32, seed) for
    seeds 2 and 3: K = 49, 47), K1 equals K9 and K2 equals K10 on every ray
    in both walks (a lane a ray, a team a ray), on 16,384 rays entering
    the box (datagen's recipe)."""
    _need_cuda()
    scene = device_scene_from_meshes([tscene.statue_mesh(32, seed=seed)], device="cuda")
    assert scene.num_clusters >= 47
    lo, hi = (x.cpu().numpy() for x in scene.scene_aabb)
    rng = np.random.RandomState(90 + seed)
    n = 16384
    p = lo + rng.rand(n, 3) * (hi - lo)
    face = rng.randint(0, 6, n)
    p[np.arange(n), face // 2] = np.where(face % 2 == 1, hi[face // 2], lo[face // 2])
    d = lo + rng.rand(n, 3) * (hi - lo) - p
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    on = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")
    rays = (on(p), on(d), torch.full((n,), 1e-4, device="cuda"), on(np.full(n, 3.4e38)),
            torch.ones(n, dtype=torch.bool, device="cuda"))
    k9 = tops.grouped_closest(scene, *rays)
    k10 = tops.grouped_anyhit(scene, *rays)
    assert k9.is_hit.sum() > n // 2
    for team in (False, True):
        monkeypatch.setattr(tres, "flat_lanes", _walk(team))
        k1 = tops.resident_closest(scene, *rays)
        for f in k1._fields:
            assert torch.equal(getattr(k1, f), getattr(k9, f)), f
        assert torch.equal(tops.resident_anyhit(scene, *rays), k10)


@pytest.mark.cuda
def test_flat_walk_of_another_width_raises_on_gpu(monkeypatch):
    """K1 and K2 are built in two walks each (a lane a ray, their team); a
    launch asking for another width raises: no fallback."""
    _need_cuda()
    scene = device_scene_from_meshes([random_tri_soup(140, seed=0)], tris_per_cluster=128,
                                     device="cuda")
    rays = _team_rays(scene, 64, "cuda")
    monkeypatch.setattr(tres, "flat_lanes", lambda k, n, any_hit=False: 8 if any_hit else 32)
    with pytest.raises(RuntimeError, match="resident_closest"):
        tops.resident_closest(scene, *rays)
    with pytest.raises(RuntimeError, match="resident_anyhit"):
        tops.resident_anyhit(scene, *rays)


# --------------------------------------------------------------------------
# curves: the dense curve test (ops/curve_intersect.py) is plain PyTorch on
# every device, and the fused route kernel's gate sends curve scenes to the
# composed path. Tolerance: exact (the test's operations are elementwise,
# its square root correctly rounded on both devices, its reductions min and
# argmin).


def _curve_case(device, n=20000, seed=71):
    rng = np.random.RandomState(seed)
    pts = np.cumsum(rng.randn(40, 3) * 0.3, axis=0)
    curves = tscene.CurveSet.from_strand(pts, 0.05, device=device)
    o = (pts.mean(0) + rng.randn(n, 3) * 3.0).astype(np.float32)
    d = pts[rng.randint(0, 40, n)] + rng.randn(n, 3) * 0.1 - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = np.where(rng.rand(n) < 0.2, rng.rand(n) * 3.0, 1e30).astype(np.float32)
    on = lambda a: torch.as_tensor(a, device=device)
    return curves, (on(o), on(d), T_MIN, on(tmax), on(rng.rand(n) < 0.9))


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, 4096])
def test_curve_test_on_gpu_equals_cpu(budget):
    """intersect_curves (with and without normals) and occlude_curves on
    CUDA tensors equal the same calls on CPU tensors on every field, at each
    device's own chunking and at chunks of 4,096 pairs."""
    _need_cuda()
    cc, rc = _curve_case("cpu")
    cg, rg = _curve_case("cuda")
    for with_normal in (True, False):
        want = tops.intersect_curves(cc, *rc, with_normal=with_normal, pair_budget=budget)
        got = tops.intersect_curves(cg, *rg, with_normal=with_normal, pair_budget=budget)
        for f in want._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
        assert int(want.is_hit.sum()) > 1000
    assert torch.equal(tops.occlude_curves(cg, *rg, pair_budget=budget).cpu(),
                       tops.occlude_curves(cc, *rc, pair_budget=budget))


@pytest.mark.cuda
def test_fused_route_gate_rejects_curve_scenes_on_gpu():
    """_use_fused_route takes the CUDA scene without curves and refuses the
    same scene with a strand: K7's in-kernel trace has no curve stage."""
    _need_cuda()
    scene, table, m, _ = _route_case("cuda", 0.0, n=256)
    strand = [[0.2, 0.1, 0.5], [0.4, 0.3, 0.5], [0.6, 0.4, 0.5], [0.8, 0.6, 0.5]]
    hair = scene._replace(curves=tscene.CurveSet.from_strand(strand, 0.02, device="cuda"))
    assert tps._use_fused_route(scene, m, "auto", table, MH)
    assert not tps._use_fused_route(hair, m, "auto", table, MH)


@pytest.mark.cuda
@pytest.mark.parametrize("neural", [True, False], ids=["neural", "exact"])
def test_distributed_frame_syncs_only_where_counted_on_gpu(neural):
    """A small rooms frame of 4 partitions under
    torch.cuda.set_sync_debug_mode("error"), which utils/timing.py lowers
    inside `host_sync` alone: a host sync anywhere else raises. The frame's
    host_syncs is the count of those places, and every span named by a
    LAUNCHES key runs once a launch of that key."""
    _need_cuda()
    from collections import Counter

    from pg2024_dprt_tpu_torch.parallel import make_mesh, render_image_distributed
    from pg2024_dprt_tpu_torch.utils.timing import Timing, host_syncs

    parts, side = 4, 48
    meshes, lights = tscene.two_room_scene(num_rooms=parts, tris_per_room=4000, seed=2,
                                           device="cuda")
    part = tscene.build_partitioned_scene(meshes, parts, device="cuda")
    models = tmodels.random_proxy_models(5, parts, SMALL, SMALL, device="cuda")
    env = tscene.EnvironmentMap.constant((0.25, 0.25, 0.3), device="cuda")
    cam = Camera.look_at([2.5 * parts / 2, 1.4, 5.5], [2.5 * parts / 2, 0.6, 0.5], [0, 1, 0],
                         60.0, side, side, device="cuda")
    cfg = RenderConfig(width=side, height=side, spp=1, bounces=3, use_neural_proxies=neural)
    mesh = make_mesh(parts, "cuda")
    frame = lambda b: render_image_distributed(part, models if neural else None, lights, env,
                                               cam, cfg, mesh=mesh, base_sample=b,
                                               return_stats=True)
    frame(1)        # builds and loads the kernels
    torch.cuda.synchronize()
    tops.reset_launch_counts()
    timing = Timing()
    before = host_syncs()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with timing.recording():
            img, stats = frame(2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(img).all())
    rounds = sum(map(sum, stats["migration_rounds"]))
    assert stats["host_syncs"] == host_syncs() - before > rounds
    spans = Counter(sp[0] for sp in timing.spans)
    launched = {k: v for k, v in tops.LAUNCHES.items() if k != "route_multigeo"}
    assert sum(launched.values()) > 0
    assert {k: spans[k] for k in launched} == launched
    if neural:
        assert launched["route_secondary"] > 0 and stats["route_queries"] > 0

