"""Port stackless and cluster back ends (ops/traversal.py,
ops/cluster_tracer.py) vs the JAX package's, on identical tables carried
across with scene/convert.py and rays made from a seed with numpy; and
render_image with tracer="stackless" / "cluster" against the golden EXR
and the JAX composed stackless frame.

Tolerances: hit and occlusion flags exact; t, u and v rtol 1e-4 / atol
1e-5, u/v where both picked the same triangle (the bar of the JAX package's
own tests of these functions, tests/test_bvh_traversal.py and
test_cluster_tracer.py: both back ends run the same float32 formulas, which
XLA's CPU code may contract or reorder, and t and the barycentrics are
differences of products, where an ulp of each can be 1e-5 of the result on a
grazing hit; on at most 1 % of the rays, the most grazing, u/v only within
1e-3); ids exact
except at near-ties (the two winners' t within 2^-20 relative).
Images rtol 1e-3 / atol 1e-4 (the golden bar of tests/test_render_single.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg2024_dprt_tpu.core import Camera as JCamera
from pg2024_dprt_tpu.ops.cluster_tracer import occlusion_clusters as j_occl_clusters
from pg2024_dprt_tpu.ops.cluster_tracer import traverse_clusters as j_clusters
from pg2024_dprt_tpu.ops.traversal import intersect_brute_force as j_brute
from pg2024_dprt_tpu.ops.traversal import traverse_bvh as j_bvh
from pg2024_dprt_tpu.render import RenderConfig as JConfig
from pg2024_dprt_tpu.render import render_image as j_render
from pg2024_dprt_tpu.scene import cornell_box as j_cornell
from pg2024_dprt_tpu.scene import device_scene_from_meshes as j_build
from pg2024_dprt_tpu.scene import random_tri_soup
from pg2024_dprt_tpu.scene.lights import EnvironmentMap as JEnv
from pg2024_dprt_tpu_torch import ops as tops
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.core import Camera
from pg2024_dprt_tpu_torch.render import RenderConfig, render_image
from pg2024_dprt_tpu_torch.utils import read_exr

T_MIN = 1e-3
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cornell_32x32_spp2_b3.exr")


def _scenes(meshes, tpc=None):
    js = j_build(meshes, tris_per_cluster=tpc)
    arrays = {k: np.asarray(v) for k, v in js._asdict().items() if isinstance(v, jax.Array)}
    return js, tscene.device_scene_from_arrays(arrays, device="cpu")


def _rays(kind, n, seed):
    """(o, d, tmax, active) from a seed: random rays through the unit box,
    rays aimed from one side at the soup's centre (every ray in a few
    clusters), or rays inside the cornell box; finite tmax and inactive rays
    on the last."""
    rng = np.random.RandomState(seed)
    tmax = np.full(n, 1e30, np.float32)
    act = np.ones(n, bool)
    if kind == "skewed":
        o = np.stack([np.full(n, -1.0), rng.rand(n), rng.rand(n)], -1).astype(np.float32)
        d = np.float32([0.5, 0.5, 0.5]) + rng.randn(n, 3).astype(np.float32) * 0.02 - o
    else:
        o = (rng.rand(n, 3) * (0.8 if kind == "inside" else 1.4)
             + (0.1 if kind == "inside" else -0.2)).astype(np.float32)
        d = rng.randn(n, 3).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    if kind == "limited":
        tmax = (rng.rand(n) * 1.5 + 0.05).astype(np.float32)
        act = rng.rand(n) > 0.3
    return o, d, tmax, act


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _t(*xs):
    return tuple(torch.as_tensor(x) for x in xs)


def _assert_hits_match(got, want):
    hit = np.asarray(want.is_hit)
    np.testing.assert_array_equal(got.is_hit.numpy(), hit)
    gt, wt = got.t.numpy(), np.asarray(want.t)
    np.testing.assert_allclose(gt[hit], wt[hit], rtol=1e-4, atol=1e-5)
    mismatch = hit & (got.tri_index.numpy() != np.asarray(want.tri_index))
    near_tie = np.abs(gt - wt) <= 2.0 ** -20 * np.maximum(1.0, np.abs(wt))
    assert near_tie[mismatch].all()
    assert mismatch.sum() <= max(2, hit.sum() // 100)
    same = hit & ~mismatch
    for f in ("u", "v"):
        a, b = getattr(got, f).numpy()[same], np.asarray(getattr(want, f))[same]
        np.testing.assert_allclose(a, b, rtol=0.0, atol=1e-3)
        assert (np.abs(a - b) > 1e-5 + 1e-4 * np.abs(b)).sum() <= max(1, same.sum() // 100)
    assert (got.tri_index.numpy()[~hit] == -1).all()
    assert (gt[~hit] == np.float32(3.402823466e38)).all()


_SCENES = {"soup": lambda: [random_tri_soup(700, seed=3)],
           "cornell": lambda: j_cornell()[0]}


@pytest.mark.parametrize("scene_kind,ray_kind", [("soup", "random"), ("soup", "limited"),
                                                 ("cornell", "inside")])
def test_traverse_bvh_matches_jax(scene_kind, ray_kind):
    """The stackless walk and the brute-force oracle against JAX's; the
    walk also against the port's own oracle."""
    js, ts = _scenes(_SCENES[scene_kind]())
    o, d, tmax, act = _rays(ray_kind, 512, 7)
    want = j_bvh(js, *_j(o, d), T_MIN, *_j(tmax, act))
    got = tops.traverse_bvh(ts, *_t(o, d), T_MIN, *_t(tmax, act))
    _assert_hits_match(got, want)
    brute = tops.intersect_brute_force(ts, *_t(o, d), T_MIN, *_t(tmax, act))
    _assert_hits_match(brute, j_brute(js, *_j(o, d), T_MIN, *_j(tmax, act)))
    _assert_hits_match(got, brute)
    assert not got.is_hit.numpy()[~act].any()
    assert 10 < int(got.is_hit.sum()) < 512


def test_brute_force_picks_the_lowest_index_and_reports_triangle_0_on_a_miss():
    """jnp.argmin's conventions: the first triangle at the least t wins
    (here two coincident copies of every triangle), and a miss carries
    triangle 0's u and v."""
    mesh = random_tri_soup(40, seed=5)
    twice = tscene.MeshGeometry(*(np.concatenate([a, a]) for a in (mesh.v0, mesh.v1, mesh.v2)))
    js, ts = _scenes([twice])
    o, d, tmax, act = _rays("random", 256, 8)
    want = j_brute(js, *_j(o, d), T_MIN, *_j(tmax, act))
    got = tops.intersect_brute_force(ts, *_t(o, d), T_MIN, *_t(tmax, act))
    for f in ("is_hit", "tri_index"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    assert got.is_hit.any() and (~got.is_hit).any()


@pytest.mark.parametrize("scene_kind,ray_kind,tpc,chunk", [
    ("soup", "random", 64, 256), ("soup", "skewed", 64, 4096),
    ("soup", "limited", 32, 512), ("cornell", "inside", 16, 256)])
def test_cluster_tracer_matches_jax(scene_kind, ray_kind, tpc, chunk):
    """traverse_clusters and occlusion_clusters against JAX's at the same
    chunk and block sizes; the skewed rays spill one cluster into many
    blocks."""
    js, ts = _scenes(_SCENES[scene_kind](), tpc)
    n = 2048 if ray_kind == "skewed" else 1024
    o, d, tmax, act = _rays(ray_kind, n, 11)
    kw = dict(chunk=chunk, block_rays=128)
    want = j_clusters(js, *_j(o, d), T_MIN, *_j(tmax, act), **kw)
    got, dropped = tops.traverse_clusters(ts, *_t(o, d), T_MIN, *_t(tmax, act),
                                          return_dropped=True, **kw)
    assert dropped == 0
    _assert_hits_match(got, want)
    occ = tops.occlusion_clusters(ts, *_t(o, d), T_MIN, *_t(tmax, act), **kw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(
        j_occl_clusters(js, *_j(o, d), T_MIN, *_j(tmax, act), **kw)))
    np.testing.assert_array_equal(occ.numpy(), got.is_hit.numpy())


def test_cluster_tracer_counts_pairs_past_the_block_budget():
    """A block budget too small for the rays drops pairs, as in JAX; the
    count says how many (JAX discards it)."""
    js, ts = _scenes(_SCENES["soup"](), 64)
    o, d, tmax, act = _rays("random", 1024, 12)
    kw = dict(chunk=1024, block_rays=64, block_budget=8)
    got, dropped = tops.traverse_clusters(ts, *_t(o, d), T_MIN, *_t(tmax, act),
                                          return_dropped=True, **kw)
    assert dropped > 0
    want = j_clusters(js, *_j(o, d), T_MIN, *_j(tmax, act), **kw)
    _assert_hits_match(got, want)


def test_back_ends_refuse_instanced_scenes():
    m = np.zeros((2, 3, 4), np.float32)
    m[:, :, :3] = np.eye(3)
    m[1, :, 3] = [2.0, 0.0, 0.0]
    ts = tscene.device_scene_from_instances([random_tri_soup(100, seed=1)], m,
                                            tris_per_cluster=32, device="cpu")
    assert ts.cl_tri_table is not None  # base-level, as in JAX
    o, d = torch.zeros((4, 3)), torch.ones((4, 3))
    act = torch.ones(4, dtype=torch.bool)
    for fn in (tops.traverse_bvh, tops.intersect_brute_force, tops.traverse_clusters,
               tops.occlusion_clusters, tops.trace_pairs):
        with pytest.raises(ValueError, match="instanced"):
            fn(ts, o, d, T_MIN, 1e30, act)


@pytest.mark.parametrize("tracer", ["stackless", "cluster"])
def test_render_image_through_the_back_end_matches_golden_and_jax(tracer):
    """cornell 32x32 spp2 b3 through render_image with the named tracer
    (the composed path) against the golden EXR and against the JAX
    package's composed frame with tracer="stackless"."""
    meshes, lights = tscene.cornell_box(device="cpu")
    scene = tscene.device_scene_from_meshes(meshes, device="cpu")
    env = tscene.EnvironmentMap.constant((0.2, 0.3, 0.4), device="cpu")
    cam_args = ([0.5, 0.5, 2.4], [0.5, 0.5, 0.0], [0, 1, 0], 40.0, 32, 32)
    cfg = RenderConfig(width=32, height=32, spp=2, bounces=3, tracer=tracer)
    img, stats = render_image(scene, lights, env, Camera.look_at(*cam_args, device="cpu"),
                              cfg, return_stats=True, device="cpu")
    assert stats["tracer_diag"] == 0
    img = img.numpy()
    golden, names = read_exr(GOLDEN)
    golden = golden[:, :, [names.index(c) for c in ("R", "G", "B")]]
    np.testing.assert_allclose(img, golden, rtol=1e-3, atol=1e-4)
    jm, jl = j_cornell()
    want = j_render(j_build(jm), jl, JEnv.constant((0.2, 0.3, 0.4)), JCamera.look_at(*cam_args),
                    JConfig(width=32, height=32, spp=2, bounces=3, tracer="stackless",
                            fused_frame="off"))
    np.testing.assert_allclose(img, np.asarray(want), rtol=1e-3, atol=1e-4)
