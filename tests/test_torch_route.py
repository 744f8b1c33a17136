"""The port's neural-proxy stages (render/proxy_stages.py) and fused route
(ops/route.py) against the JAX package, on the same scene tables, proxy
boxes, weights and rays (made with numpy from a seed and handed to both).

The port runs its plain versions here (CPU tensors); the JAX package runs its
composed stage, and its fused route kernel in interpret mode, without the ray
sort and once with it. vis/depth run with bf16 operands in both packages but with sums in
another order, so a decision within the nets' tolerance of a threshold could
flip: the nets' vis (and, for shadows, depth) head biases are shifted by +-10,
as the JAX package's own route tests do, and then nodes, flags and the visited
mask must be equal. Tolerances: tmax rtol / atol 2e-3 (a predicted length is
a net output, 2e-2 relative at most, times a box diagonal below the hit
distance); env_add and the light image rtol 1e-5 / atol 1e-6 (sums of equal
terms in another order).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pg2024_dprt_tpu.render.proxy_stages as jps
from pg2024_dprt_tpu.core.types import PathState as JPathState
from pg2024_dprt_tpu.models import mlp as jmlp
from pg2024_dprt_tpu.models import proxy as jproxy
from pg2024_dprt_tpu.ops import pallas_route as jroute
from pg2024_dprt_tpu.scene import device_scene_from_meshes, random_tri_soup
from pg2024_dprt_tpu.scene.geometry import ProxyTable as JProxyTable
from pg2024_dprt_tpu.scene.lights import EnvironmentMap as JEnvironmentMap
from pg2024_dprt_tpu_torch import models as tmodels
from pg2024_dprt_tpu_torch.core.types import PathState
from pg2024_dprt_tpu_torch.models import mlp as tmlp
from pg2024_dprt_tpu_torch.ops import resident as tres
from pg2024_dprt_tpu_torch.ops import route as troute
from pg2024_dprt_tpu_torch.render import proxy_stages as tps
from pg2024_dprt_tpu_torch.scene import (
    EnvironmentMap, device_scene_from_arrays, proxy_table_from_arrays,
)

MH = 3
EPS = 1e-3
MY_ID = 8
SMALL = tmlp.MLPConfig(width=64, depth=2)
ENV_COLOR = (0.4, 0.5, 0.7)
OFFS = np.asarray(
    [[-1.05, 0, 0], [1.05, 0, 0], [0, -1.05, 0], [0, 1.05, 0],
     [0, 0, -1.05], [0, 0, 1.05], [-1.05, -1.05, 0], [1.05, 1.05, 0]], np.float32)


def _jcfg(cfg):
    return jmlp.MLPConfig(**dataclasses.asdict(cfg))


def _to_jax(params):
    return {k: jnp.asarray(v.numpy()) for k, v in params.items()}


def _jmodels(m):
    return jproxy.ProxyModels(_to_jax(m.vis_params), _to_jax(m.depth_params), m.num_objects,
                              _jcfg(m.vis_cfg), _jcfg(m.depth_cfg), multi_geo=m.multi_geo,
                              combined=m.combined)


def _biased(m, vis_bias, depth_bias=0.0, last="head_b1"):
    shift = lambda d, b: {k: (v + b if k == last else v) for k, v in d.items()}
    return dataclasses.replace(m, vis_params=shift(m.vis_params, vis_bias),
                               depth_params=shift(m.depth_params, depth_bias))


def _scenes(seed):
    js = device_scene_from_meshes([random_tri_soup(900, seed=seed)], tris_per_cluster=64)
    arrays = {k: np.asarray(v) for k, v in js._asdict().items() if isinstance(v, jax.Array)}
    return js, device_scene_from_arrays(arrays, device="cpu")


def _tables(arrays):
    return (JProxyTable(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            proxy_table_from_arrays(arrays, device="cpu"))


def _unit_boxes():
    return dict(aabb_min=OFFS, aabb_max=OFFS + 1.0,
                max_length=np.full((8,), np.sqrt(3.0), np.float32))


def _instanced_boxes():
    """16 instance rows over 4 objects and 8 nodes: scaled, translated unit
    boxes around the local scene."""
    rng = np.random.RandomState(77)
    p = 16
    sc = (0.5 + rng.rand(p) * 0.7).astype(np.float32)
    ang = rng.rand(p) * 2 * np.pi
    rad = 1.3 + rng.rand(p) * 0.8
    lo = np.stack([0.5 + rad * np.cos(ang), rng.rand(p) * 1.5 - 0.5,
                   0.5 + rad * np.sin(ang)], axis=1).astype(np.float32) - sc[:, None] / 2
    m = np.zeros((p, 3, 4), np.float32)
    for i in range(p):
        m[i, :, :3] = np.eye(3, dtype=np.float32) / sc[i]
        m[i, :, 3] = -lo[i] / sc[i]
    return dict(aabb_min=lo, aabb_max=lo + sc[:, None],
                max_length=np.full((p,), np.sqrt(3.0), np.float32),
                obj_id=(np.arange(p) % 4).astype(np.int32),
                node_id=(np.arange(p) % 8).astype(np.int32),
                world_to_obj=m, obj_min=np.zeros((p, 3), np.float32),
                obj_span=np.ones((p, 3), np.float32))


def _paths(seed, n, shadow=False):
    """The same wavefront as a JAX and a port PathState."""
    rng = np.random.RandomState(seed + 2)
    o = rng.rand(n, 3).astype(np.float32) * 1.4 - 0.2
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    valid = rng.rand(n) > 0.1
    if shadow:
        rng = np.random.RandomState(seed + 9)
        tmax = (rng.rand(n) * 2.5 + 0.3).astype(np.float32)
        thr = rng.rand(n, 3).astype(np.float32)
        pix = (np.arange(n) % 97).astype(np.int32)
    else:
        tmax = np.full((n,), 3.4e38, np.float32)
        thr = np.ones((n, 3), np.float32)
        pix = np.arange(n, dtype=np.int32)
    jp = JPathState.empty(n)._replace(
        origin=jnp.asarray(o), direction=jnp.asarray(d), tmax=jnp.asarray(tmax),
        throughput=jnp.asarray(thr), pixel_index=jnp.asarray(pix), is_valid=jnp.asarray(valid))
    tp = PathState.empty(n, device="cpu")._replace(
        origin=torch.as_tensor(o), direction=torch.as_tensor(d), tmax=torch.as_tensor(tmax),
        throughput=torch.as_tensor(thr), pixel_index=torch.as_tensor(pix).to(torch.int64),
        is_valid=torch.as_tensor(valid))
    return jp, tp


def _envs():
    return JEnvironmentMap.constant(ENV_COLOR), EnvironmentMap.constant(ENV_COLOR, device="cpu")


def _assert_paths_equal(got, want, env_got, env_want):
    for f in ("target_node", "current_node", "is_hit", "is_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.visited_mask.numpy(),
                                  np.asarray(want.visited_mask).astype(np.int64))
    np.testing.assert_allclose(got.tmax.numpy(), np.asarray(want.tmax), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(env_got.numpy(), np.asarray(env_want), rtol=1e-5, atol=1e-6)


def _secondary_both(m, table, seed, n=768, my_id=MY_ID):
    js, ts = _scenes(seed)
    jt, tt = _tables(table)
    jp, tp = _paths(seed, n)
    jenv, tenv = _envs()
    want = jps.secondary_route(js, jt, _jmodels(m), jenv, jp, jnp.int32(my_id), MH, EPS, n)
    got = tps.secondary_route(ts, tt, m, tenv, tp, my_id, MH, EPS, n)
    return got, want


@pytest.mark.parametrize("vis_bias,seed", [(10.0, 3), (-10.0, 5)])
def test_secondary_route_matches_jax_composed(vis_bias, seed):
    m = _biased(tmodels.random_proxy_models(seed + 1, 8, SMALL, SMALL, device="cpu"), vis_bias)
    (gp, ge, gd), (wp, we, wd) = _secondary_both(m, _unit_boxes(), seed)
    _assert_paths_equal(gp, wp, ge, we)
    assert gd == 0 and int(wd) == 0
    if vis_bias > 0:
        # every marched proxy predicts a hit: some rays settle remotely
        assert ((gp.target_node >= 0) & (gp.target_node < 8)).sum() > 50
    else:
        assert not ((gp.target_node >= 0) & (gp.target_node < 8)).any()
        assert (gp.target_node == MY_ID).sum() > 50
    assert float(ge.sum()) > 0.0 and (~gp.is_valid).sum() > 77


@pytest.mark.parametrize("vis_bias,depth_bias,seed",
                         [(10.0, -10.0, 41), (10.0, 10.0, 43), (-10.0, 0.0, 47)])
def test_shadow_direct_light_matches_jax_composed(vis_bias, depth_bias, seed):
    """Everything marched occludes / inside-hits pass the depth test /
    nothing occludes."""
    m = _biased(tmodels.random_proxy_models(seed + 1, 8, SMALL, SMALL, device="cpu"),
                vis_bias, depth_bias)
    js, ts = _scenes(seed)
    jt, tt = _tables(_unit_boxes())
    jp, tp = _paths(seed, 768, shadow=True)
    want, _ = jps.shadow_direct_light_nn(js, jt, _jmodels(m), jp, jnp.int32(MY_ID), MH, EPS, 4, 97)
    got, diag = tps.shadow_direct_light_nn(ts, tt, m, tp, MY_ID, MH, EPS, 4, 97)
    assert tuple(got.shape) == (97, 3) and diag == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert float(got.sum()) > 0.0


def _route_args(seed, n, shadow=False):
    js, ts = _scenes(seed)
    jt, tt = _tables(_unit_boxes())
    jp, tp = _paths(seed, n, shadow=shadow)
    scale = (1.0 - 1e-3) if shadow else 1.0
    jargs = (jp.origin, jp.direction, EPS, jp.tmax * scale, jp.is_valid, jnp.int32(MY_ID))
    targs = (tp.origin, tp.direction, EPS, tp.tmax * scale, tp.is_valid, MY_ID)
    return (js, jt, jargs), (ts, tt, targs), tp


@pytest.mark.parametrize("vis_bias,seed", [(10.0, 7), (-10.0, 13)])
def test_route_fused_plain_matches_composed_and_the_pallas_kernel(vis_bias, seed):
    """The fused route's plain version against the port's composed stage
    (the same decisions applied to the same paths) and against the JAX fused
    kernel in interpret mode, without the ray sort and (one case) with its
    default schedule sort; the port's decisions in schedule order, put back,
    are the same decisions."""
    m = _biased(tmodels.random_proxy_models(seed + 1, 8, SMALL, SMALL, device="cpu"), vis_bias)
    (js, jt, jargs), (ts, tt, targs), tp = _route_args(seed, 256)
    dec = troute.route_fused(ts, tt, m, *targs, MH, EPS)     # CPU tensors: the plain version
    ref = troute.route_fused_plain(ts, tt, m, *targs, MH, EPS)
    want = jroute.route_fused(js, jt, _jmodels(m), *jargs, max_hits=MH, eps=EPS,
                              sort_rays=False, interpret=True)
    for key in ("settled_node", "has_node", "env_miss", "no_route", "local_hit"):
        assert torch.equal(dec[key], ref[key]), key
        np.testing.assert_array_equal(dec[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(dec["new_t"].numpy(), np.asarray(want["new_t"]),
                               rtol=2e-3, atol=2e-3)
    # the composed stage reaches the same paths
    tenv = _envs()[1]
    paths, env_add, _ = tps.secondary_route(ts, tt, m, tenv, tp, MY_ID, MH, EPS, 256)
    live = tp.is_valid
    assert torch.equal(paths.is_hit[live], dec["has_node"][live])
    assert torch.equal(paths.target_node[dec["has_node"]], dec["settled_node"][dec["has_node"]])
    assert torch.equal(paths.is_valid, tp.is_valid & ~dec["env_miss"])
    np.testing.assert_allclose(paths.tmax[live].numpy(), dec["new_t"][live].numpy(),
                               rtol=2e-3, atol=2e-3)
    assert dec["has_node"].sum() > 5 and (dec["env_miss"] | dec["no_route"]).any()
    # the schedule sort changes the order K7 sees the rays in, not a decision
    o, d, _, tmax, act, _ = targs
    perm = tres.schedule_order(ts, o, d, torch.full_like(tmax, EPS), tmax, act)
    assert not torch.equal(perm, torch.arange(256))
    in_order = troute.route_fused_plain(ts, tt, m, o[perm], d[perm], EPS, tmax[perm], act[perm],
                                        MY_ID, MH, EPS)
    for key, val in in_order.items():
        assert torch.equal(tres.unsorted(val, perm), dec[key]), key
    if vis_bias > 0:
        sorted_want = jroute.route_fused(js, jt, _jmodels(m), *jargs, max_hits=MH, eps=EPS,
                                         interpret=True)
        for key in ("settled_node", "has_node", "env_miss", "no_route", "local_hit"):
            np.testing.assert_array_equal(dec[key].numpy(), np.asarray(sorted_want[key]),
                                          err_msg=key)


@pytest.mark.parametrize("vis_bias,depth_bias,seed",
                         [(10.0, -10.0, 51), (10.0, 10.0, 53), (-10.0, 0.0, 57)])
def test_shadow_route_fused_plain_matches_composed_and_the_pallas_kernel(vis_bias, depth_bias, seed):
    m = _biased(tmodels.random_proxy_models(seed + 1, 8, SMALL, SMALL, device="cpu"),
                vis_bias, depth_bias)
    (js, jt, jargs), (ts, tt, targs), tp = _route_args(seed, 256, shadow=True)
    dec = troute.shadow_route_fused(ts, tt, m, *targs, MH, EPS)
    want = jroute.shadow_route_fused(js, jt, _jmodels(m), *jargs, max_hits=MH, eps=EPS,
                                     interpret=True)
    for key in ("occluded_local", "survives"):
        np.testing.assert_array_equal(dec[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(dec["weight"].numpy(), np.asarray(want["weight"]))
    # the composed stage adds the same light
    got, _ = tps.shadow_direct_light_nn(ts, tt, m, tp, MY_ID, MH, EPS, 4, 97)
    contrib = tp.throughput * dec["weight"][:, None] / 4
    ref = torch.zeros((97, 3)).index_add_(0, tp.pixel_index, contrib)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    assert dec["survives"].sum() > 20 and dec["occluded_local"].sum() > 5


def test_combined_nets_branch_matches_jax():
    """The double-output nets run the composed path in both packages; the
    shadow blend compares with the slack of 0.1."""
    cfg = tmlp.MLPConfig(width=64, depth=2, out_features=2, final_activation="none")
    m = tmodels.random_combined_proxy_models(np.random.RandomState(90), 8, cfg, device="cpu")
    # channel 0 (vis) far above the threshold, channel 1 (depth) left alone
    bias = m.vis_params["head_b1"].clone()
    bias[:, 0] += 10.0
    m = dataclasses.replace(m, vis_params={**m.vis_params, "head_b1": bias})
    (gp, ge, _), (wp, we, _) = _secondary_both(m, _unit_boxes(), 61, n=384)
    _assert_paths_equal(gp, wp, ge, we)
    js, ts = _scenes(61)
    jt, tt = _tables(_unit_boxes())
    jp, tp = _paths(61, 384, shadow=True)
    want, _ = jps.shadow_direct_light_nn(js, jt, _jmodels(m), jp, jnp.int32(MY_ID), MH, EPS, 2, 97)
    got, _ = tps.shadow_direct_light_nn(ts, tt, m, tp, MY_ID, MH, EPS, 2, 97)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_multigeo_branch_matches_jax():
    cfg_v = tmlp.MLPConfig(width=64, depth=2, in_features=6, final_activation="none",
                           multi_geo=True)
    cfg_d = dataclasses.replace(cfg_v, final_activation="leaky_relu")
    rng = np.random.RandomState(95)
    m = tmodels.multigeo_proxy_models(tmlp.init_mlp(rng, cfg_v, device="cpu"),
                                      tmlp.init_mlp(rng, cfg_d, device="cpu"), 8, cfg_v, cfg_d)
    m = _biased(m, 10.0, last="head_b2")
    (gp, ge, _), (wp, we, _) = _secondary_both(m, _unit_boxes(), 63, n=384)
    _assert_paths_equal(gp, wp, ge, we)
    assert ((gp.target_node >= 0) & (gp.target_node < 8)).sum() > 20


@pytest.mark.parametrize("vis_bias", [10.0, -10.0])
def test_secondary_route_counts_the_paths_it_routes(vis_bias):
    """With a list, secondary_route appends the masks of the live paths it
    routed and of those it settled on another partition (the frame's
    route_queries and route_remote), as a recount from the paths it returns
    finds them."""
    m = _biased(tmodels.random_proxy_models(8, 8, SMALL, SMALL, device="cpu"), vis_bias)
    _, (ts, tt, _), tp = _route_args(7, 256)
    routed = [None]
    paths, _, _ = tps.secondary_route(ts, tt, m, _envs()[1], tp, MY_ID, MH, EPS, 256,
                                      routed=routed)
    assert routed[0] is None and len(routed) == 2
    live, remote = routed[1]
    assert torch.equal(live, tp.is_valid & ~tp.is_shadow)
    assert torch.equal(remote, live & paths.is_hit & (paths.target_node != MY_ID))
    assert (int(remote.sum()) > 5) == (vis_bias > 0)


def _multigeo_models(seed, vis_bias, depth_bias=0.0):
    cfg_v = tmlp.MLPConfig(width=64, depth=2, in_features=6, final_activation="none",
                           multi_geo=True)
    cfg_d = dataclasses.replace(cfg_v, final_activation="leaky_relu")
    rng = np.random.RandomState(seed)
    m = tmodels.multigeo_proxy_models(tmlp.init_mlp(rng, cfg_v, device="cpu"),
                                      tmlp.init_mlp(rng, cfg_d, device="cpu"), 8, cfg_v, cfg_d)
    return _biased(m, vis_bias, depth_bias, last="head_b2")


@pytest.mark.parametrize("vis_bias,depth_bias,seed", [(10.0, 0.0, 71), (-10.0, 0.0, 73)])
def test_fused_route_multigeo_plain_matches_jax_composed(vis_bias, depth_bias, seed):
    """K7's multi-geo mode, plain version: the secondary decisions equal the
    JAX composed stage's (march, then the shared 6-feature nets through
    apply_multigeo) applied to the same paths, and the port's composed
    stage's; the shadow weights equal JAX's light image. Heads shifted by
    +-10, as tests/test_multigeo.py does."""
    m = _multigeo_models(seed, vis_bias, depth_bias)
    assert troute.fused_route_takes(m, proxy_table_from_arrays(_unit_boxes(), device="cpu"),
                                    MH)
    (js, jt, jargs), (ts, tt, targs), tp = _route_args(seed, 384)
    dec = troute.route_fused(ts, tt, m, *targs, MH, EPS)
    jenv, tenv = _envs()
    jp, _ = _paths(seed, 384)
    wp, we, _ = jps.secondary_route(js, jt, _jmodels(m), jenv, jp, jnp.int32(MY_ID), MH, EPS,
                                    384)
    live = tp.is_valid
    has = dec["has_node"]
    np.testing.assert_array_equal(has[live].numpy(), np.asarray(wp.is_hit)[live.numpy()])
    np.testing.assert_array_equal(dec["settled_node"][has].numpy(),
                                  np.asarray(wp.target_node)[has.numpy()])
    np.testing.assert_array_equal((tp.is_valid & ~dec["env_miss"]).numpy(),
                                  np.asarray(wp.is_valid))
    np.testing.assert_allclose(dec["new_t"][live].numpy(), np.asarray(wp.tmax)[live.numpy()],
                               rtol=2e-3, atol=2e-3)
    gp, ge, _ = tps.secondary_route(ts, tt, m, tenv, tp, MY_ID, MH, EPS, 384)
    _assert_paths_equal(gp, wp, ge, we)
    if vis_bias > 0:
        assert ((gp.target_node >= 0) & (gp.target_node < 8)).sum() > 20
    (js, jt, jargs), (ts, tt, targs), tp = _route_args(seed, 384, shadow=True)
    jp, _ = _paths(seed, 384, shadow=True)
    weight = troute.shadow_route_fused(ts, tt, m, *targs, MH, EPS)["weight"]
    want, _ = jps.shadow_direct_light_nn(js, jt, _jmodels(m), jp, jnp.int32(MY_ID), MH, EPS,
                                         4, 97)
    got = torch.zeros((97, 3)).index_add_(0, tp.pixel_index,
                                          tp.throughput * weight[:, None] / 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_mismatched_architectures_branch_matches_jax():
    """vis and depth nets of different widths: two grouped sweeps."""
    wide = tmlp.MLPConfig(width=128, depth=1)
    m = _biased(tmodels.random_proxy_models(97, 8, wide, SMALL, device="cpu"), -10.0)
    (gp, ge, _), (wp, we, _) = _secondary_both(m, _unit_boxes(), 65, n=384)
    _assert_paths_equal(gp, wp, ge, we)


def test_instanced_proxies_branch_matches_jax():
    """Instance rows route to their owning node, pick their object's net and
    scale the predicted length by the world/object ratio; rows hosted by the
    caller's node are not proxies."""
    m = _biased(tmodels.random_proxy_models(99, 4, SMALL, SMALL, device="cpu"), 10.0)
    (gp, ge, _), (wp, we, _) = _secondary_both(m, _instanced_boxes(), 67, n=512, my_id=3)
    _assert_paths_equal(gp, wp, ge, we)
    remote = gp.is_hit & (gp.target_node != 3)
    assert remote.sum() > 20 and (gp.target_node[remote] < 8).all()
    # the fused route's plain version takes the instanced table as well
    js, ts = _scenes(67)
    jt, tt = _tables(_instanced_boxes())
    jp, tp = _paths(67, 512)
    dec = troute.route_fused_plain(ts, tt, m, tp.origin, tp.direction, EPS, tp.tmax,
                                   tp.is_valid, 3, MH, EPS)
    has = dec["has_node"]
    assert torch.equal(has[tp.is_valid], gp.is_hit[tp.is_valid])
    assert torch.equal(dec["settled_node"][has], gp.target_node[has])


def test_cutout_scene_branch_matches_jax():
    """A scene with a cutout texture traces through the alpha re-trace in
    both stages (and never takes the fused route): two stacked quads with
    transparent centres between the rays and the proxies."""
    from pg2024_dprt_tpu.scene import MeshGeometry as JMesh

    img = np.ones((16, 16, 4), np.float32)
    img[4:12, 4:12, 3] = 0.0
    meshes = []
    for i in range(2):
        z = 0.1 * (i + 1)
        p = np.asarray([[0, 0, z], [1, 0, z], [1, 1, z], [0, 1, z]], np.float32)
        meshes.append(JMesh(
            v0=np.stack([p[0], p[0]]), v1=np.stack([p[1], p[2]]), v2=np.stack([p[2], p[3]]),
            uv0=np.zeros((2, 2), np.float32), uv1=np.asarray([[1, 0], [1, 1]], np.float32),
            uv2=np.asarray([[1, 1], [0, 1]], np.float32), texture_index=0, name=f"q{i}"))
    js = device_scene_from_meshes(meshes, textures=[img])
    as_np = lambda rec: {k: np.asarray(v) for k, v in rec._asdict().items()
                         if isinstance(v, jax.Array)}
    arrays = as_np(js)
    arrays["albedo_textures"] = as_np(js.albedo_textures)
    ts = device_scene_from_arrays(arrays, device="cpu")
    assert ts.has_cutout
    n = 384
    rng = np.random.default_rng(13)
    o = np.concatenate([rng.uniform(0.02, 0.98, (n, 2)), np.full((n, 1), -0.5)], 1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    d[:, :2] += rng.normal(0, 0.05, (n, 2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jp, tp = _paths(3, n)
    jp = jp._replace(origin=jnp.asarray(o), direction=jnp.asarray(d))
    tp = tp._replace(origin=torch.as_tensor(o), direction=torch.as_tensor(d))
    jt, tt = _tables(_unit_boxes())
    jenv, tenv = _envs()
    m = _biased(tmodels.random_proxy_models(21, 8, SMALL, SMALL, device="cpu"), -10.0)
    wp, we, wd = jps.secondary_route(js, jt, _jmodels(m), jenv, jp, jnp.int32(MY_ID), MH, EPS, n)
    gp, ge, gd = tps.secondary_route(ts, tt, m, tenv, tp, MY_ID, MH, EPS, n)
    _assert_paths_equal(gp, wp, ge, we)
    assert int(gd) == int(wd)
    local = gp.target_node == MY_ID
    # stopped by a quad / through the holes of both
    assert local.sum() > 50 and (gp.is_valid & ~gp.is_hit).sum() > 20
    jp = jp._replace(tmax=jnp.full((n,), 2.0, jnp.float32))
    tp = tp._replace(tmax=torch.full((n,), 2.0))
    want, _ = jps.shadow_direct_light_nn(js, jt, _jmodels(m), jp, jnp.int32(MY_ID), MH, EPS, 1, n)
    got, _ = tps.shadow_direct_light_nn(ts, tt, m, tp, MY_ID, MH, EPS, 1, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


class _Stub:
    """A scene as the gate reads it."""

    def __init__(self, device="cuda", has_cutout=False, cl_xf=None, curves=None):
        self.cl_mt_table = types.SimpleNamespace(device=torch.device(device))
        self.has_cutout = has_cutout
        if cl_xf is not None:
            self.cl_xf = cl_xf
        if curves is not None:
            self.curves = curves


def test_fused_route_gate_case_by_case():
    """_use_fused_route keeps the JAX gate's semantic conditions and has no
    weight budget; CPU tensors always compose."""
    pair = tmodels.ProxyModels({}, {}, 8, SMALL, SMALL)
    assert tps._use_fused_route(_Stub(), pair, "auto")
    assert tps._use_fused_route(_Stub(), pair, "resident")
    assert not tps._use_fused_route(_Stub(device="cpu"), pair, "auto")
    assert not tps._use_fused_route(_Stub(), pair, "stackless")
    assert not tps._use_fused_route(_Stub(has_cutout=True), pair, "auto")
    assert not tps._use_fused_route(_Stub(cl_xf=torch.zeros(1)), pair, "auto")
    # K7's in-kernel trace has no curve stage (JAX's gate lacks this test)
    assert not tps._use_fused_route(_Stub(curves=object()), pair, "auto")
    assert not tps._use_fused_route(
        _Stub(), dataclasses.replace(pair, combined=True), "auto")
    assert not tps._use_fused_route(
        _Stub(), dataclasses.replace(pair, multi_geo=True), "auto")
    assert not tps._use_fused_route(
        _Stub(), dataclasses.replace(pair, vis_cfg=tmlp.MLPConfig(width=128, depth=2)), "auto")
    # 12 production pairs are over the JAX gate's weight budget; the port's
    # kernel reads the nets from global memory and takes them
    assert tps._use_fused_route(
        _Stub(), tmodels.ProxyModels({}, {}, 12, tmlp.PROD_VIS, tmlp.PROD_DEPTH), "auto")
    # a different final activation is not a different architecture
    assert tps._use_fused_route(_Stub(), dataclasses.replace(
        pair, vis_cfg=dataclasses.replace(SMALL, final_activation="sigmoid")), "auto")
    # what the kernel's wrapper would refuse for its shape composes: a proxy
    # row without a net pair (instance rows share their object's pair), a
    # tile beyond shared memory, an architecture the pair kernels do not take
    rows = lambda p, instanced=False: types.SimpleNamespace(num_partitions=p, instanced=instanced)
    assert tps._use_fused_route(_Stub(), pair, "auto", rows(8), MH)
    assert not tps._use_fused_route(_Stub(), pair, "auto", rows(9), MH)
    assert tps._use_fused_route(_Stub(), pair, "auto", rows(16, instanced=True), MH)
    # multi-geo nets run K7's multi-geo mode: one shared pair, whatever the
    # number of rows; the production MULTIGEO pair fits a tile at max_hits 3
    mg = tmodels.ProxyModels({}, {}, 8, tmlp.MULTIGEO_VIS, tmlp.MULTIGEO_DEPTH,
                             multi_geo=True)
    assert tps._use_fused_route(_Stub(), mg, "auto", rows(16), MH)
    assert not tps._use_fused_route(_Stub(device="cpu"), mg, "auto", rows(8), MH)
    assert tps._use_fused_route(_Stub(), mg, "auto", rows(8), 8)
    assert not tps._use_fused_route(_Stub(), mg, "auto", rows(8), 9)
    prod = tmodels.ProxyModels({}, {}, 8, tmlp.PROD_VIS, tmlp.PROD_DEPTH)
    assert tps._use_fused_route(_Stub(), prod, "auto", rows(8), 14)
    assert not tps._use_fused_route(_Stub(), prod, "auto", rows(8), 15)
    assert not tps._use_fused_route(_Stub(), prod, "auto", rows(8), 0)
    assert not tps._use_fused_route(_Stub(), dataclasses.replace(
        pair, vis_cfg=tmlp.MLPConfig(width=60, depth=2),
        depth_cfg=tmlp.MLPConfig(width=60, depth=2)), "auto")
    for args in ((pair, rows(9), MH), (prod, rows(8), 15)):
        assert not troute.fused_route_takes(*args)


def test_more_than_32_proxy_rows_raise_in_the_stages():
    rng = np.random.RandomState(5)
    lo = rng.rand(33, 3).astype(np.float32) * 3 + 1.5
    table = dict(aabb_min=lo, aabb_max=lo + 0.5,
                 max_length=np.full((33,), 0.5 * np.sqrt(3.0), np.float32))
    _, tt = _tables(table)
    _, ts = _scenes(3)
    _, tp = _paths(3, 64)
    m = tmodels.random_proxy_models(1, 33, SMALL, SMALL, device="cpu")
    with pytest.raises(ValueError, match="32"):
        tps.secondary_route(ts, tt, m, _envs()[1], tp, 40, MH, EPS, 64)
    with pytest.raises(ValueError, match="32"):
        troute.route_fused_plain(ts, tt, m, tp.origin, tp.direction, EPS, tp.tmax,
                                 tp.is_valid, 40, MH, EPS)


def test_routing_fields_default_and_existing_callers():
    """PathState's routing fields default to None (the frame paths never set
    them); the stage fills them; visited_mask is int64 holding 2^32 - 1."""
    _, tp = _paths(3, 16)
    bare = PathState(*tp[:9])
    assert bare.is_hit is None and bare.visited_mask is None
    full = bare.with_routing()
    assert full.visited_mask.dtype == torch.int64 and (full.current_node == -1).all()
    _, ts = _scenes(3)
    _, tt = _tables(_unit_boxes())
    m = tmodels.random_proxy_models(1, 8, SMALL, SMALL, device="cpu")
    out, _, _ = tps.secondary_route(ts, tt, m, _envs()[1], bare, MY_ID, MH, EPS, 16)
    assert (out.visited_mask[bare.is_valid] == 0xFFFFFFFF).all()
    assert (out.visited_mask[~bare.is_valid] == 0).all()


def _csrc_int(name, pattern):
    """An integer constant of the port's CUDA sources (csrc/<name>)."""
    import os
    import re

    import pg2024_dprt_tpu_torch

    path = os.path.join(os.path.dirname(pg2024_dprt_tpu_torch.__file__), "csrc", name)
    return int(re.search(pattern, open(path).read()).group(1))


@pytest.mark.parametrize("width,depth,in_features,multi_geo,max_hits,nets", [
    (64, 2, 5, False, 3, 8), (128, 4, 5, False, 3, 8), (256, 4, 5, False, 14, 8),
    (512, 3, 6, True, 8, 1)])
def test_route_smem_bytes_follow_the_kernel_layout(width, depth, in_features, multi_geo,
                                                   max_hits, nets):
    """route_smem_bytes is csrc/route.cu's smem_bytes: the front region holds
    the nets' chunk of kNetRows records in phase 2 and the 8 warps' team
    buffers of the grouped trace in phase 1 (aliased: the larger of the two,
    never their sum), then 11 words per query record of a kTileRays-ray tile
    and 3 per net pair. The nets' chunk (csrc/proxy_mlp.cuh smem_bytes): two
    bf16 activation planes of round16(width) columns (or the encoders' two
    hidden blocks, if wider) plus kPad, the bf16 feature plane of kFeatCols +
    kPad columns, the f32 plane h of width + kPad, the f32 predictions of
    both nets. The sizes come from the sources: kTileRays, kNetTiles, kRing,
    kCandidates, kFeatCols and kPad."""
    cfg = tmlp.MLPConfig(width=width, depth=depth, in_features=in_features,
                         multi_geo=multi_geo)
    tile = _csrc_int("route.cu", r"constexpr int kTileRays = (\d+);")
    ring = _csrc_int("resident_trace.cuh", r"constexpr int kRing = (\d+);")
    cands = _csrc_int("resident_trace.cuh", r"constexpr int kCandidates = (\d+);")
    threads = _csrc_int("proxy_mlp.cuh", r"constexpr int kThreads = (\d+);")
    rows = 16 * _csrc_int("route.cu", r"constexpr int kNetTiles = (\d+);")
    feat = _csrc_int("proxy_mlp.cuh", r"constexpr int kFeatCols = (\d+);")
    pad = _csrc_int("proxy_mlp.cuh", r"constexpr int kPad = (\d+);")
    assert (tile, troute.TEAM_BYTES) == (troute.TILE_RAYS, 4 * (ring + 2 * cands))
    r16 = lambda v: (v + 15) // 16 * 16
    ld_act = max(r16(width), 2 * r16(width // 8)) + pad
    assert rows == troute.NET_ROWS
    planes = rows * ((2 * ld_act + feat + pad) * 2 + (width + pad) * 4 + 2 * 4)
    teams = threads // 32 * 4 * (ring + 2 * cands)
    want = max(planes, teams) + tile * max_hits * 11 * 4 + 3 * nets * 4
    assert troute.route_smem_bytes(cfg, max_hits, nets) == want
    assert troute.route_smem_bytes(cfg, max_hits, nets) <= troute.SMEM_LIMIT
    # the teams outgrow the planes only for narrow nets
    assert (teams > planes) == (width < 128)


@pytest.mark.parametrize("edge", ["above_rule", "below_rule", "forced_grouped",
                                  "forced_flat", "misaligned"])
def test_route_args_take_the_grouped_mode_by_the_rule(edge, monkeypatch):
    """K7's scene arguments follow ops/resident.py::use_grouped: with the
    rule's threshold at the scene's K (or `grouped=True`) they carry the
    group tables (gboxes, a 16-byte-aligned member table, Kg), one above it
    (or `grouped=False`) null group pointers and Kg = 0. A member table that
    starts off 16 bytes (a view into a larger buffer) is passed as an aligned
    copy of equal content, as the warp walks read it with 16-byte loads."""
    _, ts = _scenes(3)
    k = ts.num_clusters
    monkeypatch.setattr(tres, "GROUPED_MIN_CLUSTERS", k + 1 if edge == "below_rule" else k)
    grouped = {"forced_grouped": True, "forced_flat": False}.get(edge)
    if edge == "forced_grouped":
        monkeypatch.setattr(tres, "GROUPED_MIN_CLUSTERS", k + 1)
    if edge == "misaligned":
        buf = torch.zeros(ts.cl_mboxes.numel() + 1)
        view = buf[1:].view(ts.cl_mboxes.shape)
        view.copy_(ts.cl_mboxes)
        assert view.data_ptr() % 16 != 0
        ts = ts._replace(cl_mboxes=view)
    args, tab = troute.scene_args(ts, torch.device("cpu"), grouped)
    assert args[:7] == [tab["cl_boxes"].data_ptr(), tab["cl_mt_table"].data_ptr(),
                        tab["cl_tri_map"].data_ptr(), tab["cl_count"].data_ptr(),
                        tab["scene_aabb"].data_ptr(), k, ts.tris_per_cluster]
    gptr, mptr, kg = args[7:]
    if edge in ("below_rule", "forced_flat"):
        assert (gptr, mptr, kg) == (None, None, 0) and "cl_mboxes" not in tab
        return
    assert gptr == tab["cl_gboxes"].data_ptr() and kg == ts.cl_gboxes.shape[1] >= 1
    assert mptr == tab["cl_mboxes"].data_ptr() and mptr % 16 == 0
    assert torch.equal(tab["cl_mboxes"], ts.cl_mboxes)
    if edge == "misaligned":
        assert mptr != ts.cl_mboxes.data_ptr()
