"""The port's distributed frame (pg2024_dprt_tpu_torch/parallel/distributed.py)
against the JAX package's (pg2024_dprt_tpu/parallel/distributed.py under
shard_map on the virtual 8-device CPU mesh of tests/conftest.py), on the
same scene, camera, config and net weights, and against the port's own
single-device frame.

Tolerance for images: rtol 1e-3 / atol 1e-4, the frame tolerance of
tests/test_torch_render.py (both packages draw the same TEA/LCG numbers;
the images differ by float32 rounding). The stats (tracer diag, truncated
paths, overflow waits, grid-culled candidates) are integers and equal.
The rank frames (one partition a gloo rank on the CPU, parallel/mesh.py
RankMesh, spawned by parallel/spawn.py run_ranks; the ranks' code is
tests/torch_rank_workers.py) are held against the same JAX frames, and
their migration rounds against the in-process frame's.
Neural mode: the nets' vis heads are shifted by +10 (every marched proxy
predicts a hit) and the depth heads by +10 (predicted remote hits lie far
behind the local ones), so that no routing decision sits within the nets'
rounding of a threshold, as the JAX package's own neural tests do.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg2024_dprt_tpu.core import Camera as JCamera
from pg2024_dprt_tpu.models import mlp as jmlp
from pg2024_dprt_tpu.models import proxy as jproxy
from pg2024_dprt_tpu.models import random_proxy_models as j_random_models
from pg2024_dprt_tpu.parallel import make_mesh as j_make_mesh
from pg2024_dprt_tpu.parallel import render_image_distributed as j_render_dist
from pg2024_dprt_tpu.render import RenderConfig as JConfig
from pg2024_dprt_tpu.scene import build_partitioned_scene as j_partition
from pg2024_dprt_tpu.scene import two_room_scene as j_rooms
from pg2024_dprt_tpu.scene.lights import EnvironmentMap as JEnv
import torch_rank_workers as w
from pg2024_dprt_tpu_torch import models as tmodels
from pg2024_dprt_tpu_torch import ops as tops
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.core import Camera
from pg2024_dprt_tpu_torch.models import mlp as tmlp
from pg2024_dprt_tpu_torch.parallel import make_mesh, render_image_distributed, run_ranks
from pg2024_dprt_tpu_torch.render import RenderConfig, render_image
from pg2024_dprt_tpu_torch.utils.timing import Timing

SIDE = 24
CAM = ([2.5, 1.4, 5.5], [2.5, 0.6, 0.5], [0, 1, 0], 60.0, SIDE, SIDE)
ENV = (0.25, 0.25, 0.3)
JAX_STATS = ("tracer_diag", "migration_truncated", "migration_overflow_waits", "grid_culled")
# the port's own counters (parallel/distributed.py)
PORT_STATS = ("exchange_bytes", "exchange_useful_bytes", "route_queries", "route_remote",
              "host_syncs")
# bytes a row: a migrating path's 16 PathState fields; a shadow ray's origin,
# direction, tmax and valid flag out, and its occlusion flag back
PATH_ROW, SHADOW_ROW = 96, 3 * 4 + 3 * 4 + 4 + 1 + 1
STAGES = ("neural_route", "migration", "settle_shade", "shadows")
SMALL = tmlp.MLPConfig(width=32, depth=1)
MULTIGEO = tmlp.MLPConfig(width=32, depth=1, in_features=6, multi_geo=True)

CASES = {
    # name: (partitions, config fields, grids, models)
    "exact_p2": (2, {}, False, None),
    # grids and a small bucket: candidates culled, paths waiting and retried
    "exact_p4_grids_buckets": (4, dict(use_visibility_grids=True, bucket_fraction=0.02,
                                       max_migrations=64), True, None),
    "neural_p2_separate": (2, dict(use_neural_proxies=True), False, "separate"),
    "neural_p2_multigeo": (2, dict(use_neural_proxies=True), False, "multigeo"),
}


def _meshes(parts):
    jmeshes, jlights = j_rooms(num_rooms=parts, tris_per_room=300, seed=2)
    tm = [tscene.MeshGeometry(v0=m.v0, v1=m.v1, v2=m.v2, base_color=m.base_color, name=m.name)
          for m in jmeshes]
    _, tlights = tscene.two_room_scene(num_rooms=parts, tris_per_room=300, seed=2,
                                       device="cpu")
    return jmeshes, jlights, tm, tlights


def _models(kind, parts):
    """Port models with shifted heads, and the same weights for JAX."""
    shift = lambda d, name: {k: (v + 10.0 if k == name else v) for k, v in d.items()}
    if kind == "separate":
        m = tmodels.random_proxy_models(31, parts, SMALL, SMALL, device="cpu")
        last = "head_b1"
    else:
        rng = np.random.RandomState(37)
        cfg_d = dataclasses.replace(MULTIGEO, final_activation="leaky_relu")
        m = tmodels.multigeo_proxy_models(tmlp.init_mlp(rng, MULTIGEO, device="cpu"),
                                          tmlp.init_mlp(rng, cfg_d, device="cpu"), parts,
                                          MULTIGEO, cfg_d)
        last = "head_b2"
    m = dataclasses.replace(m, vis_params=shift(m.vis_params, last),
                            depth_params=shift(m.depth_params, last))
    jax_params = lambda d: {k: jnp.asarray(v.numpy()) for k, v in d.items()}
    jcfg = lambda c: jmlp.MLPConfig(**dataclasses.asdict(c))
    jm = jproxy.ProxyModels(jax_params(m.vis_params), jax_params(m.depth_params),
                            m.num_objects, jcfg(m.vis_cfg), jcfg(m.depth_cfg),
                            multi_geo=m.multi_geo)
    return m, jm


@pytest.fixture(scope="module")
def jax_frames():
    """Each case's JAX distributed frame and stats, rendered once."""
    out = {}
    for name, (parts, fields, grids, kind) in CASES.items():
        jmeshes, jlights, _, _ = _meshes(parts)
        jm = (_models(kind, parts)[1] if kind
              else j_random_models(jax.random.PRNGKey(0), parts))
        cfg = JConfig(width=SIDE, height=SIDE, spp=1, bounces=2, **fields)
        img, stats = j_render_dist(
            j_partition(jmeshes, parts, visibility_grids=grids, grid_res=(8, 8, 8)), jm,
            jlights, JEnv.constant(ENV), JCamera.look_at(*CAM), cfg, j_make_mesh(parts),
            return_stats=True)
        out[name] = (np.asarray(img), stats)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_distributed_frame_matches_jax(jax_frames, case):
    parts, fields, grids, kind = CASES[case]
    _, _, tm, tlights = _meshes(parts)
    part = tscene.build_partitioned_scene(tm, parts, visibility_grids=grids,
                                          grid_res=(8, 8, 8), device="cpu")
    cfg = RenderConfig(width=SIDE, height=SIDE, spp=1, bounces=2, **fields)
    models = _models(kind, parts)[0] if kind else None
    env = tscene.EnvironmentMap.constant(ENV, device="cpu")
    cam = Camera.look_at(*CAM, device="cpu")
    got, stats = render_image_distributed(part, models, tlights, env, cam, cfg,
                                          mesh=make_mesh(parts, device="cpu"),
                                          return_stats=True)
    want, want_stats = jax_frames[case]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
    assert {k: stats[k] for k in JAX_STATS} == {k: want_stats[k] for k in JAX_STATS}
    assert stats["migration_truncated"] == 0 and stats["paths_moved"] > 0
    assert len(stats["migration_rounds"]) == 1 and len(stats["migration_rounds"][0]) == 2
    if grids:
        assert stats["grid_culled"] > 0 and stats["migration_overflow_waits"] > 0
    if kind is None:
        # exact mode: the single-device frame of the same meshes
        single = render_image(tscene.device_scene_from_meshes(tm, device="cpu"), tlights,
                              env, cam, dataclasses.replace(cfg, fused_frame="off"),
                              device="cpu")
        np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("case", ["exact_p2", "exact_p4_grids_buckets", "neural_p2_separate"])
def test_rank_frame_matches_jax(jax_frames, case, tmp_path):
    """One partition a rank: every rank returns JAX's image and stats, and
    the in-process frame's migration rounds."""
    parts, fields, grids, kind = CASES[case]
    _, _, tm, tlights = _meshes(parts)
    part = tscene.build_partitioned_scene(tm, parts, visibility_grids=grids,
                                          grid_res=(8, 8, 8), device="cpu")
    cfg = RenderConfig(width=SIDE, height=SIDE, spp=1, bounces=2, **fields)
    models = _models(kind, parts)[0] if kind else None
    env = tscene.EnvironmentMap.constant(ENV, device="cpu")
    cam = Camera.look_at(*CAM, device="cpu")
    ranks = run_ranks(w.rank_frame, parts,
                      (pickle.dumps((part, models, tlights, env, cam, cfg)),),
                      str(tmp_path), deadline_s=240)
    _, in_process = render_image_distributed(part, models, tlights, env, cam, cfg,
                                             mesh=make_mesh(parts, device="cpu"),
                                             return_stats=True)
    want, want_stats = jax_frames[case]
    for img, stats in ranks:
        np.testing.assert_array_equal(img, ranks[0][0])
        np.testing.assert_allclose(img, want, rtol=1e-3, atol=1e-4)
        assert {k: stats[k] for k in JAX_STATS} == {k: want_stats[k] for k in JAX_STATS}
        assert stats["migration_rounds"] == in_process["migration_rounds"]
        assert stats["paths_moved"] == in_process["paths_moved"] > 0
        assert {k: stats[k] for k in PORT_STATS} == {k: in_process[k] for k in PORT_STATS}


@pytest.mark.parametrize("kind", [None, "separate"], ids=["exact", "neural"])
def test_frame_counters_and_spans(kind):
    """The frame's counters against their formulas and recounts, and its
    spans under a recorder: all closed, each inside its parent, one root
    whose id is the base_sample, no stage inside another, the counts the
    loop implies, a LAUNCHES key's spans as many as its launches (none on
    the CPU), and self times that add up to the root's duration."""
    parts, neural = 2, kind is not None
    _, _, tm, tlights = _meshes(parts)
    part = tscene.build_partitioned_scene(tm, parts, device="cpu")
    cfg = RenderConfig(width=SIDE, height=SIDE, spp=1, bounces=3, use_neural_proxies=neural)
    models = _models(kind, parts)[0] if neural else None
    timing = Timing()
    tops.reset_launch_counts()
    with timing.recording():
        _, st = render_image_distributed(
            part, models, tlights, tscene.EnvironmentMap.constant(ENV, device="cpu"),
            Camera.look_at(*CAM, device="cpu"), cfg, mesh=make_mesh(parts, device="cpu"),
            base_sample=5, return_stats=True)
    rounds = sum(map(sum, st["migration_rounds"]))
    npix = SIDE * SIDE
    bucket = max(1, int(npix * cfg.bucket_fraction) // parts)
    ring = 0 if neural else cfg.bounces * parts * parts * npix * SHADOW_ROW
    assert st["exchange_bytes"] == rounds * parts * parts * (bucket * PATH_ROW + 2 * 8) + ring
    shadow_useful = st["exchange_useful_bytes"] - st["paths_moved"] * PATH_ROW
    if neural:
        assert shadow_useful == 0
        # (these rooms send few secondary rays toward the other room's box:
        # tests/test_torch_route.py recounts route_remote where many go)
        assert st["route_queries"] > 0 and 0 <= st["route_remote"] <= st["route_queries"]
    else:
        assert shadow_useful > 0 and shadow_useful % (parts * SHADOW_ROW) == 0
        assert st["route_queries"] == st["route_remote"] == 0
    # one read a round (the termination test) and the stats read
    assert st["host_syncs"] == rounds + 1

    spans = timing.spans
    names = [sp[0] for sp in spans]
    assert [sp[0] for sp in spans if sp[3] < 0] == ["render_image_distributed"]
    for name, start, end, parent, frame in spans:
        assert end is not None and frame == 5
        if parent >= 0:
            assert spans[parent][1] <= start <= end <= spans[parent][2]
        if name in STAGES:
            up = parent
            while up >= 0:
                assert spans[up][0] not in STAGES, (name, spans[up][0])
                up = spans[up][3]
    count = lambda n: names.count(n)
    for n in ("migration.round", "migration.trace", "migration.exchange", "migration.sync"):
        assert count(n) == rounds
    assert count("migration") == count("settle_shade") == count("shadows") == cfg.bounces
    assert count("settle_shade.shade") == cfg.bounces * parts
    assert count("settle_shade.retrace") == (cfg.bounces - 1) * parts * neural
    assert count("neural_route") == (cfg.bounces - 1) * neural
    assert count("shadows.nn" if neural else "shadows.ring") == cfg.bounces
    assert count("reduce") == 2
    for key, launched in tops.LAUNCHES.items():
        assert count(key) == launched
    root = spans[0]
    assert sum(timing.self_seconds().values()) == pytest.approx((root[2] - root[1]) / 1e9,
                                                                abs=1e-6)


def test_neural_frame_launch_counts_and_devices():
    """On the CPU the stages compose and no kernel launches; without CUDA
    and without a device the entry point raises."""
    parts = 2
    _, _, tm, tlights = _meshes(parts)
    part = tscene.build_partitioned_scene(tm, parts, device="cpu")
    m, _ = _models("multigeo", parts)
    args = (part, m, tlights, tscene.EnvironmentMap.constant(ENV, device="cpu"),
            Camera.look_at(*CAM, device="cpu"),
            RenderConfig(width=SIDE, height=SIDE, spp=2, bounces=2, use_neural_proxies=True))
    tops.reset_launch_counts()
    img, stats = render_image_distributed(*args, device="cpu", return_stats=True)
    assert not any(tops.LAUNCHES.values())
    assert tuple(img.shape) == (SIDE, SIDE, 3) and bool(torch.isfinite(img).all())
    assert len(stats["migration_rounds"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            render_image_distributed(*args)
