"""Port fused frame (ops/frame.py, its plain version on the CPU) against the
JAX package and against the port's own composed path, case by case after
tests/test_pallas_frame.py at its sizes (32x32 / 24x24, 2 bounces).

Every case feeds both packages the same scene tables (the JAX build carried
across as numpy arrays), lights, environment and camera. Tolerance, as in
tests/test_pallas_frame.py: rel = |a - b| / max(|a|, 1e-2) < 1e-3 on the
direct and the env image separately (< 2e-3 for the multi-light lat-long
case and the multi-resolution wrap case). Both packages draw the same
TEA/LCG numbers, so the images differ only by float32 rounding; the JAX
fused kernel in interpret mode also uses polynomial atan2/acos.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from pg2024_dprt_tpu.core import Camera as JCamera
from pg2024_dprt_tpu.ops.pallas_frame import fused_frame_supported as j_supported
from pg2024_dprt_tpu.ops.pallas_frame import render_frame_fused as j_fused
from pg2024_dprt_tpu.render import RenderConfig as JConfig
from pg2024_dprt_tpu.render.engine import render_sample as j_sample
from pg2024_dprt_tpu.scene import MeshGeometry as JMesh
from pg2024_dprt_tpu.scene import cornell_box as j_cornell
from pg2024_dprt_tpu.scene import device_scene_from_meshes as j_build
from pg2024_dprt_tpu.scene.lights import EnvironmentMap as JEnv
from pg2024_dprt_tpu.scene.lights import LightTable as JLights
from pg2024_dprt_tpu.scene.textures import checkerboard
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.core import Camera
from pg2024_dprt_tpu_torch.ops import (
    fused_frame_supported, render_frame_fused, render_sample_fused)
from pg2024_dprt_tpu_torch.render import RenderConfig, render_image, render_sample

_LIGHTS3 = (
    np.asarray([[[0.3, 0.99, 0.3], [0.7, 0.99, 0.3], [0.7, 0.99, 0.7]],
                [[0.1, 0.99, 0.1], [0.3, 0.99, 0.1], [0.3, 0.99, 0.3]],
                [[0.7, 0.99, 0.7], [0.9, 0.99, 0.7], [0.9, 0.99, 0.9]]], np.float32),
    np.asarray([[40, 40, 40], [10, 30, 10], [30, 10, 10]], np.float32))
_CAM = ([0.5, 0.5, 2.4], [0.5, 0.5, 0.0], [0, 1, 0], 40.0)
_CAM_FLOOR = ([0.5, 0.9, 2.2], [0.5, 0.2, 0.0], [0, 1, 0], 45.0)

# name -> scene, lights, env, camera, size, sample, config, tolerance
CASES = {
    "cornell": dict(sample=0),
    "water_box": dict(water=True, sample=3),
    # 24x24 = 576 rays (no multiple of a tile), 3 lights, rotated lat-long env
    "pad_multilight_envmap": dict(lights=_LIGHTS3, env="latlong", size=24, sample=11,
                                  tol=2e-3),
    "checkerboard_floor": dict(textures="checker", cam=_CAM_FLOOR, sample=2),
    # two textures of other resolutions, uv in [0, 1.7): wrap addressing
    "multires_wrap": dict(textures="two", back_tex=1, uv_scale=1.7,
                          cam=([0.5, 0.7, 2.3], [0.5, 0.3, 0.0], [0, 1, 0], 45.0),
                          env=(0.15, 0.2, 0.25), size=24, sample=5, tol=2e-3),
    "nee_sum": dict(water=True, sample=1, cfg=dict(nee_mode="sum")),
    "nee_ris_two_candidates": dict(sample=4, cfg=dict(nee_mode="ris", shadow_path_count=2)),
    "roulette": dict(sample=7, cfg=dict(russian_roulette=1, bounces=3)),
    "nee_sum_roulette_textured": dict(water=True, textures="checker", cam=_CAM_FLOOR, sample=9,
                                      cfg=dict(nee_mode="sum", russian_roulette=2, bounces=3)),
}


def _arrays(rec):
    return {k: np.asarray(v) for k, v in rec._asdict().items() if isinstance(v, jax.Array)}


def _images(kind):
    if kind == "checker":
        return [checkerboard(tiles=4)]
    if kind == "cutout":
        img = np.ones((16, 16, 4), np.float32)
        img[4:12, 4:12, 3] = 0.0
        return [img]
    rng = np.random.default_rng(7)
    return [rng.uniform(0.05, 1.0, (24, 40, 3)).astype(np.float32),
            checkerboard(res=48, tiles=3)]


def _jax_scene(water=False, textures=None, back_tex=-1, uv_scale=1.0):
    """The JAX cornell scene, optionally with uv-mapped floor (and back
    wall) textures, as tests/test_pallas_frame.py builds it."""
    meshes, lights = j_cornell(with_water_sphere=water)
    if textures is None:
        return j_build(meshes), lights
    uv = uv_scale * np.asarray(
        [[0, 0], [0, 1], [1, 1], [0, 0], [1, 1], [1, 0]], np.float32)

    def retex(m, ti):
        reps = (len(m.v0) // 2, 1)
        return JMesh(v0=m.v0, v1=m.v1, v2=m.v2, uv0=np.tile(uv[0::3], reps),
                     uv1=np.tile(uv[1::3], reps), uv2=np.tile(uv[2::3], reps),
                     base_color=m.base_color, texture_index=ti, name=m.name)

    meshes[0] = retex(meshes[0], 0)
    if back_tex >= 0:
        meshes[1] = retex(meshes[1], back_tex)
    return j_build(meshes, textures=_images(textures)), lights


def port_scene(js):
    """The JAX scene's tables and textures as the port's DeviceScene (CPU)."""
    arrays = _arrays(js)
    if js.albedo_textures is not None:
        arrays["albedo_textures"] = _arrays(js.albedo_textures)
    return tscene.device_scene_from_arrays(arrays, device="cpu")


@functools.lru_cache(maxsize=None)
def _case(name):
    """((jax scene, lights, env, camera, cfg), (port ...), sample, tol)."""
    c = CASES[name]
    js, jl = _jax_scene(c.get("water", False), c.get("textures"),
                        c.get("back_tex", -1), c.get("uv_scale", 1.0))
    if "lights" in c:
        jl = JLights.from_arrays(*c["lights"])
    tl = tscene.light_table_from_arrays(_arrays(jl), device="cpu")
    env = c.get("env", (0.2, 0.3, 0.4))
    if env == "latlong":
        img = np.random.default_rng(0).uniform(0.0, 1.0, (16, 32, 3)).astype(np.float32) ** 2 * 2.0
        je = JEnv.from_image(img, rotation_offset=2.007)
        te = tscene.EnvironmentMap.from_image(img, rotation_offset=2.007, device="cpu")
    else:
        je = JEnv.constant(env)
        te = tscene.EnvironmentMap.constant(env, device="cpu")
    size = c.get("size", 32)
    cam = c.get("cam", _CAM)
    kw = {**dict(width=size, height=size, spp=1, bounces=2), **c.get("cfg", {})}
    jax_side = (js, jl, je, JCamera.look_at(*cam, size, size),
                JConfig(fused_frame="off", tracer="stackless", **kw))
    port_side = (port_scene(js), tl, te, Camera.look_at(*cam, size, size, device="cpu"),
                 RenderConfig(**kw))
    return jax_side, port_side, c["sample"], c.get("tol", 1e-3)


@functools.lru_cache(maxsize=None)
def _port_fused(name):
    """(direct, env) of the port's fused plain version for a case, numpy."""
    _, (ts, tl, te, tc, cfg), sample, _ = _case(name)
    d, e, diag = render_sample_fused(ts, tl, te, tc, sample, cfg)
    assert diag == 0
    return d.numpy(), e.numpy()


def _close(got, want, tol):
    for a, b in zip(want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.isfinite(b).all()
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-2)
        assert rel.max() < tol, rel.max()


@pytest.mark.parametrize("name", list(CASES))
def test_fused_plain_matches_jax_composed(name):
    """The port's fused frame against the JAX composed render_sample
    (fused_frame="off", tracer="stackless")."""
    (js, jl, je, jc, jcfg), port, sample, tol = _case(name)
    assert fused_frame_supported(*port[:3], port[4])
    d0, e0, _ = j_sample(js, jl, je, jc, sample, jcfg)
    got = _port_fused(name)
    assert got[0].max() > 0.05
    _close(got, (d0, e0), tol)


@pytest.mark.parametrize("name", list(CASES))
def test_fused_plain_matches_port_composed(name):
    """The port's fused frame against the port's own composed path."""
    _, (ts, tl, te, tc, cfg), sample, tol = _case(name)
    d0, e0, _ = render_sample(ts, tl, te, tc, sample,
                              dataclasses.replace(cfg, fused_frame="off"))
    _close(_port_fused(name), (d0.numpy(), e0.numpy()), tol)


@pytest.mark.parametrize("name", ["cornell", "water_box", "checkerboard_floor"])
def test_fused_plain_matches_jax_fused_interpret(name):
    """The port's fused frame against the JAX megakernel in interpret mode."""
    (js, jl, je, jc, jcfg), _, sample, tol = _case(name)
    assert j_supported(js, jl, je, jcfg)
    d0, e0, _ = j_fused(js, jl, je, jc, sample, jcfg, spp=1, interpret=True)
    _close(_port_fused(name), (d0, e0), tol)


def test_fused_spp_batch():
    """spp 3 in ONE call equals the sum of three composed samples, in the
    JAX package and in the port."""
    (js, jl, je, jc, jcfg), (ts, tl, te, tc, cfg), _, tol = _case("cornell")
    cfg3 = dataclasses.replace(cfg, spp=3)
    got = render_frame_fused(ts, tl, te, tc, 5, cfg3, spp=3)
    jax_sum, port_sum = [0.0, 0.0], [0.0, 0.0]
    for s in range(3):
        jd, je_, _ = j_sample(js, jl, je, jc, 5 + s, jcfg)
        td, te_, _ = render_sample(ts, tl, te, tc, 5 + s,
                                   dataclasses.replace(cfg, fused_frame="off"))
        for acc, add in ((jax_sum, (jd, je_)), (port_sum, (td.numpy(), te_.numpy()))):
            acc[0] = acc[0] + np.asarray(add[0])
            acc[1] = acc[1] + np.asarray(add[1])
    got = (got[0].numpy(), got[1].numpy())
    _close(got, jax_sum, tol)
    _close(got, port_sum, tol)


def test_fused_gate_rejects_cutout_textures():
    """Alpha-cutout texture pools stay on the composed path in both
    packages: the fused trace has no re-trace past transparent hits."""
    js, jl = _jax_scene(textures="cutout")
    ts = port_scene(js)
    assert js.albedo_textures.has_cutout and ts.has_cutout
    tl = tscene.light_table_from_arrays(_arrays(jl), device="cpu")
    te = tscene.EnvironmentMap.constant((0.2, 0.3, 0.4), device="cpu")
    cfg = RenderConfig(width=32, height=32)
    assert not j_supported(js, jl, JEnv.constant((0.2, 0.3, 0.4)), JConfig(width=32, height=32))
    assert not fused_frame_supported(ts, tl, te, cfg)
    cam = Camera.look_at(*_CAM, 32, 32, device="cpu")
    with pytest.raises(ValueError, match="fused frame does not take"):
        render_sample_fused(ts, tl, te, cam, 0, cfg)


def test_fused_gate_accepts_big_env():
    """A 64x64 env map is past the JAX gate's VMEM limit only; the port's
    gate accepts it and the fused frame equals the port's composed path."""
    (js, jl, _, _, jcfg), (ts, tl, _, tc, cfg), _, _ = _case("cornell")
    img = np.random.default_rng(3).uniform(0.0, 1.5, (64, 64, 3)).astype(np.float32)
    assert not j_supported(js, jl, JEnv.from_image(img), jcfg)
    te = tscene.EnvironmentMap.from_image(img, rotation_offset=0.7, device="cpu")
    assert fused_frame_supported(ts, tl, te, cfg)
    kw = dict(spp=2, bounces=3)
    fused = render_image(ts, tl, te, tc, dataclasses.replace(cfg, fused_frame="on", **kw),
                         device="cpu")
    composed = render_image(ts, tl, te, tc, dataclasses.replace(cfg, fused_frame="off", **kw),
                            device="cpu")
    assert fused.shape == (32, 32, 3)
    np.testing.assert_allclose(fused.numpy(), composed.numpy(), rtol=1e-3, atol=1e-4)


def test_engine_routes_by_fused_frame(monkeypatch):
    """fused_frame="auto" composes for CPU tensors; "on" runs the plain fused
    version; an unknown value raises; render_sample routes one sample."""
    _, (ts, tl, te, tc, cfg), sample, _ = _case("cornell")
    from pg2024_dprt_tpu_torch.ops import frame as frame_mod
    from pg2024_dprt_tpu_torch.render import engine

    on = dataclasses.replace(cfg, fused_frame="on")
    assert not engine._fused_active(ts, tl, te, cfg)                      # auto, CPU
    assert engine._fused_active(ts, tl, te, on)
    assert not engine._fused_active(ts, tl, te, dataclasses.replace(cfg, fused_frame="off"))
    with pytest.raises(ValueError, match="unknown fused_frame"):
        render_image(ts, tl, te, tc, dataclasses.replace(cfg, fused_frame="maybe"), device="cpu")
    calls = []
    real = frame_mod.render_frame_fused_plain
    monkeypatch.setattr(frame_mod, "render_frame_fused_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    d, _, _ = render_sample(ts, tl, te, tc, sample, on)
    render_sample(ts, tl, te, tc, sample, cfg)
    assert calls == [1]
    np.testing.assert_array_equal(d.numpy(), _port_fused("cornell")[0])
