"""Port textures and cutouts against the JAX package: the packed pool and
the bilinear wrap sample (within 1e-6: float32 rounding of identical
formulas), the cutout re-trace of ops/trace_api.py on identical tables (flags,
ids and diag exact, t within 1e-5), and a cutout-textured cornell frame
through the composed path against JAX render_image (rtol 1e-3 / atol 1e-4,
the bar of tests/test_torch_render.py, with equal tracer_diag)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg2024_dprt_tpu.core import Camera as JCamera
from pg2024_dprt_tpu.ops import trace_api as j_api
from pg2024_dprt_tpu.render import RenderConfig as JConfig
from pg2024_dprt_tpu.render import render_image as j_render
from pg2024_dprt_tpu.scene import MeshGeometry as JMesh
from pg2024_dprt_tpu.scene import cornell_box as j_cornell
from pg2024_dprt_tpu.scene import device_scene_from_meshes as j_build
from pg2024_dprt_tpu.scene import textures as jtex
from pg2024_dprt_tpu.scene.lights import EnvironmentMap as JEnv
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.core import Camera
from pg2024_dprt_tpu_torch.ops import trace_api as t_api
from pg2024_dprt_tpu_torch.render import RenderConfig, render_image
from pg2024_dprt_tpu_torch.scene import textures as ttex

_UV6 = np.asarray([[0, 0], [0, 1], [1, 1], [0, 0], [1, 1], [1, 0]], np.float32)


def _arrays(rec):
    return {k: np.asarray(v) for k, v in rec._asdict().items() if isinstance(v, jax.Array)}


def _image_sets(kind):
    rng = np.random.default_rng(11)
    if kind == "rgb_rgba_gray":
        rgba = rng.uniform(0.0, 1.0, (9, 13, 4)).astype(np.float32)
        rgba[:, :, 3] = 0.5 + 0.5 * rgba[:, :, 3]          # opaque enough
        return [rng.uniform(0.0, 1.0, (24, 40, 3)).astype(np.float32), rgba,
                rng.uniform(0.0, 1.0, (7, 5)).astype(np.float32)], 2048
    if kind == "cutout":
        img = np.ones((16, 16, 4), np.float32)
        img[4:12, 4:12, 3] = 0.0
        return [jtex.checkerboard(res=32, tiles=4), img], 2048
    # odd sizes past max_res: edge-padded integer box filter, twice for one;
    # the second keeps a transparent block through the filter
    wide = rng.uniform(0.0, 1.0, (8, 70, 4)).astype(np.float32)
    wide[:, :24, 3] = 0.0
    return [rng.uniform(0.0, 1.0, (37, 21, 3)).astype(np.float32), wide], 16


def _port_tex(jt):
    return tscene.packed_textures_from_arrays(_arrays(jt), device="cpu")


@pytest.mark.parametrize("kind", ["rgb_rgba_gray", "cutout", "box_down"])
def test_build_textures_equals_jax(kind):
    """Packed texels and the offset/height/width/cutout tables equal the JAX
    pool's (within 1e-6; the integer tables exactly), and has_cutout agrees."""
    images, max_res = _image_sets(kind)
    jt = jtex.build_textures(images, max_res=max_res)
    tt = ttex.build_textures(images, max_res=max_res, device="cpu")
    assert tt.count == jt.count == len(images)
    assert tt.has_cutout == jt.has_cutout == (kind != "rgb_rgba_gray")
    np.testing.assert_allclose(tt.texels.numpy(), np.asarray(jt.texels), rtol=0, atol=1e-6)
    for f in ("offset", "height", "width", "cutout_rows"):
        got = getattr(tt, f)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jt, f)), err_msg=f)
    carried = _port_tex(jt)
    for a, b in zip(carried, tt):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_empty_pool_and_checkerboard():
    assert ttex.build_textures([], device="cpu").count == 0
    assert not ttex.build_textures([], device="cpu").has_cutout
    assert _port_tex(jtex.build_textures([])) is None
    for kw in (dict(), dict(res=48, tiles=3), dict(res=20, tiles=5, color_a=(1, 0, 0))):
        np.testing.assert_array_equal(ttex.checkerboard(**kw), jtex.checkerboard(**kw))


@pytest.mark.parametrize("kind", ["rgb_rgba_gray", "cutout", "box_down"])
def test_sample_textures_matches_jax(kind):
    """Bilinear wrap samples within 1e-6 of JAX on random uv, negatives and
    values past 1 included, and on texel centres and edges."""
    images, max_res = _image_sets(kind)
    jt = jtex.build_textures(images, max_res=max_res)
    tt = _port_tex(jt)
    rng = np.random.default_rng(12)
    n = 4096
    ti = rng.integers(-1, len(images), n).astype(np.int32)
    u = rng.uniform(-3.0, 4.0, n).astype(np.float32)
    v = rng.uniform(-3.0, 4.0, n).astype(np.float32)
    u[:64] = np.linspace(-1.0, 2.0, 64, dtype=np.float32)      # centres and edges
    v[:64] = np.float32(0.5)
    want = np.asarray(jtex.sample_textures(jt, jnp.asarray(ti), jnp.asarray(u), jnp.asarray(v)))
    got = ttex.sample_textures(tt, torch.as_tensor(ti), torch.as_tensor(u), torch.as_tensor(v))
    assert got.shape == (n, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _retex(mesh_cls, m, ti):
    reps = (len(m.v0) // 2, 1)
    return mesh_cls(v0=m.v0, v1=m.v1, v2=m.v2, uv0=np.tile(_UV6[0::3], reps),
                    uv1=np.tile(_UV6[1::3], reps), uv2=np.tile(_UV6[2::3], reps),
                    base_color=m.base_color, texture_index=ti, name=m.name)


def test_scene_build_with_textures_equals_jax():
    """device_scene_from_meshes(textures=...) packs the JAX tables (uv and
    texture index in tri_shade) and pool, exactly."""
    images, _ = _image_sets("cutout")
    jm, _ = j_cornell()
    jm[0] = _retex(JMesh, jm[0], 1)
    js = j_build(jm, textures=images)
    tm, _ = tscene.textured_cornell_box(floor_tex=1, device="cpu")
    ts = tscene.device_scene_from_meshes(tm, textures=images, device="cpu")
    assert ts.textured and ts.has_cutout
    ja = _arrays(js)
    for name in tscene.DeviceScene._fields:
        if name != "albedo_textures":
            np.testing.assert_array_equal(getattr(ts, name).numpy(), ja[name], err_msg=name)
    assert (ts.tri_shade[:, 19] >= 0).sum() == 2
    for a, b in zip(ts.albedo_textures, _port_tex(js.albedo_textures)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    plain = tscene.device_scene_from_meshes(tm, device="cpu")
    assert not plain.textured and not plain.has_cutout and plain.albedo_textures is None


def _stacked_cutout_scene(layers):
    """`layers` parallel unit quads at z = 0.1 .. , all carrying a texture
    whose centre is transparent: a ray through the centres needs one re-trace
    per layer."""
    img = np.ones((16, 16, 4), np.float32)
    img[4:12, 4:12, 3] = 0.0
    meshes = []
    for i in range(layers):
        z = 0.1 * (i + 1)
        p = np.asarray([[0, 0, z], [1, 0, z], [1, 1, z], [0, 1, z]], np.float32)
        meshes.append(JMesh(
            v0=np.stack([p[0], p[0]]), v1=np.stack([p[1], p[2]]), v2=np.stack([p[2], p[3]]),
            uv0=_UV6[[0, 0]], uv1=np.asarray([[1, 0], [1, 1]], np.float32),
            uv2=np.asarray([[1, 1], [0, 1]], np.float32), texture_index=0, name=f"q{i}"))
    return j_build(meshes, textures=[img])


@pytest.mark.parametrize("layers,max_hops", [(2, 4), (6, 4), (3, 2)])
def test_cutout_retrace_matches_jax(layers, max_hops):
    """trace_closest_cutout / trace_occlusion_cutout against JAX on stacked
    cutout quads: rays through the holes settle behind the stack or, past
    max_hops re-traces, report a miss that diag counts; rays off the holes
    stop at the first layer."""
    js = _stacked_cutout_scene(layers)
    arrays = _arrays(js)
    arrays["albedo_textures"] = _arrays(js.albedo_textures)
    ts = tscene.device_scene_from_arrays(arrays, device="cpu")
    rng = np.random.default_rng(13)
    n = 512
    o = np.concatenate([rng.uniform(0.02, 0.98, (n, 2)), np.full((n, 1), -1.0)], 1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    d[:, :2] += rng.normal(0, 0.02, (n, 2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    act = rng.random(n) > 0.1
    jh, jd = j_api.trace_closest_cutout(js, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e30,
                                        jnp.asarray(act), tracer="stackless", max_hops=max_hops)
    th, td = t_api.trace_closest_cutout(ts, torch.as_tensor(o), torch.as_tensor(d), 1e-3, 1e30,
                                        torch.as_tensor(act), max_hops=max_hops)
    assert int(td) == int(jd)
    assert (int(td) > 0) == (layers > max_hops)
    np.testing.assert_array_equal(th.is_hit.numpy(), np.asarray(jh.is_hit))
    np.testing.assert_array_equal(th.tri_index.numpy(), np.asarray(jh.tri_index))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-5, atol=1e-5)
    assert th.is_hit.any() and (~th.is_hit[torch.as_tensor(act)]).any()
    jo, jd2 = j_api.trace_occlusion_cutout(js, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e30,
                                           jnp.asarray(act), tracer="stackless", max_hops=max_hops)
    to, td2 = t_api.trace_occlusion_cutout(ts, torch.as_tensor(o), torch.as_tensor(d), 1e-3, 1e30,
                                           torch.as_tensor(act), max_hops=max_hops)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert int(td2) == int(jd2)


@pytest.mark.parametrize("nee_mode", ["ris", "sum"])
def test_cutout_cornell_frame_matches_jax(nee_mode):
    """A cornell whose floor carries a cutout texture, through the composed
    path with the cutout re-trace, against JAX render_image; tracer_diag
    equal. The default fused_frame="auto" composes here because the gate
    rejects cutouts."""
    images, _ = _image_sets("cutout")
    jm, jl = j_cornell()
    jm[0] = _retex(JMesh, jm[0], 1)
    jm[2] = _retex(JMesh, jm[2], 0)
    js = j_build(jm, textures=images)
    arrays = _arrays(js)
    arrays["albedo_textures"] = _arrays(js.albedo_textures)
    ts = tscene.device_scene_from_arrays(arrays, device="cpu")
    tl = tscene.light_table_from_arrays(_arrays(jl), device="cpu")
    cam = ([0.5, 0.9, 2.2], [0.5, 0.2, 0.0], [0, 1, 0], 45.0, 32, 32)
    kw = dict(width=32, height=32, spp=2, bounces=2, nee_mode=nee_mode)
    want, jstats = j_render(js, jl, JEnv.constant((0.2, 0.3, 0.4)), JCamera.look_at(*cam),
                            JConfig(fused_frame="off", tracer="stackless", **kw),
                            return_stats=True)
    got, tstats = render_image(ts, tl, tscene.EnvironmentMap.constant((0.2, 0.3, 0.4), device="cpu"),
                               Camera.look_at(*cam, device="cpu"), RenderConfig(**kw),
                               return_stats=True, device="cpu")
    assert tstats == jstats
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    # the holes show: the same frame with opaque textures differs
    opaque = render_image(ts._replace(albedo_textures=ts.albedo_textures._replace(
        texels=ts.albedo_textures.texels.clamp(min=1.0) * torch.tensor([0, 0, 0, 1.0])
        + ts.albedo_textures.texels * torch.tensor([1.0, 1.0, 1.0, 0]),
        cutout_rows=torch.zeros((0,), dtype=torch.int32))),
        tl, tscene.EnvironmentMap.constant((0.2, 0.3, 0.4), device="cpu"),
        Camera.look_at(*cam, device="cpu"), RenderConfig(fused_frame="off", **kw), device="cpu")
    assert float((opaque - got).abs().max()) > 1e-2
