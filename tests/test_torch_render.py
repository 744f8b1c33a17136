"""Port composed frame vs the JAX package: the cornell golden render, the
shade stage on identical inputs, and whole frames on a triangle soup
against JAX render_image (fused_frame="off") for both NEE estimators and
with Russian roulette.

Tolerance for images: rtol 1e-3 / atol 1e-4 (the golden bar of
tests/test_render_single.py). Both packages draw the same TEA/LCG numbers,
so the images differ only by float32 rounding (operation order, libm)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg2024_dprt_tpu.core import Camera as JCamera
from pg2024_dprt_tpu.render import RenderConfig as JConfig
from pg2024_dprt_tpu.render import render_image as j_render
from pg2024_dprt_tpu.render.pathgen import generate_camera_paths as j_paths
from pg2024_dprt_tpu.render.shade import shade as j_shade
from pg2024_dprt_tpu.scene import device_scene_from_meshes as j_build
from pg2024_dprt_tpu.scene import random_tri_soup
from pg2024_dprt_tpu.scene.lights import EnvironmentMap as JEnv
from pg2024_dprt_tpu.scene.lights import LightTable as JLights
from pg2024_dprt_tpu.ops.traversal import traverse_bvh
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.core import Camera, HitRecord
from pg2024_dprt_tpu_torch.render import RenderConfig, Renderer, render_image, shade
from pg2024_dprt_tpu_torch.render.pathgen import generate_camera_paths
from pg2024_dprt_tpu_torch.utils import read_exr

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cornell_32x32_spp2_b3.exr")


def _arrays(rec):
    return {k: np.asarray(v) for k, v in rec._asdict().items() if isinstance(v, jax.Array)}


def _soup_pair(size=32):
    """A 700-triangle soup under an area light (the frame benchmark's scene,
    cut to size) in both packages, on identical tables."""
    js = j_build([random_tri_soup(700, seed=3)])
    lt = np.asarray([[[0.3, 2.0, 0.3], [0.7, 2.0, 0.3], [0.7, 2.0, 0.7]]], np.float32)
    le = np.asarray([[60.0, 60.0, 60.0]], np.float32)
    cam_args = ([0.5, 0.5, 3.0], [0.5, 0.5, 0.5], [0, 1, 0], 45.0, size, size)
    jax_side = (js, JLights.from_arrays(lt, le), JEnv.constant((0.4, 0.5, 0.7)),
                JCamera.look_at(*cam_args))
    port_side = (tscene.device_scene_from_arrays(_arrays(js), device="cpu"),
                 tscene.LightTable.from_arrays(lt, le, device="cpu"),
                 tscene.EnvironmentMap.constant((0.4, 0.5, 0.7), device="cpu"),
                 Camera.look_at(*cam_args, device="cpu"))
    return jax_side, port_side


def test_golden_cornell_port():
    """The port's cornell render on the CPU matches the committed golden
    EXR (rtol 1e-3 / atol 1e-4)."""
    meshes, lights = tscene.cornell_box(device="cpu")
    scene = tscene.device_scene_from_meshes(meshes, device="cpu")
    env = tscene.EnvironmentMap.constant((0.2, 0.3, 0.4), device="cpu")
    cam = Camera.look_at([0.5, 0.5, 2.4], [0.5, 0.5, 0.0], [0, 1, 0], 40.0, 32, 32, device="cpu")
    cfg = RenderConfig(width=32, height=32, spp=2, bounces=3)
    img = render_image(scene, lights, env, cam, cfg, device="cpu").numpy()
    golden, names = read_exr(GOLDEN)
    golden = golden[:, :, [names.index(c) for c in ("R", "G", "B")]]
    np.testing.assert_allclose(img, golden, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("nee_mode", ["sum", "ris"])
def test_shade_matches_jax(nee_mode):
    """One shade pass on identical camera paths and hits: next paths,
    shadow paths and env image within 1e-5 (float32 rounding), masks and
    pixel ids exact."""
    (js, jl, je, jc), (ts, tl, te, tc) = _soup_pair()
    jp = j_paths(jc, 3)
    jh = traverse_bvh(js, jp.origin, jp.direction, 1e-3, jp.tmax, jp.is_valid)
    tp = generate_camera_paths(tc, 3)
    th = HitRecord(*(torch.as_tensor(np.array(x)) for x in jh))
    jn, jsh, jenv = j_shade(js, jl, je, jp, jh, 3, 1, 4, 1024, nee_mode=nee_mode, rr=True)
    tn, tsh, tenv = shade(ts, tl, te, tp, th, 3, 1, 4, 1024, nee_mode=nee_mode, rr=True)
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    close(tenv, jenv)
    for t_rec, j_rec in ((tn, jn), (tsh, jsh)):
        for f in ("is_valid", "is_delta", "is_shadow", "pixel_index", "shadow_path_id"):
            np.testing.assert_array_equal(getattr(t_rec, f).numpy(), np.asarray(getattr(j_rec, f)),
                                          err_msg=f)
        for f in ("origin", "direction", "tmax", "throughput"):
            close(getattr(t_rec, f), getattr(j_rec, f))
    assert tsh.is_valid.any() and tn.is_valid.any()


@pytest.mark.parametrize("nee_mode,rr", [("sum", 0), ("ris", 0), ("ris", 2)])
def test_frame_matches_jax(nee_mode, rr):
    """Whole frame (32x32, spp 2, 3 bounces) against JAX render_image with
    fused_frame="off", rtol 1e-3 / atol 1e-4."""
    (js, jl, je, jc), port = _soup_pair()
    kw = dict(width=32, height=32, spp=2, bounces=3, nee_mode=nee_mode, russian_roulette=rr)
    want = np.asarray(j_render(js, jl, je, jc, JConfig(fused_frame="off", **kw)))
    got = render_image(*port, RenderConfig(fused_frame="off", **kw), device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert got.max() > 0.05


@pytest.mark.parametrize("compression,pixel_type", [("none", "float"), ("zip", "half")])
def test_exr_writes_the_jax_bytes(tmp_path, compression, pixel_type):
    """write_exr gives the JAX package's file byte for byte, and read_exr
    reads it back (exactly, or to half precision)."""
    from pg2024_dprt_tpu.utils.exr import write_exr as j_write
    from pg2024_dprt_tpu_torch.utils import write_exr

    img = np.random.RandomState(4).rand(5, 7, 3).astype(np.float32)
    ours, theirs = tmp_path / "port.exr", tmp_path / "jax.exr"
    write_exr(str(ours), img, compression=compression, pixel_type=pixel_type)
    j_write(str(theirs), img, compression=compression, pixel_type=pixel_type)
    assert ours.read_bytes() == theirs.read_bytes()
    back, names = read_exr(str(ours))
    back = back[:, :, [names.index(c) for c in ("R", "G", "B")]]
    want = img if pixel_type == "float" else img.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(back, want)


def test_renderer_and_unported_options():
    _, (ts, tl, te, tc) = _soup_pair(size=16)
    cfg = RenderConfig(width=16, height=16, spp=1, bounces=2)
    r = Renderer(ts, tl, te, tc, cfg, device="cpu")
    np.testing.assert_array_equal(r.render().numpy(),
                                  render_image(ts, tl, te, tc, cfg, device="cpu").numpy())
    img, stats = render_image(ts, tl, te, tc, cfg, return_stats=True, device="cpu")
    assert stats == {"tracer_diag": 0}
    # fused_frame="on" runs the fused frame's plain version on CPU tensors
    fused = render_image(ts, tl, te, tc, dataclasses.replace(cfg, fused_frame="on"), device="cpu")
    np.testing.assert_allclose(fused.numpy(), img.numpy(), rtol=1e-3, atol=1e-4)
    # every tracer name of the JAX package renders; the retired pair tracer
    # is rejected by name, as in JAX
    stackless = render_image(ts, tl, te, tc, dataclasses.replace(cfg, tracer="stackless"),
                             device="cpu")
    np.testing.assert_allclose(stackless.numpy(), img.numpy(), rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError, match="retired"):
        render_image(ts, tl, te, tc, RenderConfig(width=16, height=16, tracer="pallas"),
                     device="cpu")


def test_profile_sample_has_jax_sections():
    """utils/profile.py profile_sample: JAX's section names, one entry per
    bounce each (host seconds have no parity)."""
    from pg2024_dprt_tpu.utils.profile import profile_sample as j_profile
    from pg2024_dprt_tpu_torch.utils.profile import profile_sample

    (js, jl, je, jc), port = _soup_pair(size=16)
    kw = dict(width=16, height=16, spp=1, bounces=3)
    got = profile_sample(*port, RenderConfig(**kw), sample_count=1)
    want = j_profile(js, jl, je, jc, JConfig(**kw), sample_count=1)
    assert set(got.totals) == set(want.totals) == {"Traversal", "Shade", "Shadow"}
    assert dict(got.counts) == dict(want.counts) == {k: 3 for k in want.counts}
    assert all(v > 0.0 for v in got.totals.values())
    assert "Traversal" in got.report()
