"""Port scene build vs the JAX package: packed tables equal field by field
on the same meshes (both packages on the same BVH builder), lights and the
environment lookup, and the state carried across (scene/convert.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg2024_dprt_tpu.core import Camera as JCamera
from pg2024_dprt_tpu.scene import native_bvh as j_native
from pg2024_dprt_tpu.scene import procedural as jproc
from pg2024_dprt_tpu.scene.geometry import device_scene_from_meshes as j_build
from pg2024_dprt_tpu.scene.lights import EnvironmentMap as JEnv
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.scene import native_bvh as t_native


# the tensor tables of a DeviceScene (albedo_textures is a record of its own,
# held against JAX in tests/test_torch_textures.py)
_TABLES = [f for f in tscene.DeviceScene._fields if f != "albedo_textures"]


def jax_arrays(rec) -> dict:
    """A JAX record's array fields as numpy (what the port's convert takes)."""
    return {k: np.asarray(v) for k, v in rec._asdict().items() if isinstance(v, jax.Array)}


def _meshes(kind):
    if kind == "cornell":
        return jproc.cornell_box()[0], tscene.cornell_box(device="cpu")[0]
    n = {"soup700": 700, "soup5000": 5000}[kind]
    return [jproc.random_tri_soup(n, seed=20)], [tscene.random_tri_soup(n, seed=20)]


@pytest.mark.parametrize("kind,tpc", [("cornell", None), ("cornell", 16),
                                      ("soup700", None), ("soup700", 64),
                                      ("soup5000", 512)])
def test_packed_tables_equal(kind, tpc):
    """Every table the port keeps equals the JAX table of the same name,
    exactly (0 tolerance)."""
    jm, tm = _meshes(kind)
    if sum(m.num_triangles for m in tm) >= 4096:
        # scenes this size go through the native builder in both packages;
        # the python fallback cuts a different tree, so pin the builder
        assert j_native.available() and t_native.available()
    js = j_build(jm, tris_per_cluster=tpc)
    ts = tscene.device_scene_from_meshes(tm, tris_per_cluster=tpc, device="cpu")
    ja = jax_arrays(js)
    assert ts.albedo_textures is None
    for name in _TABLES:
        got = getattr(ts, name).numpy()
        assert got.shape == ja[name].shape, name
        np.testing.assert_array_equal(got, ja[name], err_msg=name)


def test_convert_carries_jax_scene_across():
    """device_scene_from_arrays on the JAX scene's fields gives the port's
    own build, and the light/env/camera records carry over exactly."""
    jm, lights = jproc.cornell_box()
    js = j_build(jm)
    ts = tscene.device_scene_from_arrays(jax_arrays(js), device="cpu")
    own = tscene.device_scene_from_meshes(tscene.cornell_box(device="cpu")[0], device="cpu")
    for name in _TABLES:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), getattr(own, name).numpy())
    tl = tscene.light_table_from_arrays(jax_arrays(lights), device="cpu")
    for name in tl._fields:
        np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(lights, name)))
    with pytest.raises(NotImplementedError):
        tscene.device_scene_from_arrays({**jax_arrays(js), "cl_xf": np.zeros((1, 1, 16))},
                                        device="cpu")
    jc = JCamera.look_at([0.5, 0.5, 2.4], [0.5, 0.5, 0.0], [0, 1, 0], 40.0, 24, 16)
    tc = tscene.camera_from_arrays(
        {f: np.asarray(getattr(jc, f)) for f in ("origin", "forward", "right", "up",
                                                 "tan_half_fov")},
        jc.width, jc.height, device="cpu")
    assert (tc.width, tc.height) == (24, 16)
    for f in ("origin", "forward", "right", "up", "tan_half_fov"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))


def test_environment_lookup_matches_jax():
    """Bilinear lat-long lookup with rotation within 1e-5 (float32
    atan2/acos rounding)."""
    rng = np.random.RandomState(9)
    img = rng.rand(6, 10, 3).astype(np.float32)
    d = rng.randn(512, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    je = JEnv.from_image(img, rotation_offset=2.0)
    te = tscene.environment_from_arrays(
        {"image": img, "rotation_offset": np.asarray(je.rotation_offset)}, device="cpu")
    np.testing.assert_allclose(te.sample(torch.as_tensor(d)).numpy(),
                               np.asarray(je.sample(jnp.asarray(d))), rtol=1e-5, atol=1e-5)


def test_unported_scene_features_raise():
    meshes, _ = tscene.cornell_box(device="cpu")
    # textures are ported: the scene carries the packed pool
    textured = tscene.device_scene_from_meshes(meshes, textures=[np.zeros((2, 2, 4))],
                                               device="cpu")
    assert textured.textured and textured.has_cutout
    with pytest.raises(NotImplementedError):
        tscene.device_scene_from_meshes(meshes, curves=object(), device="cpu")
