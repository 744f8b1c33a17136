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

from pg2024_dprt_tpu.core import Camera as JCamera
from pg2024_dprt_tpu.ops.pallas_resident import trace_resident as j_trace
from pg2024_dprt_tpu.scene import cornell_box, device_scene_from_meshes, random_tri_soup
from pg2024_dprt_tpu_torch import ops as tops
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
    for name in ("stackless", "cluster"):
        with pytest.raises(NotImplementedError):
            tops.trace_closest_checked(ts, o, d, T_MIN, 1e30, act, tracer=name)
    with pytest.raises(ValueError):
        tops.resolve_tracer("pallas")
    with pytest.raises(NotImplementedError):
        tops.trace_resident(ts, o, d, T_MIN, 1e30, act, sort_rays=True)
    hits, diag = tops.trace_closest_checked(ts, o + 0.5, d, T_MIN, 1e30, act)
    assert diag == 0 and hits.is_hit.all()
