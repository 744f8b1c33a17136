"""The port's proxy-training stack (pg2024_dprt_tpu_torch/train/, the sampled
visibility grid, utils timing / benchmarking / memory) against the JAX
package, on the CPU, at small sizes.

Tolerances. Labels: hit flags exact; features within 1e-6 relative (the
same float32 formulas on the same rays); depth (t over the box diagonal)
within 2e-6 relative: t is a difference of products that XLA's CPU code
contracts and reorders, and on a grazing hit an ulp of each term is a few
ulps of t (1 ray in 5,000 lands at 1.2e-6). Datasets: identical arrays
(host numpy in both). Schedules: the written-out cosine schedule within
1e-7 of optax's at every step; the plateau scale equal to optax's. `fit`
from JAX's initial params: per-epoch losses within rtol 1e-4, final params
within atol 1e-5 (float32 matmuls summed in another order; Adam's
normalized first steps). Eval helpers within 1e-6. The sampled grid: equal
to JAX's bit for bit on the same rays.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pg2024_dprt_tpu.models.mlp import MLPConfig as JMLPConfig
from pg2024_dprt_tpu.models.mlp import init_mlp as j_init_mlp
from pg2024_dprt_tpu.scene import device_scene_from_meshes as j_build
from pg2024_dprt_tpu.scene.procedural import random_tri_soup as j_soup
from pg2024_dprt_tpu.train import datagen as j_datagen
from pg2024_dprt_tpu.train import datasets as j_datasets
from pg2024_dprt_tpu.train import eval as j_eval
from pg2024_dprt_tpu.train import loop as j_loop
from pg2024_dprt_tpu_torch import scene as tscene
from pg2024_dprt_tpu_torch.models.mlp import MLPConfig, apply_mlp, init_mlp
from pg2024_dprt_tpu_torch.scene import visibility_grid as tgrid
from pg2024_dprt_tpu_torch.train import datagen, datasets, eval as teval, loop
from pg2024_dprt_tpu_torch.train.__main__ import main as train_main


def _scenes(meshes):
    js = j_build(meshes)
    arrays = {k: np.asarray(v) for k, v in js._asdict().items() if isinstance(v, jax.Array)}
    return js, tscene.device_scene_from_arrays(arrays, device="cpu")


def _port_box_scene(lo=0.3, hi=0.7):
    v0, v1, v2 = tscene.procedural._box([lo] * 3, [hi] * 3)
    return tscene.device_scene_from_meshes([tscene.MeshGeometry(v0=v0, v1=v1, v2=v2)],
                                           device="cpu")


def _t(a):
    return torch.as_tensor(np.array(a))



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's tests: the tier-1 run puts several
    test files side by side on the CPU's cores, and torch's own thread pool
    in each would oversubscribe them (its matmuls then slow down many-fold)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# ---------------------------------------------------------------------------
# datagen

def test_label_rays_match_jax_datagen():
    """label_rays on the rays JAX's generate_proxy_dataset drew (the split
    chain of its batch loop) gives JAX's features and labels."""
    mesh = j_soup(600, seed=4)
    js, ts = _scenes([mesh])
    lo, hi = mesh.aabb()
    n, batch, seed = 5000, 2048, 7
    want_f, want_d = j_datagen.generate_proxy_dataset(js, lo, hi, n, seed=seed, batch=batch)
    key = jax.random.PRNGKey(seed)
    got_f, got_d = [], []
    for s in range(0, n, batch):
        key, sub = jax.random.split(key)
        o, d = j_datagen._sample_entry_rays(sub, jnp.asarray(lo), jnp.asarray(hi),
                                            min(batch, n - s))
        f, dep = datagen.label_rays(ts, _t(o), _t(d), lo, hi)
        got_f.append(f.numpy())
        got_d.append(dep.numpy())
    got_f, got_d = np.concatenate(got_f), np.concatenate(got_d)
    np.testing.assert_array_equal(got_d == 1.0, want_d == 1.0)
    assert 0.05 < (want_d < 1.0).mean() < 0.95
    np.testing.assert_allclose(got_d, want_d, rtol=2e-6, atol=0)
    np.testing.assert_allclose(got_f, want_f, rtol=1e-6, atol=1e-7)


def test_datagen_properties():
    """The JAX oracle's properties of a ray-cast dataset (shapes, finite
    features in [0, 1], labels in [0, 1], hits and misses both present), and
    the same rays for the same seed."""
    scene = _port_box_scene()
    feats, depth = datagen.generate_proxy_dataset(scene, [0, 0, 0], [1, 1, 1], 20_000,
                                                  seed=1, batch=8192)
    assert feats.shape == (20_000, 5) and feats.dtype == np.float32
    assert np.isfinite(feats).all()
    assert feats.min() >= -1e-5 and feats.max() <= 1 + 1e-5
    assert (depth >= 0).all() and (depth <= 1).all()
    assert 0.05 < (depth < 1.0).mean() < 0.95
    again = datagen.generate_proxy_dataset(scene, [0, 0, 0], [1, 1, 1], 20_000, seed=1,
                                           batch=8192)
    np.testing.assert_array_equal(again[0], feats)
    other = datagen.generate_proxy_dataset(scene, [0, 0, 0], [1, 1, 1], 2000, seed=2)
    assert not np.array_equal(other[0], feats[:2000])


def test_multigeo_dataset_layout():
    """generate_multigeo_dataset: one dataset per object (seed + 7919 i),
    the instance id / 4 as the sixth feature."""
    scenes = [_port_box_scene(0.3, 0.7), _port_box_scene(0.1, 0.5)]
    f, d = datagen.generate_multigeo_dataset(scenes, [[0, 0, 0]] * 2, [[1, 1, 1]] * 2, 3000,
                                             seed=5)
    assert f.shape == (6000, 6) and d.shape == (6000,)
    np.testing.assert_array_equal(f[:3000, 5], 0.0)
    np.testing.assert_array_equal(f[3000:, 5], np.float32(0.25))
    f1, d1 = datagen.generate_proxy_dataset(scenes[1], [0, 0, 0], [1, 1, 1], 3000,
                                            seed=5 + 7919)
    np.testing.assert_array_equal(f[3000:, :5], f1)
    np.testing.assert_array_equal(d[3000:], d1)


# ---------------------------------------------------------------------------
# datasets: the same arrays

def _labels(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.rand(n, 5).astype(np.float32)
    depth = np.where(rng.rand(n) > 0.6, rng.rand(n), 1.0).astype(np.float32)
    return feats, depth


DATASET_CASES = {
    "balance_vis": lambda m, f, d: m.balance_vis(f, d, ratio=1.5, seed=3),
    "depth_only": lambda m, f, d: m.depth_only(f, d),
    "combined_labels": lambda m, f, d: m.combined_labels(f, d, seed=4),
    "split_train_test": lambda m, f, d: m.split_train_test(f, d, seed=5),
    "shuffle": lambda m, f, d: m.shuffle(f, d, seed=6),
    "multi_geo_features": lambda m, f, d: m.multi_geo_features([f[:1000], f[1000:]],
                                                               [d[:1000], d[1000:]]),
}


@pytest.mark.parametrize("name", sorted(DATASET_CASES))
def test_dataset_helpers_match_jax(name):
    feats, depth = _labels()
    got = DATASET_CASES[name](datasets, feats, depth)
    want = DATASET_CASES[name](j_datasets, feats, depth)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_balance_and_depth_filters():
    """The JAX oracle: 1.5 misses per hit, labels in {0, 1}; depth_only
    keeps the hits."""
    feats = np.random.RandomState(0).rand(1000, 5).astype(np.float32)
    depth = np.ones(1000, np.float32)
    depth[:200] = 0.5
    x, y = datasets.balance_vis(feats, depth, ratio=1.5)
    assert set(np.unique(y)) <= {0.0, 1.0}
    assert (y == 1.0).sum() == 200 and (y == 0.0).sum() == 300
    xd, yd = datasets.depth_only(feats, depth)
    assert xd.shape[0] == 200 and (yd == 0.5).all()


def test_exr_pair_io_crosses_packages(tmp_path):
    """export_exr_pair / load_exr_pair round trip, and each package reads
    the other's pair."""
    rng = np.random.RandomState(3)
    feats = rng.rand(1000, 5).astype(np.float32)
    labels = rng.rand(1000).astype(np.float32)
    for writer, reader in ((datasets, datasets), (datasets, j_datasets), (j_datasets, datasets)):
        op, dp = str(tmp_path / "o.exr"), str(tmp_path / "d.exr")
        writer.export_exr_pair(op, dp, feats, labels, width=128)
        f2, l2 = reader.load_exr_pair(op, dp)
        np.testing.assert_array_equal(f2[:1000], feats)
        np.testing.assert_array_equal(l2[:1000], labels)
    prefix_o, prefix_d = str(tmp_path / "mo"), str(tmp_path / "md")
    for i in range(2):
        datasets.export_exr_pair(f"{prefix_o}{i}.exr", f"{prefix_d}{i}.exr", feats, labels)
    got = datasets.load_multi_datasets(prefix_o, prefix_d, 2)
    want = j_datasets.load_multi_datasets(prefix_o, prefix_d, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the optimizer written out

@pytest.mark.parametrize("total", [1000, 37, 2])
def test_cosine_schedule_matches_optax(total):
    """warmup_cosine_schedule equals optax's warmup_cosine_decay_schedule as
    make_optimizer builds it, at every step of the horizon and past it."""
    lr = 5e-4
    args = (0.0, lr, min(200, total // 10 + 1), max(total, 2), lr * 1e-3)
    want = optax.warmup_cosine_decay_schedule(*args)
    got = loop.warmup_cosine_schedule(*args)
    assert got(0) == 0.0
    for c in range(total + 20):
        assert abs(got(c) - float(want(c))) <= 1e-7 * lr / 5e-4, c
    assert got(total + 5) == pytest.approx(lr * 1e-3, rel=1e-6)


def test_plateau_rule_matches_optax():
    """ReduceOnPlateau's scale equals optax.contrib.reduce_on_plateau's on a
    loss sequence that triggers two reductions (patience 3)."""
    # improving; 3 flat (reduction 1); within rtol of the best 4 times
    # (reduction 2, then one more); improving; 2 short of patience; improving
    losses = ([1.0, 0.8, 0.6] + [0.6] * 3 + [0.59995] * 4 + [0.3, 0.2]
              + [0.25, 0.2, 0.1])
    tx = optax.contrib.reduce_on_plateau(factor=0.1, patience=3)
    state = tx.init({"w": jnp.zeros(())})
    rule = loop.ReduceOnPlateau(factor=0.1, patience=3)
    scales = []
    for v in losses:
        upd, state = tx.update({"w": jnp.ones(())}, state, value=jnp.float32(v))
        got = float(rule.update(torch.tensor(v, dtype=torch.float32)))
        assert got == float(upd["w"]), (v, got, float(upd["w"]))
        scales.append(got)
    assert sorted(set(scales)) == pytest.approx([0.01, 0.1, 1.0])


def _fit_case(nn_type, n=2048, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 5).astype(np.float32)
    if nn_type == "combined":
        hit = (rng.rand(n) > 0.5).astype(np.float32)
        y = np.stack([hit, rng.rand(n).astype(np.float32)], -1)
        kw = dict(width=32, depth=1, out_features=2, final_activation="sigmoid")
    else:
        y = ((rng.rand(n) > 0.5).astype(np.float32) if nn_type == "vis"
             else rng.rand(n).astype(np.float32))
        kw = dict(width=32, depth=1)
    return x, y, JMLPConfig(**kw), MLPConfig(**kw)


@pytest.mark.parametrize("schedule", ["cosine", "plateau"])
@pytest.mark.parametrize("nn_type", ["vis", "depth", "combined"])
def test_fit_matches_jax(nn_type, schedule):
    """fit from JAX's initial params against JAX's fit(device_loop=False):
    w32/d1, batch 512, 3 epochs of 3 steps (plateau patience 2, so the rule
    acts within the run)."""
    x, y, jcfg, tcfg = _fit_case(nn_type)
    p0 = j_init_mlp(jax.random.PRNGKey(3), jcfg)
    kw = dict(nn_type=nn_type, batch=512, epochs=3, schedule=schedule, plateau_patience=2)
    jp, jh = j_loop.fit(x, y, jcfg, j_loop.TrainConfig(**kw), params=p0, device_loop=False)
    tp, th = loop.fit(x, y, tcfg, loop.TrainConfig(**kw),
                      params={k: np.asarray(v) for k, v in p0.items()}, device="cpu")
    for key in ("train_loss", "test_loss"):
        assert len(th[key]) == 3
        np.testing.assert_allclose(th[key], jh[key], rtol=1e-4)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-5)
    # the run moved the params (the first cosine update uses lr 0)
    assert max(float(np.abs(np.asarray(jp[k]) - np.asarray(p0[k])).max()) for k in jp) > 1e-4


def test_fit_device_loop_flag_runs_the_one_loop():
    """fit(device_loop=True) and fit(device_loop=False) give the same
    history and params: the port has one loop (JAX's _fit_device is a TPU
    workaround and has no counterpart)."""
    x, y, _, tcfg = _fit_case("vis", n=1024)
    cfg = loop.TrainConfig(nn_type="vis", batch=256, epochs=2)
    a = loop.fit(x, y, tcfg, cfg, device_loop=True, device="cpu")
    b = loop.fit(x, y, tcfg, cfg, device_loop=False, device="cpu")
    c = loop.fit(x, y, tcfg, cfg, device="cpu")
    assert a[1] == b[1] == c[1]
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]) and torch.equal(a[0][k], c[0][k])


def test_fit_writes_loss_stamped_checkpoints(tmp_path):
    x, y, _, tcfg = _fit_case("depth", n=600)
    cfg = loop.TrainConfig(nn_type="depth", batch=128, epochs=3, checkpoint_every=2,
                           checkpoint_dir=str(tmp_path))
    params, hist = loop.fit(x, y, tcfg, cfg, device="cpu")
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2 and all(f.startswith("depth-loss=") for f in files)
    assert files[0].endswith("-epochs=0.npz") or files[1].endswith("-epochs=0.npz")
    last = next(f for f in files if f.endswith("-epochs=2.npz"))
    assert last == f"depth-loss={hist['test_loss'][2]:.6f}-epochs=2.npz"


def test_training_learns_visibility():
    """The JAX oracle: a small vis net beats 85 % accuracy on box visibility."""
    scene = _port_box_scene()
    feats, depth = datagen.generate_proxy_dataset(scene, [0, 0, 0], [1, 1, 1], 40_000, seed=2)
    x, y = datasets.balance_vis(feats, depth)
    cfg = MLPConfig(width=128, depth=2)
    params, hist = loop.fit(x, y, cfg, loop.TrainConfig(nn_type="vis", epochs=60, batch=4096,
                                                        learn_rate=5e-3), device="cpu")
    assert hist["test_loss"][-1] < hist["test_loss"][0]
    _, _, tx, ty = datasets.split_train_test(x, y, seed=123)
    with torch.no_grad():
        pred = apply_mlp(params, torch.as_tensor(tx[:5000]), cfg).numpy()
    acc = ((pred > 0.5) == (ty[:5000] > 0.5)).mean()
    assert acc > 0.85, f"vis accuracy {acc}"


def test_combined_training_learns():
    """The JAX oracle: the combined loss trains a tiny double-output net
    from the partition datagen pipeline."""
    mesh = tscene.random_tri_soup(200, seed=4)
    scene = tscene.device_scene_from_meshes([mesh], device="cpu")
    lo, hi = mesh.aabb()
    cfg = MLPConfig(width=32, depth=1, out_features=2, final_activation="sigmoid")
    params, hist = loop.train_proxy_for_partition(
        scene, lo, hi, "combined", mlp_cfg=cfg,
        train_cfg=loop.TrainConfig(nn_type="combined", epochs=40, batch=2048),
        num_samples=6000)
    assert params["head_w1"].shape == (64, 2)
    assert hist["train_loss"][-1] < hist["train_loss"][0] * 0.9


# ---------------------------------------------------------------------------
# checkpoints

def test_checkpoint_roundtrip(tmp_path):
    cfg = MLPConfig(width=64, depth=2)
    params = init_mlp(np.random.RandomState(0), cfg, device="cpu")
    p = str(tmp_path / "ckpt")
    loop.save_checkpoint(p, params)
    back = loop.load_checkpoint(p, device="cpu")
    assert set(back) == set(params)
    for k in params:
        assert torch.equal(back[k], params[k])


def test_checkpoints_cross_read(tmp_path):
    """A port npz read by JAX's load_checkpoint and by convert's
    load_mlp_checkpoint; a JAX npz read by the port's load_checkpoint."""
    cfg = MLPConfig(width=64, depth=2)
    params = init_mlp(np.random.RandomState(1), cfg, device="cpu")
    loop.save_checkpoint(str(tmp_path / "port"), params)
    jback = j_loop.load_checkpoint(str(tmp_path / "port"))
    cback = tscene.load_mlp_checkpoint(str(tmp_path / "port.npz"), cfg, device="cpu")
    for k in params:
        np.testing.assert_array_equal(np.asarray(jback[k]), params[k].numpy())
        assert torch.equal(cback[k], params[k])
    jparams = j_init_mlp(jax.random.PRNGKey(2), JMLPConfig(width=64, depth=2))
    j_loop.save_checkpoint(str(tmp_path / "jax"), jparams)
    back = loop.load_checkpoint(str(tmp_path / "jax.npz"), device="cpu")
    assert set(back) == set(jparams)
    for k in jparams:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jparams[k]))


# ---------------------------------------------------------------------------
# eval

def test_eval_helpers_match_jax(tmp_path):
    jcfg = JMLPConfig(width=32, depth=1)
    ccfg = JMLPConfig(width=32, depth=1, out_features=2, final_activation="sigmoid")
    jv = j_init_mlp(jax.random.PRNGKey(4), jcfg)
    jd = j_init_mlp(jax.random.PRNGKey(5), jcfg)
    jc = j_init_mlp(jax.random.PRNGKey(6), ccfg)
    conv = lambda p: {k: torch.as_tensor(np.asarray(v)) for k, v in p.items()}
    tcfg = MLPConfig(width=32, depth=1)
    tccfg = MLPConfig(width=32, depth=1, out_features=2, final_activation="sigmoid")
    got = teval.prediction_grid(conv(jv), tcfg, width=24, height=16)
    want = j_eval.prediction_grid(jv, jcfg, width=24, height=16)
    assert got.shape == (16, 24)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    img = teval.save_prediction_exr(str(tmp_path / "p.exr"), conv(jv), tcfg, width=24,
                                    height=16)
    np.testing.assert_array_equal(img, got)
    assert os.path.getsize(tmp_path / "p.exr") > 0
    feats, depth = _labels(512, seed=8)
    gm = teval.depth_accuracy(conv(jv), tcfg, conv(jd), tcfg, feats, depth)
    wm = j_eval.depth_accuracy(jv, jcfg, jd, jcfg, feats, depth)
    gc = teval.combined_accuracy(conv(jc), tccfg, feats, depth)
    wc = j_eval.combined_accuracy(jc, ccfg, feats, depth)
    for g, w in ((gm, wm), (gc, wc)):
        assert set(g) == set(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-6, abs=1e-6), k


def test_combined_accuracy_eval():
    """The JAX oracle: metrics in range on random labels."""
    cfg = MLPConfig(width=32, depth=1, out_features=2, final_activation="sigmoid")
    params = init_mlp(np.random.RandomState(3), cfg, device="cpu")
    rng = np.random.RandomState(8)
    feats = rng.rand(512, 5).astype(np.float32)
    labels = np.where(rng.rand(512) > 0.5, rng.rand(512), 1.0).astype(np.float32)
    m = teval.combined_accuracy(params, cfg, feats, labels)
    assert 0.0 <= m["vis_accuracy"] <= 1.0
    assert m["depth_l1"] >= 0.0 and 0.0 < m["hit_fraction"] < 1.0


# ---------------------------------------------------------------------------
# the sampled visibility grid

def test_sampled_grid_matches_jax():
    """grid_from_rays on the rays JAX's build_visibility_grid drew equals
    JAX's grid; query_visibility equals JAX's on other rays."""
    from pg2024_dprt_tpu.scene import visibility_grid as jgrid

    mesh = j_soup(400, seed=9)
    js, ts = _scenes([mesh])
    lo, hi = (jnp.asarray(a) for a in mesh.aabb())
    want = jgrid.build_visibility_grid(js, lo, hi, width=8, height=6, angle=4,
                                       samples=10_000, seed=3)
    o, d = j_datagen._sample_entry_rays(jax.random.PRNGKey(3), lo, hi, 10_000)
    got = tgrid.grid_from_rays(ts, np.asarray(lo), np.asarray(hi), _t(o), _t(d),
                               width=8, height=6, angle=4)
    assert got.grid.shape == (6 * 8 * 6 * 4,)
    np.testing.assert_array_equal(got.grid.numpy(), np.asarray(want.grid))
    assert 0 < int(got.grid.sum()) < got.grid.numel()
    qo, qd = j_datagen._sample_entry_rays(jax.random.PRNGKey(4), lo, hi, 4096)
    t_enter = np.random.RandomState(0).rand(4096).astype(np.float32) * 1e-3
    np.testing.assert_array_equal(
        tgrid.query_visibility(got, _t(qo), _t(qd), _t(t_enter)).numpy(),
        np.asarray(jgrid.query_visibility(want, qo, qd, jnp.asarray(t_enter))))


def test_visibility_grid():
    """The JAX oracle: rays that hit the object are predicted visible, and
    the grid culls a good share of the misses."""
    v0, v1, v2 = tscene.procedural._box([0.35] * 3, [0.65] * 3)
    scene = tscene.device_scene_from_meshes([tscene.MeshGeometry(v0=v0, v1=v1, v2=v2)],
                                            device="cpu")
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    vg = tgrid.build_visibility_grid(scene, lo, hi, samples=150_000, seed=5)
    o, d = datagen._sample_entry_rays(torch.Generator().manual_seed(99), lo, hi, 4096)
    _, h = datagen.trace_labels(scene, o, d, 1e-4)
    p = tgrid.query_visibility(vg, o, d, torch.zeros(4096)).numpy()
    h = h.numpy()
    assert p[h].mean() > 0.97
    assert (~p[~h]).mean() > 0.3
    # marked bins lie inside the conservative grid of the box's triangles
    cons = tscene.build_conservative_grid(
        np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2),
        [0.35] * 3, [0.65] * 3, 16, 16, 8)
    inner = tgrid.build_visibility_grid(scene, [0.35] * 3, [0.65] * 3, samples=20_000, seed=6)
    marked = inner.grid.numpy().reshape(6, 16, 16, 8)
    assert marked.any() and not (marked & ~cons).any()


# ---------------------------------------------------------------------------
# the training command line and the entry points

def test_train_cli_obj_and_exr_pair(tmp_path, capsys):
    """train's main on an .obj (ray-cast data) and on an EXR pair, on the
    CPU; JAX's load_checkpoint reads what it writes."""
    (tmp_path / "box.obj").write_text(
        "v 0.3 0.3 0.3\nv 0.7 0.3 0.3\nv 0.7 0.7 0.3\nv 0.3 0.7 0.3\n"
        "v 0.3 0.3 0.7\nv 0.7 0.3 0.7\nv 0.7 0.7 0.7\nv 0.3 0.7 0.7\n"
        "f 1 2 3 4\nf 5 8 7 6\nf 1 5 6 2\nf 4 3 7 8\nf 1 4 8 5\nf 2 6 7 3\n"
        "v 0 0 0\nv 1 1 1\nf 9 10 9\n")
    path, hist = train_main(["--obj", str(tmp_path / "box.obj"), "--nn-type", "vis",
                             "--width", "32", "--depth", "1", "--epochs", "2", "--batch", "512",
                             "--samples", "4000", "--out", str(tmp_path / "ck"),
                             "--device", "cpu"])
    assert os.path.exists(path) and len(hist["test_loss"]) == 2
    back = j_loop.load_checkpoint(path)
    assert back["head_w1"].shape == (64, 1)
    feats, depth = _labels(2000, seed=1)
    op, dp = str(tmp_path / "o.exr"), str(tmp_path / "d.exr")
    datasets.export_exr_pair(op, dp, feats, depth, width=64)
    path, hist = train_main(["--origin-exr", op, "--direction-exr", dp, "--nn-type", "combined",
                             "--width", "32", "--depth", "1", "--epochs", "1", "--batch", "256",
                             "--out", str(tmp_path / "ck"), "--device", "cpu"])
    assert "combined-loss=" in path and os.path.exists(path)
    assert "saved" in capsys.readouterr().out


def test_training_entry_points_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, _, tcfg = _fit_case("vis", n=256)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.fit(x, y, tcfg, loop.TrainConfig(batch=64, epochs=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.load_checkpoint("missing.npz")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--origin-exr", "o.exr", "--direction-exr", "d.exr"])
    loop.fit(x, y, tcfg, loop.TrainConfig(batch=64, epochs=1), device="cpu")


# ---------------------------------------------------------------------------
# utils: timing, chained timing, memory

def test_fold_survives_miss_sentinel():
    """A function returning the 3.4e38 miss sentinel does not blow up the
    chained operand: the time is finite and the operand stays near its start."""
    from pg2024_dprt_tpu_torch.utils.benchmarking import chained_time, fold

    seen = []

    def fn(o):
        seen.append(o.clone())
        return torch.full((4,), 3.402823466e38)

    per = chained_time(fn, torch.ones(8), short=1, long=3, reps=1)
    assert np.isfinite(per) and len(seen) == 1 + 1 + 3
    assert all(float((o - 1.0).abs().max()) < 1e-4 for o in seen)
    o2, s = fold(torch.ones(2), torch.full((1,), 3.4e38), 0)
    assert float(s) == 1.0 and torch.allclose(o2, torch.full((2,), 1.0 + 2e-6))


def test_fold_changes_bits_per_iteration():
    """Each call's input differs from the last in its bits and stays within
    1e-4 of the first (JAX's bounded, bit-changing fold)."""
    from pg2024_dprt_tpu_torch.utils.benchmarking import fold

    o = torch.full((4,), 0.5)
    trail = []
    for i in range(3):
        o, _ = fold(o, o * 1.0 + 1.0, i)
        trail.append(o)
    assert not torch.equal(trail[0], trail[1]) and not torch.equal(trail[1], trail[2])
    assert all(float((t - 0.5).abs().max()) < 1e-4 for t in trail)


def test_timing_spans_nest_and_self_times_add_up():
    """utils/timing.py: spans under a recorder nest by parent, inherit their
    frame id, and each name's self time (its duration less its children's)
    sums over the names to the root's duration; host reads count as host
    syncs, copies onto the CPU do not."""
    from pg2024_dprt_tpu_torch.utils.timing import (Timing, host_read, host_syncs, span,
                                                    to_device)

    timing = Timing()
    with span("unrecorded"):
        pass
    with timing.section("Sample"):
        with span("a"):
            for _ in range(2):
                with span("b"):
                    sum(range(1000))
        with span("c", frame=3):
            with span("d"):
                sum(range(1000))
    assert [s[0] for s in timing.spans] == ["Sample", "a", "b", "b", "c", "d"]
    assert [s[3] for s in timing.spans] == [-1, 0, 1, 1, 0, 4]
    assert [s[4] for s in timing.spans] == [None, None, None, None, 3, 3]
    for name, start, end, parent, _ in timing.spans[1:]:
        assert timing.spans[parent][1] <= start <= end <= timing.spans[parent][2]
    assert timing.counts["b"] == 2 and "unrecorded" not in timing.counts
    own = timing.self_seconds()
    root = timing.spans[0]
    assert abs(sum(own.values()) - (root[2] - root[1]) / 1e9) < 1e-6
    assert own["a"] == pytest.approx(timing.totals["a"] - timing.totals["b"], abs=1e-9)
    assert "b: " in timing.report() and "self" in timing.report()
    before = host_syncs()
    assert host_read(torch.tensor([2, 3])) == [2, 3] and host_read(torch.tensor(4)) == 4
    assert to_device(5, torch.int64, "cpu").item() == 5
    assert host_syncs() - before == 2


def test_timing_and_memory_report():
    from pg2024_dprt_tpu_torch.utils.memory import buffer_bytes, memory_report
    from pg2024_dprt_tpu_torch.utils.timing import TimedSection, Timing

    timing = Timing()
    with timing.section(TimedSection.Sample, sync_value=(torch.ones(3), {"a": torch.ones(2)})):
        pass
    with timing.section("Train"):
        pass
    rep = timing.report()
    assert "Sample:" in rep and "over 1 calls" in rep and "Train:" in rep
    scene = _port_box_scene()
    want = sum(t.numel() * t.element_size() for t in scene if torch.is_tensor(t))
    assert buffer_bytes(scene) == want > 0
    assert buffer_bytes({"a": torch.zeros(3, dtype=torch.int64), "b": [torch.zeros(2)]}) == 32
    rep = memory_report(scene=scene)
    assert rep.splitlines()[0].startswith("scene") and "total" in rep
