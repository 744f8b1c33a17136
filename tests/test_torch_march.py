"""The port's proxy march (ops/march.py) against the JAX package: its plain
version against the oracle march_proxies_xla field by field, and against the
Pallas kernel in interpret mode per ray.

Tolerances: ids, flags and the hit sequence exact; t rtol 1e-5 / atol 1e-6;
features rtol 1e-4 / atol 2e-5 against the oracle (arccos / arctan2 of two
libraries) and, against the Pallas kernel, the JAX package's own limits
between its two forms (2e-5, and 5e-4 with instancing, where the kernel
takes its angles from polynomial approximations). phi / 2pi wraps, so that
feature is compared modulo 1. The Pallas kernel breaks selection ties by a
key whose low mantissa bits hold the row, so against it a different row is
allowed where two candidates agree to 2^-20 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg2024_dprt_tpu.ops.pallas_march import march_proxies_pallas
from pg2024_dprt_tpu.render.proxy_stages import march_proxies_xla
from pg2024_dprt_tpu.scene.geometry import ProxyTable as JProxyTable
from pg2024_dprt_tpu_torch.ops import march as tmarch
from pg2024_dprt_tpu_torch.ops import resident as tres
from pg2024_dprt_tpu_torch.ops.march import march_proxies_plain, proxy_march
from pg2024_dprt_tpu_torch.render.proxy_stages import march_proxies
from pg2024_dprt_tpu_torch.scene import (device_scene_from_instances,
                                         device_scene_from_meshes, proxy_table_from_arrays,
                                         random_tri_soup)

MH = 3
EPS = 1e-3


def _boxes(p=8, seed=0, with_empty=False):
    rng = np.random.RandomState(seed)
    lo = rng.rand(p, 3).astype(np.float32) * 3.0 - 1.0
    hi = lo + 0.3 + rng.rand(p, 3).astype(np.float32) * 1.2
    ml = np.linalg.norm(hi - lo, axis=1).astype(np.float32)
    if with_empty:
        lo[2], hi[2], ml[2] = np.inf, -np.inf, 0.0
    return dict(aabb_min=lo, aabb_max=hi, max_length=ml)


def _instanced(p, seed, obj, node):
    rng = np.random.RandomState(seed)
    offs = (rng.rand(p, 3).astype(np.float32) * 3.0 - 1.0)
    sc = (0.4 + rng.rand(p).astype(np.float32) * 0.8)
    m = np.zeros((p, 3, 4), np.float32)
    for i in range(p):
        m[i, :, :3] = np.eye(3, dtype=np.float32) / sc[i]
        m[i, :, 3] = -offs[i] / sc[i]
    return dict(aabb_min=offs, aabb_max=offs + sc[:, None],
                max_length=np.full((p,), np.sqrt(3.0), np.float32),
                obj_id=np.asarray(obj, np.int32), node_id=np.asarray(node, np.int32),
                world_to_obj=m, obj_min=np.zeros((p, 3), np.float32),
                obj_span=np.ones((p, 3), np.float32))


def _rays(n, seed=1, inside_of=None):
    rng = np.random.RandomState(seed)
    o = rng.rand(n, 3).astype(np.float32) * 4.0 - 1.5
    if inside_of is not None:
        # every second origin inside one of the boxes: inside hits and dedup
        lo, hi = inside_of["aabb_min"], inside_of["aabb_max"]
        pick = rng.randint(0, lo.shape[0], size=n)
        u = rng.rand(n, 3).astype(np.float32) * 0.8 + 0.1
        inner = lo[pick] + u * (hi[pick] - lo[pick])
        o[::2] = inner[::2]
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _both(table, o, d, t_cap, act, my_node):
    jt = JProxyTable(**{k: jnp.asarray(v) for k, v in table.items()})
    tt = proxy_table_from_arrays(table, device="cpu")
    ja = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_cap), jnp.asarray(act),
          jnp.int32(my_node), MH, EPS)
    ta = (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_cap),
          torch.as_tensor(act), my_node, MH, EPS)
    return jt, ja, tt, ta


def _mod1_close(a, b, atol):
    diff = np.abs(a - b)
    return np.minimum(diff, 1.0 - diff) <= atol + 1e-4 * np.abs(b)


def _assert_fields_equal_oracle(got, ref, feat_atol=2e-5):
    g = {f: getattr(got, f).numpy() for f in got._fields}
    r = {f: np.asarray(getattr(ref, f)) for f in ref._fields}
    for f in ("aabb_id", "node_id", "hit_sequence", "is_inside", "is_valid",
              "path_index", "pixel_index", "shadow_path_id"):
        np.testing.assert_array_equal(g[f], r[f], err_msg=f)
    for f in ("aabb_t", "max_length", "t_ratio", "normalized_t"):
        np.testing.assert_allclose(g[f], r[f], rtol=1e-5, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(g["features"][:, [0, 1, 2, 4]], r["features"][:, [0, 1, 2, 4]],
                               rtol=1e-4, atol=feat_atol)
    assert _mod1_close(g["features"][:, 3], r["features"][:, 3], feat_atol).all()
    assert g["is_valid"].sum() > 0


def _records(q, n):
    """Per ray the valid records (object, node, inside, t, ratio, features)
    in order of t."""
    f = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
         for k, v in q._asdict().items()}
    out = []
    for r in range(n):
        rows = [i for i in range(r * MH, (r + 1) * MH) if f["is_valid"][i]]
        rows.sort(key=lambda i: f["aabb_t"][i])
        out.append([(f["aabb_id"][i], f["node_id"][i], bool(f["is_inside"][i]),
                     f["aabb_t"][i], f["t_ratio"][i], f["features"][i]) for i in rows])
    return out


def _assert_matches_pallas(got, ref, n, feat_atol):
    """Per ray over the valid records in order of t; a different row is
    allowed only where its t ties the other's to 2^-20 relative (the Pallas
    key's row bits)."""
    for r, (a, b) in enumerate(zip(_records(got, n), _records(ref, n))):
        assert len(a) == len(b), (r, a, b)
        for (o0, n0, i0, t0, r0, f0), (o1, n1, i1, t1, r1, f1) in zip(a, b):
            np.testing.assert_allclose(t0, t1, rtol=1e-5, atol=1e-6)
            if (o0, n0, i0) != (o1, n1, i1):
                assert abs(t0 - t1) <= 2.0 ** -20 * abs(t1), (r, a, b)
                continue
            np.testing.assert_allclose(r0, r1, rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(f0[[0, 1, 2, 4]], f1[[0, 1, 2, 4]], rtol=1e-4,
                                       atol=feat_atol)
            assert _mod1_close(f0[3], f1[3], feat_atol)


CASES = {
    # name: (table, rays seed, origins inside boxes, finite cap and inactive rays, my_node)
    "plain_table": (_boxes(), 1, False, False, 8),
    "own_node_and_t_cap": (_boxes(seed=3), 4, False, True, 2),
    "empty_partition": (_boxes(seed=6, with_empty=True), 7, False, False, 0),
    "origins_inside": (_boxes(seed=9), 10, True, True, 8),
    "instanced": (_instanced(4, 11, [0, 1, 0, 1], [1, 2, 3, 0]), 12, False, False, 0),
    "instanced_foreign_node": (_instanced(4, 11, [0, 1, 0, 1], [1, 2, 3, 0]), 12, False, False, 4),
}


def _case(name, n=384):
    table, seed, inside, capped, my_node = CASES[name]
    o, d = _rays(n, seed, table if inside else None)
    rng = np.random.RandomState(seed + 100)
    if capped:
        t_cap = (0.3 + rng.rand(n) * 3.0).astype(np.float32)
        act = rng.rand(n) > 0.3
    else:
        t_cap = np.full((n,), 3.4e38, np.float32)
        act = np.ones((n,), bool)
    return _both(table, o, d, t_cap, act, my_node), n


@pytest.mark.parametrize("name", list(CASES))
def test_plain_march_matches_oracle_field_by_field(name):
    (jt, ja, tt, ta), n = _case(name)
    got = march_proxies_plain(tt, *ta)
    ref = march_proxies_xla(jt, *ja)
    _assert_fields_equal_oracle(got, ref)
    if name == "empty_partition":
        assert not (got.aabb_id[got.is_valid] == 2).any()
        assert torch.isfinite(got.features).all()
    if name == "origins_inside":
        assert got.is_inside.sum() > 20


@pytest.mark.parametrize("name", list(CASES))
def test_plain_march_matches_pallas_kernel_per_ray(name):
    (jt, ja, tt, ta), n = _case(name, n=256)
    got = march_proxies_plain(tt, *ta)
    ref = march_proxies_pallas(jt, *ja, interpret=True)
    _assert_matches_pallas(got, ref, n, 5e-4 if name.startswith("instanced") else 2e-5)


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    """proxy_march and the stage's march_proxies dispatch by the tensors'
    device: CPU tensors give the plain version's result, bit for bit."""
    (jt, ja, tt, ta), n = _case("own_node_and_t_cap", n=128)
    want = march_proxies_plain(tt, *ta)
    for fn in (proxy_march, march_proxies):
        got = fn(tt, *ta)
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_valid_rows_are_front_packed_and_ordered():
    (jt, ja, tt, ta), n = _case("origins_inside")
    q = march_proxies_plain(tt, *ta)
    valid = q.is_valid.reshape(n, MH)
    t = q.aabb_t.reshape(n, MH)
    seq = q.hit_sequence.reshape(n, MH)
    count = valid.sum(dim=1)
    for k in range(MH):
        assert torch.equal(valid[:, k], count > k)
    assert (seq[valid] == torch.arange(MH).expand(n, MH)[valid]).all()
    later = valid[:, 1:]
    assert (t[:, 1:][later] >= t[:, :-1][later]).all()


def test_proxy_table_converter_round_trip():
    """proxy_table_from_arrays carries every field of a JAX ProxyTable across
    (the instancing fields stay None on a plain table), .to() keeps them, and
    a table's visibility grids carry across as bool."""
    plain = proxy_table_from_arrays(_boxes(), device="cpu")
    assert not plain.instanced and plain.obj_id is None and plain.vis_grid is None
    arrays = _instanced(4, 11, [0, 1, 0, 1], [1, 2, 3, 0])
    jt = JProxyTable(**{k: jnp.asarray(v) for k, v in arrays.items()})
    back = proxy_table_from_arrays(
        {k: (None if v is None else np.asarray(v)) for k, v in jt._asdict().items()},
        device="cpu")
    assert back.instanced and back.num_partitions == 4
    assert back.obj_id.dtype == torch.int32 and back.node_id.dtype == torch.int32
    for k, v in arrays.items():
        np.testing.assert_array_equal(getattr(back, k).numpy(), v, err_msg=k)
        assert torch.equal(getattr(back.to("cpu"), k), getattr(back, k))
    grid = (np.arange(8 * 6 * 2 * 2 * 4) % 3 == 0).reshape(8, 6, 2, 2, 4)
    gridded = proxy_table_from_arrays({**_boxes(), "vis_grid": grid}, device="cpu")
    assert gridded.vis_grid.dtype == torch.bool
    np.testing.assert_array_equal(gridded.to("cpu").vis_grid.numpy(), grid)


def test_more_than_32_rows_raise():
    table = _boxes(p=33)
    tt = proxy_table_from_arrays(table, device="cpu")
    o, d = _rays(8)
    args = (torch.as_tensor(o), torch.as_tensor(d), torch.full((8,), 3.4e38),
            torch.ones(8, dtype=torch.bool), 40, MH, EPS)
    with pytest.raises(ValueError, match="32"):
        march_proxies_plain(tt, *args)
    with pytest.raises(ValueError, match="32"):
        proxy_march(tt, *args)


@pytest.mark.parametrize("kind", ["plain", "instanced"])
def test_proxy_table_args_are_kept_until_a_table_tensor_changes(kind):
    """The kernels' table arguments are made once per table: the same
    object while the table's tensors are the same objects at the same
    versions, made anew after a tensor is replaced or written in place."""
    arrays = _boxes() if kind == "plain" else _instanced(4, 11, [0, 1, 0, 1], [1, 2, 3, 0])
    table = proxy_table_from_arrays(arrays, device="cpu")
    cpu = torch.device("cpu")
    first = tmarch.ProxyTableArgs.of(table, cpu)
    assert tmarch.ProxyTableArgs.of(table, cpu) is first
    assert tmarch.ProxyTableArgs.of(table._replace(), cpu) is first
    assert first.pointers[5:] == ([None] * 3 if kind == "plain" else first.pointers[5:])
    replaced = table._replace(aabb_max=table.aabb_max.clone())
    again = tmarch.ProxyTableArgs.of(replaced, cpu)
    assert again is not first and again.keep[1] is replaced.aabb_max
    table.max_length.mul_(1.0)                      # an in-place write
    written = tmarch.ProxyTableArgs.of(table, cpu)
    assert written is not first
    assert tmarch.ProxyTableArgs.of(table, cpu) is written
    if kind == "instanced":
        table.world_to_obj[0, 0, 0] = 2.0
        assert tmarch.ProxyTableArgs.of(table, cpu) is not written
        # a table without its id columns takes the row index as both
        bare = table._replace(obj_id=None, node_id=None)
        ids = tmarch.ProxyTableArgs.of(bare, cpu).keep[3:5]
        assert all(torch.equal(t, torch.arange(4, dtype=torch.int32)) for t in ids)


def test_broken_tables_raise_on_every_call():
    """A table the kernels cannot take raises the same ValueError on every
    call (nothing of it is kept), for proxy tables and scene tables."""
    cpu = torch.device("cpu")
    wide = proxy_table_from_arrays(_boxes(p=33), device="cpu")
    short = proxy_table_from_arrays(_boxes(), device="cpu")
    short = short._replace(max_length=short.max_length[:7])
    scene = device_scene_from_meshes([random_tri_soup(300, seed=2)], tris_per_cluster=32,
                                     device="cpu")
    bad_count = scene._replace(cl_count=scene.cl_count.to(torch.int64))
    for _ in range(2):
        with pytest.raises(ValueError, match="32"):
            tmarch.ProxyTableArgs.of(wide, cpu)
        with pytest.raises(ValueError, match="max_length"):
            tmarch.ProxyTableArgs.of(short, cpu)
        with pytest.raises(ValueError, match="cl_count"):
            tres.scene_tables(bad_count, cpu)
        with pytest.raises(ValueError, match="group tables"):
            tres.scene_tables(scene._replace(cl_gboxes=None), cpu, grouped=True)


@pytest.mark.parametrize("instanced", [False, True])
def test_scene_tables_are_checked_once_per_table(instanced, monkeypatch):
    """The trace kernels' scene tables are validated once per set of tables:
    again after a table is replaced or written in place, never for a repeat
    call; a strided table (an instanced scene's boxes) is made contiguous
    once, with its checks."""
    base = random_tri_soup(300, seed=2)
    if instanced:
        xf = np.tile(np.eye(4, dtype=np.float32)[None, :3], (2, 1, 1))
        xf[1, 0, 3] = 3.0
        scene = device_scene_from_instances([base], xf, tris_per_cluster=32, device="cpu")
    else:
        scene = device_scene_from_meshes([base], tris_per_cluster=32, device="cpu")
    calls = []
    real = tres._validated_tables
    monkeypatch.setattr(tres, "_validated_tables",
                        lambda *a: calls.append(1) or real(*a))
    cpu = torch.device("cpu")
    kept = {}
    for grouped in (False, True, False):
        tab, k, c = tres.scene_tables(scene, cpu, grouped)
        assert k == scene.num_clusters and c == scene.tris_per_cluster
        assert ("cl_xf" in tab) == instanced and ("cl_gboxes" in tab) == grouped
        for name, t in tab.items():
            own = getattr(scene, name)
            assert t.is_contiguous() and torch.equal(t, own)
            assert (t is own) == own.is_contiguous(), name
            assert kept.setdefault((grouped, name), t) is t, name
    assert len(calls) == 2                      # flat once, grouped once
    scene.cl_boxes.add_(0.0)
    tres.scene_tables(scene, cpu)
    tres.scene_tables(scene, cpu)
    assert len(calls) == 3
    moved = scene._replace(scene_aabb=scene.scene_aabb.clone())
    tres.scene_tables(moved, cpu)
    assert len(calls) == 4
    strided = scene._replace(cl_count=torch.stack([scene.cl_count] * 2, 1)[:, 0])
    copies = [tres.scene_tables(strided, cpu)[0]["cl_count"] for _ in range(2)]
    assert copies[0] is copies[1] and copies[0].is_contiguous()
    assert torch.equal(copies[0], scene.cl_count)
    assert len(calls) == 5
    strided.cl_count.add_(0)                    # written through the view
    assert tres.scene_tables(strided, cpu)[0]["cl_count"] is not copies[0]
    assert len(calls) == 6


@pytest.mark.parametrize("q", [0, 1, 7, 4099])
def test_query_columns_are_aligned_views_of_one_allocation(q):
    """The march kernel's output columns: views of one allocation with the
    query's dtypes and shapes, each starting on 16 bytes, none overlapping."""
    cols = tmarch.query_columns(q, "cpu")
    assert set(cols) == set(tmarch._KERNEL_COLUMNS)
    want = {"features": (torch.float32, (q, 5)), "is_inside": (torch.bool, (q,)),
            "is_valid": (torch.bool, (q,)), "aabb_t": (torch.float32, (q,)),
            "max_length": (torch.float32, (q,)), "t_ratio": (torch.float32, (q,)),
            "normalized_t": (torch.float32, (q,))}
    spans = []
    for name, t in cols.items():
        dtype, shape = want.get(name, (torch.int32, (q,)))
        assert t.dtype == dtype and tuple(t.shape) == shape and t.is_contiguous(), name
        assert t.untyped_storage().data_ptr() == cols["features"].untyped_storage().data_ptr()
        assert t.data_ptr() % 16 == 0, name
        spans.append((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
