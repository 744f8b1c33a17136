"""Wavefront shading in one launch: render/shade.py `shade` on CUDA tensors.

The kernel, K14 `shade_paths` in csrc/shade.cu, is written by hand for
Hopper; its source says what it computes, how, and what bounds it. It
shares the shading device functions of the fused frame K3 (csrc/shade.cuh).
Its plain version is render/shade.py `shade_plain`, the eager tensor code
the JAX-parity tests hold; `shade` picks between the two by the tensors'
device. The wrapper takes CUDA tensors only: it launches the kernel or
raises. `LAUNCHES["shade_paths"]` counts the launches.

It replaces no TPU kernel: the JAX package shades with XLA-fused jnp code.
On this card the eager version issued about 700 ops over every row of a
buffer at each call, and its host time, not the card, set the pace of the
partitioned frame (PERF.md).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.rng import tea_int
from ..core.types import PathState
from ..render.shade import RIS_SALT, RR_SALT
from ..utils.timing import launch_span
from . import _build
from .resident import LAUNCHES, _check, _checked, _ptr, _stream, stamped


def shade_paths(scene, lights, env, paths: PathState, hits, sample_count: int,
                bounce: int, shadow_path_count: int, frame_buffer_size: int,
                nee_mode: str = "sum", rr: bool = False):
    """One shade pass of CUDA tensors in one launch of K14, the contract of
    render/shade.py `shade`: (next_paths, shadow_paths, env_image_add)."""
    dev = paths.origin.device
    if dev.type != "cuda":
        raise ValueError(f"paths on {dev}: the kernel takes CUDA tensors")
    n, s, npix = paths.capacity, int(shadow_path_count), int(frame_buffer_size)
    ris = nee_mode == "ris" and s > 1
    m = n if ris else n * s
    if n >= 2**31 or m >= 2**31:
        raise ValueError("row count exceeds int32")
    with launch_span("shade_paths", n):
        f32, i64, flag = torch.float32, torch.int64, torch.bool
        rows = [_checked(name, x, dtype, shape, dev) for name, x, dtype, shape in (
            ("origin", paths.origin, f32, (n, 3)),
            ("direction", paths.direction, f32, (n, 3)),
            ("throughput", paths.throughput, f32, (n, 3)),
            ("pixel_index", paths.pixel_index, i64, (n,)),
            ("is_valid", paths.is_valid, flag, (n,)),
            ("is_shadow", paths.is_shadow, flag, (n,)),
            ("hits.t", hits.t, f32, (n,)),
            ("hits.tri_index", hits.tri_index, torch.int32, (n,)),
            ("hits.u", hits.u, f32, (n,)),
            ("hits.v", hits.v, f32, (n,)),
            ("hits.is_hit", hits.is_hit, flag, (n,)))]
        # `tab` holds the tables' contiguous copies until the launch is enqueued
        tab, table_args = shade_tables(scene, lights, env, dev)
        salt = tea_int(int(sample_count), int(bounce))

        out = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype, device=dev)
        nxt = PathState(origin=out(n, 3), direction=out(n, 3), tmax=out(n),
                        throughput=out(n, 3), pixel_index=rows[3],
                        shadow_path_id=out(n, dtype=i64), is_shadow=out(n, dtype=flag),
                        is_delta=out(n, dtype=flag), is_valid=out(n, dtype=flag))
        shadow = PathState(origin=out(m, 3), direction=out(m, 3), tmax=out(m),
                           throughput=out(m, 3),
                           pixel_index=rows[3] if ris else out(m, dtype=i64),
                           shadow_path_id=out(m, dtype=i64), is_shadow=out(m, dtype=flag),
                           is_delta=out(m, dtype=flag), is_valid=out(m, dtype=flag))
        env_add = torch.zeros((npix, 3), dtype=f32, device=dev)
        outs = [nxt.origin, nxt.direction, nxt.tmax, nxt.throughput, nxt.shadow_path_id,
                nxt.is_shadow, nxt.is_delta, nxt.is_valid, shadow.origin, shadow.direction,
                shadow.tmax, shadow.throughput, None if ris else shadow.pixel_index,
                shadow.shadow_path_id, shadow.is_shadow, shadow.is_delta, shadow.is_valid,
                env_add]
        ptr = lambda x: None if x is None else _ptr(x)
        rc = _lib().shade_paths(
            n, npix, *map(_ptr, rows), *table_args, salt,
            tea_int(salt, RIS_SALT), tea_int(salt, RR_SALT), s, int(ris), int(bool(rr)),
            *map(ptr, outs), _stream(paths.origin))
        _check(rc, "shade_paths")
        if n:
            LAUNCHES["shade_paths"] += 1
    return nxt, shadow, env_add


def shade_tables(scene, lights, env, device):
    """The C entry point's table arguments, from tri_shade to env_rot: the
    scene, light and environment tables K14 reads, validated and contiguous.
    The checks run once per set of tables, and the contiguous copies of
    strided tables are made once: both are kept (ops/resident.py
    `stamped`), and a table replaced or written in place since is checked
    and copied again."""
    f32, i32 = torch.float32, torch.int32
    t_n, l_n = scene.tri_shade.shape[0], lights.count
    eh, ew = env.image.shape[0], env.image.shape[1]
    specs = [("tri_shade", scene.tri_shade, f32, (t_n, 24))]
    if scene.instanced:
        specs.append(("cl_xf", scene.cl_xf, f32, (scene.cl_xf.shape[0], 1, 16)))
    if scene.curves is not None:
        cs, mp = scene.curves, scene.curves.num_pieces
        specs += [(f"curves.{name}", getattr(cs, name), f32, shape) for name, shape in (
            ("p0", (mp, 3)), ("p1", (mp, 3)), ("r0", (mp,)), ("r1", (mp,)), ("color", (3,)))]
    n_tex = scene.albedo_textures.count if scene.textured else 0
    if n_tex:
        tex = scene.albedo_textures
        specs.append(("texels", tex.texels, f32, (tex.texels.shape[0], 4)))
        specs += [(f"textures.{name}", getattr(tex, name), i32, (n_tex,))
                  for name in ("offset", "height", "width")]
    specs += [(f"lights.{name}", getattr(lights, name), f32, (l_n, 3))
              for name in ("p0", "p1", "p2", "radiance")]
    specs.append(("env", env.image, f32, (eh, ew, 3)))

    def validate():
        if l_n < 1:
            raise ValueError("the light table has no rows: NEE picks a light by index")
        if scene.instanced and scene.cl_xf.shape[0] * t_n >= 2**31:
            raise ValueError("virtual triangle ids exceed int32")
        checked = {name: _checked(name, x, dtype, shape, device)
                   for name, x, dtype, shape in specs}
        # keep the copies only: the scene's own tables stay its to free
        return {name: c for (name, x, _, _), c in zip(specs, checked.values()) if c is not x}

    copies = stamped(("shade_tables", str(device)), [x for _, x, _, _ in specs], validate)
    tab = {name: copies.get(name, x) for name, x, _, _ in specs}
    p = lambda name: _ptr(tab[name]) if name in tab else None
    return (tab, (p("tri_shade"), t_n, p("cl_xf"),
                  *(p(f"curves.{k}") for k in ("p0", "p1", "r0", "r1", "color")),
                  p("texels"), *(p(f"textures.{k}") for k in ("offset", "height", "width")),
                  n_tex, *(p(f"lights.{k}") for k in ("p0", "p1", "p2", "radiance")),
                  l_n, p("env"), eh, ew, float(env.rotation_offset)))


def _lib():
    lib = _build.load("shade")
    if not getattr(lib, "_pg_typed", False):
        p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        lib.shade_paths.argtypes = (
            [i, i] + [p] * 11                       # N, npix, paths and hits
            + [p, i, p] + [p] * 5                   # tri_shade, TB, xf, curves
            + [p] * 4 + [i]                         # textures
            + [p] * 4 + [i] + [p, i, i, f]          # lights, environment
            + [u, u, u, i, i, i]                    # salts, S, ris, rr
            + [p] * 18 + [p])                       # outputs, stream
        lib.shade_paths.restype = i
        lib._pg_typed = True
    return lib
