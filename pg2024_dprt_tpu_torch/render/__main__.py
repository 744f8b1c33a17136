"""Command-line renderer (counterpart of pg2024_dprt_tpu/render/__main__.py):
load a scene (an .obj from disk or a named builtin), set up the camera and
lights, render N frames, write PNG / EXR.

Usage:
    python -m pg2024_dprt_tpu_torch.render SCENE [options]

SCENE is a path to a .obj file (materials and PNG textures resolved
relative to it, scene/obj.py) or a builtin:
    cornell | cornell-water | city[:N] | soup[:N] | rooms[:N] | instanced[:I[,T]]

Runs on the GPU (--device cuda, the default) or on the CPU (--device cpu).
--partitions P renders through the P partitions of parallel/ on an
in-process mesh on that one device, so the JAX CLI's --cpu-mesh (a virtual
CPU mesh of P devices) is --device cpu here; --neural first trains every
partition's vis / depth nets (train/) and then routes through them.

Under torchrun the partitions are ranks, one a process (parallel/mesh.py
RankMesh): --partitions must equal the world size, each rank renders its
partition on cuda:LOCAL_RANK over NCCL (or on the CPU over gloo with
--device cpu), and rank 0 prints the report and writes the frames. With
--neural each rank trains its own partition's nets on its device (an
instanced scene's one base pair: rank 0) and receives every other rank's
before the frame.

Examples:
    python -m pg2024_dprt_tpu_torch.render cornell --size 256 --spp 8 --out /tmp/r
    python -m pg2024_dprt_tpu_torch.render bunny.obj --spp 4 --format both
    python -m pg2024_dprt_tpu_torch.render rooms:8 --partitions 8 --neural
    python -m pg2024_dprt_tpu_torch.render rooms:2 --partitions 2 --device cpu
    torchrun --standalone --nproc-per-node 8 -m pg2024_dprt_tpu_torch.render rooms:8 \
        --partitions 8 --neural
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

import numpy as np
import torch

from ..core.camera import Camera
from ..core.device import resolve_device
from ..scene.geometry import device_scene_from_instances, device_scene_from_meshes
from ..scene.lights import EnvironmentMap
from ..scene.procedural import auto_light
from ..utils.timing import Timing
from .config import RenderConfig

BUILTINS = "cornell | cornell-water | city[:N] | soup[:N] | rooms[:N] | instanced[:I[,T]]"


def _parse_vec3(s: str):
    parts = [float(x) for x in s.split(",")]
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(f"expected 'x,y,z', got {s!r}")
    return parts


def load_scene(spec: str, default_color=(0.8, 0.8, 0.8), device=None):
    """Resolve a SCENE spec -> (meshes, lights or None, texture images or
    None); an instanced spec gives ([base mesh], (I, 3, 4) transforms) as
    its meshes. Lights go to `device` (CUDA unless given)."""
    from ..scene.procedural import city_scene, cornell_box, random_tri_soup, two_room_scene

    name, _, arg = spec.partition(":")
    if name in ("cornell", "cornell-water"):
        meshes, lights = cornell_box(with_water_sphere=name == "cornell-water", device=device)
        return meshes, lights, None
    if name == "city":
        return [city_scene(int(arg or 20000))], None, None
    if name == "soup":
        return [random_tri_soup(int(arg or 65536))], None, None
    if name == "rooms":
        meshes, lights = two_room_scene(int(arg or 2), device=device)
        return meshes, lights, None
    if name == "instanced":
        # instanced:I[,T]: a grid of I instances of one T-triangle soup over
        # one shared triangle table
        parts = (arg or "8").split(",")
        ni = int(parts[0])
        tris = int(parts[1]) if len(parts) > 1 else 65536
        base = random_tri_soup(tris, seed=9)
        cols = max(1, int(np.ceil(np.sqrt(ni))))
        tf = np.zeros((ni, 3, 4), np.float32)
        for i in range(ni):
            tf[i, :, :3] = np.eye(3, dtype=np.float32)
            tf[i, :, 3] = [2.2 * (i % cols), 0.0, 2.2 * (i // cols)]
        return ([base], tf), None, None
    if not os.path.exists(spec):
        raise SystemExit(f"scene {spec!r}: no such file and not a builtin ({BUILTINS})")
    from ..scene.obj import load_obj, load_texture_images

    meshes, texture_paths = load_obj(spec, default_color=default_color)
    images = load_texture_images(texture_paths, base_dir=os.path.dirname(spec))
    return meshes, None, images


def scene_bounds(meshes):
    lo = np.full(3, np.inf, np.float32)
    hi = np.full(3, -np.inf, np.float32)
    for m in meshes:
        for v in (m.v0, m.v1, m.v2):
            lo = np.minimum(lo, np.asarray(v).min(axis=0))
            hi = np.maximum(hi, np.asarray(v).max(axis=0))
    return lo, hi


def auto_camera(lo, hi, fov: float, width: int, height: int, device=None):
    """Frame the scene box from a 3/4 view."""
    center = 0.5 * (lo + hi)
    radius = max(0.5 * float(np.linalg.norm(hi - lo)), 1e-3)
    dist = radius / np.tan(np.deg2rad(fov) * 0.5) * 1.15
    eye = center + np.asarray([0.45, 0.35, 1.0]) / np.linalg.norm([0.45, 0.35, 1.0]) * dist
    return Camera.look_at(eye, center, [0.0, 1.0, 0.0], fov, width, height, device=device)


def _pair_row(vis, depth, cfg, losses):
    """A trained vis / depth pair and its two final test losses as one f32
    row: both nets flattened (models/mlp.py flatten_params), then the
    losses."""
    from ..models.mlp import flatten_params

    v = flatten_params(vis, cfg)
    return torch.cat([v, flatten_params(depth, cfg),
                      torch.tensor(losses, dtype=torch.float32, device=v.device)])


def _share_pairs(mesh, rows: dict, cfg):
    """Every partition's pair on every process: `rows` maps some of this
    process's partitions to their _pair_row (a partition left out sends
    zeros). One all_to_all of an (L, P, n) block, each row copied to every
    destination, so out[0, s] is partition s's row: it moves bits unchanged
    (a psum with zeros would turn -0.0 into 0.0). Returns (vis params, depth
    params, (vis loss, depth loss)) a partition, in partition order."""
    from ..models.mlp import param_layout, unflatten_params

    n = sum(math.prod(s) for s in param_layout(cfg).values())
    block = torch.zeros((len(mesh.local), 2 * n + 2), dtype=torch.float32, device=mesh.device)
    for i, p in enumerate(mesh.local):
        if p in rows:
            block[i] = rows[p]
    got = mesh.all_to_all(block[:, None].expand(-1, mesh.size, -1))[0]
    return [(unflatten_params(r[:n], cfg), unflatten_params(r[n:2 * n], cfg), tuple(loss))
            for r, loss in zip(got, got[:, 2 * n:].tolist())]


def train_partition_proxies(meshes, part, mesh, samples: int, epochs: int,
                            width: int = 64, depth: int = 2):
    """The offline stage of the neural workflow: train a vis and a depth net
    for each partition this process holds (`mesh.local`, of `mesh.size`) on
    its real geometry (rays cast at the partition's proxy box, seeds
    100 + p) on the mesh's device, then hand every process every partition's
    nets and stack them in partition order. The process that holds
    partition 0 prints every partition's losses."""
    from ..models.mlp import MLPConfig, stack_params
    from ..models.proxy import ProxyModels
    from ..scene.partition import partition_meshes
    from ..train import TrainConfig, balance_vis, depth_only, fit, generate_proxy_dataset

    assignment = partition_meshes(meshes, mesh.size)
    cfg = MLPConfig(width=width, depth=depth)
    rows = {}
    for p in mesh.local:
        sub = device_scene_from_meshes([meshes[i] for i in assignment[p]], device=mesh.device)
        lo = part.proxies.aabb_min[p].cpu().numpy()
        hi = part.proxies.aabb_max[p].cpu().numpy()
        feats, d = generate_proxy_dataset(sub, lo, hi, samples, seed=100 + p)
        xv, yv = balance_vis(feats, d)
        vp, hv = fit(xv, yv, cfg, TrainConfig(nn_type="vis", epochs=epochs, batch=4096,
                                              learn_rate=5e-3), device=mesh.device)
        xd, yd = depth_only(feats, d)
        if xd.shape[0] < 256:
            xd, yd = feats, d
        dp, hd = fit(xd, yd, cfg, TrainConfig(nn_type="depth", epochs=epochs, batch=4096,
                                              learn_rate=5e-3), device=mesh.device)
        rows[p] = _pair_row(vp, dp, cfg, (hv["test_loss"][-1], hd["test_loss"][-1]))
    pairs = _share_pairs(mesh, rows, cfg)
    if 0 in mesh.local:
        for p, (_, _, (lv, ld)) in enumerate(pairs):
            print(f"partition {p}: vis loss {lv:.4f}", flush=True)
            print(f"partition {p}: depth loss {ld:.4f}", flush=True)
    return ProxyModels(vis_params=stack_params([v for v, _, _ in pairs]),
                       depth_params=stack_params([d for _, d, _ in pairs]),
                       num_objects=mesh.size, vis_cfg=cfg, depth_cfg=cfg)


def _train_base_object(base_meshes, mesh, samples: int, epochs: int):
    """Neural instancing: ONE vis / depth pair trained on the shared base
    object serves every instance through the instance-level proxy rows. The
    process that holds partition 0 trains it on the mesh's device and hands
    it to every process."""
    from ..models.mlp import MLPConfig, stack_params
    from ..models.proxy import ProxyModels
    from ..scene.partition import _meshes_aabb
    from ..train.loop import TrainConfig, train_proxy_for_partition

    mcfg = MLPConfig(width=64, depth=2)
    rows = {}
    if 0 in mesh.local:
        blo, bhi = _meshes_aabb(base_meshes)
        base_scene = device_scene_from_meshes(base_meshes, device=mesh.device)
        nets = {}
        for nn_type in ("vis", "depth"):
            nets[nn_type] = train_proxy_for_partition(
                base_scene, blo, bhi, nn_type, mlp_cfg=mcfg,
                train_cfg=TrainConfig(nn_type=nn_type, epochs=epochs, batch=4096,
                                      learn_rate=5e-3),
                num_samples=samples)
        rows[0] = _pair_row(nets["vis"][0], nets["depth"][0], mcfg,
                            (nets["vis"][1]["test_loss"][-1], nets["depth"][1]["test_loss"][-1]))
    vp, dp, (lv, ld) = _share_pairs(mesh, rows, mcfg)[0]
    if 0 in mesh.local:
        print(f"base-object nets: vis {lv:.4f} depth {ld:.4f}", flush=True)
    return ProxyModels(stack_params([vp]), stack_params([dp]), 1, mcfg, mcfg)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m pg2024_dprt_tpu_torch.render", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", help=f".obj path or builtin ({BUILTINS})")
    p.add_argument("--size", type=int, default=256, help="square image size")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--shadow-paths", type=int, default=4,
                   help="NEE samples per shading point")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--format", choices=("png", "exr", "both"), default="png")
    p.add_argument("--partitions", type=int, default=0,
                   help="render through N partitions on an in-process mesh on the one "
                        "device (exact mode: migration + ring shadows)")
    p.add_argument("--neural", action="store_true",
                   help="with --partitions: train per-partition vis/depth proxies, then "
                        "route secondary/shadow rays through them")
    p.add_argument("--proxy-samples", type=int, default=30000,
                   help="--neural: training rays per partition")
    p.add_argument("--proxy-epochs", type=int, default=25,
                   help="--neural: training epochs per net")
    p.add_argument("--env", type=_parse_vec3, default=[0.0, 0.0, 0.0],
                   metavar="R,G,B", help="constant environment radiance")
    p.add_argument("--cam-pos", type=_parse_vec3, default=None, metavar="X,Y,Z")
    p.add_argument("--cam-target", type=_parse_vec3, default=None, metavar="X,Y,Z")
    p.add_argument("--fov", type=float, default=45.0)
    p.add_argument("--light-intensity", type=float, default=8.0,
                   help="auto area-light radiance scale (scenes without emitters)")
    p.add_argument("--light-velocity", type=_parse_vec3, default=None,
                   metavar="X,Y,Z", help="LIGHT_MOVE: light offset per frame")
    p.add_argument("--dolly", type=_parse_vec3, default=None, metavar="X,Y,Z",
                   help="CAMERA_MOVE: camera offset per frame")
    p.add_argument("--device", default=None,
                   help="torch device: cuda (the default; raises without CUDA) or cpu")
    p.add_argument("--tracer", default="auto",
                   choices=("auto", "stackless", "cluster", "resident"))
    p.add_argument("--fused-frame", default="auto", choices=("auto", "on", "off"))
    p.add_argument("--nee", default="ris", choices=("ris", "sum"),
                   help="NEE estimator: reservoir-selected single occlusion ray (ris) or "
                        "the S-ray sum")
    p.add_argument("--visibility-grids", action="store_true",
                   help="with --partitions (exact mode): conservative per-partition "
                        "visibility grids pre-filter migrations and ring-shadow hops "
                        "(image unchanged)")
    args = p.parse_args(argv)
    from ..parallel.mesh import make_rank_mesh

    rank_mesh = None
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")):   # torchrun
        world = int(os.environ["WORLD_SIZE"])
        if args.partitions != world:
            raise ValueError(f"under torchrun --partitions ({args.partitions}) must equal the "
                             f"world size ({world}): one partition a rank")
        rank_mesh = make_rank_mesh(world, device=None if args.device in (None, "cuda")
                                   else args.device)
        dev = rank_mesh.device
    else:
        dev = resolve_device(args.device)

    w = args.width or args.size
    h = args.height or args.size
    meshes, lights, textures = load_scene(args.scene, device=dev)
    instanced_spec = isinstance(meshes, tuple)
    if instanced_spec:
        base_meshes, transforms = meshes
        blo, bhi = scene_bounds(base_meshes)
        corners = np.stack([np.where(np.asarray(sel), bhi, blo)
                            for sel in np.ndindex(2, 2, 2)])
        wc = (np.einsum("iab,cb->ica", transforms[:, :, :3], corners)
              + transforms[:, None, :, 3])
        lo = wc.reshape(-1, 3).min(axis=0).astype(np.float32)
        hi = wc.reshape(-1, 3).max(axis=0).astype(np.float32)
    else:
        lo, hi = scene_bounds(meshes)
    if lights is None:
        lights = auto_light(lo, hi, args.light_intensity, device=dev)
    if args.cam_pos is not None:
        target = args.cam_target if args.cam_target is not None else list(0.5 * (lo + hi))
        camera = Camera.look_at(args.cam_pos, target, [0, 1, 0], args.fov, w, h, device=dev)
    else:
        camera = auto_camera(lo, hi, args.fov, w, h, device=dev)
    env = EnvironmentMap.constant(args.env, device=dev)
    cfg = RenderConfig(width=w, height=h, spp=args.spp, bounces=args.bounces,
                       shadow_path_count=args.shadow_paths, tracer=args.tracer,
                       fused_frame=args.fused_frame, nee_mode=args.nee,
                       use_visibility_grids=args.visibility_grids)
    timing = Timing()

    from .frames import render_frames

    if args.partitions > 1 or rank_mesh is not None:
        from ..parallel import make_mesh
        from ..scene.partition import build_partitioned_scene, build_partitioned_scene_instanced

        # a rank builds on the host; the frame moves its own partition to
        # its device
        build_dev = dev if rank_mesh is None else "cpu"
        if instanced_spec:
            part = build_partitioned_scene_instanced(
                base_meshes, transforms, args.partitions,
                visibility_grids=args.visibility_grids, device=build_dev)
        else:
            part = build_partitioned_scene(meshes, args.partitions, textures=textures,
                                           visibility_grids=args.visibility_grids,
                                           device=build_dev)
        mesh = rank_mesh or make_mesh(args.partitions, dev)
        # exact mode reads no nets (JAX passes random ones for its compiled
        # program's structure)
        models = None
        if args.neural:
            # each process trains the partitions it holds, on its device,
            # and receives every other partition's nets
            with timing.section("Train"):
                if instanced_spec:
                    models = _train_base_object(base_meshes, mesh, args.proxy_samples,
                                                args.proxy_epochs)
                else:
                    models = train_partition_proxies(meshes, part, mesh, args.proxy_samples,
                                                     args.proxy_epochs)
            cfg = dataclasses.replace(cfg, use_neural_proxies=True)
        images = render_frames(
            None, lights, env, camera, cfg, num_frames=args.frames, timing=timing,
            distributed=(part, models, mesh), light_velocity=args.light_velocity,
            camera_velocity=args.dolly)
    else:
        if instanced_spec:
            scene = device_scene_from_instances(base_meshes, transforms, device=dev)
        else:
            scene = device_scene_from_meshes(meshes, textures=textures, device=dev)
        images = render_frames(scene, lights, env, camera, cfg, num_frames=args.frames,
                               timing=timing, light_velocity=args.light_velocity,
                               camera_velocity=args.dolly, device=dev)

    if rank_mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
        if rank_mesh.rank != 0:
            return images
    os.makedirs(args.out, exist_ok=True)
    for i, img in enumerate(images):
        if args.format in ("exr", "both"):
            from ..utils.exr import write_exr

            write_exr(os.path.join(args.out, f"frame{i}.exr"), img)
        if args.format in ("png", "both"):
            from ..utils.png import write_png

            write_png(os.path.join(args.out, f"frame{i}.png"), img)
    print(timing.report())
    print(f"wrote {len(images)} frame(s) ({w}x{h}, {args.spp}spp, {args.bounces} bounces) "
          f"to {args.out}/; mean luminance {float(np.mean(images[0])):.4f}")
    return images


if __name__ == "__main__":
    main(sys.argv[1:])
