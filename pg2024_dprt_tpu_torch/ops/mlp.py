"""The vis/depth net pair of the neural proxies (counterpart of
pg2024_dprt_tpu/ops/pallas_mlp.py): for every query the vis and the depth
net of the query's own object, both in one launch.

Two kernels written by hand for Hopper, in csrc/proxy_mlp.cu:
  * `mlp_pair` (K5, `grouped_mlp_pair`) replaces _pair_kernel: the wrapper
    groups the queries by object with one stable sort, the kernel runs each
    object's nets over chunks of its segment, the wrapper un-sorts;
  * `mlp_dense` (K6, `grouped_mlp_dense`) replaces _dense_kernel: queries stay
    in ray order with a per-row object id, nothing runs around the kernel;
    a block per (part of the batch, object) gathers its object's rows.
Both return (vis, depth) f32 of shape (Q,), zero where `valid` is false.
They take the single-output, non-multi-geo architecture at any width, depth
and head_hidden, with architecturally identical vis and depth nets. Every
Linear runs on the tensor cores in the kernels' own bodies
(csrc/proxy_mlp.cuh): bf16 operands, f32 accumulation in a fixed order, so
K5, K6 and the fused route kernel K7 give a row the same bits.

Beside each is its plain PyTorch version (`grouped_mlp_pair_plain`,
`grouped_mlp_dense_plain`): masked per-object passes with the same operand
rounding. A wrapper runs the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.

The kernels read every object's nets from two packed buffers (`pack_nets`):
weights bf16 in fragment order (each Linear zero-padded to 16 x 16 blocks,
laid out so that a lane's tensor-core B fragments are one 16-byte load) and
biases f32 (O, biases per net), per object the Linears in param_shapes
order. The wrappers take the ProxyModels record; `packed_pair` keeps the
packed copy on it and makes it anew when a param tensor changed.

Which kernel a model set takes is the JAX package's rule
(`DENSE_WEIGHT_LIMIT` on the bf16 bytes of both nets' params): it is a
dispatch policy, kept so that both packages pick the same kernel for the
same models.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..models.mlp import MLPConfig, bias_name, param_shapes, same_architecture
from ..models.proxy import apply_grouped_reference
from ..utils.timing import launch_span
from . import _build
from .resident import LAUNCHES, _check, _checked, _ptr, _stream

# models whose bf16 params (both nets, all objects) are at most this many
# bytes take the dense kernel, larger ones the pair kernel
DENSE_WEIGHT_LIMIT = 10 * 2**20

ACTIVATIONS = {"none": 0, "leaky_relu": 1, "sigmoid": 2}
MAX_FEATURES = 8      # csrc/proxy_mlp.cuh kMaxFeatures
SMEM_LIMIT = 232448   # bytes of shared memory a block can use on an H100
KERNEL_ROWS = 16      # csrc/proxy_mlp.cuh kRows: an m16 tile
MAX_CHUNK_ROWS = 64   # csrc/proxy_mlp.cu kMaxTiles x 16: K5 / K6 chunks at most
KERNEL_THREADS = 256  # csrc/proxy_mlp.cuh kThreads (the threads of a route tile)
# csrc/proxy_mlp.cuh: the feature plane's columns and every row's bf16 pad
FEATURE_COLS, ROW_PAD = 32, 8
# K6 (csrc/proxy_mlp.cu mlp_dense_kernel): its row list and warp counts
# beside the forward's shared memory, at most
DENSE_LIST_BYTES = (MAX_CHUNK_ROWS + KERNEL_THREADS + KERNEL_THREADS // 32) * 4
# K6's grid: about this many (part, object) blocks an SM, parts of at least
# DENSE_MIN_PART rows
DENSE_BLOCKS_PER_SM = 2
DENSE_MIN_PART = 1024


def param_bytes(params: dict) -> int:
    """Bytes of a param dict held as bf16."""
    return sum(int(a.numel()) * 2 for a in params.values())


def use_dense(vis_params: dict, depth_params: dict) -> bool:
    return param_bytes(vis_params) + param_bytes(depth_params) <= DENSE_WEIGHT_LIMIT


def pair_refusal(vis_cfg: MLPConfig, depth_cfg: MLPConfig, multi_geo: bool = False):
    """Why the pair kernels (K5, K6, and K7's nets) do not take this pair of
    architectures, or None when they do. K5 and K6 take the single-output
    family; with `multi_geo` the question is K7's, which also takes the
    shared multi-geo net (6 inputs)."""
    if not same_architecture(vis_cfg, depth_cfg):
        return "the pair kernels need architecturally identical vis/depth nets"
    for cfg in (vis_cfg, depth_cfg):
        if cfg.out_features != 1:
            return "the pair kernels take single-output nets"
        if cfg.multi_geo != multi_geo:
            return ("the route kernel's multi-geo mode takes multi-geo nets only"
                    if multi_geo else "the pair kernels take non-multi-geo nets")
        if cfg.final_activation not in ACTIVATIONS:
            return f"unknown final activation {cfg.final_activation!r}"
    c = vis_cfg
    if (c.width < 16 or c.width % 8 or not 3 <= c.in_features <= MAX_FEATURES
            or not 1 <= c.head_hidden <= c.width):
        return f"the pair kernels do not take the architecture {c}"
    if multi_geo and c.in_features != 6:
        return f"the multi-geo mode does not take the architecture {c}"
    if forward_smem_bytes(c) + 4096 > SMEM_LIMIT:
        return f"width {c.width} exceeds the kernels' shared memory"
    return None


def _check_pair(vis_cfg: MLPConfig, depth_cfg: MLPConfig):
    reason = pair_refusal(vis_cfg, depth_cfg)
    if reason:
        raise ValueError(reason)


def _round16(v: int) -> int:
    return (v + 15) // 16 * 16


def forward_smem_bytes(cfg: MLPConfig, rows: int = KERNEL_ROWS) -> int:
    """Bytes of shared memory the nets' forward needs for chunks of `rows`
    (csrc/proxy_mlp.cuh smem_bytes): two bf16 activation planes, the bf16
    feature plane, the f32 plane h, the f32 predictions."""
    ld_act = max(_round16(cfg.width), 2 * _round16(cfg.width // 8)) + ROW_PAD
    ld_f32 = cfg.width + ROW_PAD
    return (rows * (2 * ld_act + FEATURE_COLS + ROW_PAD) * 2 + rows * ld_f32 * 4
            + rows * 2 * cfg.out_features * 4)


def chunk_rows(cfg: MLPConfig) -> int:
    """Rows of a K5 / K6 chunk: the most, up to MAX_CHUNK_ROWS in steps of
    an m16 tile, whose shared memory fits beside K6's row list."""
    for rows in range(MAX_CHUNK_ROWS, KERNEL_ROWS - 1, -KERNEL_ROWS):
        if forward_smem_bytes(cfg, rows) + DENSE_LIST_BYTES <= SMEM_LIMIT:
            return rows
    raise ValueError(f"width {cfg.width} exceeds the kernels' shared memory")


def dense_parts(q: int, num_objects: int, device) -> int:
    """Parts K6 cuts a batch of q rows into (its grid is parts x objects):
    about DENSE_BLOCKS_PER_SM blocks an SM, no part under DENSE_MIN_PART
    rows, at least one."""
    device = torch.device(device)
    sms = _sms(device.index if device.index is not None else torch.cuda.current_device())
    return max(1, min(-(-q // DENSE_MIN_PART), -(-DENSE_BLOCKS_PER_SM * sms // num_objects)))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """The streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def pack_nets(params: dict, cfg: MLPConfig, num_objects: int):
    """(weights (O, W) bf16, biases (O, B) f32) of stacked params as the
    kernels read them: per object the Linears in param_shapes order, each
    weight (in, out) zero-padded to K = round16(in) rows and N = round16(out)
    columns and laid out as [pair p of 16 columns][k-step s][lane][8] with
    W[16 s + 8 half + 2 t + e][16 p + 8 h + g] at lane 4 g + t, element
    4 h + 2 half + e (csrc/proxy_mlp.cuh: a lane's B fragments of two n-tiles
    over one k-step are one 16-byte load)."""
    ws, bs = [], []
    for wn, fi, fo in param_shapes(cfg):
        w, b = params[wn], params[bias_name(wn)]
        if tuple(w.shape) != (num_objects, fi, fo) or tuple(b.shape) != (num_objects, fo):
            raise ValueError(f"{wn}: want stacked shapes {(num_objects, fi, fo)} and "
                             f"{(num_objects, fo)}, got {tuple(w.shape)} and {tuple(b.shape)}")
        k, n = _round16(fi), _round16(fo)
        padded = torch.zeros((num_objects, k, n), dtype=torch.bfloat16, device=w.device)
        padded[:, :fi, :fo] = w
        # (o, s, half, t, e, p, h, g) -> (o, p, s, g, t, h, half, e)
        frag = padded.view(num_objects, k // 16, 2, 4, 2, n // 16, 2, 8)
        ws.append(frag.permute(0, 5, 1, 7, 3, 6, 2, 4).reshape(num_objects, k * n))
        bs.append(b)
    return (torch.cat(ws, dim=1).contiguous(),
            torch.cat(bs, dim=1).to(torch.float32).contiguous())


def packed_pair(models):
    """(vis weights, vis biases, depth weights, depth biases) of a
    ProxyModels record packed by `pack_nets`, as K5, K6 and K7 read them (a
    multi-geo record's one shared pair as a table of one net). The packed
    copy is kept on the record beside the param tensors it was made from and
    their versions, and is made anew when a param was replaced or written in
    place since."""
    tensors = [*models.vis_params.values(), *models.depth_params.values()]
    versions = [t._version for t in tensors]
    kept = models.cache.get("packed_pair")
    # the kept tensors stay alive, so `is` cannot match a new tensor
    if (kept is None or kept[1] != versions or len(kept[0]) != len(tensors)
            or any(a is not b for a, b in zip(kept[0], tensors))):
        if models.multi_geo:
            one = lambda params: {k: v[None] for k, v in params.items()}
            packs = (pack_nets(one(models.vis_params), models.vis_cfg, 1),
                     pack_nets(one(models.depth_params), models.depth_cfg, 1))
        else:
            packs = (pack_nets(models.vis_params, models.vis_cfg, models.num_objects),
                     pack_nets(models.depth_params, models.depth_cfg, models.num_objects))
        kept = (tensors, versions, (*packs[0], *packs[1]))
        models.cache["packed_pair"] = kept
    return kept[2]


def _kernel_args(models, features, obj_id, valid):
    """Validate what K5/K6 read; returns (features, obj_id i32, valid,
    packed buffers, the architecture's C arguments)."""
    vis_cfg, depth_cfg = models.vis_cfg, models.depth_cfg
    _check_pair(vis_cfg, depth_cfg)
    dev = features.device
    if dev.type != "cuda":
        raise ValueError(f"queries on {dev}: the kernels take CUDA tensors")
    q = features.shape[0]
    if 2 * q >= 2**31:
        raise ValueError("query count exceeds int32")
    x = _checked("features", features, torch.float32, (q, vis_cfg.in_features), dev)
    if obj_id.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"obj_id: want an integer tensor, got {obj_id.dtype}")
    obj = _checked("obj_id", obj_id.to(torch.int32), torch.int32, (q,), dev)
    val = _checked("valid", valid, torch.bool, (q,), dev)
    packed = packed_pair(models)
    for name, buf in zip(("vis_w", "vis_b", "depth_w", "depth_b"), packed):
        if buf.device != dev:
            raise ValueError(f"{name} on {buf.device}, queries on {dev}")
    arch = (vis_cfg.width, vis_cfg.depth, vis_cfg.in_features, vis_cfg.head_hidden,
            ACTIVATIONS[vis_cfg.final_activation], ACTIVATIONS[depth_cfg.final_activation])
    return x, obj, val, packed, arch


def grouped_mlp_pair(models, features, obj_id, valid):
    """(vis, depth) of every query by its own object's nets of the
    ProxyModels record: K5 for CUDA tensors (one stable sort by object, the
    kernel over the segments, the un-sort), the plain version for CPU
    tensors."""
    if features.device.type == "cpu":
        return grouped_mlp_pair_plain(models, features, obj_id, valid)
    with launch_span("mlp_pair", features.shape[0]):
        x, obj, val, packed, arch = _kernel_args(models, features, obj_id, valid)
        num_objects = models.num_objects
        q, dev = x.shape[0], x.device
        in_range = val & (obj >= 0) & (obj < num_objects)
        key = torch.where(in_range, obj.to(torch.int64), num_objects)
        sorted_key, perm = torch.sort(key, stable=True)
        seg = torch.searchsorted(
            sorted_key, torch.arange(num_objects + 1, dtype=torch.int64, device=dev))
        xs = x[perm]
        out_sorted = torch.zeros((q, 2), dtype=torch.float32, device=dev)
        rc = _lib().mlp_pair(_ptr(xs), _ptr(seg), q, num_objects, *map(_ptr, packed),
                             *arch, chunk_rows(models.vis_cfg), _ptr(out_sorted), _stream(x))
        _check(rc, "mlp_pair")
        if q:
            LAUNCHES["mlp_pair"] += 1
    out = torch.empty_like(out_sorted)
    out[perm] = out_sorted
    return out[:, 0], out[:, 1]


def grouped_mlp_dense(models, features, obj_id, valid):
    """(vis, depth) of every query by its own object's nets, queries in ray
    order: K6 for CUDA tensors, the plain version for CPU tensors."""
    if features.device.type == "cpu":
        return grouped_mlp_dense_plain(models, features, obj_id, valid)
    with launch_span("mlp_dense", features.shape[0]):
        x, obj, val, packed, arch = _kernel_args(models, features, obj_id, valid)
        q = x.shape[0]
        out = torch.empty((q, 2), dtype=torch.float32, device=x.device)
        rc = _lib().mlp_dense(_ptr(x), _ptr(obj), _ptr(val), q, models.num_objects,
                              dense_parts(q, models.num_objects, x.device), *map(_ptr, packed),
                              *arch, chunk_rows(models.vis_cfg), _ptr(out), _stream(x))
        _check(rc, "mlp_dense")
        if q:
            LAUNCHES["mlp_dense"] += 1
    return out[:, 0], out[:, 1]


def _lib():
    lib = _build.load("proxy_mlp")
    if not getattr(lib, "_pg_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mlp_pair.argtypes = [p, p, i, i] + [p] * 4 + [i] * 7 + [p, p]
        lib.mlp_pair.restype = i
        lib.mlp_dense.argtypes = [p, p, p, i, i, i] + [p] * 4 + [i] * 7 + [p, p]
        lib.mlp_dense.restype = i
        lib._pg_typed = True
    return lib


# --------------------------------------------------------------------------
# plain PyTorch versions (masked per-object passes, bf16 operands)

def grouped_mlp_pair_plain(models, features, obj_id, valid):
    """Plain version of K5: O masked full-batch passes per net."""
    _check_pair(models.vis_cfg, models.depth_cfg)
    args = (features, obj_id, valid, models.num_objects)
    return (apply_grouped_reference(models.vis_params, models.vis_cfg, *args),
            apply_grouped_reference(models.depth_params, models.depth_cfg, *args))


def grouped_mlp_dense_plain(models, features, obj_id, valid):
    """Plain version of K6: the same function as K5's (the two kernels
    differ in the order they are given the queries, not in the result)."""
    return grouped_mlp_pair_plain(models, features, obj_id, valid)
