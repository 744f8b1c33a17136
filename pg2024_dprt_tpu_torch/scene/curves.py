"""Round cubic B-spline curve primitives, hair and fur geometry (counterpart
of pg2024_dprt_tpu/scene/curves.py).

`CurveSet.from_bspline` flattens each uniform cubic B-spline segment (4
control points and per-control radii) into L round-cone (swept-sphere)
pieces at build time, in float64 numpy, so the piece tables equal the JAX
package's bit for bit. `ops/curve_intersect.py` intersects ray wavefronts
against the flattened table; `ops/trace_api.py` merges the curve hit into
the triangle closest hit and the curve any-hit into occlusion, and
`render/shade.py` shades a curve winner diffuse in the strand colour.

The JAX module's `kernel_table` (a transposed, 8-padded layout for a TPU
kernel that no code calls) is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device

# uniform cubic B-spline basis (rows: 1, u, u^2, u^3)
_BSPLINE = np.asarray(
    [[1, 4, 1, 0],
     [-3, 0, 3, 0],
     [3, -6, 3, 0],
     [-1, 3, -3, 1]], np.float64
) / 6.0


class CurveSet(NamedTuple):
    """Flattened swept-sphere pieces of all curve segments.

    p0/p1 (M, 3) f32 piece endpoints, r0/r1 (M,) f32 endpoint radii, seg_id
    (M,) i32 source B-spline segment, color (3,) f32 strand albedo."""

    p0: torch.Tensor
    p1: torch.Tensor
    r0: torch.Tensor
    r1: torch.Tensor
    seg_id: torch.Tensor
    color: torch.Tensor

    @property
    def num_pieces(self) -> int:
        return self.p0.shape[0]

    def aabb(self):
        """(lo, hi) (M, 3) swept-sphere box of every piece."""
        lo = torch.minimum(self.p0 - self.r0[:, None], self.p1 - self.r1[:, None])
        hi = torch.maximum(self.p0 + self.r0[:, None], self.p1 + self.r1[:, None])
        return lo, hi

    def to(self, device) -> "CurveSet":
        return CurveSet(*(x.to(device) for x in self))

    @staticmethod
    def from_bspline(control_points, radii, pieces_per_segment: int = 8,
                     color=(0.4, 0.3, 0.2), tolerance: float = None,
                     device=None) -> "CurveSet":
        """control_points: (S, 4, 3), one row of 4 control points per cubic
        B-spline segment (overlapping windows of a strand's control
        polygon); radii: (S, 4). The set goes to `device` (CUDA unless the
        caller passes another).

        `tolerance` (world units) picks pieces_per_segment from the derived
        surface-deviation bound (ops/curve_exact.py pieces_for_tolerance):
        the cone surface is then within `tolerance` of the exact round
        B-spline surface."""
        dev = resolve_device(device)
        cp = np.asarray(control_points, np.float64)
        rr = np.asarray(radii, np.float64)
        if tolerance is not None:
            from ..ops.curve_exact import pieces_for_tolerance

            pieces_per_segment = pieces_for_tolerance(cp, rr, tolerance)
        s = cp.shape[0]
        l = pieces_per_segment
        u = np.linspace(0.0, 1.0, l + 1)
        powers = np.stack([np.ones_like(u), u, u * u, u ** 3], axis=-1)  # (L+1,4)
        w = powers @ _BSPLINE                                            # (L+1,4)
        pts = np.einsum("lc,scd->sld", w, cp)                            # (S,L+1,3)
        rad = np.einsum("lc,sc->sl", w, rr)                              # (S,L+1)
        p0 = pts[:, :-1].reshape(s * l, 3)
        p1 = pts[:, 1:].reshape(s * l, 3)
        r0 = rad[:, :-1].reshape(s * l)
        r1 = rad[:, 1:].reshape(s * l)
        seg = np.repeat(np.arange(s, dtype=np.int32), l)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        return CurveSet(
            p0=t(p0.astype(np.float32)),
            p1=t(p1.astype(np.float32)),
            r0=t(np.maximum(r0, 1e-6).astype(np.float32)),
            r1=t(np.maximum(r1, 1e-6).astype(np.float32)),
            seg_id=t(seg),
            color=t(np.asarray(color, np.float32)),
        )

    @staticmethod
    def from_strand(points, radius, pieces_per_segment: int = 8,
                    color=(0.4, 0.3, 0.2), device=None) -> "CurveSet":
        """Build from one strand polyline: points (P, 3) control polygon
        with a constant or per-point radius; emits P - 3 overlapping
        B-spline windows."""
        pts = np.asarray(points, np.float64)
        p = pts.shape[0]
        if p < 4:
            raise ValueError("a cubic B-spline strand needs >= 4 control points")
        rad = np.broadcast_to(np.asarray(radius, np.float64), (p,))
        windows = np.stack([pts[i:i + 4] for i in range(p - 3)])
        rwin = np.stack([rad[i:i + 4] for i in range(p - 3)])
        return CurveSet.from_bspline(windows, rwin, pieces_per_segment, color,
                                     device=device)
