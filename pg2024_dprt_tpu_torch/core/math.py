"""Vectorized geometry and sampling math (counterpart of
pg2024_dprt_tpu/core/math.py). Every function works on (..., 3) tensors.

Conventions: y-up world; spherical theta = acos(y) in [0, pi], phi =
atan2(z, x) wrapped to [0, 2pi); local shading frames put the normal on +z.

Dot products and norms are written out component by component (left to
right) rather than through a reduction, so their rounding is the same on
every device.
"""
from __future__ import annotations

import math

import torch

EPS = 1e-8


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def safe_inv(d):
    """1 / d with |d| below 1e-12 replaced by +-1e-12 (the sign of d, + at
    0): the slab tests' guarded reciprocal."""
    return 1.0 / torch.where(d.abs() < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d)


def norm(v):
    return torch.sqrt(dot(v, v))


def normalize(v):
    return v / torch.clamp(norm(v), min=EPS)[..., None]


def cartesian_to_spherical(d):
    """Direction -> (phi in [0,2pi), theta in [0,pi]). y-up."""
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    return phi, theta


def spherical_for_train(d):
    """Spherical parameterization of the proxy nets' inputs: the same
    convention as `cartesian_to_spherical`, kept under its own name so that
    training data and inference featurization stay in lockstep."""
    return cartesian_to_spherical(d)


def make_frame(n):
    """Branchless orthonormal basis around normal n (Duff et al. 2017).
    Returns (t, b): tangent/bitangent with n as +z."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def to_world(n, w_local):
    """Local (z=normal) -> world."""
    t, b = make_frame(n)
    return w_local[..., 0:1] * t + w_local[..., 1:2] * b + w_local[..., 2:3] * n


def to_local(n, w_world):
    """World -> local (z=normal)."""
    t, b = make_frame(n)
    return torch.stack([dot(w_world, t), dot(w_world, b), dot(w_world, n)], dim=-1)


def uniform_hemisphere(xi1, xi2):
    """Uniform hemisphere sample around +z (z = xi1)."""
    z = xi1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * xi2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_triangle(p0, p1, p2, xi1, xi2):
    """Uniform area sample of a triangle; returns (point, normal, area_pdf)."""
    su = torch.sqrt(xi1)
    b0 = 1.0 - su
    b1 = xi2 * su
    point = p0 + b0[..., None] * (p1 - p0) + b1[..., None] * (p2 - p0)
    cr = cross(p1 - p0, p2 - p0)
    area = 0.5 * norm(cr)
    normal = cr / torch.clamp(2.0 * area[..., None], min=EPS)
    return point, normal, 1.0 / torch.clamp(area, min=EPS)


def reflect_z(w):
    """Reflect about the local +z axis."""
    return torch.stack([-w[..., 0], -w[..., 1], w[..., 2]], dim=-1)


def refract_z(wo, eta_incident, eta_transmitted):
    """Snell refraction in the local frame (normal = +z). Returns
    (wi, total_internal_reflection_mask)."""
    eta = eta_incident / eta_transmitted
    cos_i = torch.abs(wo[..., 2])
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta * eta * sin2_i
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    sign = torch.where(wo[..., 2] >= 0.0, 1.0, -1.0)
    wi = torch.stack([-eta * wo[..., 0], -eta * wo[..., 1], -sign * cos_t], dim=-1)
    return wi, tir


def dielectric_reflectance(cos_theta_i, eta_incident, eta_transmitted):
    """Exact Fresnel reflectance for a dielectric (unpolarized)."""
    cos_i = torch.clamp(cos_theta_i, 0.0, 1.0)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    eta = eta_incident / eta_transmitted
    sin2_t = eta * eta * sin2_i
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_parl = (eta_transmitted * cos_i - eta_incident * cos_t) / torch.clamp(
        eta_transmitted * cos_i + eta_incident * cos_t, min=EPS)
    r_perp = (eta_incident * cos_i - eta_transmitted * cos_t) / torch.clamp(
        eta_incident * cos_i + eta_transmitted * cos_t, min=EPS)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, f)
