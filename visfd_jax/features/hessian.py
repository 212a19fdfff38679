"""Gaussian-scale gradient/Hessian fields and ridge saliency scores.

Parity targets: ``CalcHessian`` (``feature.hpp:1203-1348``) --
Gaussian blur then central finite differences, scaled by sigma /
sigma^2 for Lindeberg scale invariance; FD stencils from
``visfd_utils.hpp:528-682`` (edge voxels evaluate the stencil at the
nearest interior voxel); ``DiagonalizeHessianImage`` /
``UndiagonalizeHessianImage`` (``feature.hpp:1364-1514``); saliency
scores (``feature.hpp:1526-1612``).

Formulation: all stencils are shift-sums over the whole (Z, Y, X)
grid (fusable elementwise code); the voxelwise eigendecomposition is
the batched closed-form solver from ``visfd_jax.linalg.sym3``.
``ridge_score_direction`` and ``tensor_score_direction`` put the
CLI's chains under one ``jit`` each, so XLA can fuse the stencil, the
solver and the score.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from visfd_jax.linalg import sym3
from visfd_jax.ops import filters as F


def _edge_clamp(result: jax.Array) -> jax.Array:
    """Replicate the stencil evaluated at the nearest interior voxel
    onto the faces -- equivalent to the reference's coordinate
    clamping (``visfd_utils.hpp:592-610``)."""
    return jnp.pad(result[1:-1, 1:-1, 1:-1], 1, mode="edge")


def _sh(x, dz, dy, dx):
    """x shifted so out[p] = x[p + (dz,dy,dx)], zero padded (the pad
    values never survive: _edge_clamp discards the faces)."""
    out = jnp.roll(x, shift=(-dz, -dy, -dx), axis=(0, 1, 2))
    return out


def gradient_fd(smoothed: jax.Array) -> jax.Array:
    """Central-difference gradient, (Z, Y, X, 3) in (x, y, z) order
    (``visfd_utils.hpp:629-682``)."""
    gx = 0.5 * (_sh(smoothed, 0, 0, 1) - _sh(smoothed, 0, 0, -1))
    gy = 0.5 * (_sh(smoothed, 0, 1, 0) - _sh(smoothed, 0, -1, 0))
    gz = 0.5 * (_sh(smoothed, 1, 0, 0) - _sh(smoothed, -1, 0, 0))
    g = jnp.stack([gx, gy, gz], axis=-1)
    return jnp.pad(g[1:-1, 1:-1, 1:-1], ((1, 1), (1, 1), (1, 1), (0, 0)),
                   mode="edge")


def hessian_fd(smoothed: jax.Array) -> jax.Array:
    """3x3 central-difference Hessian flattened to (Z, Y, X, 6)
    [xx, yy, zz, xy, yz, xz] (``visfd_utils.hpp:528-566``)."""
    c = smoothed
    hxx = _sh(c, 0, 0, 1) + _sh(c, 0, 0, -1) - 2 * c
    hyy = _sh(c, 0, 1, 0) + _sh(c, 0, -1, 0) - 2 * c
    hzz = _sh(c, 1, 0, 0) + _sh(c, -1, 0, 0) - 2 * c
    hxy = 0.25 * (_sh(c, 0, 1, 1) + _sh(c, 0, -1, -1)
                  - _sh(c, 0, -1, 1) - _sh(c, 0, 1, -1))
    hyz = 0.25 * (_sh(c, 1, 1, 0) + _sh(c, -1, -1, 0)
                  - _sh(c, -1, 1, 0) - _sh(c, 1, -1, 0))
    hxz = 0.25 * (_sh(c, 1, 0, 1) + _sh(c, -1, 0, -1)
                  - _sh(c, 1, 0, -1) - _sh(c, -1, 0, 1))
    h = jnp.stack([hxx, hyy, hzz, hxy, hyz, hxz], axis=-1)
    return jnp.pad(h[1:-1, 1:-1, 1:-1], ((1, 1), (1, 1), (1, 1), (0, 0)),
                   mode="edge")


def calc_hessian(
    x: jax.Array,
    sigma: float,
    mask: Optional[jax.Array] = None,
    truncate_ratio: float = 2.5,
    want_gradient: bool = True,
) -> Tuple[Optional[jax.Array], jax.Array]:
    """Blur at scale sigma then return (gradient*sigma,
    hessian*sigma^2) as (Z,Y,X,3) / (Z,Y,X,6) fields
    (``feature.hpp:1203-1348``). Voxels where mask == 0 are computed
    anyway (cheap, elementwise) -- callers gate on the mask
    downstream, as the reference leaves those entries
    zero-initialized."""
    hw = max(1, int(np.floor(sigma * truncate_ratio)))
    smoothed = F.apply_gauss(x, sigma, mask=mask, truncate_halfwidth=(hw,) * 3)
    grad = None
    if want_gradient:
        grad = gradient_fd(smoothed) * sigma
        if mask is not None:
            grad = grad * (mask[..., None] != 0)
    hess = hessian_fd(smoothed) * (sigma * sigma)
    if mask is not None:
        hess = hess * (mask[..., None] != 0)
    return grad, hess


@functools.partial(jax.jit, static_argnames=("order",))
def diagonalize_hessian_image(
    hess_flat: jax.Array,
    mask: Optional[jax.Array] = None,
    order: sym3.EigenOrder = sym3.EigenOrder.DECREASING_ABS,
) -> jax.Array:
    """Voxelwise eigendecomposition of a (Z, Y, X, 6) symmetric-tensor
    field into [eivals(3), shoemake(3)] (``feature.hpp:1364-1471``;
    default ordering there is DECREASING_ABS_EIVALS). Masked-out
    voxels are zeroed."""
    out = sym3.diagonalize_flat_sym3(hess_flat, order=order)
    if mask is not None:
        out = out * (mask[..., None] != 0)
    return out


@jax.jit
def undiagonalize_hessian_image(
    diag: jax.Array,
    mask: Optional[jax.Array] = None,
) -> jax.Array:
    """Inverse voxelwise rebuild (``feature.hpp:1477-1514``)."""
    out = sym3.undiagonalize_flat_sym3(diag)
    if mask is not None:
        out = out * (mask[..., None] != 0)
    return out


def score_hessian_planar(eivals: jax.Array) -> jax.Array:
    """Ridge "surfaceness": (lambda1^2 - lambda2^2)^2 with eigenvalues
    sorted by decreasing magnitude (``feature.hpp:1526-1568``,
    Lindeberg's Ngamma norm)."""
    l1, l2 = eivals[..., 0], eivals[..., 1]
    n = l1 * l1 - l2 * l2
    return n * n


def score_hessian_linear(eivals: jax.Array) -> jax.Array:
    """Curve-ness score lambda1*lambda2 - lambda3^2
    (``feature.hpp:1573-1589``)."""
    l1, l2, l3 = eivals[..., 0], eivals[..., 1], eivals[..., 2]
    return l1 * l2 - l3 * l3


def score_tensor_planar(eivals: jax.Array) -> jax.Array:
    """Stick saliency ("stickness") lambda1 - lambda2 of a vote tensor
    (``feature.hpp:1592-1601``)."""
    return eivals[..., 0] - eivals[..., 1]


def score_tensor_linear(eivals: jax.Array) -> jax.Array:
    """Curve saliency of a vote tensor (``feature.hpp:1604-1612``)."""
    return score_hessian_linear(eivals)


def score_direction_from_derivatives(grad, hess, mask, order, score):
    """The front end's tail: mask the scaled derivatives as
    ``calc_hessian`` does, then the principal eigensolve and ``score``
    (see ``ridge_score_direction``)."""
    if mask is not None:
        grad = grad * (mask[..., None] != 0)
        hess = hess * (mask[..., None] != 0)
    if score == "edge":
        return jnp.linalg.norm(grad, axis=-1), grad
    eivals, ev1 = sym3.principal_sym3(sym3.flat_to_full(hess), order=order)
    if score == "linear":
        return score_hessian_linear(eivals), ev1
    return score_hessian_planar(eivals), ev1


@functools.partial(jax.jit, static_argnames=("sigma", "truncate_ratio",
                                             "order", "score"))
def _ridge_score_direction(x, mask, sigma, truncate_ratio, order, score):
    hw = max(1, int(np.floor(sigma * truncate_ratio)))
    blur = F.apply_gauss(x, sigma, mask=mask, truncate_halfwidth=(hw,) * 3)
    return score_direction_from_derivatives(
        gradient_fd(blur) * sigma, hessian_fd(blur) * (sigma * sigma),
        mask, order, score)


def ridge_score_direction(x, mask, sigma: float, truncate_ratio: float,
                          order: sym3.EigenOrder, score: str):
    """The ``-membrane``/``-curve``/``-edge`` front end as one jitted
    chain: blur at ``sigma`` -> FD gradient/Hessian -> principal
    eigensolve -> score.  ``score`` is "planar" (surfaces), "linear"
    (curves) or "edge" (gradient magnitude).  Returns (score (Z, Y, X),
    direction (Z, Y, X, 3)): the principal Hessian eigenvector, or the
    gradient for "edge".  A volume block-sharded over a (z, y) device
    grid (``-mesh``) runs block by block with halo exchange
    (``parallel.sharded.ridge_score_direction_sharded``), equal to the
    single-device result."""
    from visfd_jax.parallel.mesh import grid_mesh_of
    mesh = grid_mesh_of(x)
    if mesh is not None and mesh.devices.size > 1:
        from visfd_jax.parallel.sharded import (
            ridge_score_direction_sharded)
        return ridge_score_direction_sharded(
            x, mask, mesh, float(sigma), float(truncate_ratio), order, score)
    return _ridge_score_direction(x, mask, float(sigma),
                                  float(truncate_ratio), order, score)


@functools.partial(jax.jit, static_argnames=("order", "linear"))
def tensor_score_direction(vote, order: sym3.EigenOrder, linear: bool):
    """Saliency of a (Z, Y, X, 6) vote-tensor field and its principal
    eigenvector, in one jitted pass over the field: stick saliency
    (``score_tensor_planar``), or ``score_tensor_linear`` for curves."""
    eivals, v1 = sym3.principal_sym3(sym3.flat_to_full(vote), order=order)
    if linear:
        return score_tensor_linear(eivals), v1
    return score_tensor_planar(eivals), v1
