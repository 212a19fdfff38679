"""Batched closed-form symmetric 3x3 eigendecomposition + compact
rotation codecs (quaternion / Shoemake).

This is the voxelwise hot path behind Hessian saliency and tensor
voting, so it is written as pure branch-free jnp math over arrays of
shape (..., 6) / (..., 3, 3): every reference branch becomes a
``jnp.where`` select, so the solver is branch-free elementwise code.
Reference: ``lib/visfd/eigen3_simple.hpp:36-399`` (trigonometric root
solver + cross-product kernel extraction, from Eigen's
SelfAdjointEigenSolver lineage) and ``lib/visfd/lin3_utils.hpp:
225-399`` (quaternion/Shoemake codecs).

Flat symmetric-6 layout matches ``MapIndices_3x3_to_linear``
(``lin3_utils.hpp:400-404``): [xx, yy, zz, xy, yz, xz].

Behavioral notes mirrored from the reference:

* The "diagonalized flat" 6-vector is [eival0, eival1, eival2,
  shoemake0, shoemake1, shoemake2] where the Shoemake coords encode
  the ROW-eigenvector matrix.  (The reference's in-place
  ``Transpose3(m)`` is a double-swap no-op, ``lin3_utils.hpp:199-203``,
  so despite the comment about column vectors the packed matrix keeps
  eigenvectors in rows.)
* If the eigenvector matrix has negative determinant, row 0 is
  negated first (``eigen3_simple.hpp:318-321``).
* Nearly-degenerate pairs reproduce the reference's quirky
  "orthogonalization" v_l <- normalize(rep * (1 - dot(v_k, rep)))
  (``eigen3_simple.hpp:219-228`` -- the subtraction uses eivects[l]
  on both sides, so it reduces to a rescale of the representative).
"""

from __future__ import annotations

import enum
import functools

import jax
import jax.numpy as jnp
import numpy as np


class EigenOrder(enum.Enum):
    """Eigenvalue orderings (``eigen3_simple.hpp:36-43``)."""

    INCREASING = "increasing"
    DECREASING = "decreasing"
    INCREASING_ABS = "increasing_abs"
    DECREASING_ABS = "decreasing_abs"
    INCREASINGLY_DISTINCT = "increasingly_distinct"
    DECREASINGLY_DISTINCT = "decreasingly_distinct"


def full_to_flat(m: jax.Array) -> jax.Array:
    """(..., 3, 3) symmetric -> (..., 6) flat [xx,yy,zz,xy,yz,xz]."""
    return jnp.stack(
        [m[..., 0, 0], m[..., 1, 1], m[..., 2, 2],
         m[..., 0, 1], m[..., 1, 2], m[..., 0, 2]], axis=-1)


def flat_to_full(f: jax.Array) -> jax.Array:
    """(..., 6) flat -> (..., 3, 3) symmetric."""
    xx, yy, zz, xy, yz, xz = (f[..., i] for i in range(6))
    row0 = jnp.stack([xx, xy, xz], axis=-1)
    row1 = jnp.stack([xy, yy, yz], axis=-1)
    row2 = jnp.stack([xz, yz, zz], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def _compute_roots3(m: jax.Array) -> jax.Array:
    """Trigonometric roots of the characteristic polynomial of a
    (..., 3, 3) symmetric matrix, sorted increasing
    (``eigen3_simple.hpp:47-82``)."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    m10, m20, m21 = m[..., 1, 0], m[..., 2, 0], m[..., 2, 1]
    c0 = (m00 * m11 * m22 + 2.0 * m10 * m20 * m21
          - m00 * m21 * m21 - m11 * m20 * m20 - m22 * m10 * m10)
    c1 = (m00 * m11 - m10 * m10 + m00 * m22 - m20 * m20
          + m11 * m22 - m21 * m21)
    c2 = m00 + m11 + m22

    inv3 = 1.0 / 3.0
    sqrt3 = np.sqrt(3.0)
    c2_over_3 = c2 * inv3
    a_over_3 = jnp.maximum((c2 * c2_over_3 - c1) * inv3, 0.0)
    half_b = 0.5 * (c0 + c2_over_3 * (2.0 * c2_over_3 * c2_over_3 - c1))
    q = jnp.maximum(a_over_3 ** 3 - half_b * half_b, 0.0)
    rho = jnp.sqrt(a_over_3)
    theta = jnp.arctan2(jnp.sqrt(q), half_b) * inv3
    cos_t, sin_t = jnp.cos(theta), jnp.sin(theta)
    r0 = c2_over_3 - rho * (cos_t + sqrt3 * sin_t)
    r1 = c2_over_3 - rho * (cos_t - sqrt3 * sin_t)
    r2 = c2_over_3 + 2.0 * rho * cos_t
    return jnp.stack([r0, r1, r2], axis=-1)


def _cross(a, b):
    return jnp.cross(a, b)


def _extract_kernel3(mat: jax.Array):
    """Null-space direction of a rank-2 symmetric (..., 3, 3) matrix
    plus a "representative" near-orthogonal vector
    (``eigen3_simple.hpp:88-137``). Returns (res, representative)."""
    diag = jnp.abs(jnp.stack([mat[..., 0, 0], mat[..., 1, 1],
                              mat[..., 2, 2]], axis=-1))
    i0 = jnp.argmax(diag, axis=-1)  # (...,)

    def take(idx):
        # column (idx % 3) of mat, picked by selects: exact, where a
        # one-hot matrix product may run at reduced (TF32) precision
        j = (idx % 3)[..., None]
        return jnp.where(j == 0, mat[..., :, 0],
                         jnp.where(j == 1, mat[..., :, 1], mat[..., :, 2]))

    rep = take(i0)
    c0 = _cross(rep, take(i0 + 1))
    c1 = _cross(rep, take(i0 + 2))
    n0 = jnp.sum(c0 * c0, axis=-1, keepdims=True)
    n1 = jnp.sum(c1 * c1, axis=-1, keepdims=True)
    use0 = n0 > n1
    c = jnp.where(use0, c0, c1)
    n = jnp.where(use0, n0, n1)
    res = c / jnp.sqrt(jnp.maximum(n, np.finfo(np.float32).tiny))
    return res, rep


def _normalize(v):
    n = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    return v / jnp.maximum(n, np.finfo(np.float32).tiny)


@functools.partial(jax.jit, static_argnames=("order", "want_vects"))
def diagonalize_sym3(
    mat: jax.Array,
    order: EigenOrder = EigenOrder.INCREASING,
    want_vects: bool = True,
):
    """Eigenvalues (and row-eigenvectors) of (..., 3, 3) symmetric
    matrices; branch-free port of ``DiagonalizeSym3``
    (``eigen3_simple.hpp:139-266``).

    Returns (eivals, eivects) with eivects[..., i, :] the eigenvector
    of eivals[..., i] (or None when want_vects=False).
    """
    dtype = mat.dtype
    eps = jnp.asarray(np.finfo(np.dtype(dtype.name)).eps, dtype)
    shift = (mat[..., 0, 0] + mat[..., 1, 1] + mat[..., 2, 2]) / 3.0
    eye = jnp.eye(3, dtype=dtype)
    scaled = mat - shift[..., None, None] * eye
    scale = jnp.max(jnp.abs(scaled), axis=(-2, -1))
    safe = jnp.where(scale > 0, scale, 1.0)
    scaled = scaled / safe[..., None, None]

    eivals = _compute_roots3(scaled)  # increasing

    eivects = None
    if want_vects:
        l0, l1, l2 = eivals[..., 0], eivals[..., 1], eivals[..., 2]
        # k = index of most distinct extreme eigenvalue
        d0 = l2 - l1
        d1 = l1 - l0
        k_is_0 = d0 > d1  # then k=0 (l0 most distinct), else k=2
        d_small = jnp.minimum(d0, d1)
        d_large = jnp.where(k_is_0, d1, d0)
        lam_k = jnp.where(k_is_0, l0, l2)
        lam_l = jnp.where(k_is_0, l2, l0)

        tmp_k = scaled - lam_k[..., None, None] * eye
        vk, rep = _extract_kernel3(tmp_k)

        # near-degenerate remaining pair: the reference's branch
        # reduces to normalize(rep * (1 - dot(vk, rep)))
        k_dot_rep = jnp.sum(vk * rep, axis=-1, keepdims=True)
        vl_degen = _normalize(rep * (1.0 - k_dot_rep))

        tmp_l = scaled - lam_l[..., None, None] * eye
        vl_full, _ = _extract_kernel3(tmp_l)

        degen = d_small <= 2.0 * eps * d_large
        vl = jnp.where(degen[..., None], vl_degen, vl_full)

        # scatter into (v0, v1, v2): row k gets vk, row l gets vl,
        # middle row = cross(v2, v0) normalized
        v0 = jnp.where(k_is_0[..., None], vk, vl)
        v2 = jnp.where(k_is_0[..., None], vl, vk)
        v1 = _normalize(_cross(v2, v0))

        # wholly-degenerate: all three eigenvalues equal -> identity
        iso = (l2 - l0) <= eps
        v0 = jnp.where(iso[..., None], eye[0], v0)
        v1 = jnp.where(iso[..., None], eye[1], v1)
        v2 = jnp.where(iso[..., None], eye[2], v2)
        eivects = jnp.stack([v0, v1, v2], axis=-2)

    eivals = eivals * safe[..., None] + shift[..., None]

    # ordering: conditional swap of first and last (eigen3_simple.hpp
    # :239-263); base order is increasing
    l0, l2 = eivals[..., 0], eivals[..., 2]
    if order == EigenOrder.INCREASING:
        do_swap = l0 > l2  # never (already sorted)
    elif order == EigenOrder.DECREASING:
        do_swap = l0 < l2
    elif order == EigenOrder.INCREASING_ABS:
        do_swap = jnp.abs(l0) > jnp.abs(l2)
    elif order == EigenOrder.DECREASING_ABS:
        do_swap = jnp.abs(l0) < jnp.abs(l2)
    elif order == EigenOrder.INCREASINGLY_DISTINCT:
        do_swap = eivals[..., 1] - l0 > l2 - eivals[..., 1]
    elif order == EigenOrder.DECREASINGLY_DISTINCT:
        do_swap = eivals[..., 1] - l0 < l2 - eivals[..., 1]
    else:  # pragma: no cover
        raise ValueError(order)

    swapped_vals = eivals[..., ::-1]
    eivals = jnp.where(do_swap[..., None], swapped_vals, eivals)
    if want_vects:
        swapped_vects = eivects[..., ::-1, :]
        eivects = jnp.where(do_swap[..., None, None], swapped_vects, eivects)
    return eivals, eivects


@functools.partial(jax.jit, static_argnames=("order",))
def principal_sym3(
    mat: jax.Array,
    order: EigenOrder = EigenOrder.DECREASING,
):
    """Eigenvalues + ONLY the principal (first-in-order) eigenvector.

    Fast path for the membrane/curve pipeline, which consumes
    ``eivals`` and ``eivects[..., 0, :]`` and never the other two rows
    (``handlers.cpp:1645-1746``): one kernel extraction instead of the
    full solver's two extractions + degenerate blend + cross.  Agrees
    with ``diagonalize_sym3`` everywhere the principal eigenvalue is
    simple; where it is (near-)degenerate the feature scores built
    from it vanish, so downstream results match.

    Returns (eivals (..., 3) in `order`, v1 (..., 3)).
    """
    if order not in (EigenOrder.INCREASING, EigenOrder.DECREASING):
        raise ValueError("principal_sym3 supports INCREASING/DECREASING")
    dtype = mat.dtype
    eye = jnp.eye(3, dtype=dtype)
    shift = (mat[..., 0, 0] + mat[..., 1, 1] + mat[..., 2, 2]) / 3.0
    scaled = mat - shift[..., None, None] * eye
    scale = jnp.max(jnp.abs(scaled), axis=(-2, -1))
    safe = jnp.where(scale > 0, scale, 1.0)
    scaled = scaled / safe[..., None, None]

    vals = _compute_roots3(scaled)  # increasing
    lam_p = vals[..., 2] if order == EigenOrder.DECREASING else vals[..., 0]
    v1, _ = _extract_kernel3(scaled - lam_p[..., None, None] * eye)

    vals = vals * safe[..., None] + shift[..., None]
    if order == EigenOrder.DECREASING:
        vals = vals[..., ::-1]
    return vals, v1


def matrix_to_quaternion(m: jax.Array) -> jax.Array:
    """Rotation matrix -> quaternion [w, x, y, z], 4-branch select
    (``lin3_utils.hpp:231-269``)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def pack(w, x, y, z):
        return jnp.stack([w, x, y, z], axis=-1)

    tiny = np.finfo(np.float32).tiny
    s_a = jnp.sqrt(jnp.maximum(tr + 1.0, 0.0)) * 2
    qa = pack(0.25 * s_a, (m21 - m12) / jnp.maximum(s_a, tiny),
              (m02 - m20) / jnp.maximum(s_a, tiny),
              (m10 - m01) / jnp.maximum(s_a, tiny))
    s_b = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 0.0)) * 2
    qb = pack((m21 - m12) / jnp.maximum(s_b, tiny), 0.25 * s_b,
              (m01 + m10) / jnp.maximum(s_b, tiny),
              (m02 + m20) / jnp.maximum(s_b, tiny))
    s_c = jnp.sqrt(jnp.maximum(1.0 + m11 - m00 - m22, 0.0)) * 2
    qc = pack((m02 - m20) / jnp.maximum(s_c, tiny),
              (m01 + m10) / jnp.maximum(s_c, tiny), 0.25 * s_c,
              (m12 + m21) / jnp.maximum(s_c, tiny))
    s_d = jnp.sqrt(jnp.maximum(1.0 + m22 - m00 - m11, 0.0)) * 2
    qd = pack((m10 - m01) / jnp.maximum(s_d, tiny),
              (m02 + m20) / jnp.maximum(s_d, tiny),
              (m12 + m21) / jnp.maximum(s_d, tiny), 0.25 * s_d)

    case_a = (tr > 0)[..., None]
    case_b = ((m00 > m11) & (m00 > m22))[..., None]
    case_c = (m11 > m22)[..., None]
    return jnp.where(case_a, qa, jnp.where(case_b, qb,
                     jnp.where(case_c, qc, qd)))


def quaternion_to_matrix(q: jax.Array) -> jax.Array:
    """Quaternion [w, x, y, z] -> rotation matrix
    (``lin3_utils.hpp:280-311``)."""
    w, x, y, z = (q[..., i] for i in range(4))
    row0 = jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                      2 * (x * z + y * w)], axis=-1)
    row1 = jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                      2 * (y * z - x * w)], axis=-1)
    row2 = jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                      1 - 2 * (x * x + y * y)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def quaternion_to_shoemake(q: jax.Array) -> jax.Array:
    """Quaternion [w, x, y, z] -> Shoemake coords [X0, X1, X2]
    (``lin3_utils.hpp:344-377``; the reference's storage convention
    maps its q[0..3] = our [w, x, y, z])."""
    two_pi = 2.0 * np.pi
    w, x, y, z = (q[..., i] for i in range(4))
    r1sq = w * w + x * x
    r2sq = y * y + z * z
    x0 = r2sq
    theta1 = jnp.where(r1sq > 0, jnp.arctan2(w, x), 0.0)
    theta2 = jnp.where(r2sq > 0, jnp.arctan2(y, z), 0.0)
    return jnp.stack([x0, theta1 / two_pi, theta2 / two_pi], axis=-1)


def shoemake_to_quaternion(sm: jax.Array) -> jax.Array:
    """Shoemake coords -> quaternion (``lin3_utils.hpp:311-341``)."""
    two_pi = 2.0 * np.pi
    x0, x1, x2 = (sm[..., i] for i in range(3))
    t1, t2 = two_pi * x1, two_pi * x2
    r1 = jnp.sqrt(jnp.maximum(1.0 - x0, 0.0))
    r2 = jnp.sqrt(jnp.maximum(x0, 0.0))
    return jnp.stack([jnp.sin(t1) * r1, jnp.cos(t1) * r1,
                      jnp.sin(t2) * r2, jnp.cos(t2) * r2], axis=-1)


def matrix_to_shoemake(m: jax.Array) -> jax.Array:
    return quaternion_to_shoemake(matrix_to_quaternion(m))


def shoemake_to_matrix(sm: jax.Array) -> jax.Array:
    return quaternion_to_matrix(shoemake_to_quaternion(sm))


@functools.partial(jax.jit, static_argnames=("order",))
def diagonalize_flat_sym3(
    flat: jax.Array,
    order: EigenOrder = EigenOrder.INCREASING,
) -> jax.Array:
    """(..., 6) flat symmetric -> (..., 6) [eivals(3), shoemake(3)]
    (``eigen3_simple.hpp:273-342``). The Shoemake coords encode the
    row-eigenvector matrix after a det>0 fix-up (row 0 negated when
    det < 0)."""
    m = flat_to_full(flat)
    eivals, eivects = diagonalize_sym3(m, order=order)
    # closed-form 3x3 determinant v0 . (v1 x v2): elementwise, where
    # jnp.linalg.det runs a batched LU factorization per voxel
    det = jnp.sum(eivects[..., 0, :]
                  * _cross(eivects[..., 1, :], eivects[..., 2, :]), axis=-1)
    flip = (det < 0)[..., None]
    v0 = jnp.where(flip, -eivects[..., 0, :], eivects[..., 0, :])
    eivects = jnp.concatenate([v0[..., None, :], eivects[..., 1:, :]],
                              axis=-2)
    sm = matrix_to_shoemake(eivects)
    return jnp.concatenate([eivals, sm], axis=-1)


@jax.jit
def undiagonalize_flat_sym3(diag: jax.Array) -> jax.Array:
    """Inverse of diagonalize_flat_sym3: rebuild the flat symmetric
    matrix sum_d eival_d * v_d v_d^T from [eivals, shoemake]
    (``eigen3_simple.hpp:348-388``)."""
    eivals = diag[..., :3]
    eivects = shoemake_to_matrix(diag[..., 3:6])  # rows = eigenvectors
    # elementwise products and a sum, not a contraction: exact f32
    m = jnp.sum(eivals[..., :, None, None] * eivects[..., :, :, None]
                * eivects[..., :, None, :], axis=-3)
    return full_to_flat(m)


def flat_eigenvectors(diag: jax.Array):
    """[eivals, shoemake] -> (eivals, row-eigenvector matrix), the
    ``ConvertDiagFlatSym2Evects3`` unpacking
    (``lin3_utils.hpp:566-585``)."""
    return diag[..., :3], shoemake_to_matrix(diag[..., 3:6])
