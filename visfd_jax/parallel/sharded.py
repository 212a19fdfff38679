"""Sharded (multi-chip) voxel pipelines via shard_map + halo exchange.

The (Z, Y, X) grid is block-partitioned over a ("z", "y") mesh
(``visfd_jax.parallel.mesh``); every stencil stage pulls its halo rows
from its mesh neighbours (``halo_pad``, collective permutes) and
computes locally, so the sharded results match the single-device
zero-padded stencils exactly.  This replaces the reference's OpenMP
loop parallelism (SURVEY 2.5) and its only large-tomogram strategy
(binning): the volume itself scales across devices.

``make_membrane_step`` builds the flagship end-to-end step:
Gaussian blur -> FD gradient/Hessian -> voxelwise eigen ->
planar saliency -> threshold -> dense stick tensor voting ->
vote-tensor eigen -> stick saliency.  It jit-compiles over the mesh
with real (z, y) block shardings.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from visfd_jax.ops import kernels as K
from visfd_jax.ops.conv import _conv1d_axis_impl
from visfd_jax.features import tv as TV
from visfd_jax.linalg import sym3
from visfd_jax.parallel.halo import halo_pad, halo_pad_2d


def _local_conv_sliced(xp: jax.Array, kernel, axis: int, halo: int):
    """Convolve a halo-padded block along ``axis`` and slice out the
    valid interior."""
    out = _conv1d_axis_impl(xp, kernel, axis)
    if halo == 0:
        return out
    sl = [slice(None)] * xp.ndim
    sl[axis] = slice(halo, xp.shape[axis] - halo)
    return out[tuple(sl)]


def _sharded_sep3(v, kx, ky, kz, z_name="z", y_name="y"):
    """Raw separable blur of a sharded block: the z, y and x passes of
    ``ops.conv._sep3`` in its order, each sharded axis first extended by
    its neighbours' rows."""
    hz, hy = len(kz) // 2, len(ky) // 2
    v = _local_conv_sliced(halo_pad(v, hz, 0, z_name), kz, 0, hz)
    v = _local_conv_sliced(halo_pad(v, hy, 1, y_name), ky, 1, hy)
    return _conv1d_axis_impl(v, kx, 2)


def _sharded_gauss(x, kx, ky, kz, hw, z_name="z", y_name="y"):
    """Separable blur of a local block with halo exchange; the no-mask
    edge normalization (filter3d.hpp:1006-1040) divides by the same
    rank-1 (dz*dy)*dx 1-D denominators as the single-device path
    (``_separable_conv3d_nomask``), computed over the GLOBAL axis
    lengths and sliced to this block -- bit-identical to the
    single-device result and one full blur cheaper than the round-4
    blur-of-ones formulation."""
    from visfd_jax.ops.conv import _ones_denom_1d

    num = _sharded_sep3(x, kx, ky, kz, z_name, y_name)
    bz, by_, nxl = x.shape
    dz_full = _ones_denom_1d(kz, bz * jax.lax.axis_size(z_name))
    dy_full = _ones_denom_1d(ky, by_ * jax.lax.axis_size(y_name))
    dx = _ones_denom_1d(kx, nxl)
    dz = jax.lax.dynamic_slice(
        dz_full, (jax.lax.axis_index(z_name) * bz,), (bz,))
    dy = jax.lax.dynamic_slice(
        dy_full, (jax.lax.axis_index(y_name) * by_,), (by_,))
    return num / (dz[:, None, None] * dy[None, :, None]
                  * dx[None, None, :])


def _sharded_stencil_edge_fix(res, axis, axis_name):
    """Replicate the stencil result of the nearest interior voxel onto
    the global boundary faces of a sharded axis (the reference's
    coordinate clamping, visfd_utils.hpp:592-610)."""
    idx = jax.lax.axis_index(axis_name)
    n_shards = jax.lax.axis_size(axis_name)
    first = jnp.take(res, jnp.asarray(1), axis=axis)
    last = jnp.take(res, jnp.asarray(res.shape[axis] - 2), axis=axis)
    res = res.at[(slice(None),) * axis + (0,)].set(
        jnp.where(idx == 0, first,
                  jnp.take(res, jnp.asarray(0), axis=axis)))
    res = res.at[(slice(None),) * axis + (res.shape[axis] - 1,)].set(
        jnp.where(idx == n_shards - 1, last,
                  jnp.take(res, jnp.asarray(res.shape[axis] - 1),
                           axis=axis)))
    return res


def _local_gradient_hessian(blur_block, z_name="z", y_name="y"):
    """FD gradient + flat-6 Hessian of a sharded block: halo 1 along
    z/y, local along x, with global edge clamping on all axes."""
    p = halo_pad_2d(blur_block, 1, 1, z_name, y_name)
    p = jnp.pad(p, ((0, 0), (0, 0), (1, 1)))  # x zero pad (clamped later)

    def sh(dz, dy, dx):
        nz, ny, nx = blur_block.shape
        return jax.lax.dynamic_slice(p, (1 + dz, 1 + dy, 1 + dx),
                                     (nz, ny, nx))

    c = blur_block
    gx = 0.5 * (sh(0, 0, 1) - sh(0, 0, -1))
    gy = 0.5 * (sh(0, 1, 0) - sh(0, -1, 0))
    gz = 0.5 * (sh(1, 0, 0) - sh(-1, 0, 0))
    hxx = sh(0, 0, 1) + sh(0, 0, -1) - 2 * c
    hyy = sh(0, 1, 0) + sh(0, -1, 0) - 2 * c
    hzz = sh(1, 0, 0) + sh(-1, 0, 0) - 2 * c
    hxy = 0.25 * (sh(0, 1, 1) + sh(0, -1, -1) - sh(0, -1, 1) - sh(0, 1, -1))
    hyz = 0.25 * (sh(1, 1, 0) + sh(-1, -1, 0) - sh(-1, 1, 0) - sh(1, -1, 0))
    hxz = 0.25 * (sh(1, 0, 1) + sh(-1, 0, -1) - sh(1, 0, -1) - sh(-1, 0, 1))
    grad = jnp.stack([gx, gy, gz], axis=-1)
    hess = jnp.stack([hxx, hyy, hzz, hxy, hyz, hxz], axis=-1)

    # x-axis edge clamp is local; z/y clamps are shard-aware
    def clamp_x(a):
        a = a.at[:, :, 0].set(a[:, :, 1])
        return a.at[:, :, -1].set(a[:, :, -2])

    grad = clamp_x(grad)
    hess = clamp_x(hess)
    grad = _sharded_stencil_edge_fix(grad, 0, z_name)
    hess = _sharded_stencil_edge_fix(hess, 0, z_name)
    grad = _sharded_stencil_edge_fix(grad, 1, y_name)
    hess = _sharded_stencil_edge_fix(hess, 1, y_name)
    return grad, hess


@functools.partial(jax.jit, static_argnames=(
    "mesh", "sigma", "truncate_ratio", "order", "score"))
def ridge_score_direction_sharded(x, mask, mesh: Mesh, sigma: float,
                                  truncate_ratio: float,
                                  order: sym3.EigenOrder, score: str):
    """``features.hessian.ridge_score_direction`` of a volume
    block-sharded over the (z, y) ``mesh``, block by block: the blur
    and the FD stencils take their halo rows from the neighbours and run
    the single-device arithmetic, so the result equals one device's bit
    for bit.  (Partitioned by GSPMD instead, the blur rounds differently
    in the last bit, and the FD Hessian's second differences amplify
    that to ~1e-5 of the score.)"""
    from visfd_jax.features import hessian as FH
    z_name, y_name = mesh.axis_names
    hw = max(1, int(np.floor(sigma * truncate_ratio)))
    k1 = jnp.asarray(K.gauss_kernel_1d(sigma, hw), jnp.float32)

    def local(xb, *mb):
        if mb:
            m = mb[0]
            num = _sharded_sep3(xb * m, k1, k1, k1, z_name, y_name)
            den = _sharded_sep3(m, k1, k1, k1, z_name, y_name)
            blur = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0),
                             num)
        else:
            blur = _sharded_gauss(xb, k1, k1, k1, hw, z_name, y_name)
        grad, hess = _local_gradient_hessian(blur, z_name, y_name)
        return FH.score_direction_from_derivatives(
            grad * sigma, hess * (sigma * sigma), mb[0] if mb else None,
            order, score)

    spec = P(z_name, y_name)
    args = (x,) if mask is None else (x, mask)
    return shard_map(local, mesh=mesh, in_specs=(spec,) * len(args),
                     out_specs=(spec, P(z_name, y_name, None)),
                     check_vma=False)(*args)


def _halo_pad_fields(sal, nvec, mask, hw, z_name, y_name):
    """Pad a block's TV source fields by the vote radius: neighbour rows
    along the sharded z/y axes (zeros outside the global volume, the
    reference's out-of-bounds skip), zeros along the local x axis."""
    xpad = ((0, 0), (0, 0), (hw, hw))

    def pad(f, extra=()):
        return jnp.pad(halo_pad_2d(f, hw, hw, z_name, y_name),
                       xpad + extra)

    return (pad(sal), pad(nvec, ((0, 0),)),
            None if mask is None else pad(mask))


def _sharded_tv(sal, nvec, tv_hw, w_t, rhat_t, off_t, exponent,
                z_name="z", y_name="y", kernel_tables=None,
                interpret=False, sparse=False):
    """Dense stick voting on a sharded block: halo-exchange the
    (saliency, direction) fields by the vote radius, then vote locally
    -- through the Triton kernel when ``kernel_tables`` (the concrete
    (w, rhat) tables) are given, else through the XLA shift-sum."""
    # the XLA path's in-bounds indicator: halo_pad of ones zero-fills
    # outside the global volume -- exactly the reference's
    # out-of-bounds skip
    ones = None if kernel_tables is not None else jnp.ones_like(sal)
    sal_pad, n_pad, m_pad = _halo_pad_fields(sal, nvec, ones, tv_hw,
                                             z_name, y_name)
    if kernel_tables is not None:
        from visfd_jax.ops.tv_triton import tv_accumulate_padded_triton
        dest, _ = tv_accumulate_padded_triton(
            sal_pad, n_pad, None, sal.shape, *kernel_tables, exponent,
            False, tv_hw, False, sparse=sparse, interpret=interpret)
        return dest
    dest, _ = TV.tv_accumulate_padded(
        sal_pad, n_pad, m_pad, sal.shape,
        w_t, rhat_t, off_t, exponent, False, tv_hw, False)
    return dest


def tv_accumulate_sharded(
    saliency: jax.Array,          # (Z, Y, X) sharded over the mesh grid
    nvec: jax.Array,              # (Z, Y, X, 3)
    mask_src: Optional[jax.Array],
    sigma: float,
    exponent: int,
    detect_curves: bool,
    truncate_ratio: float,
    want_denominator: bool,
    mesh: Mesh,
    sparse: bool = False,
    interpret: bool = False,
):
    """Raw (unnormalized) vote accumulation of a mesh-sharded volume
    through the per-shard Triton kernel: halo-exchange saliency,
    direction and mask by the vote radius, vote locally.  Each voxel
    sums the same taps in the same order as the single-device kernel,
    so the result equals it (tests/test_parallel.py).  Returns
    (dest, den|None) with the input sharding."""
    from visfd_jax.ops.tv_triton import tv_accumulate_padded_triton
    z_name, y_name = mesh.axis_names
    w, rhat, _, hw = TV.tv_tables(sigma, truncate_ratio)
    has_mask = mask_src is not None

    def local(sal, nv, m):
        sal_pad, n_pad, m_pad = _halo_pad_fields(
            sal, nv, m if has_mask else None, hw, z_name, y_name)
        dest, den = tv_accumulate_padded_triton(
            sal_pad, n_pad, m_pad, sal.shape, w, rhat, exponent,
            detect_curves, hw, want_denominator, sparse=sparse,
            interpret=interpret)
        return dest, (jnp.zeros_like(sal) if den is None else den)

    spec = P(z_name, y_name)
    dest, den = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(spec, P(z_name, y_name, None), spec),
        out_specs=(P(z_name, y_name, None, None), spec),
        check_vma=False,
    ))(saliency, nvec,
       # the dummy (mask-less) operand just needs the grid sharding
       mask_src if has_mask else saliency)
    return dest, (den if want_denominator else None)


def make_membrane_step(
    mesh: Mesh,
    sigma: float = 2.0,
    tv_sigma: float = 2.0,
    tv_exponent: int = 4,
    saliency_threshold: float = 0.0,
    truncate_ratio: float = 2.5,
    tv_truncate_ratio: float = float(np.sqrt(2.0)),
    tv_sparse: bool = False,
    interpret: bool = False,
):
    """Build the jitted, mesh-sharded flagship membrane step.

    Returns (step_fn, in_sharding). step_fn: (Z, Y, X) float32 ->
    (stick_saliency (Z, Y, X), vote_tensor (Z, Y, X, 6)).

    The TV stage runs per shard through the Triton kernel where
    ``features.tv.use_triton_tv`` chooses it for the mesh's platform,
    and through the XLA shift-sum elsewhere; ``interpret=True`` runs
    the kernel in the Pallas interpreter instead (tests on the CPU).
    ``tv_sparse`` lets the kernel skip empty source windows (the
    -tv-best cost lever); the output is the same.
    """
    z_name, y_name = mesh.axis_names
    platform = mesh.devices.reshape(-1)[0].platform
    hw = max(1, int(np.floor(sigma * truncate_ratio)))
    k1_np = K.gauss_kernel_1d(sigma, hw)
    w_np, rhat_np, off_np, tv_hw = TV.tv_tables(tv_sigma, tv_truncate_ratio)
    kernel_tables = None
    if interpret or TV.use_triton_tv(platform):
        kernel_tables = (w_np, rhat_np)

    # tables enter as traced args (constant-embedding pessimizes XLA)
    def local_step(x, k1, w_t, rhat_t, off_t):
        blur = _sharded_gauss(x, k1, k1, k1, hw, z_name, y_name)
        grad, hess = _local_gradient_hessian(blur, z_name, y_name)
        grad = grad * sigma
        hess = hess * (sigma * sigma)
        eivals, direction = sym3.principal_sym3(
            sym3.flat_to_full(hess), order=sym3.EigenOrder.DECREASING)
        l1, l2 = eivals[..., 0], eivals[..., 1]
        nrm = l1 * l1 - l2 * l2
        saliency = nrm * nrm
        saliency = jnp.where(saliency < saliency_threshold, 0.0, saliency)
        vote = _sharded_tv(saliency, direction, tv_hw, w_t, rhat_t, off_t,
                           tv_exponent, z_name, y_name,
                           kernel_tables=kernel_tables,
                           interpret=interpret,
                           sparse=tv_sparse and kernel_tables is not None)
        vvals, _ = sym3.diagonalize_sym3(
            sym3.flat_to_full(vote), order=sym3.EigenOrder.DECREASING,
            want_vects=False)
        stick = vvals[..., 0] - vvals[..., 1]
        return stick, vote

    spec = P(z_name, y_name)
    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(spec, P(), P(), P(), P()),
        out_specs=(spec, P(z_name, y_name, None, None)),
        check_vma=False)
    jitted = jax.jit(sharded)
    tables = (jnp.asarray(k1_np), jnp.asarray(w_np),
              jnp.asarray(rhat_np), jnp.asarray(off_np))

    def step(x):
        return jitted(x, *tables)

    return step, NamedSharding(mesh, spec)
