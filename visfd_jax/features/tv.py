"""Dense stick tensor voting (surface / curve saliency refinement).

Parity with ``class TV3D`` (``feature.hpp:1624-2483``):

* radial decay kernel = normalized generalized Gaussian exp(-(r/sigma)^2)
  with corner truncation, window halfwidth = floor(sigma * ratio)
  (``:2419-2440``);
* per receiver i, each in-window source voxel s = i - j casts
  ``vote = saliency(s) * w(j) * mask_src(s) * angle^(p/2) *
  outer(n_rot, n_rot)`` where sin(theta) = r_hat . n(s),
  ``angle = cos^2`` for surfaces / ``sin^2`` for curves, and
  ``n_rot = 2 sin(theta) r_hat - n`` (surfaces) or its negation
  (curves) (``:2216-2384``);
* sources that are out of bounds, masked out, zero-saliency, or have
  a zero kernel weight contribute neither votes nor denominator;
* normalization: with a source mask, all 6 tensor channels divide by
  the accumulated denominator; WITHOUT a mask the reference divides
  through a full 3x3 double loop over the symmetric-6 storage, so
  off-diagonal channels are divided TWICE by the separable
  1-D-Gaussian box denominator (``feature.hpp:1840-1864`` -- a real
  behavior we replicate for parity);
* optional final diagonalization with DECREASING eigenvalue order.

XLA formulation: receiver-centric gather as a ``lax.fori_loop`` over
the (2*hw+1)^3 window offsets; each step is a dynamic-slice shifted
fused multiply-add over the whole (Z, Y, X) grid -- the same
gather-not-scatter structure the reference chose for thread safety,
race-free and vectorizable. The offset tables (radial weight, unit
displacement) are precomputed host-side like the reference's lookup
tables.  On a GPU the same sum runs in one kernel
(``ops.tv_triton``); ``use_triton_tv`` chooses between them.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from visfd_jax.ops import kernels as K
from visfd_jax.ops.conv import _ones_denom_1d
from visfd_jax.linalg import sym3
from visfd_jax.parallel.mesh import grid_mesh_of


def tv_tables(sigma: float, truncate_ratio: float = 2.5):
    """(radial weights (K,), unit displacements (K, 3) in (x, y, z),
    offsets (K, 3) as (jz, jy, jx), halfwidth)."""
    hw = int(np.floor(sigma * truncate_ratio))
    ker = K.gen_gauss_kernel_3d((sigma,) * 3, 2.0, (hw,) * 3)  # (Z, Y, X)
    jz, jy, jx = np.meshgrid(*([np.arange(-hw, hw + 1)] * 3), indexing="ij")
    offs = np.stack([jz.ravel(), jy.ravel(), jx.ravel()], axis=-1)
    w = ker.ravel().astype(np.float32)
    length = np.sqrt((offs ** 2).sum(axis=-1)).astype(np.float32)
    length[length == 0] = 1.0
    rhat = np.stack([offs[:, 2], offs[:, 1], offs[:, 0]],
                    axis=-1).astype(np.float32) / length[:, None]
    return w, rhat, offs.astype(np.int32), hw


def tv_accumulate_padded(
    sal_pad, n_pad, m_pad, out_shape,
    w_table, rhat_table, off_table,
    exponent: int, detect_curves: bool, hw: int,
    want_denominator: bool,
):
    """Core vote-accumulation loop over PRE-PADDED (by hw) fields.
    Exposed separately so the sharded path (which pads with halo
    exchange instead of zeros) can reuse the identical vote math.

    Loop structure: the z-offset runs in a ``fori_loop`` (so compile
    size stays bounded) while the (2*hw+1)^2 in-plane offsets are
    unrolled INSIDE the body, so XLA can fuse their shifted reads and
    the big (Z, Y, X, 6) accumulator is read+written only 2*hw+1 times
    instead of (2*hw+1)^3 times.
    """
    nz, ny, nx = out_shape
    w_len = 2 * hw + 1

    dest0 = jnp.zeros((nz, ny, nx, 6), jnp.float32)
    den0 = jnp.zeros((nz, ny, nx), jnp.float32)
    # per-offset scalars indexed [tz][ty][tx] (may be traced)
    w_tz = jnp.reshape(jnp.asarray(w_table), (w_len, w_len, w_len))
    rh_tz = jnp.reshape(jnp.asarray(rhat_table), (w_len, w_len, w_len, 3))

    def body(tz, carry):
        dest, den = carry
        z0 = 2 * hw - tz  # = hw - jz
        sal_sl = jax.lax.dynamic_slice(
            sal_pad, (z0, 0, 0), (nz, ny + 2 * hw, nx + 2 * hw))
        m_sl = jax.lax.dynamic_slice(
            m_pad, (z0, 0, 0), (nz, ny + 2 * hw, nx + 2 * hw))
        n_sl = jax.lax.dynamic_slice(
            n_pad, (z0, 0, 0, 0), (nz, ny + 2 * hw, nx + 2 * hw, 3))

        acc = [jnp.zeros((nz, ny, nx), jnp.float32) for _ in range(7)]
        for ty in range(w_len):
            for tx in range(w_len):
                y0 = 2 * hw - ty
                x0 = 2 * hw - tx
                sl = (slice(None), slice(y0, y0 + ny), slice(x0, x0 + nx))
                sal = sal_sl[sl]
                m = m_sl[sl]
                n = n_sl[sl + (slice(None),)]
                w = w_tz[tz, ty, tx]
                rh = rh_tz[tz, ty, tx]

                filter_val = w * m
                active = (sal != 0.0) & (filter_val != 0.0)
                weight = jnp.where(active, sal * filter_val, 0.0)

                sin_t = (n[..., 0] * rh[0] + n[..., 1] * rh[1]
                         + n[..., 2] * rh[2])
                sin2 = sin_t * sin_t
                cos2 = 1.0 - sin2
                ang2 = sin2 if detect_curves else cos2
                if exponent == 2:
                    decay_ang = ang2
                elif exponent == 4:
                    decay_ang = ang2 * ang2
                elif exponent % 2 == 0:
                    decay_ang = ang2 ** (exponent // 2)
                else:
                    decay_ang = jnp.abs(ang2) ** (0.5 * exponent)
                sinx2 = 2.0 * sin_t
                if detect_curves:
                    nr = n - sinx2[..., None] * rh
                else:
                    nr = sinx2[..., None] * rh - n

                amp = weight * decay_ang
                acc[0] += amp * nr[..., 0] * nr[..., 0]
                acc[1] += amp * nr[..., 1] * nr[..., 1]
                acc[2] += amp * nr[..., 2] * nr[..., 2]
                acc[3] += amp * nr[..., 0] * nr[..., 1]
                acc[4] += amp * nr[..., 1] * nr[..., 2]
                acc[5] += amp * nr[..., 0] * nr[..., 2]
                if want_denominator:
                    acc[6] += jnp.where(active, filter_val, 0.0)
        dest = dest + jnp.stack(acc[:6], axis=-1)
        if want_denominator:
            den = den + acc[6]
        return dest, den

    dest, den = jax.lax.fori_loop(0, w_len, body, (dest0, den0))
    return dest, den


@functools.partial(
    jax.jit,
    static_argnames=("exponent", "detect_curves", "hw", "want_denominator"))
def _tv_accumulate(
    saliency, nvec, mask_src,
    w_table, rhat_table, off_table,
    exponent: int, detect_curves: bool, hw: int,
    want_denominator: bool,
):
    pad = [(hw, hw)] * 3
    sal_pad = jnp.pad(saliency, pad)
    n_pad = jnp.pad(nvec, pad + [(0, 0)])
    if mask_src is not None:
        m_pad = jnp.pad(mask_src, pad)
    else:
        m_pad = jnp.pad(jnp.ones_like(saliency), pad)
    dest, den = tv_accumulate_padded(
        sal_pad, n_pad, m_pad, saliency.shape,
        w_table, rhat_table, off_table,
        exponent, detect_curves, hw, want_denominator)
    return dest, den


def _is_multidevice(x) -> bool:
    """True when x is committed to a >1-device sharding."""
    sh = getattr(x, "sharding", None)
    return sh is not None and len(sh.device_set) > 1


def use_triton_tv(platform: Optional[str] = None) -> bool:
    """Which vote accumulation serves ``platform`` (default: that of
    ``jax.devices()[0]``): the Triton kernel (``ops.tv_triton``) on a
    GPU, the XLA shift-sum everywhere else."""
    if platform is None:
        platform = jax.devices()[0].platform
    return platform == "gpu"


@functools.partial(
    jax.jit,
    static_argnames=("sigma", "truncate_ratio", "exponent",
                     "detect_curves", "want_denominator", "sparse",
                     "interpret"))
def tv_accumulate_triton(saliency, nvec, mask_src, sigma: float,
                         truncate_ratio: float, exponent: int,
                         detect_curves: bool, want_denominator: bool,
                         sparse: bool = False, interpret: bool = False):
    """Single-device raw vote accumulation through the Triton kernel:
    (dest (Z, Y, X, 6), den or None), as ``_tv_accumulate`` returns
    them before the destination mask."""
    from visfd_jax.ops.tv_triton import tv_accumulate_padded_triton
    w, rhat, _, hw = tv_tables(sigma, truncate_ratio)
    pad = [(hw, hw)] * 3
    m_pad = None if mask_src is None else jnp.pad(mask_src, pad)
    return tv_accumulate_padded_triton(
        jnp.pad(saliency, pad), jnp.pad(nvec, pad + [(0, 0)]), m_pad,
        saliency.shape, w, rhat, exponent, detect_curves, hw,
        want_denominator, sparse=sparse, interpret=interpret)


def tv_dense_stick(
    saliency: jax.Array,          # (Z, Y, X)
    nvec: jax.Array,              # (Z, Y, X, 3) unit stick directions (x,y,z)
    sigma: float,
    exponent: int = 4,
    mask_src: Optional[jax.Array] = None,
    mask_dest: Optional[jax.Array] = None,
    detect_curves: bool = False,
    truncate_ratio: float = 2.5,
    normalize: bool = True,
    diagonalize_dest: bool = False,
    sparse: bool = False,
    interpret: bool = False,
) -> jax.Array:
    """Run dense stick voting; returns (Z, Y, X, 6) vote tensors (or
    [eivals, shoemake] when diagonalize_dest).

    The accumulation runs where ``use_triton_tv`` says: the Triton
    kernel on a GPU, the XLA shift-sum elsewhere.  A volume sharded
    over a (z, y) device grid runs it per shard with halo exchange
    (``parallel.sharded.tv_accumulate_sharded``); any other multi-device
    sharding runs the XLA path under GSPMD.  ``sparse`` lets the kernel
    skip tap groups whose source window holds no nonzero saliency (the
    CLI sets it when ``-tv-best`` zeroed most sources); the result is
    the same.  ``interpret=True`` runs the kernel in the Pallas
    interpreter, on any platform (tests on the CPU).  The path that ran
    is recorded under "tv" (``utils.record_path``)."""
    from visfd_jax.utils import record_path
    w, rhat, offs, hw = tv_tables(sigma, truncate_ratio)
    saliency = jnp.asarray(saliency, jnp.float32)
    nvec = jnp.asarray(nvec, jnp.float32)
    ms = None if mask_src is None else jnp.asarray(mask_src, jnp.float32)
    md = None if mask_dest is None else jnp.asarray(mask_dest, jnp.float32)
    want_den = bool(normalize and ms is not None)
    kernel = interpret or use_triton_tv()
    grid_mesh = None
    if kernel and _is_multidevice(saliency):
        grid_mesh = grid_mesh_of(saliency)
        kernel = grid_mesh is not None
    sparse = bool(sparse) and kernel
    if grid_mesh is not None:
        from visfd_jax.parallel.sharded import tv_accumulate_sharded
        dest, den = tv_accumulate_sharded(
            saliency, nvec, ms, float(sigma), int(exponent),
            bool(detect_curves), float(truncate_ratio), want_den,
            grid_mesh, sparse=sparse, interpret=interpret)
        path = "triton-sharded"
    elif kernel:
        dest, den = tv_accumulate_triton(
            saliency, nvec, ms, float(sigma), float(truncate_ratio),
            int(exponent), bool(detect_curves), want_den, sparse=sparse,
            interpret=interpret)
        path = "triton"
    else:
        dest, den = _tv_accumulate(
            saliency, nvec, ms,
            jnp.asarray(w), jnp.asarray(rhat), jnp.asarray(offs),
            int(exponent), bool(detect_curves), hw, want_den)
        path = "xla"
    record_path("tv", path + ("-sparse" if sparse else ""))
    if md is not None:
        dest = jnp.where((md != 0)[..., None], dest, 0.0)
        if den is not None:
            den = jnp.where(md != 0, den, 0.0)

    if normalize:
        if ms is not None:
            ok = den > 0
            dest = jnp.where(ok[..., None],
                             dest / jnp.where(ok, den, 1.0)[..., None], dest)
        else:
            # no-mask shortcut: separable product of the 1-D *discrete*
            # Gaussian convolved with all-ones (feature.hpp:1833-1864).
            # The reference divides through a full 3x3 loop, so the 3
            # off-diagonal channels are divided twice -- replicated.
            k1 = jnp.asarray(K.gauss_kernel_1d(sigma, hw))
            dz = _ones_denom_1d(k1, saliency.shape[0])[:, None, None]
            dy = _ones_denom_1d(k1, saliency.shape[1])[None, :, None]
            dx = _ones_denom_1d(k1, saliency.shape[2])[None, None, :]
            den_box = dz * dy * dx
            scale = jnp.stack([den_box, den_box, den_box,
                               den_box * den_box, den_box * den_box,
                               den_box * den_box], axis=-1)
            dest = dest / scale
            if md is not None:
                dest = jnp.where((md != 0)[..., None], dest, 0.0)

    if diagonalize_dest:
        diag = sym3.diagonalize_flat_sym3(dest,
                                          order=sym3.EigenOrder.DECREASING)
        if md is not None:
            diag = diag * (md != 0)[..., None]
        dest = diag
    return dest
