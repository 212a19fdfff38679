"""Stick tensor voting as a GPU kernel: Pallas on the Triton route.

One program computes a (BY, BX) tile of receivers in one z-plane.  Its
six vote accumulators (seven with the masked-normalization denominator)
stay in registers across every tap of the (2*hw+1)^3 window, so the
(Z, Y, X, 6) vote tensor is written once, where the XLA shift-sum
(``features.tv.tv_accumulate_padded``) reads and writes it 2*hw+1
times.  The taps run as loops over a tap table: corner-truncated taps
(zero radial weight) are left out of it, and each tap's weight and unit
displacement are the same float32 table entries the XLA path uses
(``features.tv.tv_tables``), summed in the same order.  (Unrolling the
taps at trace time instead took over ten minutes of compilation at
hw=5.)

Each tap loads a shifted (BY, BX) window of the pre-padded source
fields; neighbouring taps hit the same lines in L1/L2.  With
``sparse=True`` a z-offset's whole tap group is skipped when its
source window holds no nonzero saliency (an occupancy table computed
by XLA before the call): the ``-tv-best`` lever, exact because a
skipped group contributes only zeros.  Dense mode runs the same kernel
with every flag set.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Receiver tile per program (powers of two, x contiguous) and warps.
BLOCK_Y = 16
BLOCK_X = 64
NUM_WARPS = 4


def _tap_tables(w_table, rhat_table, hw):
    """The nonzero-weight taps of the XLA path's (tz, ty, tx)-ordered
    tables, in that order: int32 (ty, tx) offsets (n, 2), float32
    (w, rx, ry, rz) (n, 4), and int32 bounds (2*hw+2,) such that the
    taps of z-offset tz are [bounds[tz], bounds[tz+1])."""
    w_len = 2 * hw + 1
    w = np.asarray(w_table, np.float32).reshape(w_len, w_len, w_len)
    rh = np.asarray(rhat_table, np.float32).reshape(w_len, w_len, w_len, 3)
    offs, vals, bounds = [], [], [0]
    for tz in range(w_len):
        for ty in range(w_len):
            for tx in range(w_len):
                if w[tz, ty, tx] != 0.0:
                    offs.append((ty, tx))
                    vals.append((w[tz, ty, tx], *rh[tz, ty, tx]))
        bounds.append(len(offs))
    return (np.asarray(offs, np.int32), np.asarray(vals, np.float32),
            np.asarray(bounds, np.int32))


def _tv_kernel(*refs, hw, exponent, detect_curves, has_mask, want_den,
               ny, nx):
    it = iter(refs)
    sal_ref, n0_ref, n1_ref, n2_ref = (next(it) for _ in range(4))
    m_ref = next(it) if has_mask else None
    occ_ref, offs_ref, vals_ref, bounds_ref = (next(it) for _ in range(4))
    out_ref = next(it)
    den_ref = next(it) if want_den else None

    z = pl.program_id(0)
    yb = pl.program_id(1)
    xb = pl.program_id(2)
    y0 = yb * BLOCK_Y
    x0 = xb * BLOCK_X
    n_acc = 7 if want_den else 6

    def tap(zs, k, acc):
        acc = list(acc)
        ty, tx = offs_ref[k, 0], offs_ref[k, 1]
        w, rx, ry, rz = (vals_ref[k, i] for i in range(4))
        win = (zs, pl.ds(y0 + (2 * hw - ty), BLOCK_Y),
               pl.ds(x0 + (2 * hw - tx), BLOCK_X))
        s = sal_ref[win]
        a0 = n0_ref[win]
        a1 = n1_ref[win]
        a2 = n2_ref[win]
        if has_mask:
            fv = w * m_ref[win]
            active = (s != 0.0) & (fv != 0.0)
            weight = jnp.where(active, s * fv, 0.0)
        else:
            weight = s * w
        sin_t = a0 * rx + a1 * ry + a2 * rz
        sin2 = sin_t * sin_t
        ang2 = sin2 if detect_curves else 1.0 - sin2
        if exponent == 2:
            dec = ang2
        elif exponent == 4:
            dec = ang2 * ang2
        elif exponent % 2 == 0:
            dec = ang2 ** (exponent // 2)
        else:
            dec = jnp.abs(ang2) ** (0.5 * exponent)
        sx2 = 2.0 * sin_t
        if detect_curves:
            r0, r1, r2 = a0 - sx2 * rx, a1 - sx2 * ry, a2 - sx2 * rz
        else:
            r0, r1, r2 = sx2 * rx - a0, sx2 * ry - a1, sx2 * rz - a2
        amp = weight * dec
        acc[0] = acc[0] + amp * r0 * r0
        acc[1] = acc[1] + amp * r1 * r1
        acc[2] = acc[2] + amp * r2 * r2
        acc[3] = acc[3] + amp * r0 * r1
        acc[4] = acc[4] + amp * r1 * r2
        acc[5] = acc[5] + amp * r0 * r2
        if want_den:
            acc[6] = acc[6] + jnp.where(active, fv, 0.0)
        return tuple(acc)

    def tap_group(tz, acc):
        # every group runs behind its occupancy flag, in dense mode too
        # (where all flags are set): both modes run the same code, so a
        # skipped group is the only difference and the sums agree
        zs = z + (2 * hw - tz)     # padded source plane of this z-offset
        return jax.lax.cond(
            occ_ref[zs, yb, xb] != 0.0,
            lambda a: jax.lax.fori_loop(
                bounds_ref[tz], bounds_ref[tz + 1],
                functools.partial(tap, zs), a),
            lambda a: a, acc)

    acc = tuple(jnp.zeros((BLOCK_Y, BLOCK_X), jnp.float32)
                for _ in range(n_acc))
    acc = jax.lax.fori_loop(0, 2 * hw + 1, tap_group, acc)

    ys = y0 + jax.lax.broadcasted_iota(jnp.int32, (BLOCK_Y, BLOCK_X), 0)
    xs = x0 + jax.lax.broadcasted_iota(jnp.int32, (BLOCK_Y, BLOCK_X), 1)
    inside = (ys < ny) & (xs < nx)
    rows = pl.ds(y0, BLOCK_Y)
    cols = pl.ds(x0, BLOCK_X)
    for c in range(6):
        plgpu.store(out_ref.at[z, rows, cols, c], acc[c], mask=inside)
    if want_den:
        plgpu.store(den_ref.at[z, rows, cols], acc[6], mask=inside)


def tv_accumulate_padded_triton(
    sal_pad: jax.Array,              # (Z+2hw, Y+2hw, X+2hw)
    n_pad: jax.Array,                # (Z+2hw, Y+2hw, X+2hw, 3)
    m_pad: Optional[jax.Array],      # like sal_pad, or None (no mask)
    out_shape: Tuple[int, int, int],
    w_table,                         # concrete (K,) radial weights
    rhat_table,                      # concrete (K, 3) unit displacements
    exponent: int,
    detect_curves: bool,
    hw: int,
    want_denominator: bool,
    sparse: bool = False,
    interpret: bool = False,
) -> Tuple[jax.Array, Optional[jax.Array]]:
    """Raw vote accumulation over fields padded by ``hw`` on every
    face; the same contract as ``features.tv.tv_accumulate_padded``
    (zeros or neighbour halos in the padding), except that the tables
    must be concrete and ``m_pad`` may be None.  Returns the
    (Z, Y, X, 6) vote tensor and the (Z, Y, X) denominator (None
    unless ``want_denominator``, which needs a mask)."""
    if want_denominator and m_pad is None:
        raise ValueError("the vote denominator needs a source mask")
    nz, ny, nx = out_shape
    n_yblk = -(-ny // BLOCK_Y)
    n_xblk = -(-nx // BLOCK_X)
    # every program's shifted windows must stay inside the fields
    extra = [(0, 0), (0, n_yblk * BLOCK_Y + 2 * hw - sal_pad.shape[1]),
             (0, n_xblk * BLOCK_X + 2 * hw - sal_pad.shape[2])]
    fields = [sal_pad] + [n_pad[..., c] for c in range(3)]
    if m_pad is not None:
        fields.append(m_pad)
    fields = [jnp.pad(jnp.asarray(f, jnp.float32), extra) for f in fields]
    # per source plane and receiver tile: may the tile's source window
    # hold a nonzero saliency?  (Always, in dense mode.)
    occ_shape = (sal_pad.shape[0], n_yblk, n_xblk)
    if sparse:
        occ = jax.lax.reduce_window(
            jnp.abs(fields[0]), 0.0, jax.lax.max,
            (1, BLOCK_Y + 2 * hw, BLOCK_X + 2 * hw), (1, BLOCK_Y, BLOCK_X),
            "valid")
    else:
        # opaque to constant folding, so that no backend (the CPU
        # interpreter included) inlines the groups in dense mode only
        occ = jax.lax.optimization_barrier(
            jnp.ones(occ_shape, jnp.float32))
    fields.append(occ)
    fields += [jnp.asarray(t) for t in _tap_tables(w_table, rhat_table, hw)]
    out_shapes = [jax.ShapeDtypeStruct((nz, ny, nx, 6), jnp.float32)]
    if want_denominator:
        out_shapes.append(jax.ShapeDtypeStruct((nz, ny, nx), jnp.float32))
    kernel = functools.partial(
        _tv_kernel, hw=hw, exponent=int(exponent), detect_curves=bool(detect_curves),
        has_mask=m_pad is not None, want_den=bool(want_denominator),
        ny=ny, nx=nx)
    outs = pl.pallas_call(
        kernel,
        out_shape=out_shapes,
        grid=(nz, n_yblk, n_xblk),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="tv_stick_vote",
    )(*fields)
    return outs[0], (outs[1] if want_denominator else None)
