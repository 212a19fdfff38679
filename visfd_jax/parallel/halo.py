"""Halo exchange for sharded stencils.

Inside ``shard_map``, each device holds a (Z/nz, Y/ny, X) block.
Stencils (separable conv, FD Hessian, tensor voting windows) need
``halo`` rows of neighbor data along each sharded axis.  ``halo_pad``
fetches those rows with ``jax.lax.ppermute`` (a neighbour exchange)
and zero-fills at the global boundary, so a local zero-padded stencil
over the haloed block reproduces the unsharded zero-padded stencil
exactly (the reference's boundary convention, ``filter1d.hpp:93-99``).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp


def halo_pad(x: jax.Array, halo: int, axis: int, axis_name: str) -> jax.Array:
    """Return x extended by ``halo`` rows on both sides of ``axis``,
    filled from ring neighbors along ``axis_name`` (zeros at the
    global edges). Must be called inside shard_map.

    Halos larger than the local block (wide stencils on small blocks,
    e.g. the blob ladder's largest sigmas) gather from neighbors up to
    distance ceil(halo / block) hops away: hop d < K contributes a full
    block, the farthest hop contributes the remaining partial slab."""
    if halo == 0:
        return x
    n_shards = jax.lax.axis_size(axis_name)
    if n_shards == 1:
        pad = [(0, 0)] * x.ndim
        pad[axis] = (halo, halo)
        return jnp.pad(x, pad)
    idx = jax.lax.axis_index(axis_name)
    bs = x.shape[axis]
    hops = -(-halo // bs)  # ceil

    def slab(v, lo, hi):
        sl = [slice(None)] * v.ndim
        sl[axis] = slice(lo, hi)
        return v[tuple(sl)]

    below_parts = []  # ordered outermost (farthest) first
    above_parts = []  # ordered nearest first
    for d in range(hops, 0, -1):
        take = bs if d < hops else halo - (hops - 1) * bs
        # from the -d neighbor: its trailing ``take`` rows
        send_up = slab(x, bs - take, bs)
        fwd = [(i, (i + d) % n_shards) for i in range(n_shards)]
        from_below = jax.lax.ppermute(send_up, axis_name, fwd)
        # from the +d neighbor: its leading ``take`` rows
        send_down = slab(x, 0, take)
        bwd = [(i, (i - d) % n_shards) for i in range(n_shards)]
        from_above = jax.lax.ppermute(send_down, axis_name, bwd)
        # zero-fill wrapped slabs outside the global volume
        zero = jnp.zeros_like(from_below)
        from_below = jnp.where(idx >= d, from_below, zero)
        from_above = jnp.where(idx < n_shards - d, from_above, zero)
        below_parts.append(from_below)
        above_parts.append(from_above)
    above_parts.reverse()  # nearest (d=1) first, farthest last
    return jnp.concatenate(below_parts + [x] + above_parts, axis=axis)


def halo_pad_2d(x: jax.Array, halo_z: int, halo_y: int,
                z_name: str = "z", y_name: str = "y") -> jax.Array:
    """Halo-pad axes 0 (z) and 1 (y) of a (Z, Y, X[, C]) block.
    Corner regions are filled correctly because the y exchange runs
    after the z exchange (slabs already include z halos)."""
    x = halo_pad(x, halo_z, 0, z_name)
    x = halo_pad(x, halo_y, 1, y_name)
    return x
