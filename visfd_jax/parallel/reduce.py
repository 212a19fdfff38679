"""Cross-device reductions: global image statistics and exact
distributed order statistics.

The reference computes global statistics (``MrcSimple::FindMinMaxMean``,
``mrc_simple.hpp:100``) and the ``-tv-best`` saliency threshold by a
full host sort of every voxel (``handlers.cpp:1753-1797``).  Neither
scales across devices.  Equivalents here:

* ``global_min_max_mean`` -- one fused shard_map with
  ``psum``/``pmin``/``pmax`` over the mesh (NCCL all-reduces on
  GPUs, across hosts too under GSPMD).
* ``kth_largest`` -- the EXACT k-th largest element (counting
  duplicates, 0-indexed) of a sharded volume, computed by 4 rounds of
  radix histogram selection: per round, a 256-bin histogram of one key
  byte is ``psum``-reduced and the target bin selected, so the full
  value is pinned after exactly 4 collective rounds of a 256-vector --
  no gather, no sort, O(N/devices) local work.  float32 keys are
  mapped to an order-preserving uint32 (sign-flip trick) so the result
  is bit-identical to ``np.sort(vals)[::-1][k]``.
* ``fraction_threshold`` -- the ``-tv-best`` rule: threshold =
  k-th largest with k = min(floor(n_valid * fraction), n_valid - 1).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from visfd_jax.parallel.mesh import make_mesh, grid_sharding


def _f32_to_ordered_u32(x: jax.Array) -> jax.Array:
    """Map float32 to uint32 such that the uint order equals the float
    order (sign-flip trick; total order, -0.0 < +0.0)."""
    b = jax.lax.bitcast_convert_type(x, jnp.uint32)
    neg = (b >> 31).astype(bool)
    return jnp.where(neg, ~b, b ^ jnp.uint32(0x80000000))


def _ordered_u32_to_f32(k: jax.Array) -> jax.Array:
    neg = (k >> 31).astype(bool) == False  # noqa: E712  (top bit 0 <=> negative float)
    b = jnp.where(neg, ~k, k ^ jnp.uint32(0x80000000))
    return jax.lax.bitcast_convert_type(b, jnp.float32)


def _pad_to_mesh(x: jax.Array, m: jax.Array, mesh: Mesh):
    """Zero-pad (Z, Y) so block shapes divide the mesh; padding is
    masked out (m = 0) so reductions are unaffected."""
    nz_m, ny_m = mesh.devices.shape
    pz = (-x.shape[0]) % nz_m
    py = (-x.shape[1]) % ny_m
    if pz == 0 and py == 0:
        return x, m
    pad = ((0, pz), (0, py), (0, 0))
    return jnp.pad(x, pad), jnp.pad(m, pad)


def _local_minmaxsum(x, m):
    valid = m != 0
    big = jnp.float32(np.inf)
    vmin = jnp.min(jnp.where(valid, x, big))
    vmax = jnp.max(jnp.where(valid, x, -big))
    vsum = jnp.sum(jnp.where(valid, x, 0.0), dtype=jnp.float64
                   if jax.config.jax_enable_x64 else jnp.float32)
    cnt = jnp.sum(valid, dtype=jnp.int32)
    return vmin, vmax, vsum, cnt


def global_min_max_mean(
    x: jax.Array,
    mesh: Mesh,
    mask: Optional[jax.Array] = None,
) -> Tuple[float, float, float]:
    """(min, max, mean) over in-mask voxels of a mesh-sharded volume.
    Reference semantics: ``MrcSimple::FindMinMaxMean``
    (``mrc_simple.hpp:100-121``)."""
    zn, yn = mesh.axis_names
    spec = P(zn, yn)

    def local(xb, mb):
        vmin, vmax, vsum, cnt = _local_minmaxsum(xb, mb)
        vmin = jax.lax.pmin(jax.lax.pmin(vmin, zn), yn)
        vmax = jax.lax.pmax(jax.lax.pmax(vmax, zn), yn)
        vsum = jax.lax.psum(jax.lax.psum(vsum, zn), yn)
        cnt = jax.lax.psum(jax.lax.psum(cnt, zn), yn)
        return vmin, vmax, vsum / jnp.maximum(cnt, 1).astype(vsum.dtype)

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec, spec),
                           out_specs=(P(), P(), P()), check_vma=False))
    m = jnp.ones_like(x) if mask is None else jnp.asarray(mask, jnp.float32)
    xp, mp = _pad_to_mesh(jnp.asarray(x, jnp.float32), m, mesh)
    vmin, vmax, vmean = fn(xp, mp)
    return float(vmin), float(vmax), float(vmean)


@functools.lru_cache(maxsize=None)
def _build_kth_largest(mesh: Mesh):
    zn, yn = mesh.axis_names
    spec = P(zn, yn)

    def local(xb, mb, k):
        key = _f32_to_ordered_u32(xb).reshape(-1)
        valid = (mb != 0).reshape(-1)

        def psum2(v):
            return jax.lax.psum(jax.lax.psum(v, zn), yn)

        prefix = jnp.uint32(0)
        kk = k.astype(jnp.int32)
        for r in range(4):
            shift = 24 - 8 * r
            if r == 0:
                match = valid
            else:
                hi_shift = shift + 8
                match = valid & ((key >> jnp.uint32(hi_shift))
                                 == (prefix >> jnp.uint32(hi_shift)))
            byte = ((key >> jnp.uint32(shift)) & jnp.uint32(0xFF)
                    ).astype(jnp.int32)
            hist = jax.ops.segment_sum(match.astype(jnp.int32), byte,
                                       num_segments=256)
            hist = psum2(hist)
            # c[b] = count of elements with byte >= b (within the prefix)
            c = jnp.cumsum(hist[::-1])[::-1]
            # target bin: largest b with c[b] > k
            b = jnp.sum((c > kk).astype(jnp.int32)) - 1
            b = jnp.clip(b, 0, 255)
            kk = kk - (c[b] - hist[b])
            prefix = prefix | (b.astype(jnp.uint32) << jnp.uint32(shift))
        return _ordered_u32_to_f32(prefix)

    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=(spec, spec, P()), out_specs=P(),
        check_vma=False))


def kth_largest(
    x: jax.Array,
    k,
    mesh: Mesh,
    mask: Optional[jax.Array] = None,
):
    """Exact k-th largest in-mask element (0-indexed, duplicates
    counted): bit-identical to ``np.sort(vals)[::-1][k]``."""
    fn = _build_kth_largest(mesh)
    m = jnp.ones_like(x) if mask is None else jnp.asarray(mask, jnp.float32)
    xp, mp = _pad_to_mesh(jnp.asarray(x, jnp.float32), m, mesh)
    return fn(xp, mp, jnp.asarray(k, jnp.int32))


@functools.lru_cache(maxsize=None)
def _build_count_valid(mesh: Mesh):
    zn, yn = mesh.axis_names
    spec = P(zn, yn)

    def local(mb):
        c = jnp.sum((mb != 0).astype(jnp.int32))
        return jax.lax.psum(jax.lax.psum(c, zn), yn)

    # cached per mesh: building a fresh jit object per call would pay
    # a fresh trace + remote compile on every CLI invocation
    return jax.jit(shard_map(local, mesh=mesh, in_specs=(spec,),
                             out_specs=P(), check_vma=False))


def count_valid(x: jax.Array, mesh: Mesh,
                mask: Optional[jax.Array] = None) -> int:
    fn = _build_count_valid(mesh)
    m = jnp.ones_like(x) if mask is None else jnp.asarray(mask, jnp.float32)
    _, mp = _pad_to_mesh(jnp.asarray(x, jnp.float32), m, mesh)
    return int(fn(mp))


def fraction_threshold(
    score: jax.Array,
    fraction: float,
    mesh: Optional[Mesh] = None,
    mask: Optional[jax.Array] = None,
) -> float:
    """The ``-tv-best`` threshold (``handlers.cpp:1753-1797``):
    sort the in-mask saliencies descending and take entry
    ``min(floor(n * fraction), n - 1)`` -- computed here as an exact
    distributed order statistic (no sort, no gather)."""
    if mesh is None:
        mesh = make_mesh()
    n = count_valid(score, mesh, mask)
    if n == 0:
        return 0.0
    k = min(int(np.floor(n * fraction)), n - 1)
    return float(kth_largest(score, k, mesh, mask))
