"""Mesh-sharded blob scale-space ladder and plateau extrema.

Round-2 parallel coverage (SURVEY 2.5 items 2-4 beyond the membrane
step): the blob DoG ladder (``feature.hpp:53-427``) and the
plateau-aware extrema finder (``morphology_implementation.hpp:55-515``)
run block-sharded over a ("z", "y") mesh with halo exchange, and are
**bit-identical** to the single-device implementations:

* separable LoG: the haloed numerator conv performs the same
  multiply-adds per voxel in the same order; the no-mask edge
  normalization divides by the same rank-1 (dz*dy)*dx denominator,
  passed in as 1-D arrays sharded along their own axes;
* volumes whose (Z, Y) do not divide the mesh are zero-padded and an
  in-bounds indicator marks the true boundary, so windows that cross
  it see zeros -- the reference's boundary convention -- and extremum
  tests treat pad voxels as out of bounds;
* plateau labels converge to the min global flat index of each
  plateau (the reference's raster-first representative) via
  neighbor-local min propagation with per-round halo exchange plus
  block-local pointer jumping; candidate lists are gathered to host
  exactly like the single-device path.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from visfd_jax.ops import kernels as K
from visfd_jax.ops.conv import _conv1d_axis_impl, _ones_denom_1d
from visfd_jax.parallel.gather import to_host_np
from visfd_jax.parallel.halo import halo_pad, halo_pad_2d
from visfd_jax.parallel.sharded import _local_conv_sliced


def _pad_zy(a: np.ndarray | jax.Array, mesh: Mesh):
    nz_m, ny_m = mesh.devices.shape
    pz = (-a.shape[0]) % nz_m
    py = (-a.shape[1]) % ny_m
    if pz == 0 and py == 0:
        return jnp.asarray(a), (0, 0)
    return jnp.pad(jnp.asarray(a), ((0, pz), (0, py), (0, 0))), (pz, py)


def _inbounds_indicator(shape_zyx, mesh: Mesh) -> jax.Array:
    """1.0 inside the true volume, 0.0 in mesh-divisibility padding."""
    ind = jnp.ones(shape_zyx, jnp.float32)
    ind, _ = _pad_zy(ind, mesh)
    return ind


def _sep_blur_halo(x, kx, ky, kz, hwx, hwy, hwz, z_name, y_name):
    """Separable conv of a local block with halo exchange along z/y;
    per-voxel FP ops identical to the unsharded ``_sep3``."""
    v = halo_pad(x, hwz, 0, z_name)
    v = _local_conv_sliced(v, kz, 0, hwz)
    v = halo_pad(v, hwy, 1, y_name)
    v = _local_conv_sliced(v, ky, 1, hwy)
    return _conv1d_axis_impl(v, kx, 2)


@functools.lru_cache(maxsize=None)
def _build_sharded_log(mesh: Mesh, hw_xyz: Tuple[int, int, int],
                       masked: bool):
    """Jitted sharded apply_log for one (per-axis) halfwidth triple.
    Takes both Gaussians' 1-D kernels plus (no-mask case) the rank-1
    edge denominators; bit-exact vs ``ops.filters.apply_log``."""
    zn, yn = mesh.axis_names
    hwx, hwy, hwz = hw_xyz
    spec = P(zn, yn)

    def local(x, m, ka, kb, da, db, inv_d2):
        kax, kay, kaz = ka
        kbx, kby, kbz = kb

        def blur(src, kx, ky, kz):
            return _sep_blur_halo(src, kx, ky, kz, hwx, hwy, hwz, zn, yn)

        if masked:
            def gauss(kx, ky, kz):
                num = blur(x * m, kx, ky, kz)
                den = blur(m, kx, ky, kz)
                return jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0),
                                 num)
            ga = gauss(kax, kay, kaz)
            gb = gauss(kbx, kby, kbz)
        else:
            dza, dya, dxa = da
            dzb, dyb, dxb = db

            def gauss(kx, ky, kz, dz, dy, dx):
                num = blur(x, kx, ky, kz)
                den = (dz[:, None, None] * dy[None, :, None]) \
                    * dx[None, None, :]
                return num / den
            ga = gauss(kax, kay, kaz, dza, dya, dxa)
            gb = gauss(kbx, kby, kbz, dzb, dyb, dxb)
        return (ga - gb) * inv_d2

    in_specs = (spec, spec,
                (P(), P(), P()), (P(), P(), P()),
                (P(zn), P(yn), P()), (P(zn), P(yn), P()), P())
    return jax.jit(shard_map(local, mesh=mesh, in_specs=in_specs,
                             out_specs=spec, check_vma=False))


def make_sharded_log_fn(mesh: Mesh, orig_shape=None):
    """Returns log_fn(x, sig_xyz, delta, truncate_ratio, mask) matching
    ``features.blob.log_filter_for_scale`` bit-exactly, computed over
    the mesh.  ``x`` (and ``mask``) must already be padded to
    mesh-divisible (Z, Y); ``orig_shape`` gives the true (Z, Y, X) so
    the no-mask edge denominators cover exactly the true volume (pad
    voxels divide by zero and are discarded downstream)."""
    def log_fn(x, sig_xyz, delta, truncate_ratio, mask):
        true_shape = orig_shape if orig_shape is not None else x.shape
        sa = tuple(s * (1.0 - 0.5 * delta) for s in sig_xyz)
        sb = tuple(s * (1.0 + 0.5 * delta) for s in sig_xyz)
        hw = tuple(max(1, int(np.floor(truncate_ratio * max(a, b))))
                   for a, b in zip(sa, sb))
        ka = tuple(jnp.asarray(K.gauss_kernel_1d(s, h))
                   for s, h in zip(sa, hw))
        kb = tuple(jnp.asarray(K.gauss_kernel_1d(s, h))
                   for s, h in zip(sb, hw))
        nz, ny, nx = x.shape
        tz, ty, tx = true_shape
        masked = mask is not None

        def denoms(kx, ky, kz):
            # _separable_conv3d_nomask's per-axis denominators for the
            # TRUE lengths, zero-extended into the mesh padding (pad
            # voxels divide by 0 -> discarded downstream).
            return (jnp.pad(_ones_denom_1d(kz, tz), (0, nz - tz)),
                    jnp.pad(_ones_denom_1d(ky, ty), (0, ny - ty)),
                    jnp.pad(_ones_denom_1d(kx, tx), (0, nx - tx)))

        if masked:
            zeros = (jnp.zeros(nz), jnp.zeros(ny), jnp.zeros(nx))
            da = db = zeros
            m = mask
        else:
            da = denoms(*ka)
            db = denoms(*kb)
            m = jnp.ones_like(x)
        inv_d2 = jnp.float32(1.0 / (delta * delta))
        fn = _build_sharded_log(mesh, hw, masked)
        return fn(x, m, ka, kb, da, db, inv_d2)

    return log_fn


@functools.lru_cache(maxsize=None)
def _build_sharded_extremum(mesh: Mesh, masked: bool):
    """Strict 80-neighbor 4-D extremum test over three sharded scale
    planes; semantics of ``features.blob._extremum_masks``.  The mask
    argument doubles as the in-bounds indicator (0 in mesh padding)."""
    zn, yn = mesh.axis_names
    spec = P(zn, yn)

    def local(prev, mid, next_, m):
        nz, ny, nx = mid.shape

        def pad1(v):
            v = halo_pad_2d(v, 1, 1, zn, yn)
            return jnp.pad(v, ((0, 0), (0, 0), (1, 1)))

        planes = [pad1(p) for p in (prev, mid, next_)]
        ok_pad = pad1(m)

        def sl(p, dz, dy, dx):
            return jax.lax.dynamic_slice(
                p, (1 + dz, 1 + dy, 1 + dx), (nz, ny, nx))

        center = mid
        is_min = jnp.ones(mid.shape, bool)
        is_max = jnp.ones(mid.shape, bool)
        for pi, plane in enumerate(planes):
            for dz in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        if pi == 1 and dz == 0 and dy == 0 and dx == 0:
                            continue
                        nb = sl(plane, dz, dy, dx)
                        ok = sl(ok_pad, dz, dy, dx) > 0
                        is_min &= ok & (nb > center)
                        is_max &= ok & (nb < center)
        valid = m != 0
        return is_min & valid, is_max & valid

    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec, spec),
        out_specs=(spec, spec), check_vma=False))


@functools.lru_cache(maxsize=None)
def _build_sharded_extrema_device(mesh: Mesh,
                                  offsets: Tuple[Tuple[int, int, int], ...]):
    """Sharded counterpart of ``segment.extrema._extrema_device``:
    plateau labels (min global flat index, = the reference's
    raster-first representative) by neighbor-local min propagation with
    per-round halo exchange + block-local pointer jumping, plus the
    has_lower/has_higher/touches_border flags.  ``m`` combines the
    user mask and the mesh-padding indicator."""
    zn, yn = mesh.axis_names
    spec = P(zn, yn)
    r = max(max(abs(c) for c in off) for off in offsets)
    SENT = jnp.int32(2 ** 31 - 1)

    def local(x, m):
        bz, by, nx = x.shape
        ny = by * jax.lax.axis_size(yn)
        z0 = jax.lax.axis_index(zn) * bz
        y0 = jax.lax.axis_index(yn) * by
        valid = m != 0

        def pad_r(v):
            v = halo_pad_2d(v, r, r, zn, yn)
            return jnp.pad(v, ((0, 0), (0, 0), (r, r)))

        def pad_labels(lab):
            # halo_pad zero-fills; map 0-fill to the SENT sentinel
            inv = pad_r(SENT - lab)
            return SENT - inv

        def sl(p, off):
            dz, dy, dx = off
            return jax.lax.dynamic_slice(p, (r + dz, r + dy, r + dx),
                                         (bz, by, nx))

        xpad = pad_r(x)
        ind = pad_r(valid.astype(jnp.float32))

        zi = (jnp.arange(bz, dtype=jnp.int32) + z0)[:, None, None]
        yi = (jnp.arange(by, dtype=jnp.int32) + y0)[None, :, None]
        xi = jnp.arange(nx, dtype=jnp.int32)[None, None, :]
        idx = (zi * ny + yi) * nx + xi

        has_lt = jnp.zeros(x.shape, bool)
        has_gt = jnp.zeros(x.shape, bool)
        border = jnp.zeros(x.shape, bool)
        same_list = []
        for off in offsets:
            nv = sl(xpad, off)
            usable = sl(ind, off) > 0
            border = border | ~usable
            has_lt = has_lt | (usable & (nv < x))
            has_gt = has_gt | (usable & (nv > x))
            same_list.append(usable & (nv == x))

        def body(state):
            lab, _ = state
            lab_h = pad_labels(lab)
            new = lab
            for same, off in zip(same_list, offsets):
                nlab = sl(lab_h, off)
                new = jnp.where(same, jnp.minimum(new, nlab), new)
            # block-local pointer jump: follow labels that point at a
            # voxel inside this block
            dz_ = new // (ny * nx)
            remv = new - dz_ * (ny * nx)
            dy_ = remv // nx
            dx_ = remv - dy_ * nx
            inblk = ((dz_ >= z0) & (dz_ < z0 + bz)
                     & (dy_ >= y0) & (dy_ < y0 + by))
            loc = ((dz_ - z0) * by + (dy_ - y0)) * nx + dx_
            loc = jnp.clip(loc, 0, bz * by * nx - 1)
            jumped = new.reshape(-1)[loc.reshape(-1)].reshape(x.shape)
            new = jnp.where(inblk, jumped, new)
            changed = jnp.any(new != lab)
            changed = jax.lax.psum(
                jax.lax.psum(changed.astype(jnp.int32), zn), yn) > 0
            return new, changed

        labels, _ = jax.lax.while_loop(lambda s: s[1], body,
                                       (idx, jnp.asarray(True)))
        labels = jnp.where(valid, labels, jnp.int32(-1))
        return labels, has_lt & valid, has_gt & valid, border & valid

    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=(spec, spec),
        out_specs=(spec, spec, spec, spec), check_vma=False))


def find_extrema_sharded(
    x,
    mesh: Mesh,
    mask=None,
    connectivity: int = 3,
    **kw,
):
    """Mesh-sharded ``segment.extrema.find_extrema``: identical
    results (labels converge to the same plateau representatives)."""
    from visfd_jax.segment import extrema as E

    x = jnp.asarray(x, jnp.float32)
    nz, ny, nx = x.shape
    xp, _ = _pad_zy(x, mesh)
    ind = _inbounds_indicator(x.shape, mesh)
    mp = ind
    if mask is not None:
        mpad, _ = _pad_zy(jnp.asarray(mask, jnp.float32), mesh)
        mp = mpad * ind

    sharding = NamedSharding(mesh, P(*mesh.axis_names))
    xp = jax.device_put(xp, sharding)
    mp = jax.device_put(mp, sharding)

    offs = E.neighbor_offsets(connectivity)
    fn = _build_sharded_extrema_device(mesh, offs)
    labels_p, has_lt_p, has_gt_p, border_p = fn(xp, mp)

    # crop the mesh padding and re-encode plateau labels from
    # padded-dims flat indices to true-dims flat indices (both
    # encodings are monotonic in (z, y, x) lex order, so the min-index
    # representative is the same voxel)
    ny_p, nx_p = xp.shape[1], xp.shape[2]
    labels = np.array(to_host_np(labels_p)[:nz, :ny])
    pos = labels >= 0
    L = labels[pos]
    z_ = L // (ny_p * nx_p)
    rem = L - z_ * (ny_p * nx_p)
    y_ = rem // nx_p
    x_ = rem - y_ * nx_p
    labels[pos] = (z_ * ny + y_) * nx + x_

    return E.postprocess_extrema(
        labels,
        to_host_np(has_lt_p)[:nz, :ny],
        to_host_np(has_gt_p)[:nz, :ny],
        to_host_np(border_p)[:nz, :ny],
        to_host_np(x),
        **kw)


@functools.lru_cache(maxsize=None)
def _build_sharded_descend(mesh: Mesh,
                           offsets: Tuple[Tuple[int, int, int], ...]):
    """Sharded counterpart of ``segment.propagate._descend_device``'s
    stencil phases: per-voxel steepest-descent parents (min lower
    neighbor, ties -> min flat index), plateau representatives, plateau
    has-lower reduction, and the synchronous BFS-from-exit resolve
    ordering for non-minimum plateau members.  Returns the parent
    pointer graph; the host collapses it to roots (vectorized numpy
    pointer jumping -- the volume is gathered for labeling anyway).

    ``m`` is the user-mask validity (0 in mesh padding too) and
    ``inb`` the true-volume indicator (1 wherever the voxel exists,
    masked or not)."""
    zn, yn = mesh.axis_names
    spec = P(zn, yn)
    r = max(max(abs(c) for c in off) for off in offsets)
    SENT = jnp.int32(2 ** 31 - 1)
    INF = jnp.float32(np.inf)

    def local(x, m, inb):
        bz, by, nx = x.shape
        ny = by * jax.lax.axis_size(yn)
        z0 = jax.lax.axis_index(zn) * bz
        y0 = jax.lax.axis_index(yn) * by
        valid = m != 0
        xv = jnp.where(valid, x, INF)

        def pad_r(v):
            v = halo_pad_2d(v, r, r, zn, yn)
            return jnp.pad(v, ((0, 0), (0, 0), (r, r)))

        def pad_labels(lab):
            return SENT - pad_r(SENT - lab)

        def sl(p, off):
            dz, dy, dx = off
            return jax.lax.dynamic_slice(p, (r + dz, r + dy, r + dx),
                                         (bz, by, nx))

        indpad = pad_r(inb)
        xvpad = jnp.where(indpad > 0, pad_r(xv), INF)

        zi = (jnp.arange(bz, dtype=jnp.int32) + z0)[:, None, None]
        yi = (jnp.arange(by, dtype=jnp.int32) + y0)[None, :, None]
        xi = jnp.arange(nx, dtype=jnp.int32)[None, None, :]
        idx = (zi * ny + yi) * nx + xi

        best_val = jnp.full(x.shape, INF)
        best_idx = jnp.full(x.shape, SENT)
        same_list = []
        nidx_list = []
        for off in offsets:
            dz, dy, dx = off
            nv = sl(xvpad, off)
            usable = sl(indpad, off) > 0
            nidx = idx + jnp.int32((dz * ny + dy) * nx + dx)
            lower = usable & (nv < xv)
            better = lower & ((nv < best_val)
                              | ((nv == best_val) & (nidx < best_idx)))
            best_val = jnp.where(better, nv, best_val)
            best_idx = jnp.where(better, nidx, best_idx)
            same_list.append(usable & (nv == xv))
            nidx_list.append(nidx)
        has_lower = jnp.isfinite(best_val)

        # plateau labels + plateau-has-lower, min-propagated together
        key2 = jnp.where(has_lower & valid, idx, SENT)

        def plab_body(state):
            lab, key, _ = state
            lab_h = pad_labels(lab)
            key_h = pad_labels(key)
            newl, newk = lab, key
            for same, off in zip(same_list, offsets):
                newl = jnp.where(same, jnp.minimum(newl, sl(lab_h, off)),
                                 newl)
                newk = jnp.where(same, jnp.minimum(newk, sl(key_h, off)),
                                 newk)
            # block-local pointer jump on the labels
            dz_ = newl // (ny * nx)
            remv = newl - dz_ * (ny * nx)
            dy_ = remv // nx
            dx_ = remv - dy_ * nx
            inblk = ((dz_ >= z0) & (dz_ < z0 + bz)
                     & (dy_ >= y0) & (dy_ < y0 + by))
            loc = jnp.clip(((dz_ - z0) * by + (dy_ - y0)) * nx + dx_,
                           0, bz * by * nx - 1)
            jl = newl.reshape(-1)[loc.reshape(-1)].reshape(x.shape)
            jk = newk.reshape(-1)[loc.reshape(-1)].reshape(x.shape)
            newl = jnp.where(inblk, jl, newl)
            newk = jnp.where(inblk, jnp.minimum(newk, jk), newk)
            ch = jnp.any((newl != lab) | (newk != key))
            ch = jax.lax.psum(jax.lax.psum(ch.astype(jnp.int32), zn),
                              yn) > 0
            return newl, newk, ch

        plab, pkey, _ = jax.lax.while_loop(
            lambda s: s[2], plab_body, (idx, key2, jnp.asarray(True)))
        is_min_plateau = valid & (pkey == SENT)

        # initial parents (propagate.py:103-105 semantics)
        parent = jnp.where(has_lower, best_idx, jnp.int32(-1))
        parent = jnp.where(is_min_plateau, plab, parent)
        parent = jnp.where(~valid, idx, parent)

        def resolve_body(state):
            par, _ = state
            resolved = par >= 0
            par_h = pad_labels(jnp.where(resolved, par, jnp.int32(-1)))
            newpar = par
            for same, nidx, off in zip(same_list, nidx_list, offsets):
                nres = sl(par_h, off) >= 0
                cand_ok = same & nres
                cand = jnp.where(cand_ok, nidx, SENT)
                newpar = jnp.where(
                    ~resolved & cand_ok
                    & (cand < jnp.where(newpar >= 0, newpar, SENT)),
                    cand, newpar)
            ch = jnp.any((newpar >= 0) != resolved)
            ch = jax.lax.psum(jax.lax.psum(ch.astype(jnp.int32), zn),
                              yn) > 0
            return newpar, ch

        parent, _ = jax.lax.while_loop(lambda s: s[1], resolve_body,
                                       (parent, jnp.asarray(True)))
        parent = jnp.where(parent < 0, idx, parent)  # safety net
        return parent

    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec),
        out_specs=spec, check_vma=False))


@functools.lru_cache(maxsize=None)
def _build_sharded_minimax(mesh: Mesh,
                           offsets: Tuple[Tuple[int, int, int], ...]):
    """Sharded counterpart of ``segment.propagate._minimax_device``
    (the marker/boundary flooding-level propagation): identical
    per-iteration update math on halo-exchanged blocks, with the
    convergence flag psum'd over the mesh -- states are bit-identical
    to the single-device loop at every iteration.

    Inputs (block-sharded): signed surface ``x``, int32 ``seed_lab``,
    validity ``m`` (user mask AND in-bounds) and the in-bounds
    indicator ``inb``.  Returns (flooding level r, labels)."""
    zn, yn = mesh.axis_names
    spec = P(zn, yn)
    rr = max(max(abs(c) for c in off) for off in offsets)
    BIG = jnp.int32(np.iinfo(np.int32).max)
    INF = jnp.float32(np.inf)

    def local(x, seed_lab, m, inb):
        bz, by, nx = x.shape
        valid = m != 0
        xv = jnp.where(valid, x, INF)
        is_seed = (seed_lab > 0) & valid

        def pad_r(v):
            v = halo_pad_2d(v, rr, rr, zn, yn)
            return jnp.pad(v, ((0, 0), (0, 0), (rr, rr)))

        def sl(p, off):
            dz, dy, dx = off
            return jax.lax.dynamic_slice(p, (rr + dz, rr + dy, rr + dx),
                                         (bz, by, nx))

        inh = pad_r(inb) > 0
        xv_h = jnp.where(inh, pad_r(xv), INF)

        r0 = jnp.where(is_seed, xv, INF)
        l0 = jnp.where(is_seed, seed_lab, BIG)
        dr0 = jnp.where(is_seed, -INF, INF)
        dx0 = jnp.where(is_seed, -INF, INF)

        def body(state):
            r, lab, dr, dxk, _, it = state
            r_hp = jnp.where(inh, pad_r(r), INF)
            lab_hp = BIG - pad_r(BIG - lab)     # BIG beyond the volume
            new_r, new_lab, new_dr, new_dx = r, lab, dr, dxk
            for off in offsets:
                r_u = sl(r_hp, off)
                x_u = sl(xv_h, off)
                lab_u = sl(lab_hp, off)
                better = valid & ~is_seed & (lab_u != BIG) & (
                    (r_u < new_dr) | ((r_u == new_dr) & (x_u < new_dx)))
                relabel = valid & ~is_seed & (lab_u != BIG) & (
                    (r_u == new_dr) & (x_u == new_dx)
                    & (lab_u != new_lab))
                new_dr = jnp.where(better, r_u, new_dr)
                new_dx = jnp.where(better, x_u, new_dx)
                new_lab = jnp.where(better | relabel, lab_u, new_lab)
                new_r = jnp.where(better, jnp.maximum(r_u, xv), new_r)
            ch = jnp.any((new_dr != dr) | (new_dx != dxk)
                         | (new_lab != lab))
            ch = jax.lax.psum(jax.lax.psum(ch.astype(jnp.int32), zn),
                              yn) > 0
            return new_r, new_lab, new_dr, new_dx, ch, it + 1

        nz_g = bz * jax.lax.axis_size(zn)
        ny_g = by * jax.lax.axis_size(yn)
        max_it = 8 * int(nz_g + ny_g + nx) if isinstance(nz_g, int) \
            else jnp.int32(8) * (nz_g + ny_g + nx)
        r, lab, _, _, _, _ = jax.lax.while_loop(
            lambda s: s[4] & (s[5] < max_it), body,
            (r0, l0, dr0, dx0, jnp.asarray(True), jnp.int32(0)))
        return r, jnp.where(lab == BIG, 0, lab)

    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec, spec),
        out_specs=(spec, spec), check_vma=False))


def sharded_minimax(x_np, seeds_np, mask_np, offs, mesh: Mesh):
    """Mesh-sharded ``_minimax_device`` over host arrays: pads to the
    mesh grid, runs the halo-exchange flood, crops.  Returns (r, lab)
    numpy arrays, bit-identical to the single-device propagation."""
    x = np.asarray(x_np, np.float32)
    nz, ny, nx = x.shape
    xp, _ = _pad_zy(x, mesh)
    seedp, _ = _pad_zy(np.asarray(seeds_np, np.int32), mesh)
    inb = _inbounds_indicator(x.shape, mesh)
    mp = inb
    if mask_np is not None:
        mpad, _ = _pad_zy(np.asarray(mask_np, np.float32), mesh)
        mp = mpad * inb

    sharding = NamedSharding(mesh, P(*mesh.axis_names))
    args = [jax.device_put(jnp.asarray(a), sharding)
            for a in (xp, seedp, mp, inb)]
    fn = _build_sharded_minimax(mesh, offs)
    r, lab = fn(*args)
    return (to_host_np(r)[:nz, :ny, :nx],
            to_host_np(lab)[:nz, :ny, :nx])


def propagate_watershed_sharded(
    source,
    mesh: Mesh,
    mask=None,
    markers=None,
    start_from_minima: bool = True,
    halt_threshold: float = np.inf,
    connectivity: int = 1,
    show_boundaries: bool = False,
    label_boundary: int = 0,
    label_undefined: int = -1,
):
    """Mesh-sharded ``segment.propagate.propagate_watershed``:
    identical basins/labels; the descent/plateau/resolve stencil
    phases AND the marker/boundary minimax flood run under shard_map
    with halo exchange; only the tiny label LUTs and the contested-set
    boundary cascade (vectorized numpy over the contested voxels) run
    on the host."""
    from visfd_jax.segment import extrema as E
    from visfd_jax.segment.propagate import (
        _marker_watershed, postprocess_basins)

    offs_all = E.neighbor_offsets(connectivity)

    def minimax_fn(x_j, seeds_j, m_j, offs_):
        return sharded_minimax(np.asarray(x_j), np.asarray(seeds_j),
                               None if m_j is None else np.asarray(m_j),
                               offs_, mesh)

    def add_boundaries(res, x_s, offs_):
        """Shared Meyer-boundary post-pass: sharded minimax flood from
        the basin roots, host contested-set cascade."""
        import dataclasses as _dc
        from visfd_jax.segment.propagate import meyer_boundaries
        seeds = np.zeros(res.labels.shape, np.int32)
        locs = np.asarray(res.basin_locations)
        if len(locs):
            seeds[locs[:, 2], locs[:, 1], locs[:, 0]] = np.arange(
                1, len(locs) + 1, dtype=np.int32)
        r, _ = minimax_fn(x_s, seeds, mask, offs_)
        labels = meyer_boundaries(
            res.labels, r, x_s, offs_,
            valid=None if mask is None else np.asarray(mask),
            label_boundary=label_boundary)
        return _dc.replace(res, labels=labels)

    if markers is not None:
        # marker labels come from the minimax flood (not descent);
        # round 4: the flood itself runs mesh-sharded, the host only
        # builds seeds and remaps basin ids to user marker labels
        x_s = np.asarray(source, np.float32)
        if not start_from_minima:
            x_s = -x_s
            halt_s = (-halt_threshold if np.isfinite(halt_threshold)
                      else np.inf)
        else:
            halt_s = halt_threshold
        m_j = None if mask is None else jnp.asarray(mask, jnp.float32)
        res = _marker_watershed(
            jnp.asarray(x_s), m_j, np.asarray(markers), offs_all,
            start_from_minima, halt_s, label_undefined,
            minimax_fn=minimax_fn)
        if show_boundaries:
            res = add_boundaries(res, x_s, offs_all)
        return res

    x = np.asarray(source, np.float32)
    if not start_from_minima:
        x = -x
        halt = -halt_threshold if np.isfinite(halt_threshold) else np.inf
    else:
        halt = halt_threshold
    nz, ny, nx = x.shape

    xp, _ = _pad_zy(x, mesh)
    inb = _inbounds_indicator(x.shape, mesh)
    mp = inb
    if mask is not None:
        mpad, _ = _pad_zy(np.asarray(mask, np.float32), mesh)
        mp = mpad * inb

    sharding = NamedSharding(mesh, P(*mesh.axis_names))
    xp = jax.device_put(xp, sharding)
    mp = jax.device_put(mp, sharding)
    inb = jax.device_put(inb, sharding)

    offs = E.neighbor_offsets(connectivity)
    fn = _build_sharded_descend(mesh, offs)
    parent = to_host_np(fn(xp, mp, inb)).astype(np.int64)

    # host pointer collapse (log-depth rounds of vectorized gathers)
    parf = parent.reshape(-1)
    while True:
        new = parf[parf]
        if np.array_equal(new, parf):
            break
        parf = new
    root_p = parf.reshape(parent.shape)

    # crop mesh padding; remap padded-dims flat indices to true dims
    ny_p, nx_p = parent.shape[1], parent.shape[2]
    root = np.array(root_p[:nz, :ny])
    z_ = root // (ny_p * nx_p)
    rem = root - z_ * (ny_p * nx_p)
    y_ = rem // nx_p
    x_ = rem - y_ * nx_p
    root = (z_ * ny + y_) * nx + x_

    valid = np.ones((nz, ny, nx), bool) if mask is None \
        else (np.asarray(mask) != 0)
    res = postprocess_basins(root, valid, x,
                             start_from_minima=start_from_minima,
                             halt=halt, label_undefined=label_undefined)
    if show_boundaries:
        res = add_boundaries(res, x, offs)
    return res


def sharded_blob_dog(
    x,
    sigmas: Sequence[float],
    mesh: Mesh,
    mask=None,
    **kw,
):
    """Mesh-sharded ``features.blob.blob_dog``: same candidate lists,
    bit-identical scores/coordinates; per-scale LoG + extremum test run
    under shard_map with halo exchange, and candidate compaction runs
    on device (only index/score lists are gathered to host)."""
    from visfd_jax.features import blob as B

    x = jnp.asarray(x, jnp.float32)
    orig_shape = x.shape
    xp, (pz, py) = _pad_zy(x, mesh)
    ind = _inbounds_indicator(orig_shape, mesh)
    mp = ind
    if mask is not None:
        mpad, _ = _pad_zy(jnp.asarray(mask, jnp.float32), mesh)
        mp = mpad * ind

    sharding = NamedSharding(mesh, P(*mesh.axis_names))
    xp = jax.device_put(xp, sharding)
    mp = jax.device_put(mp, sharding)

    raw_log = make_sharded_log_fn(mesh, orig_shape)
    ext = _build_sharded_extremum(mesh, mask is not None)

    def log_fn(_x, sig_xyz, delta, truncate_ratio, _m):
        return raw_log(xp, sig_xyz, delta, truncate_ratio,
                       mp if mask is not None else None)

    def extremum_fn(prev, mid, next_, _m):
        # pad voxels can never be extrema (indicator = 0 there), and
        # because padding sits at the high ends of Z/Y the candidate
        # (x, y, z) coordinates in padded arrays equal the true ones --
        # no cropping needed before the host argwhere.
        return ext(prev, mid, next_, mp)

    return B.blob_dog(xp, sigmas, mask=mp if mask is not None else None,
                      log_fn=log_fn, extremum_fn=extremum_fn, **kw)
