"""Device-scale watershed by iterative label propagation.

The reference's watershed (``segmentation.hpp:240-468``) is a
sequential Meyer priority-flood; ``visfd_jax.segment.watershed`` keeps
those exact semantics on the host (native C++ flood).  This module is
the device-resident alternative for volumes that should stay in device memory: a
steepest-descent watershed computed entirely with jitted, fixpoint
``lax.while_loop`` label propagation (no host transfers of the volume).

Algorithm (all device):

1. per-voxel steepest-descent parent: the lowest strictly-lower
   neighbor (ties -> smallest flat index);
2. plateau connected components by min-index propagation over
   equal-value adjacency (pointer jumping, same scheme as
   ``extrema._extrema_device``);
3. minima plateaus (no member has a lower neighbor) become basin
   roots: every member points at the plateau representative;
   non-minimum plateau members without a lower neighbor iteratively
   adopt a resolved equal-value neighbor (BFS-from-exit ordering);
4. pointer jumping collapses parents to roots in O(log depth) rounds.

Each voxel lands in the basin its steepest-descent path reaches --
identical to the Meyer flood wherever a voxel's descent is
unambiguous, and deterministic (smallest-index tie-breaks) elsewhere.
Basin numbering matches ``segment.watershed``: basins are 1..N in
score order (ascending for minima floods, descending for maxima),
raster order on ties, so ``max(label) == number of extrema`` holds
just like the host path.

For sharded volumes, run under ``shard_map`` with halo exchange: all
steps are neighbor-local except pointer jumping, which is a gather --
see ``visfd_jax.parallel``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from visfd_jax.segment.extrema import neighbor_offsets, _shift_int


@functools.partial(jax.jit, static_argnames=("offsets",))
def _descend_device(x, mask, offsets):
    """Returns (root, valid) where ``root`` is the basin-root flat
    index per voxel (its steepest-descent destination) and ``valid``
    the in-mask predicate."""
    nz, ny, nx = x.shape
    n = nz * ny * nx
    valid = jnp.ones(x.shape, bool) if mask is None else (mask != 0)
    idx = jnp.arange(n, dtype=jnp.int32).reshape(x.shape)

    INF = jnp.float32(jnp.inf)
    xv = jnp.where(valid, x, INF)

    # -- 1. steepest lower neighbor (min value, tie -> min index) --
    best_val = jnp.full(x.shape, INF)
    best_idx = jnp.full(x.shape, n, jnp.int32)
    # -- 2. plateau adjacency for equal-value propagation --
    neigh_equal = []
    for off in offsets:
        nv = _shift_int(xv, off, INF)
        nidx = _shift_int(idx, off, n)
        usable = nidx < n
        lower = usable & (nv < xv)
        better = lower & ((nv < best_val)
                          | ((nv == best_val) & (nidx < best_idx)))
        best_val = jnp.where(better, nv, best_val)
        best_idx = jnp.where(better, nidx, best_idx)
        neigh_equal.append((usable & (nv == xv), nidx))

    has_lower = jnp.isfinite(best_val)

    # plateau labels: min flat index over equal-value components
    plab = idx

    def plab_body(state):
        lab, _ = state
        new = lab
        flat = lab.reshape(-1)
        for same, nidx in neigh_equal:
            nlab = flat[jnp.clip(nidx.reshape(-1), 0, n - 1)].reshape(x.shape)
            new = jnp.where(same, jnp.minimum(new, nlab), new)
        newf = new.reshape(-1)
        new = newf[newf].reshape(x.shape)
        return new, jnp.any(new != lab)

    plab, _ = jax.lax.while_loop(lambda s: s[1], plab_body,
                                 (plab, jnp.asarray(True)))

    # plateau has-a-lower-neighbor reduction
    p_has_lower = jnp.zeros(n, bool).at[plab.reshape(-1)].max(
        (has_lower & valid).reshape(-1))
    is_min_plateau = valid & ~p_has_lower[plab]

    # -- 3. initial parents --
    parent = jnp.where(has_lower, best_idx, jnp.int32(-1))
    parent = jnp.where(is_min_plateau, plab, parent)
    parent = jnp.where(~valid, idx, parent)

    def resolve_body(state):
        par, _ = state
        resolved = par >= 0
        newpar = par
        parf = par.reshape(-1)
        for same, nidx in neigh_equal:
            nres = (parf[jnp.clip(nidx.reshape(-1), 0, n - 1)] >= 0
                    ).reshape(x.shape)
            cand_ok = same & nres
            cand = jnp.where(cand_ok, nidx, n)
            newpar = jnp.where(
                ~resolved & cand_ok & (cand < jnp.where(newpar >= 0, newpar,
                                                        n)),
                cand, newpar)
        return newpar, jnp.any((newpar >= 0) != resolved)

    parent, _ = jax.lax.while_loop(lambda s: s[1], resolve_body,
                                   (parent, jnp.asarray(True)))
    parent = jnp.where(parent < 0, idx, parent)  # safety net

    # -- 4. pointer jumping to roots --
    def jump_body(state):
        par, _ = state
        parf = par.reshape(-1)
        new = parf[parf].reshape(x.shape)
        return new, jnp.any(new != par)

    root, _ = jax.lax.while_loop(lambda s: s[1], jump_body,
                                 (parent, jnp.asarray(True)))
    return jnp.where(valid, root, -1), valid


@functools.partial(jax.jit, static_argnames=("offsets",))
def _minimax_device(x, seed_lab, mask, offsets):
    """Flooding level r(v) (the level at which the Meyer flood pops v)
    and the flood label, by fixpoint propagation.

    In the Meyer flood a voxel's basin is that of its FIRST-POPPED
    neighbor (the one that queued it).  With pop order reconstructed
    as lexicographic (r, x), the recursion is: donor(v) = the neighbor
    u minimizing (r_u, x_u); label(v) = label(donor); r(v) =
    max(r_donor, x_v).  Seeds are pinned (queued at init, nothing
    overwrites them).  Exact Meyer parity wherever intensities are
    distinct; deterministic everywhere."""
    valid = jnp.ones(x.shape, bool) if mask is None else (mask != 0)
    INF = jnp.float32(jnp.inf)
    xv = jnp.where(valid, x, INF)
    BIG = jnp.int32(np.iinfo(np.int32).max)
    is_seed = (seed_lab > 0) & valid

    r0 = jnp.where(is_seed, xv, INF)
    l0 = jnp.where(is_seed, seed_lab, BIG)
    dr0 = jnp.where(is_seed, -INF, INF)  # donor pop key (r_u, x_u)
    dx0 = jnp.where(is_seed, -INF, INF)

    def body(state):
        r, lab, dr, dx, _, it = state
        new_r, new_lab, new_dr, new_dx = r, lab, dr, dx
        for off in offsets:
            r_u = _shift_int(r, off, INF)
            x_u = _shift_int(xv, off, INF)
            lab_u = _shift_int(lab, off, BIG)
            better = valid & ~is_seed & (lab_u != BIG) & (
                (r_u < new_dr) | ((r_u == new_dr) & (x_u < new_dx)))
            # a donor whose LABEL changed after we adopted it has the
            # same key; propagate the relabel (keys are unique per
            # donor since x values distinguish voxels)
            relabel = valid & ~is_seed & (lab_u != BIG) & (
                (r_u == new_dr) & (x_u == new_dx) & (lab_u != new_lab))
            new_dr = jnp.where(better, r_u, new_dr)
            new_dx = jnp.where(better, x_u, new_dx)
            new_lab = jnp.where(better | relabel, lab_u, new_lab)
            new_r = jnp.where(better, jnp.maximum(r_u, xv), new_r)
        changed = jnp.any((new_dr != dr) | (new_dx != dx)
                          | (new_lab != lab))
        return new_r, new_lab, new_dr, new_dx, changed, it + 1

    # iteration cap: relabel propagation along pathological equal-r
    # donor cycles (only constructible with exact fp ties) must not
    # livelock; 8 * (nz+ny+nx) far exceeds any real donor-chain depth
    max_it = 8 * int(sum(x.shape))
    r, lab, _, _, _, _ = jax.lax.while_loop(
        lambda s: s[4] & (s[5] < max_it), body,
        (r0, l0, dr0, dx0, jnp.asarray(True), jnp.int32(0)))
    return r, jnp.where(lab == BIG, 0, lab)


def meyer_boundaries(labels, r, x_signed, offs, valid=None,
                     label_boundary: int = 0) -> np.ndarray:
    """Post-pass reproducing the Meyer flood's boundary labeling
    (``segmentation.hpp:449-465``): a popped voxel that touches an
    already-assigned different basin becomes the boundary (the popped
    voxel is the shallower one).

    Pop order is reconstructed as lexicographic (flooding level r,
    intensity, flat index) -- exact wherever intensities are distinct.
    Only "contested" voxels (assigned, with a differently-labeled
    assigned neighbor) need the sequential cascade; everything else is
    vectorized numpy.
    """
    labels = np.asarray(labels)
    nzny = labels.shape
    nz, ny, nx = nzny
    assigned = labels > 0
    if valid is not None:
        assigned &= np.asarray(valid) != 0

    # neighbor flat-index table (host, vectorized)
    flat_idx = np.arange(labels.size, dtype=np.int64).reshape(nzny)
    contested = np.zeros(nzny, bool)
    neigh_tables = []
    for dz, dy, dx in offs:
        sl_src = tuple(
            slice(max(0, -d), min(s, s - d))
            for d, s in zip((dz, dy, dx), nzny))
        sl_dst = tuple(
            slice(max(0, d), min(s, s + d))
            for d, s in zip((dz, dy, dx), nzny))
        nlab = np.full(nzny, -2, np.int64)
        nidx = np.full(nzny, -1, np.int64)
        nlab[sl_dst] = labels[sl_src]
        nassigned = np.zeros(nzny, bool)
        nassigned[sl_dst] = assigned[sl_src]
        nidx[sl_dst] = flat_idx[sl_src]
        contested |= assigned & nassigned & (nlab != labels)
        neigh_tables.append(nidx.reshape(-1))

    out = labels.copy()
    if not contested.any():
        return out

    rf = np.asarray(r).reshape(-1)
    xf = np.asarray(x_signed).reshape(-1)
    lf = labels.reshape(-1)
    af = assigned.reshape(-1)
    cf = np.flatnonzero(contested.reshape(-1))
    # pop order: (r, x, flat index)
    order = cf[np.lexsort((cf, xf[cf], rf[cf]))]
    m = len(order)
    ntab = np.stack(neigh_tables, axis=0)  # (n_offs, n)

    # v becomes boundary iff some neighbor u with (assigned, different
    # label, popped strictly earlier) SURVIVED (was not itself marked
    # boundary when popped).  Every such donor is itself contested
    # (the offset set is symmetric, so u sees v right back), so the
    # whole cascade lives on the contested subset and resolves in
    # vectorized rounds over dependency ranks: a voxel is decided once
    # each earlier differently-labeled neighbor is decided.  Chains
    # longer than the round cap (exotic equal-key ramps) finish in the
    # sequential tail below.
    rank = np.full(labels.size, -1, np.int64)
    rank[order] = np.arange(m)
    deps = ntab[:, order]                       # (n_offs, m) flat idx
    dep_ok = deps >= 0
    du = np.where(dep_ok, deps, 0)
    dep_ok &= af[du] & (lf[du] != lf[order][None, :])
    dep_rank = np.where(dep_ok, rank[du], -1)
    dep_ok &= dep_rank < np.arange(m)[None, :]  # strictly earlier pop
    dep_rank = np.where(dep_ok, dep_rank, -1)
    dr_safe = np.where(dep_rank >= 0, dep_rank, 0)

    status = np.zeros(m, np.int8)  # 0 unknown / 1 boundary / 2 clear
    for _ in range(min(m, 256)):
        unknown = status == 0
        if not unknown.any():
            break
        ds = status[dr_safe]
        any_clear = ((dep_rank >= 0) & (ds == 2)).any(axis=0)
        all_bound = ((dep_rank < 0) | (ds == 1)).all(axis=0)
        newly_b = unknown & any_clear
        newly_c = unknown & ~any_clear & all_bound
        if not (newly_b.any() or newly_c.any()):
            break
        status[newly_b] = 1
        status[newly_c] = 2

    boundary = np.zeros(labels.size, bool)
    boundary[order[status == 1]] = True
    # sequential tail (rare): deps of every remaining unknown are
    # either vector-resolved or earlier in this same ascending walk
    for vi in np.flatnonzero(status == 0):
        v = order[vi]
        for o in range(ntab.shape[0]):
            u = deps[o, vi]
            if dep_rank[o, vi] < 0:
                continue
            if not boundary[u]:
                boundary[v] = True
                break
    out.reshape(-1)[boundary] = label_boundary
    return out


@dataclasses.dataclass
class PropagateResult:
    labels: np.ndarray           # (Z, Y, X) int64; basins 1..N; -1 undefined
    num_basins: int
    basin_locations: np.ndarray  # (N, 3) (ix, iy, iz) of basin roots
    basin_scores: np.ndarray


def propagate_watershed(
    source,
    mask=None,
    markers=None,
    start_from_minima: bool = True,
    halt_threshold: float = np.inf,
    connectivity: int = 1,
    show_boundaries: bool = False,
    label_boundary: int = 0,
    label_undefined: int = -1,
) -> PropagateResult:
    """Device watershed; see module docstring.

    ``markers``: like the host Meyer flood, a label image whose
    first-seen (raster order) voxel per positive label seeds a basin;
    labels come from a device minimax flooding-level propagation
    (exact Meyer assignment wherever levels are distinct).
    ``show_boundaries``: post-pass reproducing the Meyer flood's
    basin-collision boundary labeling (``meyer_boundaries``).
    """
    x = jnp.asarray(source, jnp.float32)
    if not start_from_minima:
        x = -x
        halt = -halt_threshold if np.isfinite(halt_threshold) else np.inf
    else:
        halt = halt_threshold
    offs = neighbor_offsets(connectivity)
    m = None if mask is None else jnp.asarray(mask, jnp.float32)
    if markers is not None:
        res = _marker_watershed(x, m, np.asarray(markers), offs,
                                start_from_minima, halt, label_undefined)
    else:
        root, valid = _descend_device(x, m, offs)
        res = postprocess_basins(
            np.asarray(root), np.asarray(valid), np.asarray(x),
            start_from_minima=start_from_minima, halt=halt,
            label_undefined=label_undefined)
    if show_boundaries:
        seeds = np.zeros(res.labels.shape, np.int32)
        locs = np.asarray(res.basin_locations)
        if len(locs):
            seeds[locs[:, 2], locs[:, 1], locs[:, 0]] = np.arange(
                1, len(locs) + 1, dtype=np.int32)
        r, _ = _minimax_device(x, jnp.asarray(seeds), m, offs)
        labels = meyer_boundaries(
            res.labels, np.asarray(r), np.asarray(x), offs,
            valid=None if mask is None else np.asarray(mask),
            label_boundary=label_boundary)
        res = dataclasses.replace(res, labels=labels)
    return res


def _marker_watershed(x_signed, mask, markers, offs, start_from_minima,
                      halt, label_undefined,
                      minimax_fn=None) -> PropagateResult:
    """Marker-seeded device watershed: one seed per positive marker
    label (first raster voxel, matching ``segment.watershed``), labels
    by minimax flooding-level propagation.  ``minimax_fn`` overrides
    the single-device flood (the mesh-sharded path plugs in
    ``parallel.sharded_features.sharded_minimax``, bit-identical)."""
    valid_np = (np.ones(markers.shape, bool) if mask is None
                else np.asarray(mask) != 0)
    flat = markers.reshape(-1)
    ok = (flat > 0) & valid_np.reshape(-1)
    hit = np.flatnonzero(ok)
    labs = flat[hit]
    uniq, first = np.unique(labs, return_index=True)
    disc = np.argsort(first, kind="stable")  # discovery (raster) order
    seed_flat = hit[first[disc]]
    marker_labels = uniq[disc].astype(np.int64)

    seeds = np.zeros(markers.shape, np.int32)
    nz, ny, nx = markers.shape
    seeds.reshape(-1)[seed_flat] = np.arange(1, len(seed_flat) + 1,
                                             dtype=np.int32)
    if minimax_fn is None:
        _, lab = _minimax_device(x_signed, jnp.asarray(seeds), mask,
                                 offs)
    else:
        _, lab = minimax_fn(x_signed, seeds, mask, offs)
    lab = np.asarray(lab).astype(np.int64)
    x_np = np.asarray(x_signed)
    labels = np.where(valid_np & (lab > 0), lab, label_undefined)
    if np.isfinite(halt):
        labels = np.where(valid_np & (x_np > halt), label_undefined,
                          labels)
    # remap basin ids -> user marker labels (reference :519-549)
    lut = np.zeros(len(seed_flat) + 1, np.int64)
    lut[1:] = marker_labels
    basin_sel = labels > 0
    labels = labels.copy()
    labels[basin_sel] = lut[labels[basin_sel]]

    ixs = seed_flat % nx
    iys = (seed_flat // nx) % ny
    izs = seed_flat // (nx * ny)
    sign = 1.0 if start_from_minima else -1.0
    return PropagateResult(
        labels=labels.astype(np.int64),
        num_basins=len(seed_flat),
        basin_locations=np.stack([ixs, iys, izs], -1).astype(np.int64),
        basin_scores=(x_np.reshape(-1)[seed_flat] * sign).astype(
            np.float32),
    )


def postprocess_basins(
    root: np.ndarray,
    valid: np.ndarray,
    x_signed: np.ndarray,
    start_from_minima: bool,
    halt: float,
    label_undefined: int,
) -> PropagateResult:
    """Host-side basin numbering shared by the single-device and
    mesh-sharded descent kernels.  ``x_signed`` is the (possibly
    sign-flipped) flood surface; ``root`` holds per-voxel basin-root
    flat indices in the TRUE (unpadded) volume."""
    vals = x_signed.reshape(-1)
    shape = root.shape
    nz, ny, nx = shape

    roots = np.unique(root[valid])
    scores = vals[roots]
    # basin numbering to match the host flood: score ascending (in the
    # sign-flipped domain), raster order on ties
    perm = np.lexsort((roots, scores))
    roots = roots[perm]
    scores = scores[perm]

    n = root.size
    lut = np.full(n + 1, 0, np.int64)
    lut[roots] = np.arange(1, len(roots) + 1)
    labels = np.where(valid, lut[np.clip(root, 0, n)], label_undefined)

    # halt: voxels above the threshold (in flood order) are undefined
    if np.isfinite(halt):
        labels = np.where(valid & (x_signed > halt), label_undefined,
                          labels)

    ixs = roots % nx
    iys = (roots // nx) % ny
    izs = roots // (nx * ny)
    sign = 1.0 if start_from_minima else -1.0
    return PropagateResult(
        labels=labels.astype(np.int64),
        num_basins=len(roots),
        basin_locations=np.stack([ixs, iys, izs], -1).astype(np.int64),
        basin_scores=(scores * sign).astype(np.float32),
    )
