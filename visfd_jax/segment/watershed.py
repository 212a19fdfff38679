"""Watershed segmentation (Meyer inter-pixel flood).

Parity with ``Watershed`` (``segmentation.hpp:65-559``):

* seeds = plateau minima (or maxima) from the extrema finder, or a
  user marker image (labels > 0; first-seen raster voxel per label
  seeds the flood);
* priority flood: repeatedly pop the lowest-intensity queued voxel
  (ties resolved exactly like the reference's
  ``priority_queue<tuple<-score, basin, (ix,iy,iz)>>``: equal scores
  pop the larger basin id first, then the larger (ix,iy,iz)
  lexicographically), assign it to the queuing basin, and queue its
  unvisited in-mask neighbors;
* when a popped voxel touches an already-assigned different basin it
  becomes the boundary label (the popped voxel is the shallower one);
* voxels whose intensity exceeds ``halt_threshold`` (after the
  minima/maxima sign flip) become ``label_undefined``;
* with markers, basin ids are remapped back to the marker labels.

This exact sequential semantics runs on the host -- segmentation
label assignment is an inherently ordered computation.  The flood
itself runs in the native C++ runtime (``visfd_jax.native``,
mirroring the reference's compiled flood) with a bit-identical
pure-Python fallback (``VISFD_NATIVE=0`` forces the fallback).  The
device-scale path (``visfd_jax.segment.propagate``) provides an
iterative label-propagation watershed for HBM-resident volumes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import heapq
from typing import Optional, Tuple

import numpy as np

from visfd_jax import native
from visfd_jax.segment.extrema import find_extrema, neighbor_offsets, flat_to_xyz

WATERSHED_BOUNDARY = 0
UNDEFINED = -1


@dataclasses.dataclass
class WatershedResult:
    labels: np.ndarray          # (Z, Y, X) int64; basins are 1..N
    num_basins: int
    basin_locations: np.ndarray  # (N, 3) as (ix, iy, iz)
    basin_scores: np.ndarray


def watershed(
    source: np.ndarray,
    mask: Optional[np.ndarray] = None,
    markers: Optional[np.ndarray] = None,
    halt_threshold: float = np.inf,
    start_from_minima: bool = True,
    connectivity: int = 1,
    show_boundaries: bool = True,
    label_boundary: int = WATERSHED_BOUNDARY,
    label_undefined: int = UNDEFINED,
) -> WatershedResult:
    source = np.asarray(source, np.float32)
    nz, ny, nx = source.shape
    valid = None if mask is None else (np.asarray(mask) != 0)
    offs = neighbor_offsets(connectivity)

    sign = 1.0 if start_from_minima else -1.0
    if (not start_from_minima) and np.isinf(halt_threshold) \
       and halt_threshold > 0:
        halt_threshold = -np.inf

    # ---- seeds ----
    basin_locs = []   # (ix, iy, iz)
    basin_scores = []
    marker_labels = []  # per-basin marker label (when markers given)
    if markers is not None:
        # vectorized first-occurrence-per-label scan (raster order,
        # matching the reference's sequential discovery)
        markers = np.asarray(markers)
        flat = markers.reshape(-1)
        ok = flat > 0
        if valid is not None:
            ok &= valid.reshape(-1)
        hit = np.flatnonzero(ok)
        labs = flat[hit]
        uniq, first = np.unique(labs, return_index=True)
        disc = np.argsort(first, kind="stable")  # discovery order
        seed_flat = hit[first[disc]]
        for f, lab in zip(seed_flat, uniq[disc]):
            iz, rem = divmod(int(f), ny * nx)
            iy, ix = divmod(rem, nx)
            basin_locs.append((ix, iy, iz))
            basin_scores.append(float(source[iz, iy, ix]))
            marker_labels.append(int(lab))
    else:
        res = find_extrema(
            source, mask=mask,
            find_minima=start_from_minima,
            find_maxima=not start_from_minima,
            minima_threshold=halt_threshold if start_from_minima else np.inf,
            maxima_threshold=halt_threshold if not start_from_minima
            else -np.inf,
            connectivity=connectivity,
            allow_borders=True,
            want_label_image=False,
        )
        idxs = (res.minima_indices if start_from_minima
                else res.maxima_indices)
        scs = (res.minima_scores if start_from_minima else res.maxima_scores)
        for i, s in zip(idxs, scs):
            ix, iy, iz = flat_to_xyz(int(i), source.shape)
            basin_locs.append((ix, iy, iz))
            basin_scores.append(float(s))

    num_basins = len(basin_locs)

    lib = native.load()
    if lib is not None:
        src_c = np.ascontiguousarray(source, np.float32)
        valid_c = (None if valid is None
                   else np.ascontiguousarray(valid, np.uint8))
        seeds_c = np.ascontiguousarray(
            np.asarray(basin_locs, np.int32).reshape(-1, 3))
        scores_c = np.ascontiguousarray(basin_scores, np.float32)
        offs_c = np.ascontiguousarray(np.asarray(offs, np.int32))
        labels = np.empty(source.shape, np.int64)
        lib.visfd_watershed_flood(
            native.ptr(src_c, ctypes.c_float),
            native.ptr(valid_c, ctypes.c_uint8),
            nz, ny, nx,
            native.ptr(seeds_c, ctypes.c_int32),
            native.ptr(scores_c, ctypes.c_float), num_basins,
            native.ptr(offs_c, ctypes.c_int32), len(offs),
            float(sign), float(halt_threshold), int(show_boundaries),
            native.ptr(labels, ctypes.c_int64))
    else:
        labels = _flood_python(source, valid, basin_locs, basin_scores,
                               num_basins, offs, sign, halt_threshold,
                               show_boundaries)

    if label_boundary != WATERSHED_BOUNDARY:
        labels[labels == WATERSHED_BOUNDARY] = label_boundary
    if label_undefined != UNDEFINED:
        sel = labels == UNDEFINED
        if valid is not None:
            sel &= valid
        labels[sel] = label_undefined

    if markers is not None:
        # remap basin ids back to user marker labels
        remap = {}
        for i, lab in enumerate(marker_labels):
            remap[i + 1] = lab
        out = labels.copy()
        basin_sel = np.ones(labels.shape, bool)
        basin_sel &= labels != label_boundary
        basin_sel &= labels != label_undefined
        if valid is not None:
            basin_sel &= valid
        vals = labels[basin_sel]
        mapped = np.array([remap.get(int(v), label_undefined) for v in vals],
                          np.int64)
        out[basin_sel] = mapped
        labels = out

    return WatershedResult(
        labels=labels,
        num_basins=num_basins,
        basin_locations=np.asarray(basin_locs, np.int64).reshape(-1, 3),
        basin_scores=np.asarray(basin_scores, np.float32),
    )


def _flood_python(source, valid, basin_locs, basin_scores, num_basins,
                  offs, sign, halt_threshold, show_boundaries):
    """Pure-Python Meyer flood, bit-identical to the native core."""
    nz, ny, nx = source.shape
    labels = np.full(source.shape, UNDEFINED, np.int64)
    QUEUED = num_basins + 2  # internal sentinel distinct from all labels

    # heapq is a min-heap; the reference's max-heap of
    # (-score, basin, coords) pops min score, then max basin, then max
    # coords -- so push (score, -basin, (-ix, -iy, -iz)).
    q = []
    for i, (ix, iy, iz) in enumerate(basin_locs):
        score = basin_scores[i] * sign
        heapq.heappush(q, (score, -i, (-ix, -iy, -iz)))
        labels[iz, iy, ix] = QUEUED

    while q:
        score, neg_basin, neg_crd = heapq.heappop(q)
        basin = -neg_basin
        ix, iy, iz = -neg_crd[0], -neg_crd[1], -neg_crd[2]

        if score > halt_threshold * sign:
            labels[iz, iy, ix] = UNDEFINED
            continue
        if valid is not None and not valid[iz, iy, ix]:
            labels[iz, iy, ix] = UNDEFINED
            continue

        labels[iz, iy, ix] = basin + 1

        for dz, dy, dx in offs:
            z, y, x = iz + dz, iy + dy, ix + dx
            if not (0 <= z < nz and 0 <= y < ny and 0 <= x < nx):
                continue
            if valid is not None and not valid[z, y, x]:
                continue
            nlab = labels[z, y, x]
            if nlab == WATERSHED_BOUNDARY or nlab == QUEUED:
                continue
            if nlab == UNDEFINED:
                labels[z, y, x] = QUEUED
                heapq.heappush(
                    q, (float(source[z, y, x]) * sign, -basin,
                        (-x, -y, -z)))
            else:
                if nlab != labels[iz, iy, ix] and show_boundaries:
                    # popped voxel is the shallower one -> boundary
                    labels[iz, iy, ix] = WATERSHED_BOUNDARY
    # note: the reference re-checks labels[iz][iy][ix] != neighbor for
    # every neighbor; after the first boundary assignment the voxel's
    # label IS boundary, and subsequent neighbors with basin labels
    # differ from it, keeping it boundary -- same result.
    return labels
