"""Scale-free blob detection: DoG scale space, 4-D extremum scan,
non-max suppression, masked discard.

Parity targets in the reference:

* ``BlobDog`` (``feature.hpp:53-427``): per-sigma scale-normalized
  LoG (DoG approximation); 3-image ring buffer; strict 80-neighbor
  (x, y, z, sigma) extremum test (neighbors out of bounds or masked
  disqualify); minima must score < 0, maxima > 0; adaptive ratio
  thresholds during the scan are only a memory optimization -- the
  final refilter against ratio*global best (``feature.hpp:362-417``)
  defines the output, so we collect all candidates and apply the
  final filter once (output-equivalent).
* ``BlobDogD`` (``:446-512``): diameter interface, d = 2*sigma*sqrt(3).
* ``SortBlobs`` (``:519-616``), ``DiscardOverlappingBlobs``
  (``:720-913``, greedy best-first NMS through a coarse occupancy
  grid -- replicated exactly, including the grid's conservative
  collision detection), ``DiscardMaskedBlobs`` (``:924-969``),
  ``CalcSphereOverlap`` (``visfd_utils.hpp:93-119``),
  ``BlobDogNM``/``_BlobDogNM`` composition
  (``bin/filter_mrc/feature_variants.hpp:394-580``).

Device/host split: the per-scale LoG filtering, the 80-neighbor extremum
test, and candidate compaction (count + fixed-capacity nonzero
extraction) run on device; only per-candidate index/score lists cross
PCIe (the reference's per-thread candidate lists,
``feature.hpp:212-346``, never materialize full-volume masks either).
NMS runs on the host (native C++ when available).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from visfd_jax.ops import filters as F

SORT_DECREASING = "decreasing"
SORT_INCREASING = "increasing"
SORT_DECREASING_MAGNITUDE = "decreasing_magnitude"
SORT_INCREASING_MAGNITUDE = "increasing_magnitude"


@dataclasses.dataclass
class BlobList:
    """Columnar blob list; crds are (N, 3) float voxel coords in
    (x, y, z) order."""
    crds: np.ndarray
    diameters: np.ndarray
    scores: np.ndarray

    @classmethod
    def empty(cls):
        return cls(np.zeros((0, 3)), np.zeros(0), np.zeros(0))

    def __len__(self):
        return len(self.scores)

    def take(self, idx) -> "BlobList":
        return BlobList(self.crds[idx], self.diameters[idx],
                        self.scores[idx])


@jax.jit
def _extremum_masks(prev, mid, next_, mask):
    """Strict 4-D local extremum test over the 3x3x3x3 neighborhood
    (80 neighbors; ``feature.hpp:227-308``). Any out-of-bounds or
    masked neighbor disqualifies."""
    center = mid
    is_min = jnp.ones(mid.shape, bool)
    is_max = jnp.ones(mid.shape, bool)
    valid = None if mask is None else (mask != 0)

    for plane in (prev, mid, next_):
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if plane is mid and dz == 0 and dy == 0 and dx == 0:
                        continue
                    nb = F._shift3(plane, (dz, dy, dx), fill=np.nan)
                    ok = ~jnp.isnan(nb)
                    if valid is not None:
                        ok &= F._shift3(valid.astype(jnp.float32),
                                        (dz, dy, dx), 0.0) > 0
                    is_min &= ok & (nb > center)
                    is_max &= ok & (nb < center)
    if valid is not None:
        is_min &= valid
        is_max &= valid
    return is_min, is_max


def log_filter_for_scale(x, sigma_xyz, delta, truncate_ratio, mask):
    return F.apply_log(x, sigma_xyz, mask=mask,
                       delta_sigma_over_sigma=delta,
                       truncate_ratio=truncate_ratio)


@jax.jit
def _candidate_counts(is_min, is_max, mid):
    """Candidate selection masks (extremum AND the sign test,
    ``feature.hpp:318-341``) plus their counts -- one 8-byte scalar
    sync per scale instead of three full-volume transfers."""
    sel_min = is_min & (mid < 0)
    sel_max = is_max & (mid > 0)
    return (sel_min, sel_max,
            jnp.stack([jnp.sum(sel_min, dtype=jnp.int32),
                       jnp.sum(sel_max, dtype=jnp.int32)]))


@functools.partial(jax.jit, static_argnames=("capacity",))
def _compact_candidates(sel_min, sel_max, mid, capacity):
    """Fixed-capacity on-device candidate extraction: (z, y, x) index
    triples in raster order (identical to the host ``np.argwhere``
    order the list-building used before) plus gathered scores.  Only
    ``capacity`` indices+scores cross PCIe, never the volume.
    Per-axis int32 indices never overflow (each dim < 2^31) even for
    volumes over 2^31 voxels; the host composes int64 flat indices."""
    out = []
    for sel in (sel_min, sel_max):
        z, y, x = jnp.nonzero(sel, size=capacity, fill_value=0)
        out.append(jnp.stack([z, y, x], axis=-1).astype(jnp.int32))
        out.append(mid[z, y, x])
    return tuple(out)


def _extract_scale_candidates(is_min, is_max, mid):
    """Host wrapper: returns ((zyx_min, sc_min), (zyx_max, sc_max)) as
    numpy, via device compaction.  Capacity is rounded up to a power
    of two so recompiles stay O(log n) across the sigma ladder."""
    sel_min, sel_max, counts = _candidate_counts(is_min, is_max, mid)
    n_min, n_max = (int(c) for c in np.asarray(counts))
    top = max(n_min, n_max)
    if top == 0:
        empty = (np.zeros((0, 3), np.int64), np.zeros(0, np.float32))
        return empty, empty
    cap = 1 << max(6, int(np.ceil(np.log2(top))))
    cap = min(cap, mid.size)
    im, sm, ix, sx = _compact_candidates(sel_min, sel_max, mid, cap)
    res = []
    for k, (zyx, sc) in ((n_min, (im, sm)), (n_max, (ix, sx))):
        res.append((np.asarray(zyx)[:k].astype(np.int64),
                    np.asarray(sc)[:k]))
    return res[0], res[1]


def blob_dog(
    x: jax.Array,
    sigmas: Sequence[float],
    mask: Optional[jax.Array] = None,
    aspect_ratio: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    delta_sigma_over_sigma: float = 0.02,
    truncate_ratio: float = 2.5,
    minima_threshold: float = np.inf,
    maxima_threshold: float = -np.inf,
    use_threshold_ratios: bool = True,
    report=None,
    log_fn=None,
    extremum_fn=None,
) -> Tuple[BlobList, BlobList]:
    """Returns (minima, maxima) BlobLists with per-blob sigma stored in
    ``diameters`` (callers converting to diameters use blob_dog_d).

    ``log_fn(x, sig_xyz, delta, truncate_ratio, mask)`` and
    ``extremum_fn(prev, mid, next_, mask)`` override the single-device
    LoG / 80-neighbor-test implementations -- the mesh-sharded ladder
    (``visfd_jax.parallel.sharded.sharded_blob_dog``) plugs in
    halo-exchange versions here so the list-building and threshold
    logic stays single-sourced."""
    x = jnp.asarray(x, jnp.float32)
    m = None if mask is None else jnp.asarray(mask, jnp.float32)
    sigmas = list(sigmas)
    if log_fn is None:
        log_fn = log_filter_for_scale
    if extremum_fn is None:
        extremum_fn = _extremum_masks

    min_crds, min_sig, min_sc = [], [], []
    max_crds, max_sig, max_sc = [], [], []

    ring = [None, None, None]
    for ir, s in enumerate(sigmas):
        if report:
            report.write(f"--- Progress: {ir+1}/{len(sigmas)}\n"
                         f"--- Applying DoG filter using sigma[{ir}] = {s}"
                         " (in voxels) ---\n")
        sig_xyz = tuple(s * a for a in aspect_ratio)
        ring[ir % 3] = log_fn(
            x, sig_xyz, delta_sigma_over_sigma, truncate_ratio, m)
        if ir < 2:
            continue
        prev, mid, next_ = ring[(ir - 2) % 3], ring[(ir - 1) % 3], ring[ir % 3]
        is_min, is_max = extremum_fn(prev, mid, next_, m)
        hit_min, hit_max = _extract_scale_candidates(is_min, is_max, mid)
        for (zyx, scores), crds, sigl, scl in (
            (hit_min, min_crds, min_sig, min_sc),
            (hit_max, max_crds, max_sig, max_sc),
        ):
            if len(zyx):
                crds.append(zyx[:, ::-1].astype(np.float64))  # (x, y, z)
                sigl.append(np.full(len(zyx), sigmas[ir - 1]))
                scl.append(scores)

    def pack(crds, sigl, scl):
        if not crds:
            return BlobList.empty()
        return BlobList(np.concatenate(crds), np.concatenate(sigl),
                        np.concatenate(scl))

    minima = pack(min_crds, min_sig, min_sc)
    maxima = pack(max_crds, max_sig, max_sc)

    # final threshold filter (feature.hpp:362-417)
    if np.isfinite(minima_threshold) or np.isfinite(maxima_threshold) \
       or use_threshold_ratios:
        mt, xt = minima_threshold, maxima_threshold
        if use_threshold_ratios:
            gmin = minima.scores.min() if len(minima) else 1.0
            gmax = maxima.scores.max() if len(maxima) else -1.0
            mt = minima_threshold * gmin
            xt = maxima_threshold * gmax
        if np.isfinite(mt) and len(minima):
            minima = minima.take(minima.scores <= mt)
        if np.isfinite(xt) and len(maxima):
            maxima = maxima.take(maxima.scores >= xt)
    return minima, maxima


def blob_dog_d(
    x: jax.Array,
    diameters: Sequence[float],
    mask: Optional[jax.Array] = None,
    mesh=None,
    **kw,
) -> Tuple[BlobList, BlobList]:
    """Diameter interface: sigma = d / (2*sqrt(3))
    (``feature.hpp:446-512``). Returned ``diameters`` columns are real
    diameters.  ``mesh``: run the ladder mesh-sharded with halo
    exchange (``parallel.sharded_features.sharded_blob_dog``) --
    bit-identical lists, handles volumes the mesh does not divide."""
    conv = 2.0 * np.sqrt(3.0)
    sigmas = [d / conv for d in diameters]
    if mesh is not None:
        from visfd_jax.parallel.sharded_features import sharded_blob_dog
        minima, maxima = sharded_blob_dog(x, sigmas, mesh, mask=mask,
                                          **kw)
    else:
        minima, maxima = blob_dog(x, sigmas, mask=mask, **kw)
    minima.diameters = minima.diameters * conv
    maxima.diameters = maxima.diameters * conv
    return minima, maxima


def sort_blobs(
    blobs: BlobList,
    criteria: str = SORT_DECREASING_MAGNITUDE,
    ascending_order: bool = True,
) -> BlobList:
    """Stable sort with the reference's tuple semantics
    (``feature.hpp:519-616``): key is score (or |score|), ties keep
    original order ascending / reversed order descending."""
    if criteria in (SORT_DECREASING_MAGNITUDE, SORT_INCREASING_MAGNITUDE):
        key = np.abs(blobs.scores)
    else:
        key = blobs.scores
    ascending = ascending_order
    if criteria in (SORT_INCREASING, SORT_INCREASING_MAGNITUDE):
        ascending = not ascending
    idx = np.arange(len(blobs))
    if ascending:
        perm = np.lexsort((idx, key))
    else:
        perm = np.lexsort((-idx, -key))
    return blobs.take(perm)


def calc_sphere_overlap(rij, ri, rj):
    """Lens volume of two intersecting spheres
    (``visfd_utils.hpp:93-119``)."""
    if ri > rj:
        ri, rj = rj, ri
    if rij <= ri:
        return (4 * np.pi / 3) * ri ** 3
    xi = 0.5 / rij * (rij * rij + ri * ri - rj * rj)
    xj = 0.5 / rij * (rij * rij + rj * rj - ri * ri)
    return (np.pi / 3) * (
        ri ** 3 * (2 - (xi / ri) * (3 - (xi / ri) ** 2))
        + rj ** 3 * (2 - (xj / rj) * (3 - (xj / rj) ** 2)))


def _sphere_overlap_vec(rij, ri, rj):
    """Vectorized ``calc_sphere_overlap`` (``visfd_utils.hpp:93-119``);
    same f64 expression as the scalar version."""
    lo = np.minimum(ri, rj)
    hi = np.maximum(ri, rj)
    full = (4 * np.pi / 3) * lo ** 3
    with np.errstate(divide="ignore", invalid="ignore"):
        xi = 0.5 / rij * (rij * rij + lo * lo - hi * hi)
        xj = 0.5 / rij * (rij * rij + hi * hi - lo * lo)
        lens = (np.pi / 3) * (
            lo ** 3 * (2 - (xi / lo) * (3 - (xi / lo) ** 2))
            + hi ** 3 * (2 - (xj / hi) * (3 - (xj / hi) ** 2)))
    return np.where(rij <= lo, full, lens)


@functools.lru_cache(maxsize=None)
def _sphere_cell_offsets(big_r: int) -> np.ndarray:
    """(M, 3) integer (jx, jy, jz) offsets with |j|^2 <= big_r^2, in
    the reference's z-outer raster order."""
    offs = []
    for jz in range(-big_r, big_r + 1):
        for jy in range(-big_r, big_r + 1):
            for jx in range(-big_r, big_r + 1):
                if jx * jx + jy * jy + jz * jz <= big_r * big_r:
                    offs.append((jx, jy, jz))
    return np.asarray(offs, np.int64)


def discard_overlapping_blobs(
    blobs: BlobList,
    min_radial_separation_ratio: float,
    max_volume_overlap_large: float = np.inf,
    max_volume_overlap_small: float = np.inf,
    criteria: str = SORT_DECREASING_MAGNITUDE,
    scale: int = 6,
) -> BlobList:
    """Greedy best-first NMS through a coarse occupancy grid,
    replicating ``DiscardOverlappingBlobs`` (``feature.hpp:720-913``)
    including its grid-limited collision detection.  The sequential
    scan runs in native C++ (``visfd_nms``) when available; the Python
    fallback vectorizes the per-blob collision test over all
    candidates in the covered cells (discard is an OR over colliding
    survivors, so batching the checks is exact)."""
    blobs = sort_blobs(blobs, criteria, ascending_order=False)
    n = len(blobs)
    if n == 0:
        return blobs

    # bounds are ints in the reference (truncation toward zero on
    # assignment, feature.hpp:765-777); keep that exactly so the grid
    # geometry matches
    reff_all = np.ceil(blobs.diameters / 2)
    lo_all = (blobs.crds - reff_all[:, None]).astype(np.int64)  # trunc
    hi_all = (blobs.crds + reff_all[:, None]).astype(np.int64)
    bounds_min = lo_all.min(axis=0)
    bounds_max = hi_all.max(axis=0)
    table_size = (1 + bounds_max - bounds_min) // scale

    radii = blobs.diameters / 2
    vols = (4 * np.pi / 3) * radii ** 3
    grid = np.floor((blobs.crds - bounds_min) / scale).astype(np.int64)

    from visfd_jax import native
    lib = native.load()
    if lib is not None:
        import ctypes
        crds_c = np.ascontiguousarray(blobs.crds, np.float64)
        radii_c = np.ascontiguousarray(radii, np.float64)
        vols_c = np.ascontiguousarray(vols, np.float64)
        grid_c = np.ascontiguousarray(grid, np.int64)
        tsz_c = np.ascontiguousarray(table_size, np.int64)
        keep_c = np.zeros(n, np.uint8)
        lib.visfd_nms(
            native.ptr(crds_c, ctypes.c_double),
            native.ptr(radii_c, ctypes.c_double),
            native.ptr(vols_c, ctypes.c_double),
            native.ptr(grid_c, ctypes.c_int64),
            native.ptr(tsz_c, ctypes.c_int64),
            n, int(scale),
            float(min_radial_separation_ratio),
            float(max_volume_overlap_small),
            float(max_volume_overlap_large),
            native.ptr(keep_c, ctypes.c_uint8))
        return blobs.take(np.flatnonzero(keep_c))

    occ = {}
    keep = []
    for i in range(n):
        big_r = int(np.ceil(radii[i] / scale)) + 1
        cells = _sphere_cell_offsets(big_r) + grid[i]
        inb = ((cells >= 0) & (cells < table_size)).all(axis=1)
        cells = cells[inb]
        cand = []
        cell_keys = list(map(tuple, cells))
        for c in cell_keys:
            cand.extend(occ.get(c, ()))
        discard = False
        if cand:
            k = np.unique(np.asarray(cand, np.int64))
            d = blobs.crds[i] - blobs.crds[k]
            rik = np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2 + d[:, 2] ** 2)
            rk = radii[k]
            ri = radii[i]
            if np.any(rik < (ri + rk) * min_radial_separation_ratio):
                discard = True
            else:
                vol = _sphere_overlap_vec(rik, ri, rk)
                v_small = np.minimum(vols[i], vols[k])
                v_large = np.maximum(vols[i], vols[k])
                if np.any((vol / v_small > max_volume_overlap_small)
                          | (vol / v_large > max_volume_overlap_large)):
                    discard = True
        if not discard:
            keep.append(i)
            for c in cell_keys:
                occ.setdefault(c, []).append(i)
    return blobs.take(np.asarray(keep, int))


def discard_masked_blobs(blobs: BlobList, mask: np.ndarray) -> BlobList:
    """Drop blobs whose (rounded) centers fall where mask == 0
    (``feature.hpp:924-969``)."""
    if mask is None or len(blobs) == 0:
        return blobs
    mask = np.asarray(mask)
    ix = np.floor(blobs.crds[:, 0] + 0.5).astype(int)
    iy = np.floor(blobs.crds[:, 1] + 0.5).astype(int)
    iz = np.floor(blobs.crds[:, 2] + 0.5).astype(int)
    keep = mask[iz, iy, ix] != 0
    return blobs.take(keep)


def blob_dog_nm(
    x,
    diameters: Sequence[float],
    mask=None,
    aspect_ratio=(1.0, 1.0, 1.0),
    delta_sigma_over_sigma: float = 0.02,
    truncate_ratio: float = 2.5,
    truncate_threshold: Optional[float] = None,
    minima_threshold: float = 0.5,
    maxima_threshold: float = 0.5,
    use_threshold_ratios: bool = True,
    sep_ratio_thresh: float = 1.0,
    nonmax_max_overlap_large: float = 1.0,
    nonmax_max_overlap_small: float = 1.0,
    report=None,
    mesh=None,
) -> Tuple[BlobList, BlobList]:
    """Blob detection + NMS composition
    (``feature_variants.hpp:394-580``). ``truncate_threshold`` (if
    given and truncate_ratio <= 0) converts a kernel-decay cutoff into
    a ratio: ratio = sqrt(-2 ln thresh)."""
    if truncate_ratio <= 0:
        assert truncate_threshold and truncate_threshold > 0
        truncate_ratio = float(np.sqrt(-2.0 * np.log(truncate_threshold)))
    minima, maxima = blob_dog_d(
        x, diameters, mask=mask, aspect_ratio=aspect_ratio,
        delta_sigma_over_sigma=delta_sigma_over_sigma,
        truncate_ratio=truncate_ratio,
        minima_threshold=minima_threshold,
        maxima_threshold=maxima_threshold,
        use_threshold_ratios=use_threshold_ratios,
        report=report, mesh=mesh)
    do_nms = (sep_ratio_thresh > 0.0 or nonmax_max_overlap_small < 1.0
              or nonmax_max_overlap_large < 1.0)
    if not do_nms:
        return minima, maxima
    minima = discard_overlapping_blobs(
        minima, sep_ratio_thresh, nonmax_max_overlap_large,
        nonmax_max_overlap_small, SORT_INCREASING)
    maxima = discard_overlapping_blobs(
        maxima, sep_ratio_thresh, nonmax_max_overlap_large,
        nonmax_max_overlap_small, SORT_DECREASING)
    return minima, maxima
