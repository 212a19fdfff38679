"""Plateau extrema + morphology tests vs brute-force references."""

import numpy as np
import pytest

import jax.numpy as jnp

from visfd_jax.segment.extrema import find_extrema, flat_to_xyz, neighbor_offsets
from visfd_jax.ops import morphology as M


def brute_extrema(x, connectivity=3, mask=None, allow_borders=True):
    """Slow reference: plateau BFS like _FindExtrema."""
    offs = neighbor_offsets(connectivity)
    nz, ny, nx = x.shape
    valid = np.ones(x.shape, bool) if mask is None else (mask != 0)
    seen = np.zeros(x.shape, bool)
    minima, maxima = [], []
    for iz0 in range(nz):
        for iy0 in range(ny):
            for ix0 in range(nx):
                if not valid[iz0, iy0, ix0] or seen[iz0, iy0, ix0]:
                    continue
                # BFS plateau
                q = [(iz0, iy0, ix0)]
                seen[iz0, iy0, ix0] = True
                plateau = []
                is_min = is_max = True
                v0 = x[iz0, iy0, ix0]
                while q:
                    p = q.pop(0)
                    plateau.append(p)
                    for dz, dy, dx in offs:
                        z, y, xx = p[0] + dz, p[1] + dy, p[2] + dx
                        if not (0 <= z < nz and 0 <= y < ny and 0 <= xx < nx) \
                           or not valid[z, y, xx]:
                            if not allow_borders:
                                is_min = is_max = False
                            continue
                        if x[z, y, xx] == v0:
                            if not seen[z, y, xx]:
                                seen[z, y, xx] = True
                                q.append((z, y, xx))
                        elif x[z, y, xx] < v0:
                            is_min = False
                        else:
                            is_max = False
                idx = ix0 + nx * (iy0 + ny * iz0)
                if is_min:
                    minima.append((idx, v0, len(plateau)))
                if is_max:
                    maxima.append((idx, v0, len(plateau)))
    minima.sort(key=lambda t: t[1])
    maxima.sort(key=lambda t: -t[1])
    return minima, maxima


@pytest.mark.parametrize("connectivity", [1, 3])
def test_extrema_random_matches_brute(rng, connectivity):
    x = rng.integers(0, 8, size=(7, 8, 9)).astype(np.float32)  # many plateaus
    res = find_extrema(x, connectivity=connectivity)
    bmin, bmax = brute_extrema(x, connectivity)
    assert len(res.minima_indices) == len(bmin)
    assert len(res.maxima_indices) == len(bmax)
    np.testing.assert_array_equal(sorted(res.minima_indices),
                                  sorted(t[0] for t in bmin))
    np.testing.assert_array_equal(sorted(res.maxima_indices),
                                  sorted(t[0] for t in bmax))
    np.testing.assert_array_equal(res.minima_scores,
                                  [t[1] for t in bmin])
    np.testing.assert_array_equal(res.maxima_scores,
                                  [t[1] for t in bmax])


def test_extrema_flat_topped_spheres():
    """The reference's watershed test scenario: flat-topped blobs must
    each count once (plateau = one maximum)."""
    x = np.zeros((16, 16, 16), np.float32)
    for cz, cy, cx in [(4, 4, 4), (11, 11, 11)]:
        z, y, xx = np.ogrid[:16, :16, :16]
        r2 = (z - cz) ** 2 + (y - cy) ** 2 + (xx - cx) ** 2
        x += np.where(r2 <= 4, 10.0, np.where(r2 <= 9, 5.0, 0.0))
    res = find_extrema(x, find_minima=False)
    assert len(res.maxima_indices) == 2
    assert (res.maxima_nvoxels > 1).all()  # plateaus, not points
    # label image: maxima plateaus labeled 1, 2; elsewhere 0
    assert res.label_image.max() == 2


def test_extrema_masked_and_thresholds(rng):
    x = rng.normal(size=(6, 6, 6)).astype(np.float32)
    mask = np.ones_like(x)
    mask[:, :3, :] = 0
    res = find_extrema(x, mask=mask)
    for idx in res.maxima_indices:
        ix, iy, iz = flat_to_xyz(idx, x.shape)
        assert mask[iz, iy, ix] != 0
    thr = float(np.median(x))
    res2 = find_extrema(x, maxima_threshold=thr)
    assert (res2.maxima_scores >= thr).all()
    res3 = find_extrema(x)
    assert len(res3.maxima_scores) >= len(res2.maxima_scores)


def test_extrema_sorted_order(rng):
    x = rng.normal(size=(9, 9, 9)).astype(np.float32)
    res = find_extrema(x)
    assert (np.diff(res.minima_scores) >= 0).all()
    assert (np.diff(res.maxima_scores) <= 0).all()


def brute_dilate(x, offs, bs, mask=None):
    nz, ny, nx = x.shape
    out = np.full(x.shape, -np.inf, np.float32)
    valid = np.ones(x.shape, bool) if mask is None else (mask != 0)
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                if not valid[iz, iy, ix]:
                    out[iz, iy, ix] = x[iz, iy, ix]
                    continue
                best = -np.inf
                for (dz, dy, dx), b in zip(offs, bs):
                    z, y, xx = iz + dz, iy + dy, ix + dx
                    if 0 <= z < nz and 0 <= y < ny and 0 <= xx < nx \
                       and valid[z, y, xx]:
                        best = max(best, x[z, y, xx] + b)
                out[iz, iy, ix] = best
    return out


def test_dilate_erode_match_brute(rng):
    x = rng.normal(size=(6, 7, 8)).astype(np.float32)
    offs, bs = M.sphere_structure_element(1.5)
    got = np.asarray(M.dilate_sphere(jnp.asarray(x), 1.5))
    want = brute_dilate(x, offs, bs)
    np.testing.assert_allclose(got, want)
    # erosion duality: erode(x) == -dilate(-x) for symmetric flat SE
    er = np.asarray(M.erode_sphere(jnp.asarray(x), 1.5))
    di = np.asarray(M.dilate_sphere(jnp.asarray(-x), 1.5))
    np.testing.assert_allclose(er, -di)


def test_morphology_with_mask(rng):
    x = rng.normal(size=(5, 6, 7)).astype(np.float32)
    mask = (rng.uniform(size=x.shape) > 0.4).astype(np.float32)
    offs, bs = M.sphere_structure_element(1.0)
    got = np.asarray(M.dilate_sphere(jnp.asarray(x), 1.0,
                                     mask=jnp.asarray(mask)))
    want = brute_dilate(x, offs, bs, mask)
    np.testing.assert_allclose(got, want)


def test_open_close_tophat_properties(rng):
    x = rng.normal(size=(8, 8, 8)).astype(np.float32)
    xo = np.asarray(M.open_sphere(jnp.asarray(x), 1.0))
    xc = np.asarray(M.close_sphere(jnp.asarray(x), 1.0))
    assert (xo <= x + 1e-5).all()   # opening is anti-extensive
    assert (xc >= x - 1e-5).all()   # closing is extensive
    wth = np.asarray(M.white_top_hat_sphere(jnp.asarray(x), 1.0))
    bth = np.asarray(M.black_top_hat_sphere(jnp.asarray(x), 1.0))
    np.testing.assert_allclose(wth, x - xo, atol=1e-6)
    np.testing.assert_allclose(bth, xc - x, atol=1e-6)


def test_soft_sphere_structure_element():
    offs, bs = M.sphere_structure_element(2.0, radius_max=3.0, bmax=1.0)
    r = np.linalg.norm(offs, axis=1)
    assert (bs[r <= 2.0] == 0).all()
    shell = (r > 2.0) & (r <= 3.0)
    assert (bs[shell] < 0).all() and (bs[shell] >= -1.0).all()
    # anti-aliased variant (bmax != 0, radius_max <= radius)
    offs2, bs2 = M.sphere_structure_element(2.0, bmax=1.0)
    assert (bs2 <= 0).all() and (bs2 >= -1.0).all()
    assert len(offs2) > 0


@pytest.mark.parametrize("connectivity", [1, 3])
def test_extrema_hybrid_plateau_path_matches_full(rng, connectivity):
    """Round-5 fast path: a float field with a FEW injected plateaus
    must take the compaction + host-union-find branch (n_same small)
    and agree exactly with the full-volume label-propagation path and
    the brute BFS."""
    from visfd_jax.segment import extrema as E
    x = rng.normal(size=(16, 16, 16)).astype(np.float32)
    # inject small plateaus: an L-shaped triple (local max), a pair,
    # and a flat pair that is NOT an extremum
    x[2, 3, 4] = x[2, 3, 5] = x[2, 4, 4] = 50.0
    x[7, 7, 7] = x[7, 7, 8] = -50.0
    x[5, 2, 2] = x[5, 2, 3] = 0.25
    x[5, 2, 1] = 60.0  # a higher neighbor kills that plateau

    offs = E.neighbor_offsets(connectivity)
    _, _, _, _, cnts = E._extrema_flags(jnp.asarray(x), None, offs)
    n_same = int(np.asarray(cnts).sum())
    assert 0 < n_same * len(offs) <= x.size // 8  # hybrid branch taken

    res = find_extrema(x, connectivity=connectivity)
    # full-volume reference path
    labels, hl, hg, bd = E._extrema_device(jnp.asarray(x), None, offs)
    ref = E.postprocess_extrema(np.asarray(labels), np.asarray(hl),
                                np.asarray(hg), np.asarray(bd), x)
    np.testing.assert_array_equal(res.minima_indices, ref.minima_indices)
    np.testing.assert_array_equal(res.maxima_indices, ref.maxima_indices)
    np.testing.assert_array_equal(res.minima_scores, ref.minima_scores)
    np.testing.assert_array_equal(res.maxima_scores, ref.maxima_scores)
    np.testing.assert_array_equal(res.minima_nvoxels, ref.minima_nvoxels)
    np.testing.assert_array_equal(res.maxima_nvoxels, ref.maxima_nvoxels)
    np.testing.assert_array_equal(res.label_image, ref.label_image)

    bmin, bmax = brute_extrema(x, connectivity)
    assert len(res.maxima_indices) == len(bmax)
    assert len(res.minima_indices) == len(bmin)
    # the injected plateau maxima/minima appear with their sizes
    sizes = dict(zip(res.maxima_indices, res.maxima_nvoxels))
    nz, ny, nx = x.shape
    l_idx = 4 + nx * (3 + ny * 2)
    assert sizes[l_idx] == 3


def test_extrema_thresholded_zero_plateau_fast_path(rng):
    """Regression (round 5): a -tv-best-thresholded saliency field is
    ~95% EXACT ZEROS -- one volume-sized plateau that forced the
    full-volume label propagation (and crashed the device worker at
    384^3).  With a maxima threshold above zero the zero plateau is
    irrelevant (no member can pass), so the fast path must engage and
    agree with the full-volume path."""
    from visfd_jax.segment import extrema as E
    x = np.abs(rng.normal(size=(12, 12, 12))).astype(np.float32)
    thr = float(np.quantile(x, 0.9))
    x[x < thr] = 0.0   # 90% exact zeros
    offs = E.neighbor_offsets(1)
    _, _, _, hs, _ = E._extrema_flags(jnp.asarray(x), None, offs)
    assert int(np.asarray(jnp.sum(hs))) > x.size // 2  # giant plateau
    res = E.find_extrema(x, find_minima=False, find_maxima=True,
                         maxima_threshold=thr, connectivity=1)
    labels, hl, hg, bd = E._extrema_device(jnp.asarray(x), None, offs)
    ref = E.postprocess_extrema(np.asarray(labels), np.asarray(hl),
                                np.asarray(hg), np.asarray(bd), x,
                                find_minima=False, find_maxima=True,
                                maxima_threshold=thr)
    np.testing.assert_array_equal(res.maxima_indices, ref.maxima_indices)
    np.testing.assert_array_equal(res.maxima_scores, ref.maxima_scores)
    np.testing.assert_array_equal(res.maxima_nvoxels, ref.maxima_nvoxels)
    np.testing.assert_array_equal(res.label_image, ref.label_image)
