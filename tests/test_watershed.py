"""Watershed tests mirroring the reference's behavioral invariants
(tests/test_watershed.sh) plus marker/threshold paths."""

import numpy as np

import jax.numpy as jnp

from visfd_jax.ops.filters import apply_gauss
from visfd_jax.segment.extrema import find_extrema
from visfd_jax.segment.watershed import watershed


def blurred_noise(rng, n=14, sigma=2.0):
    x = rng.normal(size=(n, n, n)).astype(np.float32)
    return np.asarray(apply_gauss(jnp.asarray(x), sigma))


def test_basins_equal_minima(rng):
    x = blurred_noise(rng)
    res = find_extrema(x, find_maxima=False, connectivity=1)
    ws = watershed(x, start_from_minima=True, connectivity=1)
    assert ws.num_basins == len(res.minima_indices)
    # all in-image voxels are basin or boundary; max label == #basins
    assert ws.labels.max() == ws.num_basins
    assert ws.labels.min() >= 0  # no undefined without threshold/mask


def test_inversion_symmetry(rng):
    """-invert then -watershed maxima must give the same basin count
    (tests/test_watershed.sh)."""
    x = blurred_noise(rng)
    ws_min = watershed(x, start_from_minima=True)
    ave = x.mean(dtype=np.float64)
    inv = (2.0 * ave - x).astype(np.float32)
    ws_max = watershed(inv, start_from_minima=False)
    assert ws_min.num_basins == ws_max.num_basins
    # identical partition (label ids may match since seeds sort equally)
    np.testing.assert_array_equal(ws_min.labels, ws_max.labels)


def test_watershed_every_basin_appears(rng):
    x = blurred_noise(rng)
    ws = watershed(x)
    labs = np.unique(ws.labels)
    labs = labs[labs > 0]
    assert len(labs) == ws.num_basins


def test_halt_threshold(rng):
    x = blurred_noise(rng)
    thr = float(np.percentile(x, 40))
    ws = watershed(x, halt_threshold=thr, label_undefined=-7)
    assert (x[ws.labels == -7] > thr).all()
    # all basin-labeled voxels are below threshold
    assert (x[ws.labels > 0] <= thr).all()


def test_markers(rng):
    # place markers in two separated wells so each genuinely seeds a
    # basin (markers off-minima can legitimately drown, as in the
    # reference's flood)
    n = 12
    z, y, x = np.meshgrid(*([np.arange(n, dtype=np.float32)] * 3),
                          indexing="ij")
    img = np.minimum((z - 2) ** 2 + (y - 2) ** 2 + (x - 2) ** 2,
                     (z - 9) ** 2 + (y - 9) ** 2 + (x - 9) ** 2).astype(
                         np.float32)
    markers = np.zeros_like(img, dtype=np.int64)
    markers[2, 2, 2] = 5
    markers[9, 9, 9] = 9
    ws = watershed(img, markers=markers, show_boundaries=False)
    assert ws.num_basins == 2
    labs = set(np.unique(ws.labels))
    assert labs == {5, 9}
    assert ws.labels[2, 2, 2] == 5
    assert ws.labels[9, 9, 9] == 9


def test_mask_voxels_untouched(rng):
    x = blurred_noise(rng, n=10)
    mask = np.ones_like(x)
    mask[:, :4, :] = 0
    ws = watershed(x, mask=mask)
    assert (ws.labels[mask == 0] == -1).all()
    assert (ws.labels[mask != 0] >= 0).all()
