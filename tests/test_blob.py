"""Blob detection parity tests: the reference CI pipeline
(tests/test_blob_detection.sh) must yield exactly 2 blobs after NMS on
the checked-in fixture, plus synthetic sanity checks."""

import numpy as np
import pytest

import jax.numpy as jnp

from visfd_jax.io import read_mrc
from visfd_jax.features import blob as B


def diameter_ladder(d_min, d_max, growth_ratio):
    """-blob ladder construction (settings.cpp:1702-1750)."""
    n = 1 + int(np.ceil(np.log(d_max / d_min) / np.log(growth_ratio)))
    g = (d_max / d_min) ** (1.0 / n)
    out = [d_min]
    for _ in range(1, n):
        out.append(out[-1] * g)
    return out


def test_ladder_construction():
    lad = diameter_ladder(160.0, 280.0, 1.01)
    assert len(lad) == 1 + int(np.ceil(np.log(280 / 160) / np.log(1.01)))
    assert lad[0] == pytest.approx(160.0)
    # last element: d_min * g^(N-1) < d_max (g was shrunk to fit N steps)
    assert lad[-1] < 280.0


def test_blob_fixture_pipeline(reference_fixture_dir):
    """-blob minima 160 280 1.01 (w=19.6) then -discard-blobs
    -blob-separation 1.1 -minima-threshold -90 => exactly 2 blobs."""
    img = read_mrc(reference_fixture_dir / "test_blob_detect.rec")
    mask = read_mrc(reference_fixture_dir / "test_blob_detect_mask.rec")
    w = 19.6
    diam_vox = [d / w for d in diameter_ladder(160.0, 280.0, 1.01)]

    minima, maxima = B.blob_dog_nm(
        jnp.asarray(img.data), diam_vox,
        mask=jnp.asarray(mask.data),
        truncate_ratio=-1.0, truncate_threshold=0.03,
        minima_threshold=0.0,      # score_upper_bound after "-blob minima"
        maxima_threshold=-np.inf,  # score_lower_bound default
        use_threshold_ratios=False,
        sep_ratio_thresh=0.0,      # no NMS inside -blob run
        nonmax_max_overlap_large=np.inf,
        nonmax_max_overlap_small=np.inf)
    assert len(minima) > 2  # raw candidate list is larger

    # -discard-blobs stage: score <= -90, mask, NMS sep ratio 1.1
    kept = minima.take(minima.scores <= -90.0)
    kept = B.discard_masked_blobs(kept, mask.data)
    kept = B.discard_overlapping_blobs(
        kept, 1.1, np.inf, np.inf, B.SORT_DECREASING_MAGNITUDE)
    assert len(kept) == 2


def test_blob_synthetic_bright_spheres(rng):
    """Three bright Gaussian blobs of diameter ~8 in a 32^3 volume: the
    detector must find 3 maxima at the right places and scales."""
    n = 40
    centers = [(10, 10, 10), (10, 28, 28), (30, 18, 12)]
    z, y, x = np.meshgrid(*([np.arange(n, dtype=np.float64)] * 3),
                          indexing="ij")
    img = np.zeros((n, n, n))
    sigma_true = 8.0 / (2 * np.sqrt(3))
    for cz, cy, cx in centers:
        img += np.exp(-0.5 * ((z - cz) ** 2 + (y - cy) ** 2
                              + (x - cx) ** 2) / sigma_true ** 2)
    img = img.astype(np.float32)
    diams = diameter_ladder(4.0, 16.0, 1.05)
    minima, maxima = B.blob_dog_nm(
        jnp.asarray(img), diams,
        minima_threshold=0.5, maxima_threshold=0.5,
        use_threshold_ratios=True,
        sep_ratio_thresh=1.0)
    assert len(maxima) == 3
    found = {tuple(int(v) for v in c) for c in maxima.crds}
    want = {(cx, cy, cz) for cz, cy, cx in centers}
    assert found == want
    # detected diameters should be near 8
    assert np.all(np.abs(maxima.diameters - 8.0) < 3.0)


def test_sort_blobs_orderings():
    blobs = B.BlobList(
        crds=np.arange(12, dtype=float).reshape(4, 3),
        diameters=np.ones(4),
        scores=np.array([-5.0, 2.0, -1.0, 4.0]))
    inc = B.sort_blobs(blobs, B.SORT_INCREASING, ascending_order=False)
    np.testing.assert_array_equal(inc.scores, [-5, -1, 2, 4])
    dec_mag = B.sort_blobs(blobs, B.SORT_DECREASING_MAGNITUDE,
                           ascending_order=False)
    np.testing.assert_array_equal(dec_mag.scores, [-5, 4, 2, -1])


def test_sphere_overlap_analytic():
    # identical spheres at distance 0: overlap = full volume
    v = B.calc_sphere_overlap(0.0, 2.0, 2.0)
    assert v == pytest.approx(4 * np.pi / 3 * 8)
    # exactly touching: zero overlap
    assert B.calc_sphere_overlap(4.0, 2.0, 2.0) == pytest.approx(0.0, abs=1e-9)
    # NOTE: for separated spheres (rij > Ri+Rj) the reference formula
    # (visfd_utils.hpp:93-119) returns a spurious positive value (it
    # never clamps); we replicate that exactly for NMS parity.
    assert B.calc_sphere_overlap(5.0, 2.0, 2.0) > 0.0
    # small sphere inside large
    v2 = B.calc_sphere_overlap(0.5, 1.0, 3.0)
    assert v2 == pytest.approx(4 * np.pi / 3, rel=1e-6)


def test_nms_removes_overlaps(rng):
    crds = np.array([[10.0, 10, 10], [11, 10, 10], [30, 30, 30]])
    blobs = B.BlobList(crds=crds, diameters=np.array([6.0, 6.0, 6.0]),
                       scores=np.array([5.0, 4.0, 3.0]))
    kept = B.discard_overlapping_blobs(blobs, 1.0)
    assert len(kept) == 2
    assert 5.0 in kept.scores and 3.0 in kept.scores
