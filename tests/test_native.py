"""Native C++ runtime vs pure-Python fallback parity.

The flood algorithms in ``visfd_jax/native/visfd_native.cpp`` must be
bit-identical to the Python implementations in
``visfd_jax.segment.{watershed,connect}`` (same heap ordering, same
tie-breaks, same label states).
"""

import contextlib
import os

import numpy as np
import pytest

from visfd_jax import native


@contextlib.contextmanager
def forced_native(enabled: bool):
    old = os.environ.get("VISFD_NATIVE")
    os.environ["VISFD_NATIVE"] = "1" if enabled else "0"
    native._tried = False
    native._lib = None
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("VISFD_NATIVE", None)
        else:
            os.environ["VISFD_NATIVE"] = old
        native._tried = False
        native._lib = None


def test_native_library_loads():
    with forced_native(True):
        assert native.load() is not None, "native runtime failed to build"


@pytest.mark.parametrize("connectivity", [1, 3])
@pytest.mark.parametrize("minima", [True, False])
def test_watershed_parity(connectivity, minima):
    from visfd_jax.segment import watershed as W
    rng = np.random.default_rng(7)
    x = rng.normal(size=(14, 15, 16)).astype(np.float32)
    mask = rng.random((14, 15, 16)) > 0.15
    kw = dict(mask=mask, start_from_minima=minima,
              connectivity=connectivity, show_boundaries=True)
    with forced_native(True):
        r_nat = W.watershed(x, **kw)
    with forced_native(False):
        r_py = W.watershed(x, **kw)
    assert r_nat.num_basins == r_py.num_basins
    np.testing.assert_array_equal(r_nat.labels, r_py.labels)


def test_watershed_parity_halt_and_plateaus():
    from visfd_jax.segment import watershed as W
    rng = np.random.default_rng(3)
    # quantized values create plateaus and heap ties
    x = np.round(rng.normal(size=(12, 12, 12)) * 3).astype(np.float32)
    with forced_native(True):
        r_nat = W.watershed(x, halt_threshold=1.0)
    with forced_native(False):
        r_py = W.watershed(x, halt_threshold=1.0)
    np.testing.assert_array_equal(r_nat.labels, r_py.labels)


def _connect_inputs(seed=11, shape=(12, 13, 14)):
    rng = np.random.default_rng(seed)
    sal = rng.random(shape).astype(np.float32)
    # smooth it a little so there are fewer, larger basins
    for ax in range(3):
        sal = (sal + np.roll(sal, 1, ax) + np.roll(sal, -1, ax)) / 3.0
    vec = rng.normal(size=shape + (3,)).astype(np.float32)
    tens = rng.normal(size=shape + (6,)).astype(np.float32)
    mask = rng.random(shape) > 0.1
    return sal.astype(np.float32), vec, tens, mask


@pytest.mark.parametrize("with_tensor", [False, True])
def test_connect_parity(with_tensor):
    from visfd_jax.segment import connect as C
    sal, vec, tens, mask = _connect_inputs()
    kw = dict(
        mask=mask,
        threshold_saliency=0.3,
        vector=vec,
        threshold_vector_saliency=-0.5,
        threshold_vector_neighbor=0.2,
        consider_dot_product_sign=False,
        tensor=tens if with_tensor else None,
        threshold_tensor_saliency=-0.5 if with_tensor else -np.inf,
        threshold_tensor_neighbor=-0.2 if with_tensor else -np.inf,
        connectivity=3,
        standardize_vector_sign=True,
        sort_criteria=C.SORT_BY_SIZE,
    )
    with forced_native(True):
        r_nat = C.label_connected(sal, **kw)
    with forced_native(False):
        r_py = C.label_connected(sal, **kw)
    assert r_nat.num_clusters == r_py.num_clusters
    np.testing.assert_array_equal(r_nat.labels, r_py.labels)
    np.testing.assert_array_equal(r_nat.cluster_sizes, r_py.cluster_sizes)
    if r_nat.vector_standardized is not None:
        np.testing.assert_array_equal(r_nat.vector_standardized,
                                      r_py.vector_standardized)


def _assert_connect_equal(r_a, r_b, vec_at_labeled_only=False):
    assert r_a.num_clusters == r_b.num_clusters
    np.testing.assert_array_equal(r_a.labels, r_b.labels)
    np.testing.assert_array_equal(r_a.cluster_sizes, r_b.cluster_sizes)
    np.testing.assert_array_equal(r_a.cluster_maxima, r_b.cluster_maxima)
    np.testing.assert_array_equal(r_a.cluster_saliencies,
                                  r_b.cluster_saliencies)
    if r_a.vector_standardized is not None:
        va, vb = r_a.vector_standardized, r_b.vector_standardized
        if vec_at_labeled_only:
            # the compact flood skips sign flips at voxels that are
            # never assigned (values no consumer reads)
            sel = (r_a.labels >= 1) & (r_a.labels <= r_a.num_clusters)
            va, vb = va[sel], vb[sel]
        np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("with_tensor", [False, True])
def test_connect_compact_parity(use_native, with_tensor):
    """compact=True (device candidate compaction + compact flood) vs
    the dense path: identical labels/clusters/polarity; standardized
    vectors identical at every assigned voxel."""
    from visfd_jax.segment import connect as C
    sal, vec, tens, mask = _connect_inputs(seed=31)
    kw = dict(
        mask=mask,
        threshold_saliency=0.3,
        vector=vec,
        threshold_vector_saliency=-0.5,
        threshold_vector_neighbor=0.2,
        consider_dot_product_sign=False,
        tensor=tens if with_tensor else None,
        threshold_tensor_saliency=-0.5 if with_tensor else -np.inf,
        threshold_tensor_neighbor=-0.2 if with_tensor else -np.inf,
        connectivity=3,
        standardize_vector_sign=True,
        sort_criteria=C.SORT_BY_SIZE,
    )
    with forced_native(use_native):
        r_dense = C.label_connected(sal, compact=False, **kw)
        r_comp = C.label_connected(sal, compact=True, **kw)
    _assert_connect_equal(r_dense, r_comp, vec_at_labeled_only=True)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("compact", [False, True])
def test_connect_tensor_without_vector(use_native, compact):
    """tensor= given but vector=None used to segfault the compact
    native flood (NULL vector deref) and crash the fallbacks; now the
    vector gate is simply skipped, identically on every path."""
    from visfd_jax.segment import connect as C
    sal, _vec, tens, mask = _connect_inputs(seed=47)
    kw = dict(
        mask=mask,
        threshold_saliency=0.3,
        tensor=tens,
        threshold_tensor_saliency=-0.5,
        threshold_tensor_neighbor=-0.2,
        connectivity=3,
    )
    with forced_native(use_native):
        r = C.label_connected(sal, compact=compact, **kw)
    assert r.num_clusters >= 1
    assert r.labels.shape == sal.shape
    # parity across all four (native x compact) paths
    with forced_native(False):
        r_ref = C.label_connected(sal, compact=False, **kw)
    np.testing.assert_array_equal(r.labels, r_ref.labels)
    assert r.num_clusters == r_ref.num_clusters


def test_connect_compact_parity_must_link():
    from visfd_jax.segment import connect as C
    sal, vec, tens, mask = _connect_inputs(seed=23)
    kw = dict(
        threshold_saliency=0.35,
        vector=vec,
        threshold_vector_neighbor=0.1,
        consider_dot_product_sign=False,
        standardize_vector_sign=True,
        connectivity=1,
        must_link=[[(2.0, 2.0, 2.0), (10.0, 10.0, 10.0)]],
    )
    with forced_native(True):
        r_dense = C.label_connected(sal, compact=False, **kw)
        r_comp = C.label_connected(sal, compact=True, **kw)
    _assert_connect_equal(r_dense, r_comp, vec_at_labeled_only=True)


def test_connect_compact_no_candidates():
    from visfd_jax.segment import connect as C
    sal = np.full((6, 6, 6), 0.5, np.float32)
    r = C.label_connected(sal, threshold_saliency=2.0, compact=True)
    assert r.num_clusters == 0
    assert (r.labels == -1).all() or (r.labels > 0).sum() == 0


def _random_blobs(n, seed=0, extent=200.0):
    from visfd_jax.features.blob import BlobList
    rng = np.random.default_rng(seed)
    crds = rng.random((n, 3)) * extent
    diam = rng.random(n) * 10.0 + 2.0
    scores = rng.normal(size=n)
    return BlobList(crds, diam, scores)


@pytest.mark.parametrize("kw", [
    dict(min_radial_separation_ratio=1.0),
    dict(min_radial_separation_ratio=0.5,
         max_volume_overlap_small=0.3, max_volume_overlap_large=0.05),
    dict(min_radial_separation_ratio=0.0,
         max_volume_overlap_small=0.1),
])
def test_nms_parity(kw):
    from visfd_jax.features import blob as B
    blobs = _random_blobs(600, seed=4)
    with forced_native(True):
        r_nat = B.discard_overlapping_blobs(blobs, **kw)
    with forced_native(False):
        r_py = B.discard_overlapping_blobs(blobs, **kw)
    assert len(r_nat) == len(r_py)
    np.testing.assert_array_equal(r_nat.crds, r_py.crds)
    np.testing.assert_array_equal(r_nat.scores, r_py.scores)
    np.testing.assert_array_equal(r_nat.diameters, r_py.diameters)


def test_nms_native_100k_under_1s():
    import time
    from visfd_jax.features import blob as B
    blobs = _random_blobs(100_000, seed=9, extent=1000.0)
    with forced_native(True):
        assert native.load() is not None
        # calling-thread CPU time: wall time flakes under suite load,
        # and process_time counts XLA's spinning pool threads
        t0 = time.thread_time()
        kept = B.discard_overlapping_blobs(
            blobs, min_radial_separation_ratio=1.0)
        dt = time.thread_time() - t0
    assert len(kept) > 0
    # generous bound: the python fallback takes minutes at this size,
    # so 3 s still proves the native path ran while tolerating slow /
    # busy CI machines (measured ~0.45 s idle, 1.16 s under load)
    assert dt < 3.0, f"native NMS took {dt:.2f}s CPU for 1e5 blobs"


def test_connect_parity_must_link():
    from visfd_jax.segment import connect as C
    sal, vec, tens, mask = _connect_inputs(seed=23)
    groups = [[(2.0, 2.0, 2.0), (10.0, 10.0, 10.0)]]
    kw = dict(
        threshold_saliency=0.35,
        vector=vec,
        threshold_vector_neighbor=0.1,
        consider_dot_product_sign=False,
        standardize_vector_sign=True,
        connectivity=1,
        must_link=groups,
    )
    with forced_native(True):
        r_nat = C.label_connected(sal, **kw)
    with forced_native(False):
        r_py = C.label_connected(sal, **kw)
    assert r_nat.num_clusters == r_py.num_clusters
    np.testing.assert_array_equal(r_nat.labels, r_py.labels)
