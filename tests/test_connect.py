"""LabelConnected tests: reference behavioral invariants
(tests/test_watershed.sh + test_membrane_detection.sh analogues)."""

import numpy as np
import pytest

import jax.numpy as jnp

from visfd_jax.ops.filters import apply_gauss
from visfd_jax.segment import connect as C
from visfd_jax.segment.connect import (
    label_connected, trace_product_sym3_quirk, SORT_BY_SIZE)
from visfd_jax.features import hessian as FH
from visfd_jax.features import tv as TV
from visfd_jax.linalg import sym3


def test_two_uniform_spheres_two_clusters():
    """Uniform-brightness two-sphere image -> 2 clusters
    (tests/test_watershed.sh connected-components case)."""
    n = 20
    z, y, x = np.ogrid[:n, :n, :n]
    img = np.zeros((n, n, n), np.float32)
    img[((z - 5) ** 2 + (y - 5) ** 2 + (x - 5) ** 2) <= 9] = 1.0
    img[((z - 14) ** 2 + (y - 14) ** 2 + (x - 14) ** 2) <= 9] = 1.0
    res = label_connected(img, threshold_saliency=0.5)
    assert res.num_clusters == 2
    # clusters sorted by size, labels 1..N, background undefined
    labs = set(np.unique(res.labels))
    assert 1 in labs and 2 in labs
    assert (res.labels[img == 0] != 1).all()


def test_connect_counts_vs_watershed(rng):
    """-connect with huge threshold merges everything reachable:
    cluster count <= basin count; every voxel above threshold gets a
    cluster."""
    x = rng.normal(size=(12, 12, 12)).astype(np.float32)
    x = np.asarray(apply_gauss(jnp.asarray(x), 2.0))
    thr = float(np.percentile(x, 30))
    res = label_connected(x, threshold_saliency=thr)
    assert res.num_clusters >= 1
    sel = x >= thr
    assert (res.labels[sel] >= 1).all()
    assert (res.labels[~sel] == -1).all()  # label_undefined


def test_cluster_sizes_sorted_desc(rng):
    n = 16
    z, y, x = np.ogrid[:n, :n, :n]
    img = np.zeros((n, n, n), np.float32)
    img[((z - 4) ** 2 + (y - 4) ** 2 + (x - 4) ** 2) <= 16] = 1.0   # big
    img[((z - 12) ** 2 + (y - 12) ** 2 + (x - 12) ** 2) <= 4] = 1.0  # small
    res = label_connected(img, threshold_saliency=0.5)
    assert res.num_clusters == 2
    assert res.cluster_sizes[0] > res.cluster_sizes[1]
    assert (np.sum(res.labels == 1) == res.cluster_sizes[0])


def test_must_link_merges_separate_islands():
    n = 18
    z, y, x = np.ogrid[:n, :n, :n]
    img = np.zeros((n, n, n), np.float32)
    img[((z - 4) ** 2 + (y - 4) ** 2 + (x - 4) ** 2) <= 6] = 1.0
    img[((z - 13) ** 2 + (y - 13) ** 2 + (x - 13) ** 2) <= 6] = 1.0
    res0 = label_connected(img, threshold_saliency=0.5)
    assert res0.num_clusters == 2
    res1 = label_connected(
        img, threshold_saliency=0.5,
        must_link=[[(4, 4, 4), (13, 13, 13)]])
    assert res1.num_clusters == 1


def test_membrane_connect_with_tv_tensor():
    """Full membrane mini-pipeline: slab -> hessian saliency +
    directions -> tensor voting -> connect with tensor gates ->
    one cluster covering the slab (>= 50 voxels, mirroring the
    membrane CI assertion)."""
    n = 16
    img = np.zeros((n, n, n), np.float32)
    img[:, :, 7:9] = 1.0
    grad, hess = FH.calc_hessian(jnp.asarray(img), sigma=1.5)
    diag = FH.diagonalize_hessian_image(hess)
    eivals, evects = sym3.diagonalize_sym3(
        sym3.flat_to_full(hess), order=sym3.EigenOrder.DECREASING_ABS)
    saliency = np.asarray(FH.score_hessian_planar(eivals)).astype(np.float32)
    v1 = np.asarray(evects)[..., 0, :]
    # keep top 20% salient voxels
    thr = np.percentile(saliency, 80)
    sal = np.where(saliency > thr, saliency, 0.0).astype(np.float32)
    tens = np.asarray(TV.tv_dense_stick(
        jnp.asarray(sal), jnp.asarray(v1), 2.0, exponent=4))
    stick_diag = np.asarray(sym3.diagonalize_flat_sym3(
        jnp.asarray(tens), order=sym3.EigenOrder.DECREASING))
    stick = stick_diag[..., 0] - stick_diag[..., 1]
    res = label_connected(
        stick.astype(np.float32),
        threshold_saliency=float(np.percentile(stick, 90)),
        vector=v1.astype(np.float32),
        tensor=tens.astype(np.float32),
        threshold_tensor_saliency=-np.inf,
        threshold_tensor_neighbor=-np.inf,
        threshold_vector_saliency=-np.inf,
        threshold_vector_neighbor=-np.inf,
        consider_dot_product_sign=False,
        standardize_vector_sign=True,
    )
    assert res.num_clusters >= 1
    assert res.cluster_sizes[0] >= 50
    # standardized normals on the dominant cluster should be
    # sign-consistent (all +x or all -x)
    sel = res.labels == 1
    nxs = res.vector_standardized[sel][:, 0]
    assert (nxs > 0).all() or (nxs < 0).all()


def test_trace_product_quirk_formula():
    a = np.array([1.0, 2, 3, 4, 5, 6])
    b = np.array([0.5, -1, 2, 0, 1, -2])
    want = (2 * 1 * 0.5 + 1 * -1 + 2 * 0.5 + 2 * -1 + 2 * 2 + 3 * -1
            + 2 * 3 * 2)
    assert trace_product_sym3_quirk(a, b) == want


def test_connect_no_seeds_with_vector_standardization(rng):
    """Regression (round 5): threshold above every saliency -> zero
    basins; the polarity application indexed an EMPTY basin2polarity
    (IndexError) when standardized vectors were requested."""
    x = rng.normal(size=(6, 7, 8)).astype(np.float32)
    v = rng.normal(size=(6, 7, 8, 3)).astype(np.float32)
    res = label_connected(
        x, threshold_saliency=1e30, vector=v,
        consider_dot_product_sign=False, standardize_vector_sign=True,
        start_from_saliency_maxima=True)
    assert res.num_clusters == 0
    assert np.all(res.labels == -1)


@pytest.mark.parametrize("nz", [33, 34, 40])
def test_discard_gates_by_slabs_equal_whole(rng, monkeypatch, nz):
    """The per-voxel gates computed over z-slabs with a one-plane halo
    equal the whole-volume computation, including slabs at the faces
    (edge clamp) and a short last slab."""
    monkeypatch.setattr(C, "_GATE_SLAB", 16)
    sal = jnp.asarray(rng.normal(size=(nz, 12, 10)).astype(np.float32))
    t = jnp.asarray(rng.normal(size=(nz, 12, 10, 6)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(nz, 12, 10, 3)).astype(np.float32))
    args = (jnp.float32(0.3), jnp.float32(0.2), jnp.float32(0.04))
    kw = dict(order=sym3.EigenOrder.DECREASING, consider_sign=False,
              neg_hess=True, has_tensor=True, has_vector=True)
    whole = C._discard_gates_device(sal, t, v, *args, **kw)
    np.testing.assert_array_equal(
        np.asarray(C._discard_gates(sal, t, v, *args, **kw)),
        np.asarray(whole))
