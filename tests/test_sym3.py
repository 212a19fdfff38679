"""Closed-form sym3 eigensolver tests vs numpy.linalg.eigh and
roundtrip identities."""

import numpy as np
import pytest

import jax.numpy as jnp

from visfd_jax.linalg import (
    EigenOrder,
    diagonalize_sym3,
    diagonalize_flat_sym3,
    undiagonalize_flat_sym3,
    flat_to_full,
    full_to_flat,
    matrix_to_shoemake,
    shoemake_to_matrix,
)
from visfd_jax.linalg.sym3 import (
    matrix_to_quaternion,
    quaternion_to_matrix,
    flat_eigenvectors,
)


def random_sym(rng, n):
    a = rng.normal(size=(n, 3, 3))
    return ((a + np.swapaxes(a, -1, -2)) / 2).astype(np.float32)


def test_eigenvalues_match_numpy(rng):
    m = random_sym(rng, 500)
    vals, vects = diagonalize_sym3(jnp.asarray(m))
    want = np.linalg.eigvalsh(m.astype(np.float64))
    np.testing.assert_allclose(np.asarray(vals), want, rtol=2e-4, atol=2e-5)


def test_eigenvector_property(rng):
    m = random_sym(rng, 300)
    vals, vects = diagonalize_sym3(jnp.asarray(m))
    vals, vects = np.asarray(vals), np.asarray(vects)
    # M v_i = lambda_i v_i  (rows are eigenvectors)
    mv = np.einsum("nij,nkj->nki", m, vects)
    lv = vals[..., None] * vects
    np.testing.assert_allclose(mv, lv, atol=5e-4)
    # orthonormality
    gram = np.einsum("nki,nli->nkl", vects, vects)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(3), gram.shape),
                               atol=5e-4)


def test_degenerate_matrices():
    mats = np.stack([
        np.eye(3),                       # fully degenerate
        np.diag([2.0, 2.0, 5.0]),        # pairwise degenerate
        np.diag([5.0, 2.0, 2.0]),
        np.zeros((3, 3)),
        np.diag([1.0, 1.0 + 1e-8, 1.0 - 1e-8]),
    ]).astype(np.float32)
    vals, vects = diagonalize_sym3(jnp.asarray(mats))
    vals, vects = np.asarray(vals), np.asarray(vects)
    assert np.isfinite(vals).all() and np.isfinite(vects).all()
    mv = np.einsum("nij,nkj->nki", mats, vects)
    lv = vals[..., None] * vects
    np.testing.assert_allclose(mv, lv, atol=1e-5)


@pytest.mark.parametrize("order,check", [
    (EigenOrder.INCREASING, lambda v: (np.diff(v, axis=-1) >= 0).all()),
    (EigenOrder.DECREASING,
     lambda v: (v[:, 0] >= v[:, 2]).all()),
    (EigenOrder.INCREASING_ABS,
     lambda v: (np.abs(v[:, 0]) <= np.abs(v[:, 2])).all()),
    (EigenOrder.DECREASING_ABS,
     lambda v: (np.abs(v[:, 0]) >= np.abs(v[:, 2])).all()),
])
def test_orderings(rng, order, check):
    m = random_sym(rng, 200)
    vals, _ = diagonalize_sym3(jnp.asarray(m), order=order)
    assert check(np.asarray(vals))


def test_flat_roundtrip(rng):
    m = random_sym(rng, 200)
    flat = full_to_flat(jnp.asarray(m))
    np.testing.assert_allclose(np.asarray(flat_to_full(flat)), m, atol=1e-7)
    diag = diagonalize_flat_sym3(flat)
    rebuilt = undiagonalize_flat_sym3(diag)
    np.testing.assert_allclose(np.asarray(rebuilt), np.asarray(flat),
                               atol=2e-3)


def test_shoemake_quaternion_roundtrip(rng):
    # random rotations via QR
    a = rng.normal(size=(100, 3, 3))
    q, _ = np.linalg.qr(a)
    det = np.linalg.det(q)
    q = q * np.sign(det)[..., None, None]  # ensure det +1
    q = q.astype(np.float32)
    quat = matrix_to_quaternion(jnp.asarray(q))
    back = quaternion_to_matrix(quat)
    np.testing.assert_allclose(np.asarray(back), q, atol=2e-3)
    sm = matrix_to_shoemake(jnp.asarray(q))
    back2 = shoemake_to_matrix(sm)
    np.testing.assert_allclose(np.asarray(back2), q, atol=2e-3)


def test_flat_eigenvectors_unpack(rng):
    m = random_sym(rng, 50)
    diag = diagonalize_flat_sym3(full_to_flat(jnp.asarray(m)))
    vals, vects = flat_eigenvectors(diag)
    vals, vects = np.asarray(vals), np.asarray(vects)
    mv = np.einsum("nij,nkj->nki", m, vects)
    lv = vals[..., None] * vects
    np.testing.assert_allclose(mv, lv, atol=5e-3)


def test_principal_sym3_matches_full_solver():
    import jax
    import jax.numpy as jnp
    from visfd_jax.linalg import sym3

    rng = np.random.default_rng(42)
    m6 = rng.normal(size=(3000, 6)).astype(np.float32)
    mat = sym3.flat_to_full(jnp.asarray(m6))
    for order in (sym3.EigenOrder.DECREASING, sym3.EigenOrder.INCREASING):
        ev_f, vec_f = sym3.diagonalize_sym3(mat, order=order)
        ev_p, v1 = sym3.principal_sym3(mat, order=order)
        np.testing.assert_allclose(np.asarray(ev_f), np.asarray(ev_p),
                                   atol=2e-5, rtol=1e-5)
        dots = np.abs(np.einsum("nd,nd->n",
                                np.asarray(vec_f)[:, 0, :], np.asarray(v1)))
        assert dots.min() > 0.9999


def _eigh_ordered(m, order):
    """float64 eigenvalues/row-eigenvectors of (n, 3, 3) in `order`,
    with the reference's rule: ascending, then the first and last swap
    when the order asks (``eigen3_simple.hpp:239-263``)."""
    vals, vecs = np.linalg.eigh(m.astype(np.float64))   # ascending
    vecs = np.swapaxes(vecs, -1, -2)                      # rows
    l0, l2 = vals[:, 0], vals[:, 2]
    swap = {EigenOrder.INCREASING: np.zeros_like(l0, bool),
            EigenOrder.DECREASING: l0 < l2,
            EigenOrder.INCREASING_ABS: np.abs(l0) > np.abs(l2),
            EigenOrder.DECREASING_ABS: np.abs(l0) < np.abs(l2)}[order]
    vals = np.where(swap[:, None], vals[:, ::-1], vals)
    vecs = np.where(swap[:, None, None], vecs[:, ::-1], vecs)
    return vals, vecs


def _separated_sym(rng, n):
    """Symmetric matrices with eigenvalue gaps >= 0.3 (well-posed
    eigenvectors in float32)."""
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    lam = rng.uniform(-3, 3, size=(n, 3))
    lam = np.sort(lam, -1)
    lam[:, 1] = np.maximum(lam[:, 1], lam[:, 0] + 0.3)
    lam[:, 2] = np.maximum(lam[:, 2], lam[:, 1] + 0.3)
    lam *= rng.choice([-1.0, 1.0], size=(n, 1))
    return np.einsum("nij,nj,nkj->nik", q, lam, q).astype(np.float32)


def _check_vects(got, want):
    dots = np.abs(np.sum(np.asarray(got, np.float64) * want, axis=-1))
    assert dots.min() > 1 - 1e-4, dots.min()


@pytest.mark.parametrize("case", [
    "principal-increasing", "principal-decreasing",
    "full-increasing", "full-decreasing",
    "full-increasing_abs", "full-decreasing_abs",
    "score-planar", "score-linear", "score-stick", "edge-clamp"])
def test_sym3_matches_float64_eigh(rng, case):
    """The closed-form solvers and the scores built on them against
    float64 ``numpy.linalg.eigh``: each ordering, each score formula,
    and the FD Hessian's nearest-interior face clamp."""
    from visfd_jax.features import hessian as FH
    from visfd_jax.linalg.sym3 import principal_sym3
    m = _separated_sym(rng, 400)
    kind, _, arg = case.partition("-")
    if kind in ("principal", "full"):
        order = EigenOrder(arg)
        want_vals, want_vecs = _eigh_ordered(m, order)
        if kind == "principal":
            vals, v1 = principal_sym3(jnp.asarray(m), order=order)
            _check_vects(v1, want_vecs[:, 0])
        else:
            vals, vecs = diagonalize_sym3(jnp.asarray(m), order=order)
            for r in range(3):
                _check_vects(np.asarray(vecs)[:, r], want_vecs[:, r])
        np.testing.assert_allclose(np.asarray(vals), want_vals,
                                   rtol=2e-4, atol=2e-5)
        return
    if kind == "score":
        dec, _ = _eigh_ordered(m, EigenOrder.DECREASING)
        if arg == "stick":
            got, v1 = FH.tensor_score_direction(
                full_to_flat(jnp.asarray(m)), EigenOrder.DECREASING, False)
            want = dec[:, 0] - dec[:, 1]
            _check_vects(v1, _eigh_ordered(m, EigenOrder.DECREASING)[1][:, 0])
        else:
            vals, _ = principal_sym3(jnp.asarray(m),
                                     order=EigenOrder.DECREASING)
            score = (FH.score_hessian_planar if arg == "planar"
                     else FH.score_hessian_linear)
            got = score(vals)
            want = score(dec)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max())
        return
    # edge-clamp: ridge_score_direction on a volume, every voxel incl.
    # the faces, against a float64 FD Hessian of the same blur
    from visfd_jax.ops.filters import apply_gauss
    x = rng.normal(size=(9, 11, 13)).astype(np.float32)
    sigma = 1.2
    hw = max(1, int(np.floor(sigma * 2.5)))
    blur = np.asarray(apply_gauss(jnp.asarray(x), sigma,
                                  truncate_halfwidth=(hw,) * 3), np.float64)
    b = np.pad(blur, 1)
    c = b[1:-1, 1:-1, 1:-1]

    def sh(dz, dy, dx):
        return b[1 + dz:b.shape[0] - 1 + dz, 1 + dy:b.shape[1] - 1 + dy,
                 1 + dx:b.shape[2] - 1 + dx]

    hxx = sh(0, 0, 1) + sh(0, 0, -1) - 2 * c
    hyy = sh(0, 1, 0) + sh(0, -1, 0) - 2 * c
    hzz = sh(1, 0, 0) + sh(-1, 0, 0) - 2 * c
    hxy = 0.25 * (sh(0, 1, 1) + sh(0, -1, -1) - sh(0, -1, 1) - sh(0, 1, -1))
    hyz = 0.25 * (sh(1, 1, 0) + sh(-1, -1, 0) - sh(-1, 1, 0) - sh(1, -1, 0))
    hxz = 0.25 * (sh(1, 0, 1) + sh(-1, 0, -1) - sh(1, 0, -1) - sh(-1, 0, 1))
    h = np.stack([hxx, hyy, hzz, hxy, hyz, hxz], -1)
    h = np.pad(h[1:-1, 1:-1, 1:-1], ((1, 1),) * 3 + ((0, 0),), mode="edge")
    full = np.asarray(flat_to_full(jnp.asarray(h * sigma * sigma)))
    dec, _ = _eigh_ordered(full.reshape(-1, 3, 3).astype(np.float64),
                           EigenOrder.DECREASING)
    want = FH.score_hessian_planar(dec).reshape(x.shape)
    got, _ = FH.ridge_score_direction(jnp.asarray(x), None, sigma, 2.5,
                                      EigenOrder.DECREASING, "planar")
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-3,
                               atol=1e-5 * np.abs(want).max())


def test_column_pick_is_exact(rng):
    """_extract_kernel3's column pick is a select, bit-exact for any
    float32 values (a one-hot product could round at TF32 precision)."""
    from visfd_jax.linalg.sym3 import _extract_kernel3
    m = (rng.normal(size=(64, 3, 3)) * 1e3).astype(np.float32)
    m = m + np.swapaxes(m, -1, -2)
    res, rep = _extract_kernel3(jnp.asarray(m))
    i0 = np.argmax(np.abs(np.diagonal(m, axis1=-2, axis2=-1)), -1)
    np.testing.assert_array_equal(np.asarray(rep),
                                  m[np.arange(len(m)), :, i0])
