"""Hessian/gradient field tests: analytic Gaussian blob derivatives
and eigen-scoring sanity on a synthetic membrane."""

import numpy as np

import jax.numpy as jnp

from visfd_jax.features import hessian as H
from visfd_jax.linalg import sym3


def test_gradient_hessian_on_quadratic():
    """FD stencils are exact on quadratics: f = ax^2+by^2+cz^2+dxy."""
    n = 9
    z, y, x = np.meshgrid(*([np.arange(n, dtype=np.float64) - 4] * 3),
                          indexing="ij")
    f = (2 * x * x + 3 * y * y + 0.5 * z * z + 1.5 * x * y).astype(np.float32)
    g = np.asarray(H.gradient_fd(jnp.asarray(f)))
    h = np.asarray(H.hessian_fd(jnp.asarray(f)))
    c = n // 2
    # at center: grad = 0, hessian = [[4,1.5,0],[1.5,6,0],[0,0,1]]
    np.testing.assert_allclose(g[c, c, c], [0, 0, 0], atol=1e-4)
    np.testing.assert_allclose(h[c, c, c], [4, 6, 1, 1.5, 0, 0], atol=1e-4)
    # interior voxel off-center: grad exact for quadratic
    np.testing.assert_allclose(g[c, c, c + 2], [4 * 2, 1.5 * 2, 0], atol=1e-3)


def test_edge_clamping():
    n = 6
    z, y, x = np.meshgrid(*([np.arange(n, dtype=np.float32)] * 3),
                          indexing="ij")
    f = (x * x).astype(np.float32)
    h = np.asarray(H.hessian_fd(jnp.asarray(f)))
    # face voxels replicate nearest interior stencil
    np.testing.assert_allclose(h[0], h[1], atol=1e-6)
    np.testing.assert_allclose(h[:, :, 0], h[:, :, 1], atol=1e-6)


def test_membrane_saliency():
    """A planar membrane (bright slab) should give dominant |lambda1|
    with eigenvector ~ plane normal and high planar score on the
    slab."""
    n = 24
    img = np.zeros((n, n, n), np.float32)
    img[:, :, 11:13] = 1.0  # slab normal to x
    grad, hess = H.calc_hessian(jnp.asarray(img), sigma=2.0)
    diag = H.diagonalize_hessian_image(hess)
    eivals = np.asarray(diag[..., :3])
    score = np.asarray(H.score_hessian_planar(jnp.asarray(eivals)))
    c = n // 2
    # max planar score near the slab
    peak = np.unravel_index(np.argmax(score), score.shape)
    assert abs(peak[2] - 11.5) < 2.0
    # principal eigenvector at slab center ~ +-x
    _, vects = H.diagonalize_hessian_image(hess), None
    vals, eivects = sym3.diagonalize_sym3(
        sym3.flat_to_full(hess), order=sym3.EigenOrder.DECREASING_ABS)
    v1 = np.asarray(eivects)[c, c, 12, 0]
    assert abs(v1[0]) > 0.95  # x component dominates


def test_diag_undiag_roundtrip(rng):
    hess = rng.normal(size=(4, 5, 6, 6)).astype(np.float32)
    diag = H.diagonalize_hessian_image(jnp.asarray(hess))
    back = np.asarray(H.undiagonalize_hessian_image(diag))
    np.testing.assert_allclose(back, hess, atol=5e-3)


def test_mask_zeroing(rng):
    x = rng.normal(size=(8, 8, 8)).astype(np.float32)
    mask = np.zeros_like(x)
    mask[2:6] = 1
    grad, hess = H.calc_hessian(jnp.asarray(x), 1.5, mask=jnp.asarray(mask))
    assert np.all(np.asarray(hess)[mask == 0] == 0)
    assert np.all(np.asarray(grad)[mask == 0] == 0)
