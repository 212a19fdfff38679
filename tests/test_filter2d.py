"""General 2-D filter (reference Filter2D, filter2d.hpp) semantics."""

import numpy as np
import pytest

import jax.numpy as jnp

from visfd_jax.ops import filter2d as F2
from visfd_jax.ops import kernels as K
from visfd_jax.ops.conv import dense_conv3d


def brute_conv2d(x, k, mask=None, normalize=False):
    """Direct reimplementation of Filter2D::ApplyToVoxel
    (filter2d.hpp:200-300): g[i] = sum_j h[j] f[i-j] m[i-j]."""
    hy, hx = k.shape[0] // 2, k.shape[1] // 2
    ny, nx = x.shape
    g = np.zeros_like(x)
    d = np.zeros_like(x)
    for iy in range(ny):
        for ix in range(nx):
            acc = den = 0.0
            for jy in range(-hy, hy + 1):
                for jx in range(-hx, hx + 1):
                    sy, sx = iy - jy, ix - jx
                    if not (0 <= sy < ny and 0 <= sx < nx):
                        continue
                    w = k[jy + hy, jx + hx]
                    if mask is not None:
                        if mask[sy, sx] == 0:
                            continue
                        w = w * mask[sy, sx]
                    acc += w * x[sy, sx]
                    den += w
            g[iy, ix] = acc
            d[iy, ix] = den
    if normalize:
        return np.where(d > 0, g / np.where(d > 0, d, 1), g)
    return g


def test_dense_conv2d_matches_brute(rng):
    x = rng.normal(size=(9, 11)).astype(np.float32)
    k = rng.normal(size=(5, 3)).astype(np.float32)
    got = np.asarray(F2.dense_conv2d(x, k))
    np.testing.assert_allclose(got, brute_conv2d(x, k), atol=1e-5)


def test_dense_conv2d_masked_normalized(rng):
    x = rng.normal(size=(8, 10)).astype(np.float32)
    m = (rng.random((8, 10)) > 0.3).astype(np.float32)
    k = F2.gauss_kernel_2d((1.5, 1.5), (3, 3))
    got = np.asarray(F2.dense_conv2d(x, k, mask=m, normalize=True))
    want = brute_conv2d(x, k, mask=m, normalize=True)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_volume_batches_slices(rng):
    vol = rng.normal(size=(4, 8, 10)).astype(np.float32)
    k = F2.gen_gauss_kernel_2d((2.0, 1.5), 3.0, (3, 3))
    got = np.asarray(F2.dense_conv2d(vol, k))
    for z in range(4):
        np.testing.assert_allclose(got[z], brute_conv2d(vol[z], k),
                                   atol=1e-5)


def test_gen_gauss_2d_matches_3d_slice():
    """A 2-D gen-Gauss kernel equals the z=0 plane behavior of the
    width-0-z 3-D kernel (delta along z)."""
    k2 = F2.gen_gauss_kernel_2d((2.0, 3.0), 4.0, (4, 5))
    k3 = K.gen_gauss_kernel_3d((2.0, 3.0, 0.0), 4.0, (4, 5, 0))
    np.testing.assert_allclose(k2, k3[0], rtol=1e-6)


def test_dogg_2d_kernel_properties():
    k, (A, B) = F2.dogg_kernel_2d((2.0, 2.0), (4.0, 4.0), 3.0, 5.0)
    # each term was normalized -> kernel sums to ~0
    assert abs(k.sum()) < 1e-5
    assert A > B > 0
    # central value = A - B
    hy, hx = k.shape[0] // 2, k.shape[1] // 2
    np.testing.assert_allclose(k[hy, hx], A - B, rtol=1e-5)


def test_apply_dogg_2d_masked_zeroing(rng):
    x = rng.normal(size=(4, 8, 10)).astype(np.float32)
    m = np.zeros((4, 8, 10), np.float32)
    m[:, 2:-2, 2:-2] = 1
    out = np.asarray(F2.apply_dogg_2d(x, (1.5, 1.5), (3.0, 3.0),
                                      2.0, 2.0, mask=m))
    assert (out[m == 0] == 0).all()
    assert (out[m != 0] != 0).any()
