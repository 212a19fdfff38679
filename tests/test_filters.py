"""Filter correctness vs brute-force numpy references.

The reference's semantics (filter1d.hpp / filter3d.hpp) are
re-implemented here as slow-but-obvious numpy loops, and the XLA paths
must match them."""

import numpy as np
import pytest
from scipy.special import ive

import jax.numpy as jnp

from visfd_jax.ops import kernels as K
from visfd_jax.ops.conv import conv1d_axis, dense_conv3d, separable_conv3d
from visfd_jax.ops import filters as F
from visfd_jax.ops import threshold as T
from visfd_jax.ops import resample as R


def brute_conv1d(f, h):
    """g[i] = sum_j h[j] f[i-j], zero padded (filter1d.hpp:47-105)."""
    hw = len(h) // 2
    n = len(f)
    g = np.zeros(n)
    for i in range(n):
        for j in range(-hw, hw + 1):
            ij = i - j
            if 0 <= ij < n:
                g[i] += h[j + hw] * f[ij]
    return g


def brute_sep3(x, kx, ky, kz, mask=None, normalize=True):
    src = x if mask is None else x * mask
    out = np.apply_along_axis(brute_conv1d, 0, src, kz)
    out = np.apply_along_axis(brute_conv1d, 1, out, ky)
    out = np.apply_along_axis(brute_conv1d, 2, out, kx)
    if not normalize:
        return out
    m = mask if mask is not None else np.ones_like(x)
    den = np.apply_along_axis(brute_conv1d, 0, m, kz)
    den = np.apply_along_axis(brute_conv1d, 1, den, ky)
    den = np.apply_along_axis(brute_conv1d, 2, den, kx)
    return np.where(den > 0, out / np.where(den > 0, den, 1), out)


def test_gauss_kernel_matches_bessel_formula():
    for sigma, hw in [(1.0, 3), (2.5, 6), (0.5, 2)]:
        k = K.gauss_kernel_1d(sigma, hw)
        i = np.arange(-hw, hw + 1, dtype=float)
        expected = ive(np.abs(i), sigma * sigma)
        expected /= expected.sum()
        np.testing.assert_allclose(k, expected, rtol=1e-6)
    # sigma=0 => delta
    k0 = K.gauss_kernel_1d(0.0, 2)
    np.testing.assert_array_equal(k0, [0, 0, 1, 0, 0])
    # large sigma switches to continuous formula
    k = K.gauss_kernel_1d(12.0, 30)
    i = np.arange(-30, 31, dtype=float)
    expected = np.exp(-(i * i) / (2 * 144.0))
    expected /= expected.sum()
    np.testing.assert_allclose(k, expected, rtol=1e-5)


def test_conv1d_axis_matches_brute(rng):
    x = rng.normal(size=(4, 5, 6)).astype(np.float32)
    k = rng.normal(size=5).astype(np.float32)  # asymmetric kernel
    for axis in range(3):
        got = np.asarray(conv1d_axis(jnp.asarray(x), k, axis))
        want = np.apply_along_axis(brute_conv1d, axis, x.astype(np.float64),
                                   k.astype(np.float64))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_separable_conv3d_matches_brute(rng, use_mask, normalize):
    x = rng.normal(size=(6, 7, 8)).astype(np.float32)
    mask = None
    if use_mask:
        mask = (rng.uniform(size=x.shape) > 0.3).astype(np.float32)
    kx = K.gauss_kernel_1d(1.0, 2)
    ky = K.gauss_kernel_1d(1.5, 3)
    kz = K.gauss_kernel_1d(0.8, 2)
    got = np.asarray(
        separable_conv3d(
            jnp.asarray(x), (kx, ky, kz),
            mask=None if mask is None else jnp.asarray(mask),
            normalize=normalize,
        )
    )
    want = brute_sep3(x.astype(np.float64), kx, ky, kz, mask, normalize)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_dense_conv3d_matches_separable(rng):
    x = rng.normal(size=(6, 6, 6)).astype(np.float32)
    kx = K.gauss_kernel_1d(1.0, 2)
    sep = np.einsum("i,j,k->ijk", kx, kx, kx)  # (z, y, x) outer product
    got = np.asarray(dense_conv3d(jnp.asarray(x), sep, normalize=False))
    want = brute_sep3(x.astype(np.float64), kx, kx, kx, None, False)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_apply_gauss_constant_image_invariant(rng):
    """Normalization must make a constant image exactly invariant,
    including near edges and mask boundaries."""
    x = np.full((8, 9, 10), 3.25, dtype=np.float32)
    mask = np.ones_like(x)
    mask[:2] = 0
    out = np.asarray(F.apply_gauss(jnp.asarray(x), 2.0, mask=jnp.asarray(mask)))
    np.testing.assert_allclose(out[mask != 0], 3.25, rtol=1e-5)
    out2 = np.asarray(F.apply_gauss(jnp.asarray(x), 2.0))
    np.testing.assert_allclose(out2, 3.25, rtol=1e-5)


def test_apply_log_approximates_laplacian():
    """LoG of a centered Gaussian blob. The reference's DoG convention
    is blur(sigma_small) - blur(sigma_large) (filter3d.hpp:1340-1402),
    so a bright blob gives a POSITIVE response at center, maximal (per
    the scale normalization) near sigma = blob sigma."""
    n = 33
    c = n // 2
    z, y, x = np.meshgrid(*([np.arange(n) - c] * 3), indexing="ij")
    blob_sigma = 3.0
    img = np.exp(-0.5 * (x**2 + y**2 + z**2) / blob_sigma**2).astype(np.float32)
    responses = {}
    for s in [1.5, 3.0, 6.0]:
        out = np.asarray(F.apply_log(jnp.asarray(img), s))
        responses[s] = out[c, c, c]
    assert responses[3.0] > 0  # bright blob => positive (Gsmall-Glarge)
    assert responses[3.0] > responses[1.5]
    assert responses[3.0] > responses[6.0]


def test_local_fluctuations_flat_image_zero():
    x = np.full((10, 10, 10), 7.0, dtype=np.float32)
    out = np.asarray(F.local_fluctuations(jnp.asarray(x), 2.0))
    np.testing.assert_allclose(out, 0.0, atol=1e-4)


def test_local_fluctuations_matches_reference_formula(rng):
    """Brute-force check of the reference recipe (filter3d.hpp:
    1700-1860): rms = sqrt(wpeak * blur((x - blur(x))^2)) where wpeak
    is the center of the normalized generalized-Gaussian weight
    kernel."""
    x = rng.normal(0, 2.0, size=(12, 13, 14)).astype(np.float64)
    sigma, ratio = 2.0, 2.5
    hw = int(np.floor(sigma * ratio))
    wker = K.gen_gauss_kernel_3d((sigma,) * 3, 2.0, (hw,) * 3)
    wpeak = float(wker[hw, hw, hw])
    k = K.gauss_kernel_1d(sigma, hw)
    mean = brute_sep3(x, k, k, k)
    p2 = (x - mean) ** 2
    var = brute_sep3(p2, k, k, k) * wpeak
    want = np.sqrt(np.maximum(var, 0.0))
    got = np.asarray(F.local_fluctuations(jnp.asarray(x), sigma))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_median_filter_matches_brute(rng):
    x = rng.normal(size=(6, 7, 8)).astype(np.float32)
    r = 1.5
    got = np.asarray(F.median_filter(jnp.asarray(x), r))
    offs = F.sphere_footprint_offsets(r)
    want = np.empty_like(x)
    for iz in range(x.shape[0]):
        for iy in range(x.shape[1]):
            for ix in range(x.shape[2]):
                vals = []
                for dz, dy, dx in offs:
                    z, y, xx = iz + dz, iy + dy, ix + dx
                    if (0 <= z < x.shape[0] and 0 <= y < x.shape[1]
                            and 0 <= xx < x.shape[2]):
                        vals.append(x[z, y, xx])
                vals.sort()
                want[iz, iy, ix] = vals[len(vals) // 2]
    np.testing.assert_allclose(got, want)


def test_threshold2_directions():
    x = jnp.asarray([0.0, 0.25, 0.5, 0.75, 1.0])
    up = np.asarray(T.threshold2(x, 0.25, 0.75))
    np.testing.assert_allclose(up, [0, 0, 0.5, 1.0, 1.0])
    down = np.asarray(T.threshold2(x, 0.75, 0.25))
    np.testing.assert_allclose(down, [1.0, 1.0, 0.5, 0.0, 0.0])


def _ref_is_between(x, a, b):
    return ((a <= x) and (x < b)) or ((b < x) and (x <= a))


def _ref_threshold2(x, a, b):
    """Scalar transliteration of Threshold2 (threshold.hpp:52-76)."""
    if _ref_is_between(x, a, b):
        g = (x - a) / (b - a)
    elif (x - a) * (b - a) > 0.0:
        g = 1.0
    else:
        g = 0.0
    return g


def _ref_threshold4(x, t01a, t01b, t10a, t10b):
    """Scalar transliteration of Threshold4 (threshold.hpp:113-166)."""
    if (t01b == t10a) and (t01b == t10b):
        return _ref_threshold2(x, t01a, t01b)
    if _ref_is_between(x, t01a, t01b):
        return _ref_threshold2(x, t01a, t01b)
    if _ref_is_between(x, t10a, t10b):
        return _ref_threshold2(x, t10a, t10b)
    if t01b <= t10a:
        return 1.0 if _ref_is_between(x, t01b, t10a) else 0.0
    assert t10b <= t01a
    return 0.0 if _ref_is_between(x, t10b, t01a) else 1.0


def test_threshold4_matches_scalar_reference():
    xs = np.linspace(-0.3, 1.3, 33)
    for args in [(0.0, 0.2, 0.8, 1.0), (1.0, 0.8, 0.2, 0.0),
                 (0.1, 0.4, 0.4, 0.4)]:
        got = np.asarray(T.threshold4(jnp.asarray(xs), *args))
        want = [_ref_threshold4(float(x), *args) for x in xs]
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=str(args))


def test_threshold2_matches_scalar_reference():
    xs = np.linspace(-0.3, 1.3, 33)
    for a, b in [(0.25, 0.75), (0.75, 0.25), (0.0, 1.0)]:
        got = np.asarray(T.threshold2(jnp.asarray(xs), a, b))
        want = [_ref_threshold2(float(x), a, b) for x in xs]
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_bin_unbin_roundtrip(rng):
    x = rng.normal(size=(8, 12, 16)).astype(np.float32)
    b = np.asarray(R.bin_array3d(jnp.asarray(x), (4, 6, 8)))
    want = x.reshape(4, 2, 6, 2, 8, 2).mean(axis=(1, 3, 5))
    np.testing.assert_allclose(b, want, rtol=1e-5)
    u = np.asarray(R.unbin_array3d(jnp.asarray(b), (8, 12, 16)))
    assert u.shape == (8, 12, 16)
    np.testing.assert_allclose(u[::2, ::2, ::2], b)
    # remainder cropping
    b2 = np.asarray(R.bin_array3d(jnp.asarray(x), (3, 5, 7)))
    assert b2.shape == (3, 5, 7)
    np.testing.assert_allclose(
        b2[0, 0, 0], x[:2, :2, :2].mean(), rtol=1e-6
    )
