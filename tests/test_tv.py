"""Tensor voting tests vs a direct transliteration oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from visfd_jax.features import tv as TV
from visfd_jax.ops import kernels as K
from visfd_jax.linalg import sym3


def brute_tv(saliency, nvec, sigma, exponent, mask_src=None, mask_dest=None,
             detect_curves=False, truncate_ratio=2.5):
    """Direct port of TVReceiveStickVotes (feature.hpp:2216-2384)."""
    hw = int(np.floor(sigma * truncate_ratio))
    ker = K.gen_gauss_kernel_3d((sigma,) * 3, 2.0, (hw,) * 3)
    nz, ny, nx = saliency.shape
    dest = np.zeros((nz, ny, nx, 6))
    den = np.zeros((nz, ny, nx))
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                if mask_dest is not None and mask_dest[iz, iy, ix] == 0:
                    continue
                for jz in range(-hw, hw + 1):
                    sz = iz - jz
                    if not 0 <= sz < nz:
                        continue
                    for jy in range(-hw, hw + 1):
                        sy = iy - jy
                        if not 0 <= sy < ny:
                            continue
                        for jx in range(-hw, hw + 1):
                            sx = ix - jx
                            if not 0 <= sx < nx:
                                continue
                            fv = ker[jz + hw, jy + hw, jx + hw]
                            if mask_src is not None:
                                mv = mask_src[sz, sy, sx]
                                if mv == 0:
                                    continue
                                fv = fv * mv
                            sal = saliency[sz, sy, sx]
                            if sal == 0:
                                continue
                            if fv == 0:
                                continue
                            ln = np.sqrt(jx * jx + jy * jy + jz * jz) or 1.0
                            r = np.array([jx, jy, jz]) / ln
                            n = nvec[sz, sy, sx]
                            sint = float(r @ n)
                            sin2 = sint * sint
                            cos2 = 1 - sin2
                            ang2 = sin2 if detect_curves else cos2
                            dec = ang2 ** (exponent / 2)
                            if detect_curves:
                                nr = n - 2 * sint * r
                            else:
                                nr = 2 * sint * r - n
                            amp = sal * fv * dec
                            for c, (di, dj) in enumerate(
                                    [(0, 0), (1, 1), (2, 2),
                                     (0, 1), (1, 2), (0, 2)]):
                                dest[iz, iy, ix, c] += amp * nr[di] * nr[dj]
                            den[iz, iy, ix] += fv
    return dest, den


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("curves", [False, True])
def test_tv_matches_brute(rng, use_mask, curves):
    n = 7
    sal = rng.uniform(0, 1, size=(n, n, n)).astype(np.float32)
    sal[sal < 0.5] = 0.0  # sparse saliency
    v = rng.normal(size=(n, n, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    mask = None
    if use_mask:
        mask = (rng.uniform(size=(n, n, n)) > 0.2).astype(np.float32)
    sigma, p = 1.5, 4
    got = np.asarray(TV.tv_dense_stick(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=p,
        mask_src=None if mask is None else jnp.asarray(mask),
        mask_dest=None if mask is None else jnp.asarray(mask),
        detect_curves=curves, normalize=False))
    want, _ = brute_tv(sal, v, sigma, p, mask, mask, curves)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_tv_normalization_masked(rng):
    n = 6
    sal = rng.uniform(0.1, 1, size=(n, n, n)).astype(np.float32)
    v = rng.normal(size=(n, n, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    mask = np.ones((n, n, n), np.float32)
    got = np.asarray(TV.tv_dense_stick(
        jnp.asarray(sal), jnp.asarray(v), 1.2, exponent=2,
        mask_src=jnp.asarray(mask), mask_dest=jnp.asarray(mask),
        normalize=True))
    want, den = brute_tv(sal, v, 1.2, 2, mask, mask)
    want = np.where(den[..., None] > 0, want / den[..., None], want)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_tv_normalization_nomask_double_divide(rng):
    """The no-mask path must replicate the reference's off-diagonal
    double division (feature.hpp:1848-1860)."""
    n = 6
    sigma = 1.2
    sal = rng.uniform(0.1, 1, size=(n, n, n)).astype(np.float32)
    v = rng.normal(size=(n, n, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    got = np.asarray(TV.tv_dense_stick(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=2,
        normalize=True))
    raw, _ = brute_tv(sal, v, sigma, 2)
    hw = int(np.floor(sigma * 2.5))
    k1 = K.gauss_kernel_1d(sigma, hw)

    def denom1(m):
        out = np.zeros(m)
        for i in range(m):
            for j in range(-hw, hw + 1):
                if 0 <= i - j < m:
                    out[i] += k1[j + hw]
        return out

    dz = denom1(n)[:, None, None]
    dy = denom1(n)[None, :, None]
    dx = denom1(n)[None, None, :]
    box = dz * dy * dx
    want = raw.copy()
    want[..., :3] /= box[..., None]
    want[..., 3:] /= (box * box)[..., None]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_tv_membrane_sharpens_plane():
    """Voting on a noisy plane of normals should boost stick saliency
    (l1 - l2) on the plane relative to isolated noise voxels."""
    n = 16
    sal = np.zeros((n, n, n), np.float32)
    v = np.zeros((n, n, n, 3), np.float32)
    sal[:, :, 8] = 1.0
    v[:, :, 8] = (1.0, 0.0, 0.0)  # normals along x
    # one inconsistent outlier
    sal[3, 3, 3] = 1.0
    v[3, 3, 3] = (0.577, 0.577, 0.577)
    out = TV.tv_dense_stick(jnp.asarray(sal), jnp.asarray(v), 2.0,
                            exponent=4, diagonalize_dest=True)
    eivals = np.asarray(out[..., :3])
    stick = eivals[..., 0] - eivals[..., 1]
    assert stick[8, 8, 8] > 10 * stick[3, 3, 3]
    # NOTE: raw vote sums are PSD, but the replicated no-mask
    # normalization (off-diagonals divided twice, feature.hpp:
    # 1848-1860) breaks exact PSD-ness -- mildly negative eigenvalues
    # are expected, matching the reference's release-build output
    # (its own debug assert would trip, but compiles out with -DNDEBUG).
    assert eivals.min() > -0.1


@pytest.mark.parametrize("platform,want", [
    ("gpu", True), ("cpu", False), ("METAL", False), (None, False)])
def test_tv_path_platform_rule(platform, want):
    """The Triton kernel serves a GPU at every window width; every other
    platform takes the XLA shift-sum.  No platform means the default
    device's, the CPU here."""
    assert TV.use_triton_tv(platform) is want


def test_tv_dense_stick_records_xla_path_on_cpu(rng):
    """On the CPU the XLA shift-sum runs, and it is recorded as plain
    "xla" even when sparse voting was asked for: no gating ran."""
    from visfd_jax.utils import reset_paths, stage_paths
    sal = rng.uniform(size=(6, 7, 8)).astype(np.float32)
    v = rng.normal(size=(6, 7, 8, 3)).astype(np.float32)
    reset_paths()
    TV.tv_dense_stick(jnp.asarray(sal), jnp.asarray(v), 1.2, sparse=True)
    assert stage_paths()["tv"] == "xla"
