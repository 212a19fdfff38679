"""The Pallas (Triton route) TV kernel vs the XLA reference, in
interpret mode on the CPU; on a GPU, the compiled kernel vs XLA."""

import numpy as np
import pytest

import jax.numpy as jnp

from visfd_jax.features import tv as TV


def tv_dense_stick_pallas(sal, v, sigma, exponent=4, mask_src=None,
                          detect_curves=False, truncate_ratio=2.5,
                          want_denominator=False, interpret=True,
                          sparse=False):
    """Raw kernel accumulation (dest, den|None) of unpadded fields."""
    return TV.tv_accumulate_triton(
        sal, v, mask_src, float(sigma), float(truncate_ratio),
        int(exponent), bool(detect_curves), bool(want_denominator),
        sparse=sparse, interpret=interpret)


def _random_fields(rng, n):
    sal = rng.uniform(0, 1, size=(n, n, n)).astype(np.float32)
    sal[sal < 0.4] = 0.0
    v = rng.normal(size=(n, n, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return sal, v


@pytest.mark.parametrize("exponent", [2, 4])
def test_pallas_matches_jnp_dense(rng, exponent):
    n, sigma = 8, 1.5
    sal, v = _random_fields(rng, n)
    want = np.asarray(TV.tv_dense_stick(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=exponent,
        normalize=False))
    got, den = tv_dense_stick_pallas(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=exponent,
        interpret=True)
    assert den is None
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("hw", [1, 2, 3, 4])
def test_pallas_tap_table_all_halfwidths(rng, hw):
    """Every tuned window size against the XLA table path: the r2
    regression was hw=3 only (corner taps on the r^2 == hw^2 shell
    were truncated by the XLA/gen_gauss table but kept by a kernel that
    recomputed exp() itself -- 13% error); the kernel now takes its
    taps from the same table."""
    sigma = hw / np.sqrt(2.0) + 1e-6  # floor(sigma*sqrt(2)) == hw
    sal, v = _random_fields(rng, 12)
    want = np.asarray(TV.tv_dense_stick(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=4,
        truncate_ratio=float(np.sqrt(2.0)), normalize=False))
    got, _ = tv_dense_stick_pallas(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=4,
        truncate_ratio=float(np.sqrt(2.0)), interpret=True)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got), want, atol=3e-6 * scale)


def test_pallas_matches_jnp_masked_with_denominator(rng):
    n, sigma = 8, 1.2
    sal, v = _random_fields(rng, n)
    mask = (rng.uniform(size=(n, n, n)) > 0.25).astype(np.float32)
    want = np.asarray(TV.tv_dense_stick(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=4,
        mask_src=jnp.asarray(mask), normalize=False))
    got, den = tv_dense_stick_pallas(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=4,
        mask_src=jnp.asarray(mask), want_denominator=True,
        interpret=True)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-5)
    # denominator matches the jnp masked accumulation
    from tests.test_tv import brute_tv
    _, den_want = brute_tv(sal * mask, v, sigma, 4, mask, None)
    np.testing.assert_allclose(np.asarray(den), den_want,
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("hw", [2, 3])
def test_pallas_sparse_bitwise_matches_dense(rng, hw):
    """sparse=True (occupancy-gated tap groups, the -tv-best fast
    path) must match the dense kernel to the last ulp: skipped groups
    contribute exact zeros, so the only residual differences are FMA
    contraction choices the compiler makes for the two structures."""
    sigma = hw / np.sqrt(2.0) + 1e-6
    n = 16
    sal = rng.uniform(0, 1, size=(n, n, n)).astype(np.float32)
    sal[sal < 0.95] = 0.0  # ~5% occupancy, like -tv-best 0.05
    v = rng.normal(size=(n, n, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    kw = dict(exponent=4, truncate_ratio=float(np.sqrt(2.0)),
              interpret=True)
    want, _ = tv_dense_stick_pallas(
        jnp.asarray(sal), jnp.asarray(v), sigma, sparse=False, **kw)
    got, _ = tv_dense_stick_pallas(
        jnp.asarray(sal), jnp.asarray(v), sigma, sparse=True, **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-7, atol=0)


def test_pallas_sparse_masked_denominator(rng):
    n, sigma = 12, 1.5
    sal, v = _random_fields(rng, n)
    sal[sal < 0.8] = 0.0
    mask = (rng.uniform(size=(n, n, n)) > 0.25).astype(np.float32)
    kw = dict(exponent=4, mask_src=jnp.asarray(mask),
              want_denominator=True, interpret=True)
    want, wden = tv_dense_stick_pallas(
        jnp.asarray(sal), jnp.asarray(v), sigma, sparse=False, **kw)
    got, gden = tv_dense_stick_pallas(
        jnp.asarray(sal), jnp.asarray(v), sigma, sparse=True, **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-7, atol=0)
    np.testing.assert_allclose(np.asarray(gden), np.asarray(wden),
                               rtol=3e-7, atol=0)


def test_pallas_curve_mode(rng):
    n, sigma = 7, 1.2
    sal, v = _random_fields(rng, n)
    want = np.asarray(TV.tv_dense_stick(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=2,
        detect_curves=True, normalize=False))
    got, _ = tv_dense_stick_pallas(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=2,
        detect_curves=True, interpret=True)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [2, 3, 5, 9])
@pytest.mark.parametrize("sparse", [False, True])
def test_triton_kernel_on_gpu_matches_xla(gpu, rng, hw, sparse):
    """The kernel as compiled for the card (no interpreter) against the
    XLA shift-sum: the same float32 terms summed in another order."""
    import jax
    sigma = hw / np.sqrt(2.0) + 1e-6
    sal = rng.uniform(0, 1, size=(24, 40, 72)).astype(np.float32)
    sal[sal < 0.9] = 0.0
    v = rng.normal(size=sal.shape + (3,)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    w, rhat, offs, hw_t = TV.tv_tables(sigma, float(np.sqrt(2.0)))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(TV._tv_accumulate(
            jnp.asarray(sal), jnp.asarray(v), None, jnp.asarray(w),
            jnp.asarray(rhat), jnp.asarray(offs), 4, False, hw_t,
            False)[0])
    got, _ = tv_dense_stick_pallas(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=4,
        truncate_ratio=float(np.sqrt(2.0)), interpret=False, sparse=sparse)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=1e-5 * np.abs(want).max())
