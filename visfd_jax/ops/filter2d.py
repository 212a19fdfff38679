"""General 2-D filtering (the reference's ``Filter2D`` class).

Capability parity with ``lib/visfd/filter2d.hpp``: a dense 2-D
convolution with the mask + denominator semantics of
``Filter2D::Apply`` (``filter2d.hpp:28-300``), plus the kernel
constructors ``GenFilterGenGauss2D`` (``filter2d.hpp:352-435``) and
``GenFilterDogg2D`` (``bin/filter_mrc/filter3d_variants.hpp:120-258``).

Applied to a (Z, Y, X) volume, the 2-D filter acts independently on
every Z slice (the reference uses it the same way through DOGGXY);
XLA batches the slices through one conv with Z as the batch dim, so
XLA sees one large convolution rather than Z small ones.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from visfd_jax.ops.kernels import halfwidth_from_threshold


def gen_gauss_kernel_2d(
    width_xy,
    m_exp: float,
    halfwidth_xy,
    normalize: bool = True,
) -> np.ndarray:
    """(Y, X)-shaped normalized generalized Gaussian
    h = A*exp(-r^m), r = |(x/s_x, y/s_y)|, with the reference's
    corner truncation (``filter2d.hpp:352-407``)."""
    wx, wy = (float(w) for w in width_xy)
    hx, hy = (int(h) for h in halfwidth_xy)
    trunc = 1.0
    for w, hw in ((wx, hx), (wy, hy)):
        h_edge = np.exp(-((hw / w) ** m_exp)) if w > 0 else 1.0
        trunc = min(trunc, h_edge)
    y, x = np.meshgrid(np.arange(-hy, hy + 1, dtype=np.float64),
                       np.arange(-hx, hx + 1, dtype=np.float64),
                       indexing="ij")

    def scaled(v, w):
        if w == 0.0:
            return np.where(v == 0.0, 0.0, np.inf)
        return v / w

    r = np.sqrt(scaled(x, wx) ** 2 + scaled(y, wy) ** 2)
    with np.errstate(over="ignore"):
        h = np.where(np.isinf(r), 0.0, np.exp(-(r ** m_exp)))
    h = np.where(np.abs(h) < trunc, 0.0, h)
    if normalize:
        h = h / h.sum()
    return h.astype(np.float32)


def gauss_kernel_2d(sigma_xy, halfwidth_xy) -> np.ndarray:
    """Ordinary 2-D Gaussian exp(-0.5 r^2) with std sigma
    (= gen-Gauss with width sigma*sqrt(2), m=2;
    ``filter2d.hpp:440-470``)."""
    w = tuple(float(s) * np.sqrt(2.0) for s in sigma_xy)
    return gen_gauss_kernel_2d(w, 2.0, halfwidth_xy)


def dogg_kernel_2d(
    width_a_xy,
    width_b_xy,
    m_exp: float,
    n_exp: float,
    truncate_ratio: float = -1.0,
    truncate_threshold: float = 0.03,
) -> Tuple[np.ndarray, Tuple[float, float]]:
    """Difference of independently normalized 2-D generalized
    Gaussians on the union window (``GenFilterDogg2D``,
    ``filter3d_variants.hpp:120-258``); returns (kernel, (A, B))."""
    wa = tuple(float(w) for w in width_a_xy)
    wb = tuple(float(w) for w in width_b_xy)
    ra = rb = float(truncate_ratio)
    if truncate_ratio < 0.0:
        ra = halfwidth_from_threshold(1.0, m_exp, truncate_threshold)
        rb = halfwidth_from_threshold(1.0, n_exp, truncate_threshold)
    hwa = tuple(int(np.floor(w * ra)) for w in wa)
    hwb = tuple(int(np.floor(w * rb)) for w in wb)
    ka = gen_gauss_kernel_2d(wa, m_exp, hwa)
    kb = gen_gauss_kernel_2d(wb, n_exp, hwb)
    hws = tuple(max(a, b) for a, b in zip(hwa, hwb))
    h = np.zeros((2 * hws[1] + 1, 2 * hws[0] + 1), dtype=np.float32)

    def _paste(dst, src, sign):
        off = [(d - s) // 2 for d, s in zip(dst.shape, src.shape)]
        sl = tuple(slice(o, o + n) for o, n in zip(off, src.shape))
        dst[sl] += sign * src

    _paste(h, ka, 1.0)
    _paste(h, kb, -1.0)
    A = float(ka[hwa[1], hwa[0]])
    B = float(kb[hwb[1], hwb[0]])
    return h, (A, B)


@functools.partial(jax.jit, static_argnames=("normalize",))
def _dense_conv2d_impl(x, mask, kf, normalize: bool):
    # x: (Z, Y, X) batched over Z; kf pre-flipped (correlation form)
    src = x if mask is None else x * mask

    def corr(v):
        return jax.lax.conv_general_dilated(
            v[:, None],
            kf[None, None],
            window_strides=(1, 1),
            padding=[(s // 2, s // 2) for s in kf.shape],
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=jax.lax.Precision.HIGHEST,
        )[:, 0]

    out = corr(src)
    if not normalize:
        return out
    den = corr(mask if mask is not None else jnp.ones_like(x))
    return jnp.where(den > 0, out / jnp.where(den > 0, den, 1.0), out)


def dense_conv2d(
    x: jax.Array,
    kernel_yx,
    mask: Optional[jax.Array] = None,
    normalize: bool = False,
) -> jax.Array:
    """Dense 2-D convolution with ``Filter2D::Apply`` semantics
    (``filter2d.hpp:28-300``): g = conv(f*m), optional denominator
    normalization by conv(m).  ``x`` may be a (Y, X) image or a
    (Z, Y, X) volume (slice-wise, batched over Z)."""
    k = np.asarray(kernel_yx, np.float32)
    kf = jnp.asarray(k[::-1, ::-1])  # true convolution
    x = jnp.asarray(x, jnp.float32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    m = None
    if mask is not None:
        m = jnp.asarray(mask, jnp.float32)
        if m.ndim == 2:
            m = m[None]
    out = _dense_conv2d_impl(x, m, kf, normalize)
    return out[0] if squeeze else out


def apply_gen_gauss_2d(
    x: jax.Array,
    width_xy,
    m_exp: float,
    mask: Optional[jax.Array] = None,
    truncate_ratio: float = -1.0,
    truncate_threshold: float = 0.03,
    normalize: bool = True,
) -> jax.Array:
    """2-D generalized Gaussian filter with the threshold->ratio
    conversion ratio = (-ln t)^(1/m)
    (``filter3d_variants.hpp:47-72``)."""
    tr = truncate_ratio
    if tr < 0:
        tr = halfwidth_from_threshold(1.0, m_exp, truncate_threshold)
    hw = tuple(int(np.floor(float(w) * tr)) for w in width_xy)
    ker = gen_gauss_kernel_2d(width_xy, m_exp, hw)
    return dense_conv2d(x, ker, mask=mask, normalize=normalize)


def apply_dogg_2d(
    x: jax.Array,
    width_a_xy,
    width_b_xy,
    m_exp: float,
    n_exp: float,
    mask: Optional[jax.Array] = None,
    truncate_ratio: float = -1.0,
    truncate_threshold: float = 0.03,
) -> jax.Array:
    """2-D difference of generalized Gaussians (no edge
    normalization), per-slice over a volume."""
    ker, _ = dogg_kernel_2d(width_a_xy, width_b_xy, m_exp, n_exp,
                            truncate_ratio, truncate_threshold)
    out = dense_conv2d(x, ker, mask=mask, normalize=False)
    if mask is not None:
        out = jnp.where(jnp.asarray(mask) != 0, out, 0.0)
    return out
