"""High-level 3-D filters: Gaussian, generalized Gaussian, DoG, LoG,
local fluctuations (RMS), median.

Capability parity with ``lib/visfd/filter3d.hpp`` (ApplyGauss ``:1086-
1319``, ApplyDog ``:1340-1402``, ApplyLog ``:1408-1557``,
LocalFluctuations ``:1700-1925``, Median ``:1577-1674``).  Everything
here is jit-friendly: kernel construction happens at trace time with
static shapes; voxel math is XLA on (Z, Y, X) float32 arrays.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from visfd_jax.ops import kernels as K
from visfd_jax.ops.conv import conv1d_axis, dense_conv3d, separable_conv3d


def _sigma3(sigma) -> Tuple[float, float, float]:
    if np.isscalar(sigma):
        return (float(sigma),) * 3
    s = tuple(float(v) for v in sigma)
    assert len(s) == 3
    return s


def apply_gauss(
    x: jax.Array,
    sigma,
    mask: Optional[jax.Array] = None,
    truncate_ratio: float = 2.5,
    truncate_halfwidth: Optional[Sequence[int]] = None,
    normalize: bool = True,
) -> jax.Array:
    """Separable (possibly anisotropic) Gaussian blur with mask-aware
    normalization; sigma in voxel units, per-axis order (x, y, z).
    Reference: ``filter3d.hpp:1086-1319``."""
    sx, sy, sz = _sigma3(sigma)
    if truncate_halfwidth is None:
        hwx, hwy, hwz = (K.gauss_halfwidth(s, truncate_ratio) for s in (sx, sy, sz))
    else:
        hwx, hwy, hwz = (int(h) for h in truncate_halfwidth)
    kx = K.gauss_kernel_1d(sx, hwx)
    ky = K.gauss_kernel_1d(sy, hwy)
    kz = K.gauss_kernel_1d(sz, hwz)
    return separable_conv3d(x, (kx, ky, kz), mask=mask, normalize=normalize)


def apply_gen_gauss(
    x: jax.Array,
    width,
    m_exp: float,
    mask: Optional[jax.Array] = None,
    truncate_ratio: float = 2.5,
    truncate_halfwidth: Optional[Sequence[int]] = None,
    normalize: bool = True,
) -> jax.Array:
    """Dense generalized-Gaussian filter h = A*exp(-r^m)
    (``filter3d.hpp:546-638`` + ``Filter3D::Apply``)."""
    w = _sigma3(width)
    if truncate_halfwidth is None:
        hws = tuple(int(np.floor(wi * truncate_ratio)) for wi in w)
    else:
        hws = tuple(int(h) for h in truncate_halfwidth)
    ker = K.gen_gauss_kernel_3d(w, m_exp, hws)
    return dense_conv3d(x, ker, mask=mask, normalize=normalize)


def apply_dogg(
    x: jax.Array,
    width_a,
    width_b,
    m_exp: float,
    n_exp: float,
    mask: Optional[jax.Array] = None,
    truncate_ratio: float = -1.0,
    truncate_threshold: float = 0.03,
) -> jax.Array:
    """Difference of generalized Gaussians
    h = A*exp(-(r/a)^m) - B*exp(-(r/b)^n), dense conv, no edge
    normalization; output is 0 where mask == 0 (``HandleDogg``,
    ``handlers.cpp:265-293`` + ``GenFilterDogg3D``,
    ``filter3d_variants.hpp:440-482``)."""
    ker, _ab = K.dogg_kernel_3d(_sigma3(width_a), _sigma3(width_b),
                                m_exp, n_exp, truncate_ratio,
                                truncate_threshold)
    out = dense_conv3d(x, ker, mask=mask, normalize=False)
    if mask is not None:
        out = jnp.where(jnp.asarray(mask) != 0, out, 0.0)
    return out


def apply_dog(
    x: jax.Array,
    sigma_a,
    sigma_b,
    mask: Optional[jax.Array] = None,
    truncate_halfwidth: Optional[Sequence[int]] = None,
    truncate_ratio: float = 2.5,
    normalize: bool = True,
) -> jax.Array:
    """Difference of (separately normalized) Gaussians
    (``filter3d.hpp:1340-1402``)."""
    sa, sb = _sigma3(sigma_a), _sigma3(sigma_b)
    if truncate_halfwidth is None:
        truncate_halfwidth = [
            max(1, int(np.floor(truncate_ratio * max(a, b))))
            for a, b in zip(sa, sb)
        ]
    ga = apply_gauss(x, sa, mask, truncate_halfwidth=truncate_halfwidth,
                     normalize=normalize)
    gb = apply_gauss(x, sb, mask, truncate_halfwidth=truncate_halfwidth,
                     normalize=normalize)
    return ga - gb


def apply_log(
    x: jax.Array,
    sigma,
    mask: Optional[jax.Array] = None,
    delta_sigma_over_sigma: float = 0.02,
    truncate_ratio: float = 2.5,
) -> jax.Array:
    """Scale-normalized Laplacian-of-Gaussian approximated by a DoG at
    sigma*(1 -+ delta/2), multiplied by 1/delta^2
    (``filter3d.hpp:1408-1557``)."""
    s = _sigma3(sigma)
    d = delta_sigma_over_sigma
    sa = tuple(si * (1.0 - 0.5 * d) for si in s)
    sb = tuple(si * (1.0 + 0.5 * d) for si in s)
    # reference: halfwidth = floor(ratio * max(sa, sb)), NO min-1 clamp
    # (filter3d.hpp:1496-1500); tiny sigmas hit the assert there, so we
    # clamp to >= 1 which only affects configs the reference rejects.
    hw = [max(1, int(np.floor(truncate_ratio * max(a, b))))
          for a, b in zip(sa, sb)]
    out = apply_dog(x, sa, sb, mask, truncate_halfwidth=hw)
    return out * (1.0 / (d * d))


def local_fluctuations(
    x: jax.Array,
    sigma,
    mask: Optional[jax.Array] = None,
    m_exp: float = 2.0,
    truncate_ratio: float = 2.5,
    normalize: bool = True,
) -> jax.Array:
    """Local RMS intensity fluctuation around the local (Gaussian-
    weighted) mean: sqrt(wpeak * blur((x - blur(x))^2)) where wpeak is
    the peak of the normalized weight kernel (``filter3d.hpp:1700-1925``).
    """
    s = _sigma3(sigma)
    hws = tuple(int(np.floor(si * truncate_ratio)) for si in s)
    wker = K.gen_gauss_kernel_3d(s, m_exp, hws)
    wpeak = float(wker[hws[2], hws[1], hws[0]])
    if m_exp == 2.0:
        mean = apply_gauss(x, s, mask, truncate_ratio=truncate_ratio,
                           normalize=normalize)
    else:
        mean = dense_conv3d(x, wker, mask=mask, normalize=normalize)
    p = x - mean
    p2 = p * p
    if m_exp == 2.0:
        var = apply_gauss(p2, s, mask, truncate_ratio=truncate_ratio,
                          normalize=normalize)
    else:
        var = dense_conv3d(p2, wker, mask=mask, normalize=normalize)
    var = jnp.maximum(var * wpeak, 0.0)
    return jnp.sqrt(var)


def local_fluctuations_by_radius(
    x: jax.Array,
    radius,
    mask: Optional[jax.Array] = None,
    m_exp: float = 2.0,
    truncate_ratio: float = 2.5,
    normalize: bool = True,
) -> jax.Array:
    """Radius interface: sigma = r / (9*pi/2)^(1/6)
    (``filter3d.hpp:1841-1925``)."""
    r = _sigma3(radius)
    ratio = (4.5 * np.pi) ** (1.0 / 6.0)
    sigma = tuple(ri / ratio for ri in r)
    return local_fluctuations(x, sigma, mask, m_exp, truncate_ratio, normalize)


def sphere_footprint_offsets(radius_xyz) -> np.ndarray:
    """Integer offsets (dz, dy, dx) inside an ellipsoid of the given
    per-axis radius (x, y, z), matching the reference's footprint
    criterion (ix/rx)^2+(iy/ry)^2+(iz/rz)^2 <= 1 used by MedianSphere
    (``filter3d.hpp:1640-1674``)."""
    rx, ry, rz = _sigma3(radius_xyz)
    hx, hy, hz = (int(np.floor(r)) for r in (rx, ry, rz))
    offs = []
    for dz in range(-hz, hz + 1):
        for dy in range(-hy, hy + 1):
            for dx in range(-hx, hx + 1):
                s = 0.0
                s += (dx / rx) ** 2 if rx > 0 else (0.0 if dx == 0 else np.inf)
                s += (dy / ry) ** 2 if ry > 0 else (0.0 if dy == 0 else np.inf)
                s += (dz / rz) ** 2 if rz > 0 else (0.0 if dz == 0 else np.inf)
                if s <= 1.0:
                    offs.append((dz, dy, dx))
    return np.asarray(offs, dtype=np.int32)


@functools.partial(jax.jit, static_argnames=("offsets",))
def _median_impl(x, mask, offsets):
    stack = []
    valid = []
    base_valid = jnp.ones(x.shape, dtype=bool) if mask is None else (mask != 0)
    for dz, dy, dx in offsets:
        shifted = _shift3(x, (dz, dy, dx), fill=np.inf)
        v = _shift3(base_valid.astype(jnp.float32), (dz, dy, dx), fill=0.0) > 0
        stack.append(jnp.where(v, shifted, jnp.inf))
        valid.append(v)
    vals = jnp.stack(stack)                      # (K, Z, Y, X)
    nvalid = jnp.sum(jnp.stack(valid), axis=0)   # (Z, Y, X) int
    svals = jnp.sort(vals, axis=0)
    idx = jnp.clip(nvalid // 2, 0, len(offsets) - 1)
    med = jnp.take_along_axis(svals, idx[None], axis=0)[0]
    med = jnp.where(nvalid > 0, med, x)
    if mask is not None:
        med = jnp.where(mask != 0, med, x)
    return med


def median_filter(
    x: jax.Array,
    radius,
    mask: Optional[jax.Array] = None,
) -> jax.Array:
    """Median over a spherical footprint. Out-of-bounds / masked-out
    neighbors are excluded from the median, as in the reference
    (``filter3d.hpp:1577-1674``); where the mask is 0 at the output
    voxel the input is passed through unchanged (the reference leaves
    those voxels unwritten).

    Formulation: gather the K footprint neighbors into a (K, Z, Y,
    X) stack (K static shifted copies), sort along K with invalid
    entries pushed to +inf, then select element floor(n_valid/2) --
    a vectorized replacement for nth_element.
    """
    offs = tuple(
        (int(a), int(b), int(c)) for a, b, c in sphere_footprint_offsets(radius)
    )
    return _median_impl(jnp.asarray(x, jnp.float32), mask, offs)


def _shift3(x: jax.Array, dzyx, fill=0.0) -> jax.Array:
    """Shift so out[p] = x[p + d] (neighbor gather), filling
    out-of-bounds with ``fill``."""
    out = x
    for axis, d in enumerate(dzyx):
        if d == 0:
            continue
        n = out.shape[axis]
        pad = [(0, 0)] * out.ndim
        sl = [slice(None)] * out.ndim
        if d > 0:
            pad[axis] = (0, d)
            sl[axis] = slice(d, d + n)
        else:
            pad[axis] = (-d, 0)
            sl[axis] = slice(0, n)
        out = jnp.pad(out, pad, constant_values=fill)[tuple(sl)]
    return out
