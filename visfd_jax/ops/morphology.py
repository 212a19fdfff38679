"""Grayscale morphology: dilate/erode with arbitrary structuring
elements, spherical variants with anti-aliased soft edges, opening/
closing/top-hats.

Parity with ``lib/visfd/morphology.hpp:132-590``:

* Dilation = max over the footprint of (f + b); erosion = min of
  (f - b). Out-of-bounds and masked-out neighbors are skipped; where
  the output voxel itself is masked out the input passes through
  (the reference leaves dest unwritten there).
* Sphere structuring elements: flat (b=0, r <= radius); soft shell
  between radius and radius_max with b ramping 0 .. -bmax; or the
  8-corner anti-aliasing test when bmax != 0 and radius_max <= radius
  (``morphology.hpp:276-309``).
* Top-hats in the standard form the reference's handlers produce:
  white = src - open(src), black = close(src) - src.

Formulation: each footprint tap is a shifted array; max/min
reduce across taps in a static unrolled chain that XLA fuses (an
offset max-pool).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from visfd_jax.ops.filters import _shift3


def sphere_structure_element(
    radius: float,
    radius_max: float = 0.0,
    bmax: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets (K,3) as (dz,dy,dx), b-values (K,)) for the reference's
    spherical SE (``morphology.hpp:286-365``)."""
    ri = int(np.ceil(max(radius, radius_max)))
    offs, bs = [], []
    for dz in range(-ri, ri + 1):
        for dy in range(-ri, ri + 1):
            for dx in range(-ri, ri + 1):
                add, b = False, 0.0
                if bmax == 0.0:
                    if np.sqrt(dx * dx + dy * dy + dz * dz) <= radius:
                        add = True
                elif radius_max > radius:
                    r = np.sqrt(dx * dx + dy * dy + dz * dz)
                    if r <= radius:
                        add = True
                    elif r <= radius_max:
                        add = True
                        b = -bmax * (r - radius) / (radius_max - radius)
                else:
                    # 8-corner anti-aliasing test
                    corners = [
                        np.sqrt((dx + jx - 0.5) ** 2 + (dy + jy - 0.5) ** 2
                                + (dz + jz - 0.5) ** 2)
                        for jz in (0, 1) for jy in (0, 1) for jx in (0, 1)
                    ]
                    r_min, r_max = min(corners), max(corners)
                    if r_max < radius:
                        add = True
                    elif r_min > radius:
                        add = False
                    else:
                        add = True
                        b = -bmax * (r_max - radius) / (r_max - r_min)
                if add:
                    offs.append((dz, dy, dx))
                    bs.append(b)
    return np.asarray(offs, np.int32), np.asarray(bs, np.float32)


@functools.partial(jax.jit, static_argnames=("offsets", "bvals", "is_dilate"))
def _morph_impl(x, mask, offsets, bvals, is_dilate):
    neg_inf = jnp.asarray(-np.inf, x.dtype)
    best = jnp.full(x.shape, neg_inf if is_dilate else -neg_inf, x.dtype)
    valid_src = None if mask is None else (mask != 0)
    for (dz, dy, dx), b in zip(offsets, bvals):
        f = _shift3(x, (dz, dy, dx), fill=np.nan)
        ok = ~jnp.isnan(f)
        if valid_src is not None:
            ok &= _shift3(valid_src.astype(jnp.float32), (dz, dy, dx), 0.0) > 0
        if is_dilate:
            cand = jnp.where(ok, f + b, neg_inf)
            best = jnp.maximum(best, cand)
        else:
            cand = jnp.where(ok, f - b, -neg_inf)
            best = jnp.minimum(best, cand)
    if mask is not None:
        best = jnp.where(mask != 0, best, x)
    return best


def _as_static(offsets, bvals):
    return (tuple((int(a), int(b), int(c)) for a, b, c in offsets),
            tuple(float(v) for v in bvals))


def dilate(x, offsets, bvals, mask=None):
    """Grayscale dilation max(f + b) over the footprint
    (``morphology.hpp:132-174``)."""
    o, b = _as_static(offsets, bvals)
    return _morph_impl(jnp.asarray(x, jnp.float32), mask, o, b, True)


def erode(x, offsets, bvals, mask=None):
    """Grayscale erosion min(f - b) over the footprint
    (``morphology.hpp:183-231``)."""
    o, b = _as_static(offsets, bvals)
    return _morph_impl(jnp.asarray(x, jnp.float32), mask, o, b, False)


def dilate_sphere(x, radius, mask=None, radius_max=0.0, bmax=0.0):
    o, b = sphere_structure_element(radius, radius_max, bmax)
    return dilate(x, o, b, mask)


def erode_sphere(x, radius, mask=None, radius_max=0.0, bmax=0.0):
    o, b = sphere_structure_element(radius, radius_max, bmax)
    return erode(x, o, b, mask)


def open_sphere(x, radius, mask=None, radius_max=0.0, bmax=0.0):
    """Erosion then dilation (``morphology.hpp:428-467``)."""
    return dilate_sphere(
        erode_sphere(x, radius, mask, radius_max, bmax),
        radius, mask, radius_max, bmax)


def close_sphere(x, radius, mask=None, radius_max=0.0, bmax=0.0):
    """Dilation then erosion (``morphology.hpp:472-508``)."""
    return erode_sphere(
        dilate_sphere(x, radius, mask, radius_max, bmax),
        radius, mask, radius_max, bmax)


def white_top_hat_sphere(x, radius, mask=None, radius_max=0.0, bmax=0.0):
    """src - opening (``morphology.hpp:515-549``)."""
    return jnp.asarray(x, jnp.float32) - open_sphere(x, radius, mask,
                                                     radius_max, bmax)


def black_top_hat_sphere(x, radius, mask=None, radius_max=0.0, bmax=0.0):
    """closing - src (``morphology.hpp:554-590``)."""
    return close_sphere(x, radius, mask, radius_max, bmax) - jnp.asarray(
        x, jnp.float32)
