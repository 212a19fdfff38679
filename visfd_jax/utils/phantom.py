"""Seeded synthetic tomograms for tests and on-device smoke runs."""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Planted sheets, as fractions of the volume: two horizontal sheets at
# z = 0.25*nz and z = 0.70*nz, and one tilted sheet with unit normal
# (z, y) = (0.8, 0.6) through (z, y) = (0.45*nz, 0.5*ny).
SHEET_Z = (0.25, 0.70)
TILT_NORMAL_ZY = (0.8, 0.6)
TILT_CENTER_ZY = (0.45, 0.5)
# The tilted sheet is drawn darker: sampled off the voxel grid, its
# ridge response peaks lower, and at equal contrast it would lose the
# -tv-best ranking to the two grid-aligned sheets.
TILT_CONTRAST = 1.5


def sheet_distances(shape: Tuple[int, int, int]):
    """Distance in voxels of every voxel to each planted sheet, as a
    list of three broadcastable numpy arrays (the two horizontal sheets,
    then the tilted one)."""
    nz, ny, _ = shape
    zz = np.arange(nz, dtype=np.float64)[:, None, None]
    yy = np.arange(ny, dtype=np.float64)[None, :, None]
    out = [np.abs(zz - f * nz) for f in SHEET_Z]
    (az, ay), (cz, cy) = TILT_NORMAL_ZY, TILT_CENTER_ZY
    out.append(np.abs(az * (zz - cz * nz) + ay * (yy - cy * ny)))
    return out


@functools.partial(jax.jit, static_argnames=("shape", "thickness",
                                             "noise"))
def _phantom(key, shape, thickness, noise):
    nz, ny, _ = shape
    zz = jax.lax.broadcasted_iota(jnp.float32, shape, 0)
    yy = jax.lax.broadcasted_iota(jnp.float32, shape, 1)
    s2 = 2.0 * thickness * thickness
    sheets = sum(jnp.exp(-(zz - f * nz) ** 2 / s2) for f in SHEET_Z)
    (az, ay), (cz, cy) = TILT_NORMAL_ZY, TILT_CENTER_ZY
    tilt = az * (zz - cz * nz) + ay * (yy - cy * ny)
    sheets = sheets + TILT_CONTRAST * jnp.exp(-tilt ** 2 / s2)
    return noise * jax.random.normal(key, shape, jnp.float32) - sheets


def membrane_phantom(shape: Tuple[int, int, int], seed: int = 0,
                     thickness: float = 2.5,
                     noise: float = 0.05) -> jax.Array:
    """A (Z, Y, X) float32 volume of three dark Gaussian-profile sheets
    (``thickness`` is the profile's standard deviation in voxels) in
    weak Gaussian noise drawn from ``seed``: the input of the
    ``-membrane minima`` workflow.  Generated on the default device."""
    return _phantom(jax.random.key(seed), tuple(int(n) for n in shape),
                    float(thickness), float(noise))
