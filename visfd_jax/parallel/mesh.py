"""Device-mesh construction and voxel-grid shardings.

The reference scales only via intra-node OpenMP loops
(``filter3d.hpp:172`` etc.); the equivalent here is a
(Z, Y)-block partition of the (Z, Y, X) voxel grid over a named
``jax.sharding.Mesh``.  X (the fastest axis) stays unsharded so
accesses along it stay contiguous and 1-D convolutions along X remain
local;
stencils across Z/Y shard boundaries use halo exchange
(``visfd_jax.parallel.halo``) over collectives.  The mesh shape
follows the algorithm alone (fewest halo faces): the GPUs of a host
reach each other all to all at one rate.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("z", "y")) -> Mesh:
    """Build a (z, y) mesh over the available devices: prefers a
    near-square factorization so halo surface area is minimized."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    # factor n = nz * ny with nz >= ny, nz as small as possible
    best = (n, 1)
    for ny in range(1, int(np.sqrt(n)) + 1):
        if n % ny == 0:
            best = (n // ny, ny)
    nz, ny = best
    arr = np.asarray(devs).reshape(nz, ny)
    return Mesh(arr, axis_names)


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """(Z, Y, X) voxel grid sharded over (z, y); X replicated."""
    return NamedSharding(mesh, P(mesh.axis_names[0], mesh.axis_names[1]))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def grid_mesh_of(x):
    """The concrete 2-axis (z, y) Mesh behind a NamedSharding that
    block-shards exactly the first two axes of a (Z, Y, X[, C]) array
    evenly -- the layout the CLI's ``-mesh`` / ``grid_sharding`` use.
    Returns None for any other sharding (callers then run the
    GSPMD-partitioned XLA path)."""
    sh = getattr(x, "sharding", None)
    mesh = getattr(sh, "mesh", None)
    spec = getattr(sh, "spec", None)
    if mesh is None or spec is None:
        return None
    try:
        axes = tuple(mesh.axis_names)
    except Exception:
        return None
    if len(axes) != 2:
        return None

    def norm(e):
        if isinstance(e, tuple):
            return e[0] if len(e) == 1 else e
        return e

    got = tuple(norm(e) for e in tuple(spec))
    got = got + (None,) * (x.ndim - len(got))
    if got[:2] != axes or any(g is not None for g in got[2:]):
        return None
    sizes = dict(zip(axes, mesh.devices.shape))
    if (x.shape[0] % sizes[axes[0]] != 0
            or x.shape[1] % sizes[axes[1]] != 0):
        return None  # uneven blocks: shard_map cannot partition
    return mesh
