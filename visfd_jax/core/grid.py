"""VoxelGrid: the device-side array model.

The reference holds voxel data as host ``float***`` arrays
(``mrc_simple.hpp:56-58``); here a grid is a (Z, Y, X) float32
``jax.Array`` plus physical voxel width and an optional mask, designed
to live in HBM and shard over a device mesh (see
``visfd_jax.parallel``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class VoxelGrid:
    """A 3-D voxel image on device.

    Attributes:
      data: (Z, Y, X) float32 array.
      voxel_width: physical width of one voxel, per axis (x, y, z).
        1.0 means "work in voxel units".
      mask: optional (Z, Y, X) float32 array; 0 = ignore this voxel.
        Non-binary values act as averaging weights, matching the
        reference's mask semantics (``filter1d.hpp:246-258``).
    """

    data: jax.Array
    voxel_width: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    mask: Optional[jax.Array] = None

    @classmethod
    def from_numpy(
        cls,
        data: np.ndarray,
        voxel_width=(1.0, 1.0, 1.0),
        mask: Optional[np.ndarray] = None,
        sharding=None,
    ) -> "VoxelGrid":
        if np.isscalar(voxel_width):
            voxel_width = (float(voxel_width),) * 3
        dev = jax.device_put(jnp.asarray(data, dtype=jnp.float32), sharding)
        m = None
        if mask is not None:
            m = jax.device_put(jnp.asarray(mask, dtype=jnp.float32), sharding)
        return cls(data=dev, voxel_width=tuple(voxel_width), mask=m)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.data.shape)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.data)
