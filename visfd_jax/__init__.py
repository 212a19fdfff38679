"""visfd_jax: volumetric feature detection in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference C++ library "visfd" (Volumetric Image toolkit for Simple
Feature Detection): masked separable Gaussian/DoG/LoG filtering,
grayscale morphology, scale-free blob detection with non-max
suppression, tensor-voting surface/curve saliency, watershed and
direction-aware connected-component segmentation, MRC/REC I/O,
sphere/region annotation, and oriented point-cloud export.

Voxel images are (Z, Y, X) float32 arrays (X fastest -- matches MRC
storage order and keeps X contiguous for coalesced access). All hot
compute paths are jit-compiled XLA, plus one Pallas kernel on the
Triton route for tensor voting on a GPU; large volumes shard over a
``jax.sharding.Mesh`` with halo exchange for stencils.
"""

__version__ = "0.1.0"

from visfd_jax.core.grid import VoxelGrid  # noqa: F401
