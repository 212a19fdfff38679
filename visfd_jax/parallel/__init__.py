from visfd_jax.parallel.mesh import make_mesh, grid_sharding  # noqa: F401
from visfd_jax.parallel.halo import halo_pad  # noqa: F401
