from visfd_jax.linalg.sym3 import (  # noqa: F401
    EigenOrder,
    diagonalize_sym3,
    principal_sym3,
    diagonalize_flat_sym3,
    undiagonalize_flat_sym3,
    flat_to_full,
    full_to_flat,
    matrix_to_shoemake,
    shoemake_to_matrix,
)
