from visfd_jax.io.mrc import MrcHeader, MrcImage, read_mrc, write_mrc  # noqa: F401
