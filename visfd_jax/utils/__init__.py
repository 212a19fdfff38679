from visfd_jax.utils.progress import (Report, stage,  # noqa: F401
                                      record_path, stage_paths,
                                      reset_paths, format_paths)
from visfd_jax.utils.profiling import device_trace, stage_timings  # noqa: F401
from visfd_jax.utils.cache import enable_compile_cache  # noqa: F401
