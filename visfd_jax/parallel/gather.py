"""Multi-process-safe host materialization.

In a multi-process (multi-host) run, a mesh-sharded ``jax.Array``
spans devices of OTHER processes, and ``np.asarray`` on it raises
"Fetching value for jax.Array that spans non-addressable devices".
The reference has no such concept (one process, one address space;
``mrc_simple.cpp`` just writes the buffer), so every terminal host
consumer in the CLI -- file writers, the host floods, the
PLY walker -- funnels through :func:`to_host_np`, which all-gathers
process-spanning arrays (``multihost_utils.process_allgather``, one
collective) and is a plain ``np.asarray`` in the common
single-process case.

File writes are additionally gated on :func:`is_writer` (process 0)
so N processes running the same SPMD CLI command produce one output
file, not N racing writers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def to_host_np(arr, dtype=None) -> Optional[np.ndarray]:
    """``np.asarray(arr)`` that also works on process-spanning global
    arrays (gathered with one ``process_allgather`` collective).

    MUST be called by every process in the cluster (it is a collective
    when the array is not locally materializable); returns the full
    global array on each.  ``None`` passes through."""
    if arr is None:
        return None
    import jax

    if isinstance(arr, jax.Array) and not (
            arr.is_fully_addressable or arr.is_fully_replicated):
        from jax.experimental import multihost_utils
        arr = multihost_utils.process_allgather(arr, tiled=True)
    return np.asarray(arr) if dtype is None else np.asarray(arr, dtype)


def is_writer() -> bool:
    """True on the process that should perform file writes (process 0;
    trivially true single-process)."""
    import jax

    return jax.process_index() == 0
