"""Multi-host (multi-process) initialization.

The reference parallelizes only within one node (OpenMP,
``filter3d.hpp:172``); here the scaling story is a single
``jax.sharding.Mesh`` spanning every device of every host.  Under GSPMD
the same ``shard_map``/halo/psum code in this package then runs
unmodified: on GPUs the collectives go through NCCL, over NVLink within
a host and the network across hosts -- nothing in the compute path is
host-aware.

What a multi-host launch needs (and all it needs):

1. every process calls :func:`init_distributed` FIRST (before any
   other jax call);
2. every process runs the *same* program (same CLI command / script);
3. meshes are then built from the global device list
   (``visfd_jax.parallel.mesh.make_mesh`` already uses
   ``jax.devices()``, which is global after initialization).

Example -- 2 hosts, one process per host::

    # host 0                                  # host 1
    VISFD_COORDINATOR=10.0.0.1:8476 \
    VISFD_NUM_PROCESSES=2 VISFD_PROCESS_ID=0  ...=1
    python -m visfd_jax.cli.filter_mrc -mesh -1 -in big.rec ...

Where a cluster manager (SLURM, ...) describes the job,
``jax.distributed.initialize()`` can detect all three values itself;
elsewhere they must be given.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

_initialized = False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kw,
) -> bool:
    """Initialize multi-process JAX (idempotent).

    Arguments default to the ``VISFD_COORDINATOR`` /
    ``VISFD_NUM_PROCESSES`` / ``VISFD_PROCESS_ID`` environment
    variables; with only some of them set, ``jax.distributed.
    initialize()`` detects the rest itself (SLURM, ...).  Returns True
    when a multi-process runtime was started, False for the
    single-process no-op.
    """
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "VISFD_COORDINATOR")
    if num_processes is None and "VISFD_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["VISFD_NUM_PROCESSES"])
    if process_id is None and "VISFD_PROCESS_ID" in os.environ:
        process_id = int(os.environ["VISFD_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        # multi-process mode is strictly opt-in: with nothing
        # requested, stay single-process rather than hang waiting for
        # a coordinator (auto-detecting a cluster here is unsafe:
        # single-host tooling sets cluster-like env vars too)
        return False
    try:  # private API: absent/renamed across JAX versions
        from jax._src import xla_bridge
        backends_up = xla_bridge.backends_are_initialized()
    except (ImportError, AttributeError):
        backends_up = False  # cannot check; proceed and let
        # jax.distributed.initialize raise if it is truly too late
    if backends_up:
        import warnings
        warnings.warn(
            "visfd_jax: multi-host init requested but the JAX backend "
            "is already initialized; continuing single-process. Call "
            "init_distributed() before any other JAX use.")
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kw,
    )
    _initialized = True
    return True


def shutdown_distributed() -> None:
    """Tear down the multi-process runtime (test/teardown helper)."""
    global _initialized
    if _initialized:
        jax.distributed.shutdown()
        _initialized = False
