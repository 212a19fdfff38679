"""Phase checkpoints for ``-save-progress-sharded`` /
``-load-progress-sharded``.

The reference's only checkpoint/resume is ``-save-progress F`` /
``-load-progress F``, which round-trips the 6 tensor-voting channels
through host ``F_tensor_{0..5}.rec`` files
(``handlers.cpp:1840-1922``).  These extensions persist the whole
phase state (vote tensor, saliency, direction fields) in one
directory, one ``<name>.npy`` file per array, gathered to the host
(``parallel.gather.to_host_np``) and written by process 0.  Loading
returns host arrays; the CLI places them on its mesh.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from visfd_jax.parallel.gather import is_writer, to_host_np


def save_state(path: str, arrays: Dict[str, object]) -> None:
    """Write each (possibly sharded) array of ``arrays`` as float32
    ``<path>/<name>.npy``.  The gathers are collectives: every process
    calls this, process 0 writes."""
    host = {name: to_host_np(a, np.float32) for name, a in arrays.items()}
    if not is_writer():
        return
    os.makedirs(path, exist_ok=True)
    for name, a in host.items():
        np.save(os.path.join(path, name + ".npy"), a)


def load_state(path: str) -> Dict[str, np.ndarray]:
    """The arrays :func:`save_state` wrote under ``path``, by name."""
    if not os.path.isdir(path):
        raise OSError(f'phase checkpoint "{path}" is not a directory')
    return {f[:-4]: np.load(os.path.join(path, f))
            for f in sorted(os.listdir(path)) if f.endswith(".npy")}
