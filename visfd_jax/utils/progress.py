"""Structured progress reporting.

The reference threads an optional ``ostream *pReportProgress`` through
every long-running function (``filter3d.hpp:695``, ``feature.hpp:75``,
``connect.hpp:197``) and prints plane counters / percent-complete
lines.  Here the unit of work is a jitted stage, not a scanline, so
the equivalent is a per-stage timer that reports wall time (first call
includes compile time -- reported separately on recompile) around
``block_until_ready()`` boundaries.

Usage::

    rep = Report(sys.stderr)
    with stage("tensor voting", rep):
        vote = tv_dense_stick(...)
        jax.block_until_ready(vote)

``Report(None)`` silences everything (like passing a null
pReportProgress).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, TextIO


class Report:
    """A progress sink; ``write()`` mirrors the ostream protocol so the
    segmentation modules' ``report=`` arguments accept it too."""

    def __init__(self, stream: Optional[TextIO] = None):
        self.stream = stream
        self.timings = {}  # stage name -> seconds (last run)

    def write(self, msg: str) -> None:
        if self.stream is not None:
            self.stream.write(msg)
            self.stream.flush()

    def line(self, msg: str) -> None:
        self.write(msg + "\n")


# ---------------------------------------------------------------------------
# Execution-path telemetry: which implementation served each stage.
#
# The CLI's Pallas kernels carry try/except fallbacks to the XLA
# formulations (a correctness net for Mosaic compile limits), but a
# silent fallback costs 6-15x (PERF.md) -- operators must be able to
# SEE which path ran.  Each dispatch site records (stage -> path) here
# and the drivers print one structured summary line; tests assert that
# no "*fallback*" path fired where the fast path is expected.

_stage_paths: dict = {}


def record_path(stage_name: str, path: str) -> None:
    """Record which implementation served ``stage_name`` (e.g.
    ``"tv": "pallas-sharded-sparse"`` or ``"tv": "xla-fallback"``)."""
    _stage_paths[stage_name] = path


def stage_paths() -> dict:
    return dict(_stage_paths)


def reset_paths() -> None:
    _stage_paths.clear()


def format_paths() -> str:
    """One grep-able summary line, e.g.
    ``stage paths: hessian_eigen=pallas-fused tv=pallas-sparse``."""
    body = " ".join(f"{k}={v}" for k, v in _stage_paths.items())
    return f"stage paths: {body}" if body else "stage paths: (none)"


@contextlib.contextmanager
def stage(name: str, report: Optional[Report] = None):
    """Time a pipeline stage; records into ``report.timings``."""
    rep = report if report is not None else Report(None)
    rep.line(f"---- {name} ----")
    t0 = time.perf_counter()
    try:
        yield rep
    finally:
        dt = time.perf_counter() - t0
        rep.timings[name] = dt
        rep.line(f"---- {name}: {dt:.3f}s ----")
