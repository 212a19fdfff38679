"""Time the phase-1 membrane CLI with each tensor-voting path.

    python tools/compare_tv_paths.py [Z Y X]

Runs ``chip_smoke``'s phase-1 command (``-membrane ... -tv ...
-save-progress``) on the seeded membrane phantom, in one process,
through the Triton kernel and with the XLA shift-sum forced, in the
order kernel, XLA, XLA, kernel, and prints each run's wall time and
spans, or the error that stopped it.  Needs a GPU; the default size is
the smoke's 1024x1024x256.
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main(argv):
    import jax
    import numpy as np
    from visfd_jax.features import tv as TV
    from visfd_jax.io import mrc
    from visfd_jax.utils import enable_compile_cache
    from visfd_jax.utils.phantom import membrane_phantom
    shape = tuple(int(v) for v in argv[:3]) or chip_smoke.SHAPE
    if jax.devices()[0].platform != "gpu":
        print("compare_tv_paths: needs a GPU", file=sys.stderr)
        return 3
    card = chip_smoke.card_line()
    enable_compile_cache()
    kernel_rule = TV.use_triton_tv
    with tempfile.TemporaryDirectory() as work:
        src = os.path.join(work, "phantom.mrc")
        mrc.write_mrc(src, np.asarray(membrane_phantom(shape)))
        argv = (["-in", src, "-out", os.path.join(work, "out.mrc")]
                + chip_smoke.PHASE1.format(
                    prog=os.path.join(work, "prog"),
                    tv=chip_smoke.TV_SCALE).split())
        for path in ("triton", "xla", "xla", "triton"):
            TV.use_triton_tv = (kernel_rule if path == "triton"
                                else lambda platform=None: False)
            try:
                dt, paths, spans = chip_smoke._run_cli(argv)
            except (RuntimeError, jax.errors.JaxRuntimeError) as e:
                chip_smoke.say(card, f"phase 1 {shape} with {path} TV "
                                     f"failed: {str(e)[:300]}")
                continue
            chip_smoke.say(card, f"phase 1 {shape} with {path} TV: "
                                 f"{dt:.3f} s; {paths}; {spans}")
    TV.use_triton_tv = kernel_rule
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
