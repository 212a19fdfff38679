"""combine_mrc: voxelwise + - * / of two MRC volumes with optional
per-input/output Threshold4, mask, and 0..1 rescaling.

Parity with ``bin/combine_mrc/combine_mrc.cpp:16-200``. File
arguments may carry comma-suffixed thresholds:
``file.mrc,a[,b[,c[,d]]]`` (1 value = step threshold, 2 = ramp,
4 = trapezoid). Usage:
``python -m visfd_jax.cli.combine_mrc [opts] in1[,t...] OP in2[,t...]
out[,t...]``
"""

from __future__ import annotations

import sys

import numpy as np

from visfd_jax.io import mrc
from visfd_jax.ops import threshold as T


def _parse_file_arg(arg):
    parts = arg.split(",")
    name = parts[0]
    th = None
    if len(parts) > 1:
        vals = [float(v) for v in parts[1:]]
        a = vals[0]
        b = vals[1] if len(vals) > 1 else a
        c = vals[2] if len(vals) > 2 else b
        d = vals[3] if len(vals) > 3 else c
        th = (a, b, c, d)
    return name, th


def _apply_th4(x, th):
    a, b, c, d = th
    if (b == c) and (b == d):
        # Threshold4 degenerates to Threshold2 (threshold.hpp:127-130)
        if a == b:
            return np.where(x > a, 1.0, 0.0).astype(np.float32)
        return np.asarray(T.threshold2(x, a, b), np.float32)
    return np.asarray(T.threshold4(x, a, b, c, d), np.float32)


def run(argv) -> int:
    args = list(argv)
    mask_name = ""
    use_mask_select = False
    mask_select = 1
    use_mask_out = False
    mask_out = 0.0
    rescale = False
    pos = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-mask":
            mask_name = args[i + 1]; i += 1
        elif a == "-mask-select":
            use_mask_select = True; mask_select = int(args[i + 1]); i += 1
        elif a == "-mask-out":
            use_mask_out = True; mask_out = float(args[i + 1]); i += 1
        elif a == "-rescale":
            rescale = True
        elif a == "-norescale":
            rescale = False
        else:
            pos.append(a)
        i += 1
    if len(pos) != 4:
        print("Usage: combine_mrc in1[,thresh...] OP in2[,thresh...] "
              "out[,thresh...]", file=sys.stderr)
        return 1
    in1, th1 = _parse_file_arg(pos[0])
    op = pos[1][0]
    in2, th2 = _parse_file_arg(pos[2])
    out_name, th_out = _parse_file_arg(pos[3])

    img1 = mrc.read_mrc(in1, rescale=rescale and th1 is None)
    img1.header.print_stats(sys.stderr)
    img2 = mrc.read_mrc(in2, rescale=rescale and th2 is None)
    img2.header.print_stats(sys.stderr)
    if img1.data.shape != img2.data.shape:
        print("Error: The size of the two input tomograms does not match.",
              file=sys.stderr)
        return 1
    x1, x2 = img1.data, img2.data
    if th1 is not None:
        x1 = _apply_th4(x1, th1)
    if th2 is not None:
        x2 = _apply_th4(x2, th2)

    mask = None
    if mask_name:
        mask = mrc.read_mrc(mask_name).data
        if use_mask_select:
            mask = np.where(mask == mask_select, 1.0, 0.0)

    with np.errstate(divide="ignore", invalid="ignore"):
        if op == "+":
            out = x1 + x2
        elif op == "-":
            out = x1 - x2
        elif op == "*":
            out = x1 * x2
        elif op == "/":
            out = x1 / x2
        else:
            print(f'Error: Unrecognized binary operation: "{op}"',
                  file=sys.stderr)
            return 1
    if mask is not None:
        out = np.where(mask == 0, x1, out)

    if th_out is not None:
        th_applied = _apply_th4(out, th_out)
        out = np.where(mask == 0, out, th_applied) if mask is not None \
            else th_applied
    if mask is not None and use_mask_out:
        out = np.where(mask == 0, mask_out, out)
    oimg = mrc.MrcImage(header=img1.header, data=np.asarray(out, np.float32))
    if rescale:
        oimg.rescale01(mask)
    oimg.write(out_name)
    return 0


def main():
    return run(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
