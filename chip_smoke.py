"""Smoke run of the membrane-detection CLI on one GPU.

    python chip_smoke.py            # one card
    python chip_smoke.py --mesh4    # the -mesh 4 path on four cards

On one card it runs, in one process:

1. the main path: the README's two-phase membrane workflow through
   ``visfd_jax.cli.filter_mrc.run`` on a seeded 1024x1024x256 membrane
   phantom, cold and warm, checking outputs, recorded stage paths, and
   that the planted sheets come out as the largest clusters;
2. the kernel phase: the Triton tensor-voting kernel
   (``ops/tv_triton.py``), compiled for the card at the smoke's full
   width, against the XLA shift-sum at vote half-widths 2, 3, 5 and 9
   (the CLI phases' window), dense and sparse, with the time of each;
3. the XLA stages that have no kernel (blur, Hessian -> eigen -> score):
   time and share of the card's memory-bandwidth roofline.

With ``--mesh4`` it runs only the two CLI phases with ``-mesh 4`` over
four cards and the same commands on one card, and compares them.

The last line of standard output is one JSON object; every earlier
number is printed beside the card's name and power limit.  The script
exits non-zero, printing no result, when JAX finds no GPU or the
package is missing.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SHAPE = (256, 1024, 1024)        # (Z, Y, X) voxels: 1.07 GB of float32
TV_HWS = (2, 3, 5, 9)
# z-planes of the XLA reference above half-width 5, around the first
# sheet: its whole-volume pass over z-slabs would take minutes there
REF_PLANES = 16
# Kernel vs XLA: max |difference| over max |vote|.  Both sum the same
# float32 terms (no matrix product) in different orders.
TV_TOL = 1e-5
# The README's membrane workflow without -bin: 55 A membranes at
# 19.2 A/voxel (sigma 1.65 voxels, below the auto-binning limit), -tv 4
# (a vote window of half-width 9), the default -tv-best 0.05.
TV_SCALE = 4.0
PHASE1 = ("-w 19.2 -membrane minima 55 -tv {tv} -tv-angle-exponent 4 "
          "-save-progress {prog}")
PHASE2 = ("-w 19.2 -membrane minima 55 -tv {tv} -tv-angle-exponent 4 "
          "-load-progress {prog} -connect 3e-4 -connect-angle 30")
MEMBRANE_SIGMA = 55.0 / 3 ** 0.5 / 19.2
# Peak device-memory bandwidth by device_kind (NVIDIA's H100 SXM data
# sheet); a card missing here is an error, not a default.
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them, read
    in a child process that stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0].strip()


def say(card: str, msg: str) -> None:
    print(f"[{card}] {msg}" if card else msg, flush=True)


def _best_time(fn, *args, reps=3):
    import jax
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def phantom_fields(shape, seed=0):
    """The CLI's -tv source fields on the membrane phantom: planar
    saliency thresholded at -tv-best 0.05 and the principal Hessian
    eigenvector."""
    import jax.numpy as jnp
    from visfd_jax.features import hessian as FH
    from visfd_jax.linalg import sym3
    from visfd_jax.parallel.reduce import fraction_threshold
    from visfd_jax.utils.phantom import membrane_phantom
    x = membrane_phantom(shape, seed=seed)
    score, direction = FH.ridge_score_direction(
        x, None, MEMBRANE_SIGMA, 2.5, sym3.EigenOrder.DECREASING, "planar")
    thr = fraction_threshold(score, 0.05)
    return jnp.where(score < thr, 0.0, score), direction


def xla_tv_by_slabs(sal, direction, hw, sigma, ratio, planes=None,
                    budget=16e9):
    """The XLA shift-sum (``features.tv.tv_accumulate_padded``) over
    z-slabs of the whole width: at this size it needs ~4 B x 5 fields x
    (2*hw+1)^2 of temporaries per voxel, more than one card holds for
    the whole volume.  Returns the (Z, Y, X, 6) raw votes of the
    z-planes ``planes`` = (z0, z1), by default all."""
    import jax
    import jax.numpy as jnp
    from visfd_jax.features import tv as TV
    nz, ny, nx = sal.shape
    z0, z1 = planes or (0, nz)
    w, rhat, offs, hw_t = TV.tv_tables(sigma, ratio)
    assert hw_t == hw
    per_plane = 4 * 5 * (2 * hw + 1) ** 2 * ny * nx
    slab = 1
    while slab * 2 <= z1 - z0 and (z1 - z0) % (slab * 2) == 0 \
            and slab * 2 * per_plane <= budget:
        slab *= 2
    pad = [(hw, hw)] * 3
    fields = (jnp.pad(sal, pad), jnp.pad(direction, pad + [(0, 0)]),
              jnp.pad(jnp.ones_like(sal), pad))

    @jax.jit
    def one(sal_pad, n_pad, m_pad, z0):
        cut = [jax.lax.dynamic_slice_in_dim(f, z0, slab + 2 * hw, 0)
               for f in (sal_pad, n_pad, m_pad)]
        return TV.tv_accumulate_padded(
            *cut, (slab, ny, nx), jnp.asarray(w), jnp.asarray(rhat),
            jnp.asarray(offs), 4, False, hw, False)[0]

    return jnp.concatenate([one(*fields, z) for z in range(z0, z1, slab)])


def kernel_phase(shape=SHAPE, hws=TV_HWS, card="", interpret=False):
    """The Triton TV kernel vs the XLA shift-sum on the phantom's
    thresholded saliency, dense and sparse, at each half-width; above
    half-width 5 on ``REF_PLANES`` z-planes through the first planted
    sheet.  Returns rows of (hw, sparse, rel_err, t_kernel, t_xla)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from visfd_jax.features import tv as TV
    from visfd_jax.utils.phantom import SHEET_Z
    sal, direction = phantom_fields(shape)
    say(card, f"kernel phase: {shape} voxels, occupancy "
              f"{float(jnp.mean(sal != 0)):.4f}")
    reps = 1 if interpret else 3
    rows = []
    for hw in hws:
        sigma = hw / 2 ** 0.5 + 1e-6          # floor(sigma * sqrt 2) == hw
        ratio = 2 ** 0.5
        z0, z1 = 0, shape[0]
        if hw > 5:
            z0 = max(0, int(SHEET_Z[0] * shape[0]) - REF_PLANES // 2)
            z1 = min(shape[0], z0 + REF_PLANES)
        with jax.default_matmul_precision("highest"):
            t_xla, ref = _best_time(
                lambda s, v: xla_tv_by_slabs(s, v, hw, sigma, ratio,
                                             planes=(z0, z1)),
                sal, direction, reps=1)
        scale = float(jnp.max(jnp.abs(ref)))
        for sparse in (False, True):
            def kern(s, v, sparse=sparse):
                return TV.tv_accumulate_triton(
                    s, v, None, sigma, ratio, 4, False, False,
                    sparse=sparse, interpret=interpret)[0]
            t0 = time.perf_counter()
            jax.block_until_ready(kern(sal, direction))
            t_first = time.perf_counter() - t0
            if hw == 3 and not sparse and not interpret:
                mem = jax.jit(kern).lower(sal, direction).compile() \
                    .memory_analysis()
                say(card, f"kernel hw=3 memory_analysis: {mem}")
            t_k, got = _best_time(kern, sal, direction, reps=reps)
            err = float(jnp.max(jnp.abs(got[z0:z1] - ref))) / scale
            del got
            mode = "sparse" if sparse else "dense"
            say(card, f"tv hw={hw} {mode}: triton {t_k:.6f} s (first "
                      f"call, compile included, {t_first:.3f} s), xla by "
                      f"z-slabs {t_xla:.6f} s over planes {z0}:{z1}, "
                      f"max|diff|/max|vote| "
                      f"{err:.3e} (tolerance {TV_TOL:.0e})")
            if not np.isfinite(err) or err > TV_TOL:
                raise AssertionError(
                    f"tv kernel hw={hw} {mode}: error {err:.3e} > {TV_TOL}")
            rows.append((hw, sparse, err, t_k, t_xla))
        del ref
    return rows


def xla_stage_phase(shape=SHAPE, card=""):
    """Time XLA's blur and Hessian -> eigen -> score, their bandwidth
    roofline share, and whether the 6-channel Hessian is written to
    device memory."""
    import jax
    from visfd_jax.features import hessian as FH
    from visfd_jax.linalg import sym3
    from visfd_jax.ops.filters import apply_gauss
    from visfd_jax.utils.phantom import membrane_phantom
    kind = jax.devices()[0].device_kind
    if kind not in PEAK_BYTES_PER_S:
        raise KeyError(f"no memory-bandwidth peak for {kind!r}")
    peak = PEAK_BYTES_PER_S[kind]
    x = membrane_phantom(shape)
    n = x.size
    sigma = MEMBRANE_SIGMA
    hw = max(1, int(sigma * 2.5))
    blur = jax.jit(lambda v: apply_gauss(v, sigma,
                                         truncate_halfwidth=(hw,) * 3))

    def hess_eig(b):
        hess = FH.hessian_fd(b) * (sigma * sigma)
        vals, v1 = sym3.principal_sym3(sym3.flat_to_full(hess),
                                       order=sym3.EigenOrder.DECREASING)
        return FH.score_hessian_planar(vals), v1

    hess_eig = jax.jit(hess_eig)
    t_b, b = _best_time(blur, x)
    t_h, _ = _best_time(hess_eig, b)
    mem = hess_eig.lower(b).compile().memory_analysis()
    hessian_bytes = 6 * 4 * n
    # least traffic: blur reads and writes one volume; the eigen stage
    # reads one and writes the score and the 3-vector direction
    for name, t, nbytes in (("blur", t_b, 2 * 4 * n),
                            ("hessian+eigen+score", t_h, 5 * 4 * n)):
        say(card, f"xla {name}: {t:.6f} s, {nbytes / t / 1e9:.1f} GB/s, "
                  f"{nbytes / t / peak:.3f} of the {peak / 1e12:.2f} TB/s "
                  f"roofline")
    say(card, f"hessian+eigen temp bytes {mem.temp_size_in_bytes}; "
              f"6-channel Hessian ({hessian_bytes} B) written to device "
              f"memory: {mem.temp_size_in_bytes >= hessian_bytes}")
    return t_b, t_h, mem.temp_size_in_bytes >= hessian_bytes


def check_clusters(labels):
    """Assert that the largest clusters of a -connect label volume are
    the planted sheets: every cluster of at least 1% of the largest lies
    on one sheet, each sheet holds one, and they hold most of every
    sheet (the tilted sheet loses some voxels where it crosses the
    others)."""
    import numpy as np
    from visfd_jax.utils.phantom import sheet_distances
    dist = [np.broadcast_to(d, labels.shape)
            for d in sheet_distances(labels.shape)]
    background = labels.max()              # undefined voxels: max + 1
    ids, counts = np.unique(labels[(labels > 0) & (labels < background)],
                            return_counts=True)
    big = ids[counts >= 0.01 * counts.max()]
    owners = set()
    in_big = np.isin(labels, big)
    for c in big:
        sel = labels == c
        on = [float(np.mean(d[sel] <= 3.0)) for d in dist]
        sheet = int(np.argmax(on))
        if on[sheet] < 0.9:
            raise AssertionError(f"cluster {c} is not on a planted sheet "
                                 f"(fractions {on})")
        owners.add(sheet)
    if owners != set(range(len(dist))):
        raise AssertionError(f"sheets without a cluster: "
                             f"{set(range(len(dist))) - owners}")
    for i, d in enumerate(dist):
        cover = float(np.mean(in_big[d <= 0.5]))
        if cover < 0.5:
            raise AssertionError(f"sheet {i}: {cover:.3f} of its voxels "
                                 "in the largest clusters")
    return len(ids), len(big)


def _run_cli(argv):
    import io
    from contextlib import redirect_stderr
    from visfd_jax.cli import filter_mrc
    from visfd_jax.utils import stage_paths
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stderr(buf):
        rc = filter_mrc.run(argv)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"filter_mrc {' '.join(argv)} exited {rc}:\n"
                           + buf.getvalue()[-4000:])
    spans = [m.group(1) for m in re.finditer(
        r"^---- (.*: [0-9.]+s) ----$", buf.getvalue(), re.M)]
    return dt, stage_paths(), spans


def main_path_phase(workdir, shape=SHAPE, card="", mesh=0, runs=2,
                    seed=0, tv=TV_SCALE):
    """The two CLI phases on the phantom, ``runs`` times each (cold,
    then warm), with ``-tv tv``.  Returns (saliency of phase 1, labels
    of phase 2)."""
    import jax
    import numpy as np
    from visfd_jax import native
    from visfd_jax.features.tv import use_triton_tv
    from visfd_jax.io import mrc
    from visfd_jax.utils.phantom import membrane_phantom
    src = os.path.join(workdir, "phantom.mrc")
    if not os.path.exists(src):
        mrc.write_mrc(src, np.asarray(membrane_phantom(shape, seed=seed)))
    tag = f"mesh{mesh}" if mesh else "one"
    prog = os.path.join(workdir, f"prog_{tag}")
    out1 = os.path.join(workdir, f"saliency_{tag}.mrc")
    out2 = os.path.join(workdir, f"clusters_{tag}.mrc")
    extra = ["-mesh", str(mesh)] if mesh else []
    tv_path = (("triton-sharded" if mesh else "triton") + "-sparse"
               if use_triton_tv() else "xla")
    for phase, fmt, out in ((1, PHASE1, out1), (2, PHASE2, out2)):
        argv = ["-in", src, "-out", out] \
            + fmt.format(prog=prog, tv=tv).split() + extra
        for r in range(runs):
            dt, paths, spans = _run_cli(argv)
            say(card, f"cli phase {phase} ({tag}, "
                      f"{'cold' if r == 0 else 'warm'}): {dt:.3f} s; "
                      f"stage paths {paths}; spans {spans}")
        want = {"hessian_eigen": "xla"}
        if phase == 1:
            want["tv"] = tv_path
        for k, v in want.items():
            if paths.get(k) != v:
                raise AssertionError(f"phase {phase}: stage {k} ran "
                                     f"{paths.get(k)!r}, expected {v!r}")
        if any("fallback" in v for v in paths.values()):
            raise AssertionError(f"phase {phase}: a fallback ran: {paths}")
    for d in range(6):
        if not os.path.exists(f"{prog}_tensor_{d}.rec"):
            raise AssertionError(f"missing {prog}_tensor_{d}.rec")
    sal = mrc.read_mrc(out1).data
    labels = mrc.read_mrc(out2).data
    for name, a in (("saliency", sal), ("labels", labels)):
        if a.shape != tuple(shape):
            raise AssertionError(f"{name} shape {a.shape} != {shape}")
    if not np.isfinite(sal).all():
        raise AssertionError("phase-1 saliency is not finite")
    n_clusters, n_big = check_clusters(labels)
    say(card, f"clusters ({tag}): {n_clusters} found, the {n_big} largest "
              f"lie on the planted sheets; connect flood: "
              f"{'native C++' if native.load() is not None else 'Python'}")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    if peak is not None:
        say(card, f"peak_bytes_in_use (device 0, {tag}): {peak} B, "
                  f"{peak / np.prod(shape):.1f} B/voxel")
    return sal, labels


def nccl_events(fn, *args, logdir):
    """Counts, by name, of the NCCL kernels a profiler trace of one call
    of ``fn`` shows on the GPUs."""
    import collections
    import glob
    import jax
    jax.block_until_ready(fn(*args))               # compiled outside
    with jax.profiler.trace(logdir):
        jax.block_until_ready(fn(*args))
    names = collections.Counter()
    for path in glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                       "*.xplane.pb")):
        for plane in jax.profiler.ProfileData.from_file(path).planes:
            if "GPU" not in plane.name:
                continue
            for line in plane.lines:
                for ev in line.events:
                    if "nccl" in ev.name.lower():
                        names[ev.name] += 1
    return names


def mesh4_phase(workdir, shape=SHAPE, card="", interpret=False,
                tv=TV_SCALE):
    """The two CLI phases with -mesh 4 against the same commands on one
    card: the saliency agrees within the kernel tolerance and the
    cluster labels are equal.  Then confirm that the halo exchange
    (``ppermute``) and the -tv-best radix rounds (``psum``) run as NCCL
    kernels."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from visfd_jax.parallel.mesh import grid_sharding, make_mesh
    from visfd_jax.parallel.reduce import fraction_threshold
    from visfd_jax.parallel.sharded import tv_accumulate_sharded
    sal_m, lab_m = main_path_phase(workdir, shape, card, mesh=4, runs=1,
                                   tv=tv)
    sal_1, lab_1 = main_path_phase(workdir, shape, card, mesh=0, runs=1,
                                   tv=tv)
    err = float(np.max(np.abs(sal_m - sal_1)) / np.max(np.abs(sal_1)))
    same_labels = bool(np.array_equal(lab_m, lab_1))
    say(card, f"mesh4 vs one card: saliency max|diff|/max {err:.3e} "
              f"(tolerance {TV_TOL:.0e}), differing voxels "
              f"{int(np.sum(sal_m != sal_1))}; labels equal: {same_labels}"
              f" (differing voxels {int(np.sum(lab_m != lab_1))})")
    mesh = make_mesh(4)
    sal, direction = phantom_fields(shape)
    sal = jax.device_put(sal, grid_sharding(mesh))
    direction = jax.device_put(direction, NamedSharding(
        mesh, P(*mesh.axis_names, None)))
    halo = nccl_events(
        lambda s, v: tv_accumulate_sharded(
            s, v, None, tv * MEMBRANE_SIGMA, 4, False, 2 ** 0.5, False,
            mesh, sparse=True, interpret=interpret)[0],
        sal, direction, logdir=os.path.join(workdir, "trace_halo"))
    radix = nccl_events(lambda s: fraction_threshold(s, 0.05, mesh=mesh),
                        sal, logdir=os.path.join(workdir, "trace_psum"))
    say(card, f"NCCL kernels in the sharded TV (halo ppermutes): "
              f"{dict(halo)}; in the -tv-best threshold (psum rounds): "
              f"{dict(radix)}")
    if err > TV_TOL:
        raise AssertionError(f"-mesh 4 saliency differs by {err:.3e}")
    if not same_labels:
        raise AssertionError("-mesh 4 cluster labels differ")
    if not halo or not radix:
        raise AssertionError("a collective did not run as an NCCL kernel")


def main(argv) -> int:
    mesh4 = "--mesh4" in argv
    if importlib.util.find_spec("visfd_jax") is None:
        print("chip_smoke: the visfd_jax package is not beside this "
              "script", file=sys.stderr)
        return 2
    card = card_line()
    say("", f"card: {card}")
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 3
    from visfd_jax.utils import enable_compile_cache
    say(card, f"compile cache: {enable_compile_cache()}")
    n_dev = 4 if mesh4 else 1
    if len(jax.devices()) < n_dev:
        print(f"chip_smoke: needs {n_dev} GPUs, found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 3
    os.makedirs(os.path.join(HERE, ".smoke_work"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(HERE, ".smoke_work")) as work:
        if mesh4:
            mesh4_phase(work, card=card)
        else:
            # the main path first, so that its peak device memory is
            # the process's peak so far
            main_path_phase(work, card=card)
            kernel_phase(card=card)
            xla_stage_phase(card=card)
    say(card, f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
