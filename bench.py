"""Benchmark driver: the flagship membrane-detection step on one GPU.

Prints JSON lines {"metric", "value", "unit", "vs_baseline", ...}; the
last one on standard output is the tracked metric, the others go to
standard error.  Every line names the device it ran on (platform,
device_kind, device count) and the card's power limit.  The run fails
unless JAX's default device is a GPU, and any failure exits non-zero.

The benchmarked computation is the hot path of the reference's
flagship `filter_mrc -membrane ... -tv ...` pipeline (SURVEY 3.2):
separable Gaussian blur -> FD Hessian -> voxelwise closed-form
eigendecomposition -> planar saliency -> dense stick tensor voting ->
vote-tensor eigendecomposition -> stick saliency.  Tensor voting runs
where ``features.tv.use_triton_tv`` sends the CLI on a GPU: the Triton
kernel.

Timing: the step is iterated inside one jitted ``lax.fori_loop`` (one
dispatch covers BENCH_ITERS executions) and synchronized with
``block_until_ready``; the first call, which compiles, is not timed.

vs_baseline compares voxels/s against a fixed constant: the compiled
C++ reference (16-thread OpenMP extrapolation) measured on an earlier
host and stored in ``baseline_cpp.json``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def build_step(tv_sigma: float = 2.0):
    import jax.numpy as jnp
    from visfd_jax.ops import kernels as K
    from visfd_jax.ops.conv import _sep3
    from visfd_jax.features import tv as TV
    from visfd_jax.features import hessian as FH
    from visfd_jax.linalg import sym3

    sigma = 2.0
    ratio = float(np.sqrt(2.0))
    hw = max(1, int(np.floor(sigma * 2.5)))
    k1 = jnp.asarray(K.gauss_kernel_1d(sigma, hw))

    def step(x, k1):
        blur = _sep3(x, k1, k1, k1)
        hess = FH.hessian_fd(blur) * (sigma * sigma)
        eivals, direction = sym3.principal_sym3(
            sym3.flat_to_full(hess), order=sym3.EigenOrder.DECREASING)
        l1, l2 = eivals[..., 0], eivals[..., 1]
        nrm = l1 * l1 - l2 * l2
        saliency = nrm * nrm
        vote, _ = TV.tv_accumulate_triton(
            saliency, direction, None, tv_sigma, ratio, 4, False, False)
        vvals, _ = sym3.diagonalize_sym3(
            sym3.flat_to_full(vote), order=sym3.EigenOrder.DECREASING,
            want_vects=False)
        return vvals[..., 0] - vvals[..., 1]

    return step, (k1,)


def device_fields():
    """platform, device_kind, device count and the card's power limit,
    as every output line carries them."""
    import jax
    dev = jax.devices()[0]
    r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "power_limit": r.stdout.strip().splitlines()[0].strip()}


def main():
    import jax
    import jax.numpy as jnp
    from visfd_jax.utils import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        print(f"bench: needs a GPU, JAX found "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        return 3
    enable_compile_cache()
    device = device_fields()

    n = int(os.environ.get("BENCH_SIZE", "128"))
    iters = int(os.environ.get("BENCH_ITERS", "100"))

    def run_mode(tv_sigma=2.0, loop_iters=None):
        step, tables = build_step(tv_sigma=tv_sigma)
        loop_iters = loop_iters or iters

        def looped(x0, *tables):
            def body(i, s):
                out = step(s, *tables)
                return out / (jnp.max(jnp.abs(out)) + 1e-30)
            return jax.lax.fori_loop(0, loop_iters, body, x0)

        jl = jax.jit(looped)
        x = jnp.asarray(np.random.default_rng(0).normal(
            size=(n, n, n)).astype(np.float32))
        jax.block_until_ready(jl(x, *tables))     # compile
        t0 = time.perf_counter()
        jax.block_until_ready(jl(x, *tables))
        return (time.perf_counter() - t0) / loop_iters

    base = {}
    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline_cpp.json")
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)

    def line(metric, voxels_per_s, **extra):
        b = float(base.get("voxels_per_s") or 0)
        return json.dumps({
            "metric": metric, "value": round(voxels_per_s, 1),
            "unit": "voxels/s",
            "vs_baseline": round(voxels_per_s / b, 3) if b else None,
            **device, **extra})

    # -tv-best sparse voting at hw=3 on a blob-sparse volume (the
    # reference's "up to 64x" cost lever, doc_filter_mrc.md:769-788)
    from visfd_jax.features import tv as TV
    zz, yy, xx = np.meshgrid(*([np.arange(n)] * 3), indexing="ij")
    sal_sp = np.zeros((n, n, n), np.float32)
    for c, r in (((30, 40, 40), 6), ((35, 80, 60), 8),
                 ((100, 100, 30), 5)):
        d2 = np.sqrt((zz - c[0]) ** 2 + (yy - c[1]) ** 2
                     + (xx - c[2]) ** 2)
        sal_sp[d2 < r] = 1.0
    vv = np.random.default_rng(3).normal(size=(n, n, n, 3)).astype(
        np.float32)
    vv /= np.linalg.norm(vv, axis=-1, keepdims=True)
    sal_j, v_j = jnp.asarray(sal_sp), jnp.asarray(vv)

    def sparse_tv(s_, v_):
        return TV.tv_dense_stick(s_, v_, 2.2, exponent=4,
                                 truncate_ratio=float(np.sqrt(2.0)),
                                 normalize=False, sparse=True)

    jax.block_until_ready(sparse_tv(sal_j, v_j))
    n_it = max(10, iters // 4)
    t0 = time.perf_counter()
    for _ in range(n_it):
        out = sparse_tv(sal_j, v_j)
    jax.block_until_ready(out)
    dts = (time.perf_counter() - t0) / n_it
    from visfd_jax.utils import stage_paths
    print(line("tv_sparse_hw3_blob_voxels_per_s", n ** 3 / dts,
               path=stage_paths().get("tv")), file=sys.stderr)

    # the production TV window (sigma_tv = 2.2 voxels => hw = 3 at the
    # default truncate sqrt(2))
    dt3 = run_mode(tv_sigma=2.2, loop_iters=max(10, iters // 4))
    print(line("membrane_tv_hw3_pipeline_voxels_per_s", n ** 3 / dt3),
          file=sys.stderr)

    dt = run_mode()
    print(line("membrane_tv_pipeline_voxels_per_s", n ** 3 / dt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
