"""Sharded-vs-single-chip parity on a forced 8-device CPU mesh."""

import functools
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from visfd_jax.parallel.mesh import make_mesh, grid_sharding
from visfd_jax.parallel import sharded as SH
from visfd_jax.ops import kernels as K
from visfd_jax.ops.filters import apply_gauss
from visfd_jax.features import hessian as FH
from visfd_jax.features import tv as TV
from visfd_jax.linalg import sym3
from jax import shard_map
from jax.sharding import PartitionSpec as P


REPO = str(pathlib.Path(__file__).resolve().parents[1])


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest forces 8 host devices"
    return make_mesh(8)


def test_mesh_shape(mesh8):
    assert mesh8.devices.size == 8
    # near-square factorization: 4x2
    assert sorted(mesh8.devices.shape) == [2, 4]


def test_sharded_gauss_matches_single(mesh8, rng):
    """Round-5: the sharded no-mask normalization now divides by the
    same rank-1 1-D denominators as the single-device path (sliced per
    block), so the match is BITWISE -- and one full blur cheaper."""
    nz, ny, nx = 16, 16, 12
    x = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    sigma, hw = 1.5, 3
    k1 = K.gauss_kernel_1d(sigma, hw)

    def local(xb):
        return SH._sharded_gauss(xb, k1, k1, k1, hw, "z", "y")

    fn = jax.jit(shard_map(local, mesh=mesh8, in_specs=(P("z", "y"),),
                           out_specs=P("z", "y"), check_vma=False))
    xs = jax.device_put(jnp.asarray(x), grid_sharding(mesh8))
    got = np.asarray(fn(xs))
    want = np.asarray(apply_gauss(jnp.asarray(x), sigma,
                                  truncate_halfwidth=(hw,) * 3))
    np.testing.assert_array_equal(got, want)


def test_sharded_membrane_step_sparse_matches_dense(mesh8):
    """make_membrane_step(tv_sparse=True) (the -tv-best lever composed
    with the mesh through the LIBRARY step) must match the dense
    kernel: a skipped tap group contributes only zeros."""
    nz = ny = nx = 16
    img = np.zeros((nz, ny, nx), np.float32)
    img[:, :, 7:9] = 1.0
    img += 0.01 * np.arange(nx)[None, None, :]
    kw = dict(sigma=1.5, tv_sigma=1.5, tv_exponent=4,
              saliency_threshold=1e-4)   # zero out most sources
    step_d, sharding = SH.make_membrane_step(
        mesh8, interpret=True, tv_sparse=False, **kw)
    step_s, _ = SH.make_membrane_step(
        mesh8, interpret=True, tv_sparse=True, **kw)
    xs = jax.device_put(jnp.asarray(img), sharding)
    stick_d, vote_d = step_d(xs)
    stick_s, vote_s = step_s(xs)
    vd = np.asarray(vote_d)
    scale = float(np.abs(vd).max())
    np.testing.assert_allclose(np.asarray(vote_s), vd,
                               atol=3e-7 * scale)
    # the trig eigensolver amplifies vote roundoff near degenerate
    # pairs (same allowance as test_sharded_membrane_step_pallas...)
    np.testing.assert_allclose(np.asarray(stick_s), np.asarray(stick_d),
                               atol=1e-3 * scale)


def test_sharded_membrane_step_matches_single(mesh8):
    """The full sharded flagship step must reproduce the single-device
    composition of the same stages."""
    nz, ny, nx = 16, 16, 16
    img = np.zeros((nz, ny, nx), np.float32)
    img[:, :, 7:9] = 1.0
    img += 0.01 * np.arange(nx)[None, None, :]  # break symmetry

    sigma, tv_sigma, p = 1.5, 1.5, 4
    step, sharding = SH.make_membrane_step(
        mesh8, sigma=sigma, tv_sigma=tv_sigma, tv_exponent=p,
        saliency_threshold=0.0)
    xs = jax.device_put(jnp.asarray(img), sharding)
    stick_sh, vote_sh = step(xs)

    # single-device reference composition
    hw = max(1, int(np.floor(sigma * 2.5)))
    x = jnp.asarray(img)
    grad, hess = FH.calc_hessian(x, sigma)
    eivals, evects = sym3.diagonalize_sym3(
        sym3.flat_to_full(hess), order=sym3.EigenOrder.DECREASING)
    sal = np.asarray(FH.score_hessian_planar(eivals))
    direction = np.asarray(evects)[..., 0, :]
    vote = np.asarray(TV.tv_dense_stick(
        jnp.asarray(sal.astype(np.float32)),
        jnp.asarray(direction.astype(np.float32)),
        tv_sigma, exponent=p, truncate_ratio=float(np.sqrt(2.0)),
        normalize=False))
    vvals, _ = sym3.diagonalize_sym3(
        sym3.flat_to_full(jnp.asarray(vote)),
        order=sym3.EigenOrder.DECREASING, want_vects=False)
    stick = np.asarray(vvals[..., 0] - vvals[..., 1])

    np.testing.assert_allclose(np.asarray(vote_sh), vote,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(stick_sh), stick,
                               rtol=1e-4, atol=1e-4)


def tv_dense_stick_pallas(sal, v, sigma, exponent=4, mask_src=None,
                          truncate_ratio=2.5, want_denominator=False,
                          interpret=True):
    """Single-device raw kernel accumulation (dest, den|None)."""
    return TV.tv_accumulate_triton(
        sal, v, mask_src, float(sigma), float(truncate_ratio),
        int(exponent), False, bool(want_denominator), interpret=interpret)


def _tv_fields(rng, n):
    sal = rng.uniform(0, 1, size=(n, n, n)).astype(np.float32)
    sal[sal < 0.4] = 0.0
    v = rng.normal(size=(n, n, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return sal, v


def test_sharded_tv_pallas_bitwise_matches_single(mesh8, rng):
    """The per-shard Pallas voting kernel (halo exchange + local
    kernel) must be BIT-identical to the single-device Pallas kernel:
    per voxel the tap loop runs in the same order with the same
    operands, halo rows supplying exactly the values the single-device
    interior sees."""
    n, sigma = 32, 1.5
    sal, v = _tv_fields(rng, n)
    want, _ = tv_dense_stick_pallas(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=4,
        truncate_ratio=float(np.sqrt(2.0)), interpret=True)
    xs = jax.device_put(jnp.asarray(sal), grid_sharding(mesh8))
    vs = jax.device_put(
        jnp.asarray(v),
        jax.sharding.NamedSharding(mesh8, P(*mesh8.axis_names, None)))
    got, den = SH.tv_accumulate_sharded(
        xs, vs, None, sigma, 4, False, float(np.sqrt(2.0)), False,
        mesh8, interpret=True)
    assert den is None
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sharded_tv_pallas_masked_denominator(mesh8, rng):
    """Masked voting + denominator through the sharded kernel =="""
    n, sigma = 16, 1.5
    sal, v = _tv_fields(rng, n)
    mask = (rng.uniform(size=(n, n, n)) > 0.25).astype(np.float32)
    want, want_den = tv_dense_stick_pallas(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=4,
        mask_src=jnp.asarray(mask), want_denominator=True,
        truncate_ratio=float(np.sqrt(2.0)), interpret=True)
    gs = grid_sharding(mesh8)
    got, got_den = SH.tv_accumulate_sharded(
        jax.device_put(jnp.asarray(sal), gs),
        jax.device_put(
            jnp.asarray(v),
            jax.sharding.NamedSharding(mesh8, P(*mesh8.axis_names, None))),
        jax.device_put(jnp.asarray(mask), gs),
        sigma, 4, False, float(np.sqrt(2.0)), True, mesh8,
        interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got_den),
                                  np.asarray(want_den))


def test_tv_dense_stick_multidevice_dispatches_to_sharded_pallas(
        mesh8, rng):
    """tv_dense_stick on a mesh-sharded input, with the kernel chosen
    (here by interpret=True), must route through the per-shard kernel
    under shard_map (recorded as "triton-sharded") and match the
    single-device kernel bitwise."""
    n, sigma = 32, 1.5
    sal, v = _tv_fields(rng, n)
    want, _ = tv_dense_stick_pallas(
        jnp.asarray(sal), jnp.asarray(v), sigma, exponent=4,
        truncate_ratio=float(np.sqrt(2.0)), interpret=True)
    xs = jax.device_put(jnp.asarray(sal), grid_sharding(mesh8))
    vs = jax.device_put(
        jnp.asarray(v),
        jax.sharding.NamedSharding(mesh8, P(*mesh8.axis_names, None)))
    from visfd_jax.utils import reset_paths, stage_paths
    reset_paths()
    got = TV.tv_dense_stick(
        xs, vs, sigma, exponent=4, truncate_ratio=float(np.sqrt(2.0)),
        normalize=False, interpret=True)
    assert stage_paths()["tv"] == "triton-sharded"
    # still sharded over the mesh (no gather happened)
    assert len(got.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sharded_membrane_step_pallas_matches_xla(mesh8):
    """make_membrane_step with the per-shard kernel (interpret=True)
    must agree with the XLA accumulation to roundoff (sum order
    differs across formulations)."""
    nz = ny = nx = 16
    img = np.zeros((nz, ny, nx), np.float32)
    img[:, :, 7:9] = 1.0
    img += 0.01 * np.arange(nx)[None, None, :]
    kw = dict(sigma=1.5, tv_sigma=1.5, tv_exponent=4,
              saliency_threshold=0.0)
    step_x, sharding = SH.make_membrane_step(mesh8, **kw)
    step_p, _ = SH.make_membrane_step(mesh8, interpret=True, **kw)
    xs = jax.device_put(jnp.asarray(img), sharding)
    stick_x, vote_x = step_x(xs)
    stick_p, vote_p = step_p(xs)
    scale = float(np.abs(np.asarray(vote_x)).max())
    np.testing.assert_allclose(np.asarray(vote_p), np.asarray(vote_x),
                               atol=3e-6 * scale)
    # the trig-closed-form eigensolver amplifies tensor roundoff near
    # degenerate pairs (measured ~1.3e-4 of scale at this size)
    np.testing.assert_allclose(np.asarray(stick_p), np.asarray(stick_x),
                               atol=1e-3 * scale)


def test_init_distributed_single_process_noop(monkeypatch):
    """Without a coordinator/env, init_distributed must stay a
    single-process no-op (not hang waiting for a cluster)."""
    from visfd_jax.parallel import distributed as D
    for k in ("VISFD_COORDINATOR", "VISFD_NUM_PROCESSES",
              "VISFD_PROCESS_ID", "SLURM_JOB_ID",
              "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert D.init_distributed() is False


def test_init_distributed_one_process_cluster():
    """A real (1-process) jax.distributed cluster comes up and serves a
    global device list; run in a subprocess because initialize() must
    precede any backend use."""
    import subprocess
    import sys

    code = (
        "import os\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "os.environ['VISFD_COORDINATOR'] = '127.0.0.1:18476'\n"
        "os.environ['VISFD_NUM_PROCESSES'] = '1'\n"
        "os.environ['VISFD_PROCESS_ID'] = '0'\n"
        "from visfd_jax.parallel.distributed import (init_distributed,"
        " shutdown_distributed)\n"
        "assert init_distributed() is True\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "assert jax.process_count() == 1\n"
        "assert len(jax.devices()) >= 1\n"
        "from visfd_jax.parallel.mesh import make_mesh\n"
        "m = make_mesh()\n"
        "assert m.devices.size == len(jax.devices())\n"
        "shutdown_distributed()\n"
        "print('distributed-ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=REPO)
    assert "distributed-ok" in r.stdout, r.stderr[-2000:]


def test_sharded_ridge_score_direction_matches_single(mesh8, rng):
    """The CLI's -membrane front end (blur -> FD Hessian -> principal
    eigensolve -> score) on a (z, y)-sharded volume runs block by block
    with halo exchange and equals the single-device result bit for
    bit."""
    x = rng.normal(size=(16, 24, 33)).astype(np.float32)
    args = (None, 2.0, 2.5, sym3.EigenOrder.DECREASING, "planar")
    ref_s, ref_v = FH.ridge_score_direction(jnp.asarray(x), *args)
    xs = jax.device_put(jnp.asarray(x), grid_sharding(mesh8))
    got_s, got_v = FH.ridge_score_direction(xs, *args)
    assert len(got_s.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(got_s), np.asarray(ref_s))
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(ref_v))


@pytest.mark.parametrize("score,masked", [
    ("planar", True), ("linear", False), ("edge", True)])
def test_sharded_front_end_scores_and_mask_match_single(mesh8, rng, score,
                                                        masked):
    """Every score of the sharded front end, with and without a mask,
    equals the single-device result bit for bit; the blur's halo is
    wider than a z-block (two hops)."""
    x = rng.normal(size=(16, 24, 33)).astype(np.float32)
    mask = (rng.random(x.shape) > 0.2).astype(np.float32)
    args = (2.0, 2.5, sym3.EigenOrder.DECREASING, score)
    m = jnp.asarray(mask) if masked else None
    ref_s, ref_v = FH.ridge_score_direction(jnp.asarray(x), m, *args)
    put = functools.partial(jax.device_put, device=grid_sharding(mesh8))
    got_s, got_v = FH.ridge_score_direction(
        put(jnp.asarray(x)), None if m is None else put(m), *args)
    np.testing.assert_array_equal(np.asarray(got_s), np.asarray(ref_s))
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(ref_v))


def test_sharded_tensor_score_direction_matches_single(mesh8, rng):
    """Vote-tensor saliency + principal eigenvector of a sharded field
    (purely voxelwise) equals the single-device result."""
    t6 = rng.normal(size=(16, 16, 16, 6)).astype(np.float32)
    ref, ref_v = FH.tensor_score_direction(
        jnp.asarray(t6), sym3.EigenOrder.DECREASING, False)
    t6s = jax.device_put(
        jnp.asarray(t6),
        jax.sharding.NamedSharding(mesh8, P(*mesh8.axis_names, None)))
    got, got_v = FH.tensor_score_direction(
        t6s, sym3.EigenOrder.DECREASING, False)
    b = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), b, rtol=2e-5,
                               atol=np.abs(b).max() * 1e-6)
    dot = np.abs((np.asarray(got_v) * np.asarray(ref_v)).sum(-1))
    assert np.median(dot) > 1 - 1e-5


def test_two_process_cli_flagship_golden(tmp_path):
    """The multi-host CLI flagship (README's 2-host example) runs
    end-to-end in a genuine 2-process jax.distributed cluster -- every
    terminal host materialization in handle_tv / label_connected
    gathers with process_allgather instead of np.asarray-ing a
    non-fully-addressable global array.  Both processes run the full
    ``-membrane -tv -connect -mesh -1`` pipeline on a seeded membrane
    phantom over the global 8-device (4 per process) mesh; process 0
    writes the tomogram, and it must be BIT-identical to the
    single-process ``-mesh 8`` run (the mesh shape is the same (4, 2)
    either way)."""
    import subprocess
    import sys

    from visfd_jax.io import mrc as M
    from visfd_jax.utils.phantom import membrane_phantom
    M.write_mrc(str(tmp_path / "in.rec"),
                np.asarray(membrane_phantom((32, 64, 48), seed=3)))
    flags = ["-w", "19.2", "-membrane", "minima", "55", "-tv", "1.5",
             "-tv-angle-exponent", "4",
             "-connect", "3e-4", "-connect-angle", "30"]
    cli_args = ["-in", str(tmp_path / "in.rec")] + flags

    # single-process golden over the same (4, 2) mesh (conftest forces
    # 8 CPU devices in this process)
    from visfd_jax.cli import filter_mrc as FM
    rc = FM.run(cli_args + ["-out", str(tmp_path / "golden.rec"),
                            "-mesh", "8"])
    assert rc == 0

    repo = REPO
    worker = tmp_path / "cli_worker.py"
    worker.write_text(
        "import os, sys\n"
        "pid = int(sys.argv[1]); tmp = sys.argv[2]\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "os.environ['XLA_FLAGS'] = "
        "'--xla_force_host_platform_device_count=4'\n"
        "os.environ['VISFD_COORDINATOR'] = '127.0.0.1:18765'\n"
        "os.environ['VISFD_NUM_PROCESSES'] = '2'\n"
        "os.environ['VISFD_PROCESS_ID'] = str(pid)\n"
        f"sys.path.insert(0, {repo!r})\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from visfd_jax.cli import filter_mrc as FM\n"
        "rc = FM.run(['-in', tmp + '/in.rec', '-out', tmp + '/mp.rec',\n"
        f"             '-mesh', '-1'] + {flags!r})\n"
        "assert rc == 0\n"
        "import jax as j\n"
        "assert j.process_count() == 2\n"
        "print(f'proc{pid}-cli-ok')\n")

    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=repo) for i in range(2)]
    outs, errs = [], []
    for i, pr in enumerate(procs):
        out, err = pr.communicate(timeout=600)
        assert pr.returncode == 0, f"proc{i}:\n{err[-4000:]}"
        outs.append(out)
        errs.append(err)
    assert "proc0-cli-ok" in outs[0] and "proc1-cli-ok" in outs[1]
    # the paths the CPU runs: the jitted XLA front end and the XLA
    # shift-sum under GSPMD (the kernel is chosen on a GPU only)
    for err in errs:
        assert "fallback" not in err, err[-2000:]
        assert "hessian_eigen=xla" in err, err[-2000:]
        assert "tv=xla" in err and "tv=xla-sparse" not in err, err[-2000:]
    # process 0 wrote, process 1 skipped
    assert "writing tomogram" in errs[0]
    assert "skipping tomogram write" in errs[1]

    got = M.read_mrc(str(tmp_path / "mp.rec")).data
    want = M.read_mrc(str(tmp_path / "golden.rec")).data
    np.testing.assert_array_equal(got, want)


def test_init_distributed_two_process_smoke(tmp_path):
    """GENUINE 2-process jax.distributed smoke (the round-3 advisor's
    ask): both processes build the global 8-device mesh (4 forced CPU
    devices each), run the exact distributed -tv-best quantile and
    global stats over a process-spanning sharded field, and verify
    against a host oracle gathered with process_allgather (np.asarray
    on a non-fully-addressable global array would raise)."""
    import subprocess
    import sys

    worker = tmp_path / "mh_worker.py"
    worker.write_text(
        "import os, sys\n"
        "pid = int(sys.argv[1])\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "os.environ['XLA_FLAGS'] = "
        "'--xla_force_host_platform_device_count=4'\n"
        "os.environ['VISFD_COORDINATOR'] = '127.0.0.1:18998'\n"
        "os.environ['VISFD_NUM_PROCESSES'] = '2'\n"
        "os.environ['VISFD_PROCESS_ID'] = str(pid)\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from visfd_jax.parallel.distributed import (init_distributed,"
        " shutdown_distributed)\n"
        "assert init_distributed() is True\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import jax.numpy as jnp\n"
        "import numpy as np\n"
        "assert jax.process_count() == 2\n"
        "assert len(jax.devices()) == 8\n"
        "from visfd_jax.parallel.mesh import make_mesh, grid_sharding\n"
        "from visfd_jax.parallel.reduce import (fraction_threshold,"
        " global_min_max_mean)\n"
        "mesh = make_mesh()\n"
        "sh = grid_sharding(mesh)\n"
        "n = 16\n"
        "@jax.jit\n"
        "def gen():\n"
        "    zz = jax.lax.broadcasted_iota(jnp.float32, (n, n, n), 0)\n"
        "    yy = jax.lax.broadcasted_iota(jnp.float32, (n, n, n), 1)\n"
        "    xx = jax.lax.broadcasted_iota(jnp.float32, (n, n, n), 2)\n"
        "    return jnp.sin(zz * 12.99 + yy * 78.2 + xx * 37.7)\n"
        "x = jax.jit(gen, out_shardings=sh)()\n"
        "thr = float(fraction_threshold(x, 0.05, mesh=mesh))\n"
        "vmin, vmax, _ = (float(v) for v in global_min_max_mean(x,"
        " mesh))\n"
        "from jax.experimental import multihost_utils\n"
        "ref = np.asarray(multihost_utils.process_allgather(x,"
        " tiled=True))\n"
        "assert ref.shape == (n, n, n)\n"
        "k = int(np.floor(0.05 * ref.size))\n"
        "want = np.sort(ref.reshape(-1))[::-1][min(k, ref.size - 1)]\n"
        "assert thr == want, (thr, want)\n"
        "assert vmin == ref.min() and vmax == ref.max()\n"
        "shutdown_distributed()\n"
        "print(f'proc{pid}-ok thr={thr}')\n")

    procs = [subprocess.Popen([sys.executable, str(worker), str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              cwd=REPO)
             for i in range(2)]
    outs = []
    for i, pr in enumerate(procs):
        out, err = pr.communicate(timeout=180)
        assert pr.returncode == 0, f"proc{i}:\n{err[-2000:]}"
        outs.append(out)
    assert "proc0-ok" in outs[0] and "proc1-ok" in outs[1]
    thr0 = outs[0].split("thr=")[1].strip()
    thr1 = outs[1].split("thr=")[1].strip()
    assert thr0 == thr1
