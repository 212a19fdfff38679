"""Smoke + semantics tests for the sibling CLI programs."""

import contextlib
import io
import os

import numpy as np
import pytest

from visfd_jax.cli import combine_mrc as CM
from visfd_jax.cli import crop_mrc as CR
from visfd_jax.cli import convert_to_float as CF
from visfd_jax.cli import pval_mrc as PV
from visfd_jax.cli import histogram_mrc as HG
from visfd_jax.cli import draw_filter_1d as DF
from visfd_jax.cli import voxelize_mesh as VM
from visfd_jax.io import mrc
from visfd_jax.io.pointcloud import write_oriented_pointcloud_ply


def _write_vol(path, data, w=1.0):
    mrc.write_mrc(path, np.asarray(data, np.float32), voxel_width=w)


def run_stdout(fn, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(args)
    assert rc == 0
    return buf.getvalue()


def test_combine_mrc_ops(tmp_path, rng):
    a = rng.normal(size=(4, 5, 6)).astype(np.float32)
    b = rng.normal(size=(4, 5, 6)).astype(np.float32) + 2.0
    _write_vol(tmp_path / "a.mrc", a)
    _write_vol(tmp_path / "b.mrc", b)
    for op, want in [("+", a + b), ("-", a - b), ("*", a * b),
                     ("/", a / b)]:
        out = tmp_path / "o.mrc"
        assert CM.run([str(tmp_path / "a.mrc"), op,
                       str(tmp_path / "b.mrc"), str(out)]) == 0
        got = mrc.read_mrc(out).data
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_combine_mrc_thresholds(tmp_path, rng):
    a = rng.uniform(0, 1, size=(4, 4, 4)).astype(np.float32)
    b = np.zeros((4, 4, 4), np.float32)
    _write_vol(tmp_path / "a.mrc", a)
    _write_vol(tmp_path / "b.mrc", b)
    out = tmp_path / "o.mrc"
    assert CM.run([f"{tmp_path}/a.mrc,0.5", "+",
                   str(tmp_path / "b.mrc"), str(out)]) == 0
    got = mrc.read_mrc(out).data
    np.testing.assert_array_equal(got, (a > 0.5).astype(np.float32))


def test_crop_mrc(tmp_path, rng):
    x = rng.normal(size=(6, 7, 8)).astype(np.float32)
    _write_vol(tmp_path / "x.mrc", x, w=2.0)
    out = tmp_path / "c.mrc"
    assert CR.run([str(tmp_path / "x.mrc"), str(out),
                   "1", "4", "2", "5", "0", "3"]) == 0
    got = mrc.read_mrc(out)
    np.testing.assert_array_equal(got.data, x[0:4, 2:6, 1:5])
    # padded variant
    out2 = tmp_path / "c2.mrc"
    assert CR.run([str(tmp_path / "x.mrc"), str(out2),
                   "1", "4", "2", "5", "0", "3",
                   "1", "2", "0", "0", "0", "0", "9"]) == 0
    got2 = mrc.read_mrc(out2).data
    assert got2.shape == (4, 4, 7)
    assert (got2[:, :, 0] == 9).all()
    np.testing.assert_array_equal(got2[:, :, 1:5], x[0:4, 2:6, 1:5])


def test_convert_to_float(tmp_path):
    h = mrc.MrcHeader(nvoxels=(2, 2, 2), mode=mrc.MODE_SHORT)
    vals = np.arange(-4, 4, dtype="<i2")
    raw = mrc._write_header(h) + vals.tobytes()
    p = tmp_path / "in.mrc"
    p.write_bytes(raw)
    out = tmp_path / "out.mrc"
    assert CF.run([str(p), str(out)]) == 0
    got = mrc.read_mrc(out)
    assert got.header.mode == mrc.MODE_FLOAT
    np.testing.assert_array_equal(got.data.ravel(),
                                  vals.astype(np.float32))


def test_pval_mrc_uniform_vs_clustered(tmp_path, rng):
    """Clustered particles must give a much smaller max-density
    p-value than scattered ones."""
    n = 24
    scattered = np.zeros((n, n, n), np.float32)
    idx = rng.choice(n ** 3, size=40, replace=False)
    scattered.ravel()[idx] = 1.0
    clustered = np.zeros((n, n, n), np.float32)
    clustered[10:13, 10:13, 10:13] = 1.0  # 27 particles in one clump
    _write_vol(tmp_path / "s.mrc", scattered)
    _write_vol(tmp_path / "c.mrc", clustered)
    out_s = run_stdout(PV.run, ["-in", str(tmp_path / "s.mrc"),
                                "-gauss", "3", "-pmax"])
    out_c = run_stdout(PV.run, ["-in", str(tmp_path / "c.mrc"),
                                "-gauss", "3", "-pmax"])
    p_s = float(out_s.split()[0])
    p_c = float(out_c.split()[0])
    assert 0 <= p_c <= 1 and 0 <= p_s <= 1
    assert p_c < p_s  # clump is less likely to be random


def test_histogram_mrc(tmp_path, rng):
    x = rng.normal(size=(6, 6, 6)).astype(np.float32)
    _write_vol(tmp_path / "x.mrc", x)
    out = run_stdout(HG.run, ["-n", "10", str(tmp_path / "x.mrc")])
    rows = [ln.split() for ln in out.strip().splitlines()]
    assert len(rows) == 10
    assert sum(int(r[1]) for r in rows) == x.size


def test_draw_filter_1d():
    out = run_stdout(DF.run, ["-gauss", "1.0", "2.0", "5"])
    rows = [ln.split() for ln in out.strip().splitlines()]
    xs = np.array([float(r[0]) for r in rows])
    hs = np.array([float(r[1]) for r in rows])
    np.testing.assert_allclose(hs, np.exp(-0.5 * (xs / 2.0) ** 2),
                               rtol=1e-5)


def test_voxelize_mesh_cube(tmp_path):
    """A closed unit cube mesh voxelizes to a solid block."""
    # 8 cube corners, 12 triangles
    v = np.array([[x, y, z] for z in (2.0, 7.0) for y in (2.0, 7.0)
                  for x in (2.0, 7.0)])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 2, 6, 4),
             (1, 5, 7, 3), (0, 4, 5, 1), (2, 3, 7, 6)]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    ply = tmp_path / "cube.ply"
    with open(ply, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(v)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n")
        for p in v:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
    out = tmp_path / "occ.mrc"
    assert VM.run(["-m", str(ply), "-o", str(out),
                   "-b", "0", "10", "0", "10", "0", "10", "-w", "1"]) == 0
    occ = mrc.read_mrc(out).data
    assert occ.shape == (10, 10, 10)
    assert occ[4, 4, 4] == 1.0
    assert occ[0, 0, 0] == 0.0
    # interior volume ~ 5^3
    assert 100 < occ.sum() < 220


# --- goldens produced by the compiled C++ reference tools ---

import pathlib

GOLDEN = pathlib.Path(__file__).parent / "golden"
FIXREC = pathlib.Path("/root/reference/tests/test_blob_detect.rec")


@pytest.mark.skipif(not FIXREC.exists(), reason="no reference fixtures")
@pytest.mark.parametrize("op,name", [("+", "add"), ("*", "mul")])
def test_combine_mrc_golden(tmp_path, op, name):
    # combine_mrc ref_gauss.mrc OP FIX ref_combine_NAME.mrc
    from visfd_jax.cli import combine_mrc as CM
    out = tmp_path / "out.mrc"
    assert CM.run([str(GOLDEN / "ref_gauss.mrc"), op, str(FIXREC),
                   str(out)]) == 0
    got = mrc.read_mrc(out).data
    want = mrc.read_mrc(GOLDEN / f"ref_combine_{name}.mrc").data
    np.testing.assert_array_equal(got, want)


@pytest.mark.skipif(not FIXREC.exists(), reason="no reference fixtures")
@pytest.mark.parametrize("args,golden", [
    ([], "ref_sum.txt"),          # sum_voxels FIX
    (["-ave"], "ref_sum_ave.txt"),  # sum_voxels -ave FIX
])
def test_sum_voxels_golden(capsys, args, golden):
    from visfd_jax.cli import sum_voxels as SV
    assert SV.run(args + [str(FIXREC)]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    want = (GOLDEN / golden).read_text().strip()
    assert got == want


@pytest.mark.skipif(not FIXREC.exists(), reason="no reference fixtures")
def test_pval_mrc_golden(capsys):
    # pval_mrc -in FIX -w 1 -crds ref_keep.txt -gauss 3 -max
    # (ref_keep.txt is a 5-column blob list: exercises the reference's
    # raw-triple-stream coordinate reading, replicated exactly)
    from visfd_jax.cli import pval_mrc as PV
    assert PV.run(["-in", str(FIXREC), "-w", "1",
                   "-crds", str(GOLDEN / "ref_keep.txt"),
                   "-gauss", "3", "-max"]) == 0
    got = capsys.readouterr().out.strip()
    want = (GOLDEN / "ref_pval.txt").read_text().strip()
    assert got == want
