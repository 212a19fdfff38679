"""Golden parity against the compiled C++ reference.

``tests/golden/`` holds outputs produced by the reference
``filter_mrc`` built with ``setup_gcc.sh`` (``-O3 -DNDEBUG -fopenmp``)
on the reference's own checked-in fixtures (see each test for the
exact command line).  These lock in the BASELINE parity targets:

* label-valued outputs (extrema lists/images, watershed basins,
  connected clusters, grayscale morphology) are **bit-exact**;
* float convolution outputs agree to f32 summation roundoff
  (different but equally-valid accumulation orders);
* blob lists match in count and coordinates exactly, scores to
  conv roundoff.

Regenerate with::

    cp -r /root/reference /tmp/visfd_build
    cd /tmp/visfd_build && source setup_gcc.sh && make
    # then the per-test command lines below
"""

import contextlib
import io
import pathlib

import numpy as np
import pytest

from visfd_jax.cli import filter_mrc as FM
from visfd_jax.io import read_mrc

GOLDEN = pathlib.Path(__file__).parent / "golden"
FIX = pathlib.Path("/root/reference/tests/test_blob_detect.rec")
MEM = pathlib.Path("/root/reference/tests/test_image_membrane.rec")

pytestmark = pytest.mark.skipif(not FIX.exists(),
                                reason="reference fixtures not available")


def run_cli(args):
    # In-process (not subprocess) so all invocations share one jax
    # runtime: conftest's CPU pinning applies and jit caches persist
    # across tests (a subprocess per call re-imported jax and
    # recompiled everything, ~20s each).
    buf = io.StringIO()
    try:
        with contextlib.redirect_stderr(buf):
            rc = FM.run(list(args))
    except Exception as exc:
        pytest.fail(f"filter_mrc raised {exc!r}; captured stderr tail:\n"
                    + buf.getvalue()[-2000:])
    assert rc == 0, buf.getvalue()[-2000:]


def _img(path):
    return read_mrc(str(path)).data


@pytest.mark.parametrize("name,args,exact", [
    # filter_mrc -in FIX -out ref_gauss.mrc -gauss 2 -w 1
    ("gauss", ["-gauss", "2"], False),
    # filter_mrc -in FIX -out ref_dog.mrc -dog 2 4 -w 1
    ("dog", ["-dog", "2", "4"], False),
    # filter_mrc -in FIX -out ref_erode.mrc -erode 2 -w 1
    ("erode", ["-erode", "2"], True),
    # filter_mrc -in FIX -out ref_dogg.mrc -dogg 2 4 -exponents 3 5 -w 1
    ("dogg", ["-dogg", "2", "4", "-exponents", "3", "5"], False),
    # filter_mrc -in FIX -out ref_dogg2.mrc -dogg 2 4 -w 1
    # (default exponents m=n=2: still differs from -dog, which uses
    # exp(-r^2/2s^2) Gaussians while -dogg uses exp(-(r/s)^2))
    ("dogg2", ["-dogg", "2", "4"], False),
    # filter_mrc -in FIX -out ref_ggauss.mrc -ggauss 3 -exponent 4 -w 1
    ("ggauss", ["-ggauss", "3", "-exponent", "4"], False),
    # filter_mrc -in FIX -out ref_fluct.mrc -fluct 2 -w 1
    ("fluct", ["-fluct", "2"], False),
    # filter_mrc -in FIX -out ref_open.mrc -open 2 -w 1   (etc.)
    ("open", ["-open", "2"], True),
    ("close", ["-close", "2"], True),
    ("thw", ["-top-hat-white", "2"], True),
    ("thb", ["-top-hat-black", "2"], True),
    # intensity-map post-ops (no convolution filter)
    ("thresh2", ["-thresh2", "80", "120"], True),
    ("thresh4", ["-thresh4", "70", "90", "110", "130"], True),
    ("clip", ["-clip", "80", "120"], True),
    # anisotropic variants
    ("gauss_aniso", ["-gauss-aniso", "2", "3", "1.5"], False),
    ("dog_aniso", ["-dog-aniso", "2", "3", "1.5", "4", "5", "3"], False),
    ("dogg_aniso", ["-dogg-aniso", "2", "3", "1.5", "4", "5", "3",
                    "-exponents", "3", "4"], False),
    # NOTE: no ``-median`` golden: the reference's Median() never
    # advances its footprint iterator when a neighbor is out of bounds
    # (``filter3d.hpp:1600-1618``: ``continue`` without ``pVoxel++``),
    # so the compiled reference infinite-loops on any boundary voxel.
])
def test_filter_golden(tmp_path, name, args, exact):
    out = tmp_path / "out.mrc"
    run_cli(["-in", str(FIX), "-out", str(out), "-w", "1"] + args)
    ref = _img(GOLDEN / f"ref_{name}.mrc")
    ours = _img(out)
    if exact:
        np.testing.assert_array_equal(ours, ref)
    else:
        scale = np.abs(ref).max()
        np.testing.assert_allclose(ours, ref, atol=2e-5 * scale)


def test_find_minima_golden(tmp_path):
    # filter_mrc -in FIX -out ref_min.mrc -find-minima ref_min.txt -w 1
    out = tmp_path / "out.mrc"
    txt = tmp_path / "min.txt"
    run_cli(["-in", str(FIX), "-out", str(out), "-w", "1",
             "-find-minima", str(txt)])
    np.testing.assert_array_equal(_img(out), _img(GOLDEN / "ref_min.mrc"))
    assert txt.read_text().split() == \
        (GOLDEN / "ref_min.txt").read_text().split()


def test_watershed_golden(tmp_path):
    # filter_mrc -in FIX -out ref_ws.mrc -watershed minima -w 1
    out = tmp_path / "out.mrc"
    run_cli(["-in", str(FIX), "-out", str(out), "-w", "1",
             "-watershed", "minima"])
    np.testing.assert_array_equal(_img(out), _img(GOLDEN / "ref_ws.mrc"))


def test_connect_golden(tmp_path):
    # filter_mrc -in ref_gauss.mrc -out ref_conn.mrc -connect 37 -w 1
    out = tmp_path / "out.mrc"
    run_cli(["-in", str(GOLDEN / "ref_gauss.mrc"), "-out", str(out),
             "-w", "1", "-connect", "37"])
    ref = _img(GOLDEN / "ref_conn.mrc")
    np.testing.assert_array_equal(_img(out), ref)
    assert ref.max() == 7.0  # 7 clusters in the golden run


def test_blob_and_nms_golden(tmp_path):
    # filter_mrc -in FIX -out x.mrc -blob minima ref_blobs.txt 5 15 1.02 -w 1
    # filter_mrc -in FIX -out y.mrc -discard-blobs ref_blobs.txt \
    #     ref_keep.txt -max-volume-overlap 0.2 -w 1
    blobs = tmp_path / "blobs.txt"
    keep = tmp_path / "keep.txt"
    run_cli(["-in", str(FIX), "-out", str(tmp_path / "b.mrc"), "-w", "1",
             "-blob", "minima", str(blobs), "5", "15", "1.02"])
    run_cli(["-in", str(FIX), "-out", str(tmp_path / "k.mrc"), "-w", "1",
             "-discard-blobs", str(blobs), str(keep),
             "-max-volume-overlap", "0.2"])
    for ours_f, ref_f in [(blobs, "ref_blobs.txt"), (keep, "ref_keep.txt")]:
        ours = np.loadtxt(str(ours_f), ndmin=2)
        ref = np.loadtxt(str(GOLDEN / ref_f), ndmin=2)
        assert ours.shape == ref.shape
        np.testing.assert_array_equal(ours[:, :3], ref[:, :3])  # x y z
        # diameters differ only in %g print rounding; scores come out
        # of the LoG conv chain: f32 roundoff compounded over the sigma
        # ladder -> ~3e-4 relative
        np.testing.assert_allclose(ours[:, 3], ref[:, 3], rtol=1e-4)
        scale = np.abs(ref[:, 4]).max()
        np.testing.assert_allclose(ours[:, 4], ref[:, 4],
                                   atol=1e-3 * scale)


def test_blob_golden_under_mesh(tmp_path):
    """``-blob`` with ``-mesh 8``: the CLI shards the input volume over
    the forced 8-device CPU mesh (GSPMD partitions the LoG ladder) and
    the blob list must STILL match the reference golden -- this pins
    the mesh blob path the round-3 review flagged as untested."""
    blobs = tmp_path / "blobs_mesh.txt"
    run_cli(["-in", str(FIX), "-out", str(tmp_path / "b.mrc"), "-w", "1",
             "-mesh", "8",
             "-blob", "minima", str(blobs), "5", "15", "1.02"])
    ours = np.loadtxt(str(blobs), ndmin=2)
    ref = np.loadtxt(str(GOLDEN / "ref_blobs.txt"), ndmin=2)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours[:, :3], ref[:, :3])
    np.testing.assert_allclose(ours[:, 3], ref[:, 3], rtol=1e-4)
    scale = np.abs(ref[:, 4]).max()
    np.testing.assert_allclose(ours[:, 4], ref[:, 4], atol=1e-3 * scale)


def test_draw_spheres_golden(tmp_path):
    # filter_mrc -in FIX -out ref_spheres.mrc -draw-spheres ref_keep.txt -w 1
    out = tmp_path / "out.mrc"
    run_cli(["-in", str(FIX), "-out", str(out), "-w", "1",
             "-draw-spheres", str(GOLDEN / "ref_keep.txt")])
    np.testing.assert_array_equal(_img(out), _img(GOLDEN / "ref_spheres.mrc"))


def test_watershed_markers_golden(tmp_path):
    # markers image: labels 1..N painted at the ref_min.txt minima
    # filter_mrc -in FIX -out ref_ws_markers.mrc -w 1 -watershed minima \
    #     -markers ref_markers.mrc -watershed-show-boundaries
    out = tmp_path / "out.mrc"
    run_cli(["-in", str(FIX), "-out", str(out), "-w", "1",
             "-watershed", "minima",
             "-markers", str(GOLDEN / "ref_markers.mrc"),
             "-watershed-show-boundaries"])
    np.testing.assert_array_equal(_img(out),
                                  _img(GOLDEN / "ref_ws_markers.mrc"))


def _load_ply(path):
    lines = pathlib.Path(path).read_text().splitlines()
    n = int([ln for ln in lines
             if ln.startswith("element vertex")][0].split()[-1])
    start = lines.index("end_header") + 1
    return np.array([[float(v) for v in ln.split()]
                     for ln in lines[start:start + n]])


def test_membrane_connect_flagship_golden(tmp_path):
    """Full two-phase flagship: membrane -> TV (save/load-progress) ->
    connect with tensor/vector gates + polarity standardization ->
    select-cluster -> oriented normals PLY.  Cluster labels bit-exact;
    PLY positions/normals to f32 conv roundoff.

    Reference commands (= tests/test_membrane_detection.sh):
      filter_mrc -w 19.2 -in MEM -out ref_memb_conn.mrc -membrane minima 55
        -tv 4 -tv-angle-exponent 4 -bin 2 -save-progress P
      filter_mrc ... -load-progress P -connect 1e+09 -connect-angle 30
        -normals-file ref_memb.ply -select-cluster 1
    (handlers.cpp:1501-2357, connect.hpp:168-1432)
    """
    out = tmp_path / "memb.mrc"
    ply = tmp_path / "memb.ply"
    base = str(tmp_path / "prog")
    common = ["-w", "19.2", "-in", str(MEM), "-out", str(out),
              "-membrane", "minima", "55", "-tv", "4",
              "-tv-angle-exponent", "4", "-bin", "2"]
    run_cli(common + ["-save-progress", base])
    # saved 6-channel vote tensors match the reference's checkpoint
    for d in range(6):
        ours_t = _img(f"{base}_tensor_{d}.rec")
        ref_t = _img(GOLDEN / f"ref_prog_tensor_{d}.rec")
        scale = np.abs(ref_t).max()
        np.testing.assert_allclose(ours_t, ref_t, atol=5e-6 * scale)
    run_cli(common + ["-load-progress", base,
                      "-connect", "1e+09", "-connect-angle", "30",
                      "-normals-file", str(ply), "-select-cluster", "1"])
    np.testing.assert_array_equal(_img(out),
                                  _img(GOLDEN / "ref_memb_conn.mrc"))
    ours_ply = _load_ply(ply)
    ref_ply = _load_ply(GOLDEN / "ref_memb.ply")
    assert ours_ply.shape == ref_ply.shape  # same vertex count (58)
    np.testing.assert_allclose(ours_ply[:, :3], ref_ply[:, :3],
                               atol=1e-3)  # positions (PLY %g prints)
    nscale = np.abs(ref_ply[:, 3:]).max()
    np.testing.assert_allclose(ours_ply[:, 3:], ref_ply[:, 3:],
                               atol=1e-4 * nscale)  # unnormalized normals


def test_membrane_connect_flagship_mesh_golden(tmp_path):
    """The flagship two-phase pipeline with ``-mesh 8`` (dense voxel
    stages GSPMD-sharded over the forced 8-device CPU mesh) must stay
    bit-identical to the reference goldens: sharding the mesh may not
    change a single voxel of the cluster labels or a single PLY
    vertex."""
    out = tmp_path / "memb.mrc"
    ply = tmp_path / "memb.ply"
    base = str(tmp_path / "prog")
    common = ["-w", "19.2", "-in", str(MEM), "-out", str(out),
              "-membrane", "minima", "55", "-tv", "4",
              "-tv-angle-exponent", "4", "-bin", "2", "-mesh", "8"]
    run_cli(common + ["-save-progress", base])
    for d in range(6):
        ours_t = _img(f"{base}_tensor_{d}.rec")
        ref_t = _img(GOLDEN / f"ref_prog_tensor_{d}.rec")
        scale = np.abs(ref_t).max()
        np.testing.assert_allclose(ours_t, ref_t, atol=5e-6 * scale)
    run_cli(common + ["-load-progress", base,
                      "-connect", "1e+09", "-connect-angle", "30",
                      "-normals-file", str(ply), "-select-cluster", "1"])
    np.testing.assert_array_equal(_img(out),
                                  _img(GOLDEN / "ref_memb_conn.mrc"))
    ours_ply = _load_ply(ply)
    ref_ply = _load_ply(GOLDEN / "ref_memb.ply")
    assert ours_ply.shape == ref_ply.shape
    np.testing.assert_allclose(ours_ply[:, :3], ref_ply[:, :3],
                               atol=1e-3)
    nscale = np.abs(ref_ply[:, 3:]).max()
    np.testing.assert_allclose(ours_ply[:, 3:], ref_ply[:, 3:],
                               atol=1e-4 * nscale)


def test_membrane_sharded_checkpoint_golden(tmp_path):
    """The numpy phase checkpoint (-save/-load-progress-sharded
    extensions) resumes the flagship pipeline to the same bit-exact
    cluster labels as the .rec-based -save/-load-progress path."""
    out = tmp_path / "memb.mrc"
    ck = str(tmp_path / "ckpt")
    common = ["-w", "19.2", "-in", str(MEM), "-out", str(out),
              "-membrane", "minima", "55", "-tv", "4",
              "-tv-angle-exponent", "4", "-bin", "2"]
    run_cli(common + ["-save-progress-sharded", ck])
    run_cli(common + ["-load-progress-sharded", ck,
                      "-connect", "1e+09", "-connect-angle", "30",
                      "-select-cluster", "1"])
    np.testing.assert_array_equal(_img(out),
                                  _img(GOLDEN / "ref_memb_conn.mrc"))


def test_connect_from_reference_tensors_golden(tmp_path):
    """Isolates the LabelConnected machinery: load the REFERENCE's own
    saved vote tensors (ref_prog_tensor_*.rec), run -connect at a
    threshold that fragments the membrane into 2 clusters, and demand
    bit-exact labels (connect.hpp:168-1432 gates + polarity)."""
    out = tmp_path / "memb.mrc"
    run_cli(["-w", "19.2", "-in", str(MEM), "-out", str(out),
             "-membrane", "minima", "55", "-tv", "4",
             "-tv-angle-exponent", "4", "-bin", "2",
             "-load-progress", str(GOLDEN / "ref_prog"),
             "-connect", "5e+09", "-connect-angle", "10"])
    np.testing.assert_array_equal(_img(out),
                                  _img(GOLDEN / "ref_memb_frag.mrc"))


def test_mustlink_golden(tmp_path):
    """Must-link constraints (connect.hpp:829-1045): joining the two
    fragments from the 5e+09 run back into one cluster via an
    IMOD-notation -must-link file; labels bit-exact, PLY matching."""
    out = tmp_path / "memb.mrc"
    ply = tmp_path / "memb.ply"
    run_cli(["-w", "19.2", "-in", str(MEM), "-out", str(out),
             "-membrane", "minima", "55", "-tv", "4",
             "-tv-angle-exponent", "4", "-bin", "2",
             "-load-progress", str(GOLDEN / "ref_prog"),
             "-connect", "5e+09", "-connect-angle", "10",
             "-must-link", str(GOLDEN / "ref_ml.txt"),
             "-select-cluster", "1", "-normals-file", str(ply)])
    np.testing.assert_array_equal(_img(out),
                                  _img(GOLDEN / "ref_memb_ml.mrc"))
    ours_ply = _load_ply(ply)
    ref_ply = _load_ply(GOLDEN / "ref_memb_ml.ply")
    assert ours_ply.shape == ref_ply.shape
    np.testing.assert_allclose(ours_ply[:, :3], ref_ply[:, :3], atol=1e-3)


def test_subprocess_entry_point():
    """The ``python -m visfd_jax.cli.filter_mrc`` __main__ block and
    main()'s exception->exit-code handling (cheap bad-flag case; the
    heavy pipelines run in-process above)."""
    import subprocess
    import sys
    proc = subprocess.run(
        [sys.executable, "-m", "visfd_jax.cli.filter_mrc",
         "-no-such-flag"],
        capture_output=True, text=True,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 1
    assert "Error" in proc.stderr


def test_membrane_background_golden(tmp_path):
    # filter_mrc -w 19.2 -in MEM -out ref_memb_bg.mrc -membrane minima 55
    #   -tv 4 -bin 2 -membrane-background 110
    # (the double-Gauss background-subtraction branch,
    #  handlers.cpp:1577-1605)
    out = tmp_path / "out.mrc"
    run_cli(["-in", str(MEM), "-out", str(out), "-w", "19.2",
             "-membrane", "minima", "55", "-tv", "4", "-bin", "2",
             "-membrane-background", "110"])
    ref = _img(GOLDEN / "ref_memb_bg.mrc")
    ours = _img(out)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, atol=2e-5 * scale)


def test_membrane_golden(tmp_path):
    # filter_mrc -in MEM -out ref_memb.mrc -membrane minima 6.93 -tv 2 -w 1
    out = tmp_path / "out.mrc"
    run_cli(["-in", str(MEM), "-out", str(out), "-w", "1",
             "-membrane", "minima", "6.93", "-tv", "2"])
    ref = _img(GOLDEN / "ref_memb.mrc")
    ours = _img(out)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, atol=5e-5 * scale)
    assert np.corrcoef(ours.ravel(), ref.ravel())[0, 1] > 0.999999
