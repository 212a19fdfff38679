"""End-to-end CLI pipeline tests: Python ports of the reference's
four shunit2 scripts (tests/test_*.sh), asserting the same behavioral
invariants on the same checked-in fixtures."""

import io
import os
import shutil
import sys

import numpy as np
import pytest

from visfd_jax.cli import filter_mrc as FM
from visfd_jax.cli import sum_voxels as SV
from visfd_jax.io import mrc


@pytest.fixture()
def workdir(tmp_path, reference_fixture_dir, monkeypatch):
    for f in ["test_blob_detect.rec", "test_blob_detect_mask.rec",
              "test_image_membrane.rec", "test_1d_example.rec",
              "test_supervised_pos.txt", "test_supervised_neg.txt"]:
        shutil.copy(reference_fixture_dir / f, tmp_path / f)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def run_fm(args, capture=False):
    import contextlib
    if capture:
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf):
            rc = FM.run(args.split() if isinstance(args, str) else args)
        assert rc == 0, buf.getvalue()
        return buf.getvalue()
    rc = FM.run(args.split() if isinstance(args, str) else args)
    assert rc == 0
    return ""


def count_lines(path):
    with open(path) as f:
        return sum(1 for ln in f if ln.strip())


def test_blob_detection_pipeline(workdir):
    """Port of tests/test_blob_detection.sh."""
    run_fm("-w 19.6 -mask test_blob_detect_mask.rec -in test_blob_detect.rec"
           " -o dog.rec -dog 0 500")
    assert os.path.getsize("dog.rec") > 0

    run_fm("-w 19.6 -mask test_blob_detect_mask.rec -in dog.rec"
           " -o dog_cl.rec -cl -1.3 1.3")
    assert os.path.getsize("dog_cl.rec") > 0

    run_fm("-w 19.6 -mask test_blob_detect_mask.rec -in test_blob_detect.rec"
           " -blob minima test_blobs.txt 160.0 280.0 1.01")
    assert os.path.getsize("test_blobs.txt") > 0

    run_fm("-w 19.6 -mask test_blob_detect_mask.rec -in test_blob_detect.rec"
           " -discard-blobs test_blobs.txt blobs_nms.txt"
           " -blob-separation 1.1 -minima-threshold -90")
    assert count_lines("blobs_nms.txt") == 2

    # draw single-voxel spheres; sum over mask == number of blobs
    run_fm("-w 19.6 -mask test_blob_detect_mask.rec -in dog_cl.rec"
           " -out blobs_img.rec -draw-spheres blobs_nms.txt"
           " -background 0 -foreground 1 -sphere-radii 0")
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        SV.run(["-mask", "test_blob_detect_mask.rec", "blobs_img.rec"])
    assert int(float(buf.getvalue().strip())) == 2

    # supervised thresholding (single)
    log = run_fm("-w 19.6 -mask test_blob_detect_mask.rec"
                 " -in test_blob_detect.rec -discard-blobs test_blobs.txt"
                 " blobs_sup.txt -blob-separation 1.1 -auto-thresh score"
                 " -supervised test_supervised_pos.txt"
                 " test_supervised_neg.txt", capture=True)
    assert os.path.getsize("blobs_sup.txt") > 0
    assert count_lines("blobs_sup.txt") > 0
    thr_single = [ln for ln in log.splitlines()
                  if "threshold upper bound:" in ln][0].split()[-1]
    assert thr_single not in ("inf", "-inf")

    # supervised-multi with the same data duplicated must give the
    # same threshold
    run_fm("-w 19.6 -mask test_blob_detect_mask.rec -in test_blob_detect.rec"
           " -discard-blobs test_blobs.txt blobs_sep.txt"
           " -blob-separation 1.1")
    with open("multi.txt", "w") as f:
        for _ in range(2):
            f.write("test_supervised_pos.txt test_supervised_neg.txt"
                    " blobs_sep.txt\n")
    log2 = run_fm("-w 19.6 -in test_blob_detect.rec -auto-thresh score"
                  " -supervised-multi multi.txt", capture=True)
    thr_multi = [ln for ln in log2.splitlines()
                 if "threshold upper bound:" in ln][0].split()[-1]
    assert thr_multi == thr_single


def test_watershed_pipeline(workdir):
    """Port of tests/test_watershed.sh (3-D portion)."""
    run_fm("-w 19.2 -mask test_blob_detect_mask.rec -in test_blob_detect.rec"
           " -o gauss.rec -gauss 120")
    assert os.path.getsize("gauss.rec") > 0

    run_fm("-w 19.2 -mask test_blob_detect_mask.rec -in gauss.rec"
           " -find-minima minima.txt -o minima.rec")
    n_minima = count_lines("minima.txt")
    assert n_minima > 0
    img = mrc.read_mrc("minima.rec")
    assert int(img.data.max()) == n_minima

    log = run_fm("-w 19.2 -mask test_blob_detect_mask.rec -in gauss.rec"
                 " -out ws.rec -watershed minima", capture=True)
    n_basins = int([ln for ln in log.splitlines()
                    if "Number of basins found:" in ln][0].split()[-1])
    assert n_basins > 0
    ws = mrc.read_mrc("ws.rec")
    assert int(ws.data.max()) == n_basins
    assert n_basins == n_minima

    # invert then find-maxima / watershed maxima must be consistent
    run_fm("-w 19.2 -mask test_blob_detect_mask.rec -in gauss.rec"
           " -out gauss_inv.rec -invert")
    run_fm("-w 19.2 -mask test_blob_detect_mask.rec -in gauss_inv.rec"
           " -find-maxima maxima.txt -o maxima.rec")
    n_maxima = count_lines("maxima.txt")
    assert n_maxima == n_minima
    mx = mrc.read_mrc("maxima.rec")
    assert int(mx.data.max()) == n_maxima

    log = run_fm("-w 19.2 -mask test_blob_detect_mask.rec -in gauss_inv.rec"
                 " -out ws2.rec -watershed maxima", capture=True)
    n_basins_inv = int([ln for ln in log.splitlines()
                        if "Number of basins found:" in ln][0].split()[-1])
    assert n_basins_inv == n_basins

    # -connect behaves like connected components
    log = run_fm("-w 19.2 -mask test_blob_detect_mask.rec -in gauss_inv.rec"
                 " -out conn.rec -connect 36.75", capture=True)
    n_conn = int([ln for ln in log.splitlines()
                  if "Number of clusters found:" in ln][0].split()[-1])
    assert n_conn == 2

    # two uniform spheres -> 2 clusters
    with open("spheres.txt", "w") as f:
        f.write("235.2 392 313.6   169.536\n")
        f.write("254.8 98  274.4   169.536\n")
    run_fm("-w 19.2 -mask test_blob_detect_mask.rec -in test_blob_detect.rec"
           " -out spheres_img.rec -draw-spheres spheres.txt -foreground 1"
           " -background 0 -spheres-shell-ratio 1")
    log = run_fm("-w 19.2 -mask test_blob_detect_mask.rec -in spheres_img.rec"
                 " -out conn2.rec -connect 0.5", capture=True)
    n_uniform = int([ln for ln in log.splitlines()
                     if "Number of clusters found:" in ln][0].split()[-1])
    assert n_uniform == 2


def test_watershed_1d_plateaus(workdir):
    """1-D plateau invariant from tests/test_watershed.sh."""
    run_fm("-w 1 -in test_1d_example.rec -find-maxima max1.txt"
           " -maxima-threshold 1200")
    n1 = count_lines("max1.txt")
    assert n1 > 0
    run_fm("-w 1 -in test_1d_example.rec -out spheres1d.rec"
           " -draw-spheres max1.txt -diameters 3 -foreground 1"
           " -background 0 -spheres-shell-ratio 1")
    run_fm("-w 1 -in spheres1d.rec -find-maxima max2.txt"
           " -maxima-threshold 0.5")
    assert count_lines("max2.txt") == n1


def test_fluctuation_pipeline(workdir):
    """Port of tests/test_fluctuation_filter.sh."""
    run_fm("-in test_image_membrane.rec -mask-rect 1 14 2 14 2 14"
           " -out fluct.rec -fluct 60")
    assert os.path.getsize("fluct.rec") > 0
    out = mrc.read_mrc("fluct.rec")
    assert np.isfinite(out.data).all()


def test_membrane_pipeline(workdir):
    """Port of tests/test_membrane_detection.sh (two phases,
    exercising the save/load-progress checkpoint path)."""
    run_fm("-w 19.2 -in test_image_membrane.rec -out memb.rec"
           " -membrane minima 55 -tv 4 -tv-angle-exponent 4 -bin 2"
           " -save-progress ckpt")
    for d in range(6):
        assert os.path.exists(f"ckpt_tensor_{d}.rec")

    log = run_fm("-w 19.2 -in test_image_membrane.rec -out memb.rec"
                 " -membrane minima 55 -tv 4 -tv-angle-exponent 4 -bin 2"
                 " -load-progress ckpt -connect 1e+09 -connect-angle 30"
                 " -normals-file memb.ply -select-cluster 1",
                 capture=True)
    n_clusters = int([ln for ln in log.splitlines()
                      if "Number of clusters found:" in ln][0].split()[-1])
    assert n_clusters > 0
    assert os.path.getsize("memb.rec") > 0
    # count voxels in the largest cluster (brightness == 1)
    out = mrc.read_mrc("memb.rec")
    n_voxels_largest = int(np.sum(np.abs(out.data - 1.0) < 0.01))
    assert n_voxels_largest > 50
    assert os.path.getsize("memb.ply") > 0


def test_edge_cli_brute_oracle(tmp_path, monkeypatch):
    """Brute-force oracle for the -edge (gradient magnitude) CLI path,
    which the reference binary refuses to run (settings.cpp:2754-2770;
    see README deviations): Gaussian blur (discrete Bessel kernel,
    full-volume edge normalization) -> central-difference gradient with
    nearest-interior face clamping -> * sigma -> Euclidean norm."""
    from tests.test_filters import brute_sep3
    from visfd_jax.ops import kernels as K

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(9, 10, 11)).astype(np.float32)
    mrc.write_mrc("edge_in.mrc", x)
    run_fm("-w 1 -in edge_in.mrc -out edge_out.mrc "
           "-edge minima 2.0 -tv-threshold -1")
    got = mrc.read_mrc("edge_out.mrc").data

    sigma, hw = 2.0, int(np.floor(2.0 * 2.5))
    k = K.gauss_kernel_1d(sigma, hw).astype(np.float64)
    blur = brute_sep3(x.astype(np.float64), k, k, k, normalize=True)

    def sh(dz, dy, dx):
        return np.roll(blur, shift=(-dz, -dy, -dx), axis=(0, 1, 2))

    gx = 0.5 * (sh(0, 0, 1) - sh(0, 0, -1))
    gy = 0.5 * (sh(0, 1, 0) - sh(0, -1, 0))
    gz = 0.5 * (sh(1, 0, 0) - sh(-1, 0, 0))
    g = np.stack([gx, gy, gz], -1)
    g = np.pad(g[1:-1, 1:-1, 1:-1], ((1, 1), (1, 1), (1, 1), (0, 0)),
               mode="edge") * sigma
    expect = np.sqrt((g * g).sum(-1))
    np.testing.assert_allclose(got, expect, atol=5e-6 * expect.max())


def test_phase_checkpoint_npy_roundtrip(tmp_path, monkeypatch):
    """-save-progress-sharded / -load-progress-sharded (numpy phase
    checkpoint) resume phase 2 exactly like the reference's .rec
    -save-progress / -load-progress pair, on a seeded phantom."""
    from visfd_jax.utils.phantom import membrane_phantom
    monkeypatch.chdir(tmp_path)
    mrc.write_mrc("in.mrc", np.asarray(membrane_phantom((24, 40, 32))))
    base = ("-w 19.2 -in in.mrc -membrane minima 55 -tv 1.5 "
            "-tv-angle-exponent 4 ")
    run_fm(base + "-out p1.mrc -save-progress prog "
           "-save-progress-sharded ckpt")
    assert sorted(os.listdir("ckpt")) == ["direction.npy", "saliency.npy",
                                          "vote.npy"]
    tail = " -connect 3e-4 -connect-angle 30"
    run_fm(base + "-out rec.mrc -load-progress prog" + tail)
    run_fm(base + "-out npy.mrc -load-progress-sharded ckpt" + tail)
    np.testing.assert_array_equal(mrc.read_mrc("npy.mrc").data,
                                  mrc.read_mrc("rec.mrc").data)
