"""Experimental ops (reference handlers_unsupported.cpp parity)."""

import os

import numpy as np
import pytest

from visfd_jax.features import experimental as E


def test_distance_to_points():
    pts = np.array([[2, 3, 4], [10, 1, 1]])  # (ix, iy, iz)
    out = E.distance_to_points((8, 6, 12), pts, voxel_width=2.0)
    assert out.shape == (8, 6, 12)
    assert out[4, 3, 2] == 0.0
    assert out[1, 1, 10] == 0.0
    # voxel at (ix=2, iy=3, iz=5): distance 1 voxel * width 2
    assert out[5, 3, 2] == pytest.approx(2.0)
    # nearest-point selection
    d1 = np.sqrt((11 - 2) ** 2 + (1 - 3) ** 2 + (1 - 4) ** 2)
    assert out[1, 1, 11] == pytest.approx(2.0 * min(d1, 1.0))


def test_distance_to_points_mask_keeps_background():
    pts = np.array([[1, 1, 1]])
    bg = np.full((4, 4, 4), 7.0, np.float32)
    mask = np.zeros((4, 4, 4)); mask[0] = 1
    out = E.distance_to_points((4, 4, 4), pts, 1.0, mask=mask,
                               background=bg)
    assert (out[1:] == 7.0).all()
    assert out[0, 1, 1] == pytest.approx(1.0)


def test_distance_points_to_feature():
    img = np.zeros((6, 6, 6), np.float32)
    img[5, 5, 5] = 10.0
    d = E.distance_points_to_feature(
        img, np.array([[0, 0, 0], [5, 5, 5]]), 5.0, 15.0,
        voxel_width=1.0)
    assert d[0] == pytest.approx(np.sqrt(75.0))
    assert d[1] == 0.0
    # nothing selected -> inf
    d2 = E.distance_points_to_feature(img, np.array([[0, 0, 0]]),
                                      100.0, 200.0)
    assert np.isinf(d2[0])


def test_random_spheres_invariants():
    img = np.zeros((24, 24, 24), np.float32)
    centers, occ = E.random_spheres(img, 8, 4.0, -1.0, 1.0, seed=3)
    assert centers.shape == (8, 3)
    r = int(np.ceil(4.0 / 2))
    # pairwise non-overlap: center distance > r (no voxel of one
    # sphere inside another)
    for i in range(8):
        for j in range(i):
            d = np.linalg.norm(centers[i] - centers[j])
            assert d > r, (i, j, d)
    # occupancy painted
    for ix, iy, iz in centers:
        assert occ[iz, iy, ix] == 1.0
    # impossible request errors out
    with pytest.raises(RuntimeError):
        E.random_spheres(img, 3, 20.0, -1.0, 1.0, seed=0,
                         max_attempts_per_sphere=50)


def test_blob_radial_intensity_profile():
    # spherically symmetric blob: profile must match radial function
    zz, yy, xx = np.meshgrid(*[np.arange(16)] * 3, indexing="ij")
    r = np.sqrt((xx - 8.) ** 2 + (yy - 8.) ** 2 + (zz - 8.) ** 2)
    img = np.exp(-r ** 2 / 8.0).astype(np.float32)
    prof, center = E.blob_radial_intensity(img, (8, 8, 8), 8.0,
                                           center_criteria="center")
    assert center == (8, 8, 8)
    assert prof[0] == pytest.approx(1.0)
    assert np.all(np.diff(prof) <= 1e-6)  # monotone decreasing
    # max criteria finds the true peak from an offset center
    prof2, center2 = E.blob_radial_intensity(img, (6, 7, 8), 8.0,
                                             center_criteria="max")
    assert center2 == (8, 8, 8)


def test_template_gen_gauss_peak_at_blob():
    zz, yy, xx = np.meshgrid(*[np.arange(24)] * 3, indexing="ij")
    r2 = (xx - 12.) ** 2 + (yy - 12.) ** 2 + (zz - 12.) ** 2
    img = np.exp(-r2 / (2 * 2.0 ** 2)).astype(np.float32)
    out = np.asarray(E.template_gen_gauss(img, (2.83, 2.83, 2.83),
                                          (6.0, 6.0, 6.0)))
    # the fitted amplitude peaks at the blob center
    assert np.unravel_index(out.argmax(), out.shape) == (12, 12, 12)
    assert out[12, 12, 12] > 0


def test_dogg_xy_shapes_and_response():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(10, 20, 20)).astype(np.float32)
    out = np.asarray(E.dogg_xy(img, (2.0, 2.0), (4.0, 4.0), 2.0))
    assert out.shape == img.shape
    # a DoG bandpass zeroes constants (away from the boundary: kernel
    # halfwidths are hz=5, hxy=10)
    const = np.ones((16, 26, 26), np.float32)
    outc = np.asarray(E.dogg_xy(const, (2.0, 2.0), (4.0, 4.0), 2.0))
    interior = outc[5:11, 10:16, 10:16]
    assert np.abs(interior).max() < 1e-4


def test_cli_experimental_ops(tmp_path):
    from visfd_jax.cli.filter_mrc import run
    from visfd_jax.io import mrc

    rng = np.random.default_rng(1)
    img = rng.normal(size=(12, 12, 12)).astype(np.float32)
    src = str(tmp_path / "in.mrc")
    mrc.write_mrc(src, img)

    pts = str(tmp_path / "pts.txt")
    with open(pts, "w") as fh:
        fh.write("2 3 4\n8 8 8\n")

    out = str(tmp_path / "dist.mrc")
    assert run(["-in", src, "-out", out, "-w", "1",
                "-distance-points", pts]) == 0
    d = mrc.read_mrc(out).data
    assert d[4, 3, 2] == 0.0

    outd = str(tmp_path / "d.txt")
    assert run(["-in", src, "-out", str(tmp_path / "ignore.mrc"),
                "-w", "1", "-distance-to-voxels", pts, outd,
                "-100", "100"]) == 0
    vals = [float(l.split()[0]) for l in open(outd)]
    assert vals == [0.0, 0.0]

    outr = str(tmp_path / "rs.mrc")
    crds = str(tmp_path / "rs.txt")
    assert run(["-in", src, "-out", outr, "-w", "1", "-random-spheres",
                crds, "3", "3.0", "-100", "100", "7"]) == 0
    assert len(open(crds).readlines()) == 3

    outt = str(tmp_path / "tg.mrc")
    assert run(["-in", src, "-out", outt, "-w", "1",
                "-template-gauss", "2.0", "4.0"]) == 0
    assert mrc.read_mrc(outt).data.shape == img.shape

    outx = str(tmp_path / "dxy.mrc")
    assert run(["-in", src, "-out", outx, "-w", "1",
                "-doggxy", "2.0", "4.0", "2.0"]) == 0
    assert mrc.read_mrc(outx).data.shape == img.shape

    blobs = str(tmp_path / "blobs.txt")
    with open(blobs, "w") as fh:
        fh.write("6 6 6 4.0 1.0\n")
    base = str(tmp_path / "prof")
    assert run(["-in", src, "-out", str(tmp_path / "ignore2.mrc"),
                "-w", "1", "-blob-intensity-vs-radius", "center",
                blobs, base]) == 0
    assert os.path.exists(base + "_1.txt")
