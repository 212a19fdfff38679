"""Multi-device parity: sharded blob ladder, sharded plateau extrema,
and cross-device reductions must reproduce the single-device results
bit-exactly on a forced 8-device CPU mesh (SURVEY 4 last bullet)."""

import numpy as np
import pytest

from visfd_jax.io import read_mrc
from visfd_jax.features import blob as B
from visfd_jax.segment.extrema import find_extrema
from visfd_jax.parallel.mesh import make_mesh
from visfd_jax.parallel import reduce as R
from visfd_jax.parallel.sharded_features import (
    sharded_blob_dog, find_extrema_sharded)

FIX = "/root/reference/tests/test_blob_detect.rec"
MASKF = "/root/reference/tests/test_blob_detect_mask.rec"

SIGMAS = [d / (2 * np.sqrt(3)) for d in (5.0, 6.0, 7.2, 8.6, 10.4)]
BLOB_KW = dict(minima_threshold=0.5, maxima_threshold=0.5,
               use_threshold_ratios=True)


@pytest.fixture(scope="module")
def img(reference_fixture_dir):
    return read_mrc(FIX).data


@pytest.fixture(scope="module")
def maskimg(reference_fixture_dir):
    return read_mrc(MASKF).data


def _blobs_equal(a, b):
    return (len(a) == len(b)
            and np.array_equal(a.crds, b.crds)
            and np.array_equal(a.diameters, b.diameters)
            and np.array_equal(a.scores, b.scores))


@pytest.mark.parametrize("n_devices", [1, 8])
def test_sharded_blob_bit_identical(img, n_devices):
    ref_min, ref_max = B.blob_dog(img, SIGMAS, **BLOB_KW)
    smin, smax = sharded_blob_dog(img, SIGMAS, make_mesh(n_devices),
                                  **BLOB_KW)
    assert _blobs_equal(smin, ref_min)
    assert _blobs_equal(smax, ref_max)


def test_sharded_blob_masked(img, maskimg):
    ref_min, ref_max = B.blob_dog(img, SIGMAS, mask=maskimg, **BLOB_KW)
    smin, smax = sharded_blob_dog(img, SIGMAS, make_mesh(8),
                                  mask=maskimg, **BLOB_KW)
    assert _blobs_equal(smin, ref_min)
    assert _blobs_equal(smax, ref_max)


@pytest.mark.parametrize("conn,quantize,use_mask", [
    (3, False, False),
    (3, False, True),
    (1, True, False),   # quantized -> multi-voxel plateaus
    (2, True, True),
])
def test_sharded_extrema_identical(img, maskimg, conn, quantize, use_mask):
    x = np.round(img / 8).astype(np.float32) if quantize else img
    m = maskimg if use_mask else None
    ref = find_extrema(x, mask=m, connectivity=conn)
    got = find_extrema_sharded(x, make_mesh(8), mask=m, connectivity=conn)
    np.testing.assert_array_equal(ref.minima_indices, got.minima_indices)
    np.testing.assert_array_equal(ref.maxima_indices, got.maxima_indices)
    np.testing.assert_array_equal(ref.minima_scores, got.minima_scores)
    np.testing.assert_array_equal(ref.maxima_scores, got.maxima_scores)
    np.testing.assert_array_equal(ref.minima_nvoxels, got.minima_nvoxels)
    np.testing.assert_array_equal(ref.maxima_nvoxels, got.maxima_nvoxels)
    np.testing.assert_array_equal(ref.label_image, got.label_image)


def test_global_min_max_mean(rng):
    x = (rng.normal(size=(22, 32, 27)) * 37.5).astype(np.float32)
    m = (rng.random(x.shape) > 0.3).astype(np.float32)
    mesh = make_mesh(8)
    vmin, vmax, vmean = R.global_min_max_mean(x, mesh, m)
    vals = x[m != 0]
    assert vmin == vals.min()
    assert vmax == vals.max()
    assert np.isclose(vmean, vals.mean(), rtol=1e-5)


@pytest.mark.parametrize("fraction", [0.0, 0.05, 0.5, 0.999, 1.0])
def test_fraction_threshold_exact(rng, fraction):
    """The -tv-best distributed quantile is bit-identical to the
    reference's full descending sort (handlers.cpp:1753-1797)."""
    x = (rng.normal(size=(22, 32, 27)) * 37.5).astype(np.float32)
    m = (rng.random(x.shape) > 0.3).astype(np.float32)
    mesh = make_mesh(8)
    vals = np.sort(x[m != 0])[::-1]
    k = min(int(np.floor(len(vals) * fraction)), len(vals) - 1)
    thr = R.fraction_threshold(x, fraction, mesh, m)
    assert thr == vals[k]


def _wells(shape=(16, 17, 18), centers=((4, 5, 6), (12, 12, 13)),
           depths=(2.0, 1.5)):
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    out = np.zeros(shape, np.float32)
    for (cz, cy, cx), d in zip(centers, depths):
        r2 = (zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2
        out -= d * np.exp(-r2 / 18.0)
    return out


@pytest.mark.parametrize("n_devices", [1, 8])
def test_sharded_watershed_identical(rng, n_devices):
    from visfd_jax.segment.propagate import propagate_watershed
    from visfd_jax.parallel.sharded_features import (
        propagate_watershed_sharded)
    x = rng.normal(size=(12, 13, 14)).astype(np.float32)
    for ax in range(3):
        x = (x + np.roll(x, 1, ax) + np.roll(x, -1, ax)) / 3.0
    mask = (rng.random(x.shape) > 0.1).astype(np.float32)
    for minima in (True, False):
        ref = propagate_watershed(x, mask=mask, start_from_minima=minima)
        got = propagate_watershed_sharded(
            x, make_mesh(n_devices), mask=mask, start_from_minima=minima)
        assert got.num_basins == ref.num_basins
        np.testing.assert_array_equal(got.labels, ref.labels)
        np.testing.assert_array_equal(got.basin_locations,
                                      ref.basin_locations)
        np.testing.assert_array_equal(got.basin_scores, ref.basin_scores)


def test_sharded_watershed_plateaus():
    from visfd_jax.segment.propagate import propagate_watershed
    from visfd_jax.parallel.sharded_features import (
        propagate_watershed_sharded)
    x = np.round(_wells(depths=(2.0, 2.0)) * 4) / 4  # flat tops
    ref = propagate_watershed(x)
    got = propagate_watershed_sharded(x, make_mesh(8))
    assert got.num_basins == ref.num_basins == 2
    np.testing.assert_array_equal(got.labels, ref.labels)


@pytest.mark.parametrize("n_devices", [1, 8])
def test_sharded_connect_identical(n_devices):
    """label_connected over a device mesh (sharded gates + seeds +
    candidate compaction, compact host flood) vs the single-device
    dense path: identical labels/clusters; standardized vectors
    identical at every assigned voxel."""
    from visfd_jax.segment import connect as C
    rng = np.random.default_rng(17)
    shape = (16, 14, 15)
    sal = rng.random(shape).astype(np.float32)
    for ax in range(3):
        sal = (sal + np.roll(sal, 1, ax) + np.roll(sal, -1, ax)) / 3.0
    sal = sal.astype(np.float32)
    vec = rng.normal(size=shape + (3,)).astype(np.float32)
    tens = rng.normal(size=shape + (6,)).astype(np.float32)
    mask = rng.random(shape) > 0.1
    kw = dict(
        mask=mask,
        threshold_saliency=0.3,
        vector=vec,
        threshold_vector_saliency=-0.5,
        threshold_vector_neighbor=0.2,
        consider_dot_product_sign=False,
        tensor=tens,
        threshold_tensor_saliency=-0.5,
        threshold_tensor_neighbor=-0.2,
        connectivity=3,
        standardize_vector_sign=True,
    )
    ref = C.label_connected(sal, compact=False, **kw)
    got = C.label_connected(sal, mesh=make_mesh(n_devices), **kw)
    assert got.num_clusters == ref.num_clusters
    np.testing.assert_array_equal(got.labels, ref.labels)
    np.testing.assert_array_equal(got.cluster_sizes, ref.cluster_sizes)
    np.testing.assert_array_equal(got.cluster_maxima, ref.cluster_maxima)
    sel = (ref.labels >= 1) & (ref.labels <= ref.num_clusters)
    np.testing.assert_array_equal(got.vector_standardized[sel],
                                  ref.vector_standardized[sel])


def test_cli_watershed_device(tmp_path, img):
    """-watershed-device (extension): basin count equals the host
    Meyer flood's; boundaries and markers are supported (exact label
    parity on distinct-valued volumes is asserted in
    tests/test_propagate.py -- this byte-mode fixture is full of
    plateaus, so only counts are compared here)."""
    import io
    import contextlib
    from visfd_jax.cli import filter_mrc as FM
    from visfd_jax.io import write_mrc, read_mrc
    inp = tmp_path / "in.mrc"
    write_mrc(str(inp), img.astype(np.float32))
    outs = {}
    for name, extra in [("host", ["-watershed-hide-boundaries"]),
                        ("dev", ["-watershed-device",
                                 "-watershed-hide-boundaries"]),
                        ("devb", ["-watershed-device"])]:
        out = tmp_path / f"{name}.mrc"
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf):
            rc = FM.run(["-in", str(inp), "-out", str(out), "-w", "1",
                         "-watershed", "minima"] + extra)
        assert rc == 0, buf.getvalue()[-1500:]
        outs[name] = read_mrc(str(out)).data
    assert outs["host"].max() == outs["dev"].max()  # same basin count
    # boundary run: same basin count, some boundary (0) voxels allowed
    assert outs["devb"].max() == outs["dev"].max()

    # markers: two seed voxels -> exactly those labels + undefined max
    markers = np.zeros(img.shape, np.float32)
    markers[5, 10, 10] = 4
    markers[15, 20, 15] = 9
    mf = tmp_path / "markers.mrc"
    write_mrc(str(mf), markers)
    out = tmp_path / "marked.mrc"
    with contextlib.redirect_stderr(io.StringIO()):
        rc = FM.run(["-in", str(inp), "-out", str(out), "-w", "1",
                     "-watershed", "minima", "-watershed-device",
                     "-watershed-hide-boundaries",
                     "-markers", str(mf)])
    assert rc == 0
    got = read_mrc(str(out)).data
    assert set(np.unique(got)) <= {0.0, 4.0, 9.0, 10.0}


def test_kth_largest_duplicates_and_mesh_sizes(rng):
    x = np.round(rng.normal(size=(16, 16, 16)) * 5).astype(np.float32)
    sv = np.sort(x.reshape(-1))[::-1]
    for nd in (1, 2, 8):
        got = float(R.kth_largest(x, 1234, make_mesh(nd)))
        assert got == sv[1234]


@pytest.mark.parametrize("n_devices", [1, 8])
def test_sharded_watershed_markers_identical(rng, n_devices):
    """Marker-seeded watershed: the minimax flood runs SHARDED (round
    4) and must stay bit-identical to the single-device path --
    labels, basin locations, scores."""
    from visfd_jax.segment.propagate import propagate_watershed
    from visfd_jax.parallel.sharded_features import (
        propagate_watershed_sharded)
    x = rng.normal(size=(11, 14, 13)).astype(np.float32)
    for ax in range(3):
        x = (x + np.roll(x, 1, ax) + np.roll(x, -1, ax)) / 3.0
    markers = np.zeros(x.shape, np.int64)
    markers[2, 3, 4] = 7
    markers[8, 9, 10] = 3
    markers[5, 2, 11] = 12
    mask = (rng.random(x.shape) > 0.08).astype(np.float32)
    for minima in (True, False):
        for m in (None, mask):
            ref = propagate_watershed(x, mask=m, markers=markers,
                                      start_from_minima=minima)
            got = propagate_watershed_sharded(
                x, make_mesh(n_devices), mask=m, markers=markers,
                start_from_minima=minima)
            assert got.num_basins == ref.num_basins
            np.testing.assert_array_equal(got.labels, ref.labels)
            np.testing.assert_array_equal(got.basin_locations,
                                          ref.basin_locations)
            np.testing.assert_array_equal(got.basin_scores,
                                          ref.basin_scores)


@pytest.mark.parametrize("markers", [False, True])
def test_sharded_watershed_boundaries_identical(rng, markers):
    """show_boundaries: the boundary minimax flood runs sharded; the
    Meyer boundary labels must equal the single-device result."""
    from visfd_jax.segment.propagate import propagate_watershed
    from visfd_jax.parallel.sharded_features import (
        propagate_watershed_sharded)
    x = rng.permutation(12 * 13 * 14).astype(np.float32).reshape(
        12, 13, 14)
    mk = None
    if markers:
        mk = np.zeros(x.shape, np.int64)
        mk[3, 3, 3] = 2
        mk[9, 10, 11] = 5
    ref = propagate_watershed(x, markers=mk, show_boundaries=True,
                              label_boundary=77)
    got = propagate_watershed_sharded(x, make_mesh(8), markers=mk,
                                      show_boundaries=True,
                                      label_boundary=77)
    assert got.num_basins == ref.num_basins
    np.testing.assert_array_equal(got.labels, ref.labels)


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_per_shard_compaction_equals_global(n_devices):
    """-connect's candidate compaction (each device compacts its block;
    the host merges the lists into raster order) returns every candidate
    in raster order with its own values, on one device and over (z)- and
    (z, y)-split meshes alike."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from visfd_jax.segment import connect as C
    rng = np.random.default_rng(5)
    shape = (16, 14, 15)
    sal = rng.random(shape).astype(np.float32)
    cand = sal > 0.7
    disc = rng.random(shape) > 0.5
    tens = rng.normal(size=shape + (6,)).astype(np.float32)
    vec = rng.normal(size=shape + (3,)).astype(np.float32)
    mesh = make_mesh(n_devices)

    def put(a):
        if n_devices == 1:
            return jnp.asarray(a)
        spec = P(*mesh.axis_names, *([None] * (a.ndim - 2)))
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

    got = C._compact_connect(put(cand), put(sal), put(disc), put(tens),
                             put(vec))
    z, y, x = np.nonzero(cand)
    want = [np.stack([z, y, x], axis=-1), sal[z, y, x],
            disc[z, y, x].astype(np.uint8), tens[z, y, x], vec[z, y, x]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype or g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
