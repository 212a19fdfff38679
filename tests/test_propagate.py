"""Device-scale label-propagation watershed vs the host Meyer flood."""

import numpy as np
import pytest

from visfd_jax.segment.propagate import propagate_watershed
from visfd_jax.segment.watershed import watershed


def _wells(shape=(16, 17, 18), centers=((4, 5, 6), (12, 12, 13)),
           depths=(2.0, 1.5)):
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    out = np.zeros(shape, np.float32)
    for (cz, cy, cx), d in zip(centers, depths):
        r2 = (zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2
        out -= d * np.exp(-r2 / 18.0)
    return out


def test_two_wells_match_host_flood():
    x = _wells()
    host = watershed(x, show_boundaries=False)
    dev = propagate_watershed(x)
    assert dev.num_basins == host.num_basins == 2
    np.testing.assert_array_equal(dev.labels, host.labels)
    np.testing.assert_array_equal(dev.basin_locations, host.basin_locations)


@pytest.mark.parametrize("minima", [True, False])
def test_basin_count_matches_host(minima):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(12, 13, 14)).astype(np.float32)
    for ax in range(3):
        x = (x + np.roll(x, 1, ax) + np.roll(x, -1, ax)) / 3.0
    mask = rng.random(x.shape) > 0.1
    host = watershed(x, mask=mask, start_from_minima=minima,
                     show_boundaries=False)
    dev = propagate_watershed(x, mask=mask, start_from_minima=minima)
    assert dev.num_basins == host.num_basins
    np.testing.assert_array_equal(dev.basin_locations, host.basin_locations)
    # every in-mask voxel belongs to a basin
    assert dev.labels[mask].min() >= 1
    assert dev.labels[mask].max() == dev.num_basins
    assert (dev.labels[~mask] == -1).all()


def test_plateaus_and_halt():
    # flat-topped wells (quantized) exercise the plateau resolution
    x = np.round(_wells(depths=(2.0, 2.0)) * 4) / 4
    host = watershed(x, show_boundaries=False)
    dev = propagate_watershed(x)
    assert dev.num_basins == host.num_basins
    # halt: voxels above the threshold are undefined
    dev_h = propagate_watershed(x, halt_threshold=-0.5)
    assert (dev_h.labels[x > -0.5] == -1).all()
    assert (dev_h.labels[x <= -0.5] >= 1).all()


def _distinct_random(shape=(10, 11, 12), seed=7):
    """Smooth random field with globally distinct values (no plateaus,
    no ties): the regime where the device watershed's reconstruction
    of the Meyer flood is exact."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    for ax in range(3):
        x = (x + np.roll(x, 1, ax) + np.roll(x, -1, ax)) / 3.0
    x = x.astype(np.float64) + np.arange(x.size).reshape(shape) * 1e-9
    x = x.astype(np.float32)
    assert len(np.unique(x)) == x.size
    return x


@pytest.mark.parametrize("minima", [True, False])
def test_label_map_matches_meyer(minima):
    """Label-level (not just count) parity with the host Meyer flood
    on a distinct-valued volume."""
    x = _distinct_random()
    host = watershed(x, start_from_minima=minima, show_boundaries=False)
    dev = propagate_watershed(x, start_from_minima=minima)
    np.testing.assert_array_equal(dev.labels, host.labels)


def test_boundaries_match_meyer():
    x = _distinct_random(seed=11)
    host = watershed(x, show_boundaries=True)
    dev = propagate_watershed(x, show_boundaries=True)
    assert dev.num_basins == host.num_basins
    np.testing.assert_array_equal(dev.labels, host.labels)


def test_boundaries_match_meyer_with_mask_and_custom_label():
    x = _distinct_random(seed=3)
    rng = np.random.default_rng(1)
    mask = rng.random(x.shape) > 0.15
    host = watershed(x, mask=mask, show_boundaries=True,
                     label_boundary=99)
    dev = propagate_watershed(x, mask=mask, show_boundaries=True,
                              label_boundary=99)
    np.testing.assert_array_equal(dev.labels, host.labels)


def test_markers_match_meyer():
    x = _distinct_random(seed=21)
    markers = np.zeros(x.shape, np.int64)
    markers[2, 3, 4] = 7
    markers[7, 8, 9] = 3
    markers[5, 2, 10] = 12
    host = watershed(x, markers=markers, show_boundaries=False)
    dev = propagate_watershed(x, markers=markers)
    assert dev.num_basins == host.num_basins == 3
    np.testing.assert_array_equal(dev.basin_locations,
                                  host.basin_locations)
    np.testing.assert_array_equal(dev.labels, host.labels)


def test_markers_with_boundaries_match_meyer():
    x = _distinct_random(seed=22)
    markers = np.zeros(x.shape, np.int64)
    markers[1, 1, 1] = 2
    markers[8, 9, 10] = 5
    host = watershed(x, markers=markers, show_boundaries=True)
    dev = propagate_watershed(x, markers=markers, show_boundaries=True)
    np.testing.assert_array_equal(dev.labels, host.labels)


def test_meyer_boundaries_sequential_reference():
    """The vectorized contested cascade reproduces the per-voxel
    sequential semantics exactly on a noise volume (large contested
    set with nontrivial dependency chains)."""
    from visfd_jax.segment import extrema as E
    from visfd_jax.segment.propagate import (meyer_boundaries,
                                             propagate_watershed)
    rng = np.random.default_rng(5)
    x = rng.permutation(18 * 19 * 20).astype(np.float32).reshape(18, 19, 20)
    res = propagate_watershed(x)
    labels = res.labels
    offs = E.neighbor_offsets(1)

    # rebuild the minimax flooding level exactly as the caller does
    import jax.numpy as jnp
    from visfd_jax.segment.propagate import _minimax_device
    seeds = np.zeros(labels.shape, np.int32)
    locs = np.asarray(res.basin_locations)
    seeds[locs[:, 2], locs[:, 1], locs[:, 0]] = np.arange(
        1, len(locs) + 1, dtype=np.int32)
    r, _ = _minimax_device(jnp.asarray(x), jnp.asarray(seeds), None, offs)
    r = np.asarray(r)

    got = meyer_boundaries(labels, r, x, offs, label_boundary=0)

    # per-voxel sequential oracle (the pre-round-4 implementation)
    nzny = labels.shape
    assigned = labels > 0
    flat_idx = np.arange(labels.size, dtype=np.int64).reshape(nzny)
    contested = np.zeros(nzny, bool)
    neigh_tables = []
    for dz, dy, dx in offs:
        sl_src = tuple(slice(max(0, -d), min(s, s - d))
                       for d, s in zip((dz, dy, dx), nzny))
        sl_dst = tuple(slice(max(0, d), min(s, s + d))
                       for d, s in zip((dz, dy, dx), nzny))
        nlab = np.full(nzny, -2, np.int64)
        nidx = np.full(nzny, -1, np.int64)
        nlab[sl_dst] = labels[sl_src]
        nassigned = np.zeros(nzny, bool)
        nassigned[sl_dst] = assigned[sl_src]
        nidx[sl_dst] = flat_idx[sl_src]
        contested |= assigned & nassigned & (nlab != labels)
        neigh_tables.append(nidx.reshape(-1))
    rf, xf = r.reshape(-1), x.reshape(-1)
    lf, af = labels.reshape(-1), assigned.reshape(-1)
    cf = np.flatnonzero(contested.reshape(-1))
    order = cf[np.lexsort((cf, xf[cf], rf[cf]))]
    assert len(order) > 1000  # the cascade actually runs
    boundary = np.zeros(labels.size, bool)
    ntab = np.stack(neigh_tables, axis=0)
    for v in order:
        key_v = (rf[v], xf[v], v)
        for u in ntab[:, v]:
            if u < 0 or not af[u] or boundary[u] or lf[u] == lf[v]:
                continue
            if (rf[u], xf[u], u) < key_v:
                boundary[v] = True
                break
    want = labels.copy()
    want.reshape(-1)[boundary] = 0
    np.testing.assert_array_equal(got, want)


def test_meyer_boundaries_noise_volume_fast():
    """>= 1e5 contested voxels resolve in about a second (the round-3
    per-voxel Python cascade was unbounded on noise volumes)."""
    import time
    from visfd_jax.segment import extrema as E
    from visfd_jax.segment.propagate import meyer_boundaries
    rng = np.random.default_rng(9)
    shape = (48, 64, 64)
    # adversarial label map: dense random labels -> almost every voxel
    # contested; random keys
    labels = rng.integers(1, 9, size=shape).astype(np.int64)
    r = rng.random(shape).astype(np.float32)
    x = rng.permutation(np.prod(shape)).astype(np.float32).reshape(shape)
    offs = E.neighbor_offsets(1)
    t0 = time.thread_time()
    out = meyer_boundaries(labels, r, x, offs, label_boundary=0)
    dt = time.thread_time() - t0
    n_contested = int(np.sum(out >= 0))  # sanity use of the result
    assert n_contested > 0
    assert (out == 0).sum() > 100_000  # most voxels became boundary
    assert dt < 3.0, f"cascade took {dt:.2f}s CPU"
