"""filter_mrc: the workhorse CLI driver.

Mirrors the reference's ``bin/filter_mrc/filter_mrc.cpp`` main() flow
(read -> mask -> voxel width -> binning -> unit rescale -> one handler
-> invert/threshold/mask-fill/rescale -> write) and its handlers
(``handlers.cpp``), re-targeted onto this JAX library: all voxel
math dispatches into jit-compiled XLA ops; list/graph work stays on
the host like the reference.

Usage: python -m visfd_jax.cli.filter_mrc -in in.rec -out out.rec ...
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from visfd_jax.cli import settings as S
from visfd_jax.cli.settings import Settings, InputError
from visfd_jax.io import mrc
from visfd_jax.parallel.gather import to_host_np, is_writer
from visfd_jax.io.coords import (read_blob_coords_file,
                                 write_blob_coords_file, fmt_g,
                                 read_coordinates)
from visfd_jax.io.pointcloud import write_oriented_pointcloud_ply
from visfd_jax.ops import filters as F
from visfd_jax.ops import morphology as M
from visfd_jax.ops import threshold as T
from visfd_jax.ops import resample as R
from visfd_jax.ops import draw as D
from visfd_jax.ops import kernels as K
from visfd_jax.features import blob as B
from visfd_jax.features import hessian as FH
from visfd_jax.features import tv as TV
from visfd_jax.features import supervised as SUP
from visfd_jax.linalg import sym3
from visfd_jax.segment.watershed import watershed
from visfd_jax.segment.connect import label_connected


def _truncate_ratio(s: Settings) -> float:
    if s.filter_truncate_ratio > 0:
        return s.filter_truncate_ratio
    assert s.filter_truncate_threshold > 0
    return float(np.sqrt(-2.0 * np.log(s.filter_truncate_threshold)))


def _mask_or_none(mask_img):
    return None if mask_img is None else jnp.asarray(mask_img)


def _cli_mesh(s: Settings):
    """The (z, y) device mesh requested with ``-mesh``, or None."""
    if not getattr(s, "mesh_devices", 0):
        return None
    from visfd_jax.parallel.mesh import make_mesh
    n = None if s.mesh_devices < 0 else s.mesh_devices
    return make_mesh(n)


def _maybe_shard(s: Settings, arr):
    """device_put ``arr`` with the (z, y) grid sharding when -mesh is
    active; GSPMD then partitions every dense stage consuming it (XLA
    inserts the halo collectives -- same math, same results).  Axes the
    mesh does not divide evenly are left unsharded (device_put rejects
    ragged NamedSharding blocks), so odd-shaped volumes still run --
    partially sharded instead of crashing."""
    if arr is None:
        return None
    mesh = _cli_mesh(s)
    if mesh is None:
        return arr
    # every sharded consumer in this driver is a 3-D (Z, Y, X) volume;
    # anything lower-rank would silently shard the wrong axis
    assert arr.ndim >= 3, arr.shape
    from jax.sharding import NamedSharding, PartitionSpec as P
    nz_m, ny_m = mesh.devices.shape
    zn, yn = mesh.axis_names
    spec = (zn if arr.shape[0] % nz_m == 0 else None,
            yn if arr.shape[1] % ny_m == 0 else None)
    if spec != (zn, yn):
        print(f"-mesh: volume {tuple(arr.shape)} not divisible by the "
              f"({nz_m}, {ny_m}) device grid; sharding axes {spec}",
              file=sys.stderr)
    return jax.device_put(
        jnp.asarray(arr),
        NamedSharding(mesh, P(*(spec + (None,) * (arr.ndim - 2)))))


def determine_voxel_width(s: Settings, img: mrc.MrcImage) -> np.ndarray:
    """``DetermineVoxelWidth`` (``handlers.cpp:2429-2531``)."""
    if s.voxel_width > 0:
        w = np.full(3, s.voxel_width, np.float64)
        if s.resize_with_binning > 0:
            w *= s.resize_with_binning
        return w
    nx, ny, nz = img.header.nvoxels
    if nx == 0 or ny == 0 or nz == 0:
        return np.full(3, -1.0)
    w = np.asarray(img.header.voxel_width_xyz, np.float64)
    if s.voxel_width_divide_by_10:
        w = w * 0.1
    print(f"voxel width in physical units = ({w[0]:.8g}, {w[1]:.8g}, "
          f"{w[2]:.8g})", file=sys.stderr)
    if w.max() != w.min():
        ave = w.mean()
        if (w.max() - w.min()) > 0.000005 * ave:
            raise InputError(
                "ERROR: The voxel width in the X,Y,Z directions varies by "
                "more than 0.0005%.\nUse the -w argument.")
        w = np.full(3, ave)
    if (abs((w[0] - w[1]) / (0.5 * (w[0] + w[1]))) > 1e-4
            or abs((w[0] - w[2]) / (0.5 * (w[0] + w[2]))) > 1e-4):
        raise InputError("Error: unequal voxel widths; use -w")
    return w


def handle_binning(s: Settings, img, mask_img, w):
    """``HandleBinning`` (``handlers.cpp:2361-2425``)."""
    nz, ny, nx = img.data.shape
    b = s.resize_with_binning
    new_zyx = (nz // b, ny // b, nx // b)
    vw = s.voxel_width if s.voxel_width > 0 else img.header.cellA[0] / nx
    vw = vw * b
    img.data = np.asarray(R.bin_array3d(jnp.asarray(img.data), new_zyx))
    img.header.nvoxels = (new_zyx[2], new_zyx[1], new_zyx[0])
    img.header.cellA = tuple(vw * n for n in img.header.nvoxels)
    if mask_img is not None:
        binned = np.asarray(R.bin_array3d(jnp.asarray(mask_img), new_zyx))
        mask_img = binned
    w[:] = vw
    return img, mask_img


# ---------------------------------------------------------------------------
# handlers

def handle_gauss(s, x, mask):
    sig = s.width_a
    hw = [max(1, int(np.floor(si * _truncate_ratio(s)))) for si in sig]
    return to_host_np(F.apply_gauss(
        x, tuple(sig), mask=mask, truncate_halfwidth=hw,
        normalize=s.normalize_near_boundaries))


def handle_ggauss(s, x, mask):
    # generalized Gaussians convert the truncate threshold with their
    # own exponent: ratio = (-ln t)^(1/m), NOT the m=2 Gaussian formula
    # (filter3d_variants.hpp:87-110)
    if s.filter_truncate_ratio > 0:
        tr = s.filter_truncate_ratio
    else:
        tr = K.halfwidth_from_threshold(1.0, s.m_exp,
                                        s.filter_truncate_threshold)
    out = F.apply_gen_gauss(
        x, tuple(s.width_a), s.m_exp, mask=mask,
        truncate_ratio=tr,
        normalize=s.normalize_near_boundaries)
    if mask is not None:
        out = jnp.where(jnp.asarray(mask) != 0, out, 0.0)
    return to_host_np(out)


def handle_dogg(s, x, mask):
    """``HandleDogg`` (``handlers.cpp:265-293``): difference of
    generalized Gaussians honoring ``-exponents m n``; dense conv,
    no edge normalization."""
    return to_host_np(F.apply_dogg(
        x, tuple(s.width_a), tuple(s.width_b), s.m_exp, s.n_exp,
        mask=mask,
        truncate_ratio=s.filter_truncate_ratio,
        truncate_threshold=s.filter_truncate_threshold))


def handle_dog(s, x, mask):
    # the variant wrapper applies each Gaussian with its own
    # sigma-derived window (filter3d_variants.hpp:544-590)
    tr = _truncate_ratio(s)
    hwa = [max(1, int(np.floor(si * tr))) for si in s.width_a]
    hwb = [max(1, int(np.floor(si * tr))) for si in s.width_b]
    ga = F.apply_gauss(x, tuple(s.width_a), mask=mask, truncate_halfwidth=hwa)
    gb = F.apply_gauss(x, tuple(s.width_b), mask=mask, truncate_halfwidth=hwb)
    return to_host_np(ga - gb)


def handle_log(s, x, mask):
    return to_host_np(F.apply_log(
        x, tuple(s.log_width), mask=mask,
        delta_sigma_over_sigma=s.delta_sigma_over_sigma,
        truncate_ratio=_truncate_ratio(s)))


def handle_median(s, x, mask):
    return to_host_np(F.median_filter(x, s.median_radius, mask=mask))


def handle_morphology(s, x, mask):
    fn = {
        S.DILATION: M.dilate_sphere,
        S.EROSION: M.erode_sphere,
        S.OPENING: M.open_sphere,
        S.CLOSING: M.close_sphere,
        S.TOP_HAT_WHITE: M.white_top_hat_sphere,
        S.TOP_HAT_BLACK: M.black_top_hat_sphere,
    }[s.filter_type]
    return to_host_np(fn(x, s.morphology_r, mask=mask,
                         radius_max=s.morphology_rmax,
                         bmax=s.morphology_bmax
                         if s.morphology_rmax > 0 else 0.0))


def handle_fluct(s, x, mask):
    # threshold -> ratio conversion uses the template exponent:
    # ratio = (-ln t)^(1/m) (filter3d_variants.hpp:652-681)
    if s.filter_truncate_ratio > 0:
        tr = s.filter_truncate_ratio
    else:
        tr = K.halfwidth_from_threshold(
            1.0, s.template_background_exponent,
            s.filter_truncate_threshold)
    return to_host_np(F.local_fluctuations_by_radius(
        x, tuple(s.template_background_radius), mask=mask,
        m_exp=s.template_background_exponent,
        truncate_ratio=tr,
        normalize=s.normalize_near_boundaries))


def handle_extrema(s, x_np, mask_np, w):
    """``HandleExtrema`` (``handlers.cpp:1086-1245``)."""
    from visfd_jax.segment.extrema import find_extrema, flat_to_xyz
    res = find_extrema(
        x_np, mask=mask_np,
        find_minima=s.find_minima, find_maxima=s.find_maxima,
        minima_threshold=s.score_upper_bound,
        maxima_threshold=s.score_lower_bound,
        connectivity=s.neighbor_connectivity,
        allow_borders=s.extrema_on_boundary,
        want_label_image=True)
    print(f"Found {res.num_extrema} extrema", file=sys.stderr)
    shape = x_np.shape

    def write(fname, idxs, nvox, scores):
        with open(fname, "w") as fh:
            for i, nv, sc in zip(idxs, nvox, scores):
                ix, iy, iz = flat_to_xyz(int(i), shape)
                fh.write(f"{fmt_g(ix * w[0])} {fmt_g(iy * w[1])} "
                         f"{fmt_g(iz * w[2])} {nv} {fmt_g(sc)}\n")

    if is_writer() and s.find_minima and len(res.minima_indices):
        write(s.find_minima_file_name, res.minima_indices,
              res.minima_nvoxels, res.minima_scores)
    if is_writer() and s.find_maxima and len(res.maxima_indices):
        write(s.find_maxima_file_name, res.maxima_indices,
              res.maxima_nvoxels, res.maxima_scores)
    out = res.label_image.astype(np.float32)
    if mask_np is not None:
        out = np.where(mask_np != 0, out, 0.0)
    return out


def handle_watershed(s, x_np, mask_np):
    """``HandleWatershed`` (``handlers.cpp:1279-1391``).

    With ``-watershed-device`` (extension) the volume stays in HBM and
    basins come from the sharded steepest-descent propagation
    (``parallel.sharded_features.propagate_watershed_sharded``);
    markers seed a device minimax flood and boundary labels come from
    the Meyer-order contested-voxel cascade -- label-level parity with
    the host flood wherever intensities are distinct."""
    markers = None
    if s.watershed_markers_filename:
        markers = np.round(
            mrc.read_mrc(s.watershed_markers_filename).data).astype(np.int64)
    if s.watershed_on_device:
        from visfd_jax.parallel.mesh import make_mesh
        from visfd_jax.parallel.sharded_features import (
            propagate_watershed_sharded)
        # -mesh N bounds the device count like every other sharded
        # handler; without -mesh, all devices are used
        mesh_ws = _cli_mesh(s) or make_mesh()
        res = propagate_watershed_sharded(
            x_np, mesh_ws, mask=mask_np, markers=markers,
            start_from_minima=not s.clusters_begin_at_maxima,
            halt_threshold=s.watershed_threshold,
            connectivity=s.neighbor_connectivity,
            show_boundaries=s.watershed_show_boundaries,
            label_boundary=int(s.watershed_boundary_label),
            label_undefined=-1)
    else:
        if x_np.size >= 256 ** 3:
            print("note: the host Meyer flood is serial at this "
                  "volume; -watershed-device runs the sharded device "
                  "flood (measured ~2x at 384^3, scales with -mesh; "
                  "label-level parity wherever intensities are "
                  "distinct)", file=sys.stderr)
        res = watershed(
            x_np, mask=mask_np, markers=markers,
            halt_threshold=s.watershed_threshold,
            start_from_minima=not s.clusters_begin_at_maxima,
            connectivity=s.neighbor_connectivity,
            show_boundaries=s.watershed_show_boundaries,
            label_boundary=int(s.watershed_boundary_label),
            label_undefined=-1)
    print(f"Number of basins found: {res.num_basins}", file=sys.stderr)
    labels = res.labels
    max_label = labels.max() if labels.size else 0
    out = labels.astype(np.float32)
    undef = labels == -1
    if s.undefined_voxels_are_max:
        out[undef] = max_label + 1
    else:
        out[undef] = s.undefined_voxel_brightness
    if mask_np is not None:
        out[mask_np == 0] = s.undefined_voxel_brightness
    return out


def handle_label_connected(s, x_np, mask_np):
    """``HandleLabelConnected`` (``handlers.cpp:1398-1495``)."""
    res = label_connected(
        x_np, mask=mask_np,
        threshold_saliency=s.connect_threshold_saliency,
        connectivity=1,
        label_undefined=-1,
        must_link=s.must_link_constraints or None,
        must_link_directions=s.must_link_directions or None,
        start_from_saliency_maxima=s.clusters_begin_at_maxima,
        mesh=_cli_mesh(s),
        report=sys.stderr)
    labels = np.where(res.labels > res.num_clusters, -1, res.labels)
    max_label = labels.max() if labels.size else 0
    out = labels.astype(np.float32)
    undef = labels == -1
    if s.undefined_voxels_are_max:
        out[undef] = max_label + 1
    else:
        out[undef] = s.undefined_voxel_brightness
    return out


def handle_blob_detector(s, x, mask, mask_np, w, out_header_shape):
    """``HandleBlobDetector`` (``handlers.cpp:787-996``)."""
    diam_vox = list(s.blob_diameters)
    minima, maxima = B.blob_dog_nm(
        x, diam_vox, mask=mask,
        mesh=_cli_mesh(s),
        aspect_ratio=s.blob_aspect_ratio,
        delta_sigma_over_sigma=s.delta_sigma_over_sigma,
        truncate_ratio=s.filter_truncate_ratio,
        truncate_threshold=s.filter_truncate_threshold,
        minima_threshold=s.score_upper_bound,
        maxima_threshold=s.score_lower_bound,
        use_threshold_ratios=s.score_bounds_are_ratios,
        sep_ratio_thresh=s.nonmax_min_radial_separation_ratio,
        nonmax_max_overlap_large=s.nonmax_max_volume_overlap_large,
        nonmax_max_overlap_small=s.nonmax_max_volume_overlap_small,
        report=sys.stderr)

    def physical(bl):
        return B.BlobList(bl.crds * np.asarray(w)[None, :],
                          bl.diameters * w[0], bl.scores)

    if s.blob_minima_file_name and is_writer():
        mn = B.sort_blobs(physical(minima), B.SORT_INCREASING,
                          ascending_order=False)
        write_blob_coords_file(s.blob_minima_file_name, mn.crds,
                               mn.diameters, mn.scores)
    if s.blob_maxima_file_name and is_writer():
        mx = B.sort_blobs(physical(maxima), B.SORT_DECREASING,
                          ascending_order=False)
        write_blob_coords_file(s.blob_maxima_file_name, mx.crds,
                               mx.diameters, mx.scores)

    # annotate spheres over the input image (handlers.cpp:932-981)
    crds = np.concatenate([minima.crds, maxima.crds[::-1]])
    diams = np.concatenate([minima.diameters, maxima.diameters[::-1]])
    scores = np.concatenate([minima.scores, maxima.scores[::-1]])
    shell = np.empty(len(crds))
    for i in range(len(crds)):
        th = s.sphere_decals_shell_thickness
        if s.sphere_decals_shell_thickness_is_ratio:
            th *= diams[i]
            if th < s.sphere_decals_shell_thickness_min:
                th = 1.0
        shell[i] = th
    diams = diams * s.sphere_decals_scale
    return D.draw_spheres(
        out_header_shape, crds, diams, shell, scores,
        background=np.asarray(x), mask=mask_np,
        background_offset=s.sphere_decals_background,
        background_rescale=s.sphere_decals_background_scale,
        background_normalize=s.sphere_decals_background_norm,
        foreground_normalize=False)


def load_blobs_for_nms(s, mask_np, w):
    """Shared blob loading for -discard-blobs / -draw-spheres
    (``handlers.cpp:427-640``)."""
    crds_all, diams_all, scores_all = [], [], []
    for fname in s.in_crds_file_names:
        crds, diams, scores, in_voxels = read_blob_coords_file(
            fname, diameter_override=-1.0,
            score_default=s.sphere_decals_foreground,
            diameter_factor=s.sphere_decals_scale)
        if not in_voxels and w[0] > 0:
            crds = np.floor(crds / w[0] + 0.5)
            diams = np.where(diams != -1.0, diams / w[0], diams)
        if s.sphere_decals_diameter >= 0:
            d = s.sphere_decals_diameter
            if not s.sphere_decals_diameter_in_voxels and w[0] > 0:
                d = d / w[0]
            diams = np.full_like(diams, d)
        crds_all.append(crds)
        diams_all.append(diams)
        scores_all.append(scores)
    blobs = B.BlobList(np.concatenate(crds_all),
                       np.concatenate(diams_all),
                       np.concatenate(scores_all))
    print(" --- discarding blobs in files ---\n", file=sys.stderr)

    if (np.isfinite(s.score_lower_bound) or np.isfinite(s.score_upper_bound)
            or np.isfinite(s.sphere_diameters_lower_bound)
            or np.isfinite(s.sphere_diameters_upper_bound)):
        keep = ((blobs.scores >= s.score_lower_bound)
                & (blobs.scores <= s.score_upper_bound)
                & (blobs.diameters >= s.sphere_diameters_lower_bound)
                & (blobs.diameters <= s.sphere_diameters_upper_bound))
        blobs = blobs.take(keep)

    if len(blobs) and mask_np is not None:
        blobs = B.discard_masked_blobs(blobs, mask_np)

    if (s.nonmax_min_radial_separation_ratio > 0
            or np.isfinite(s.nonmax_max_volume_overlap_large)
            or np.isfinite(s.nonmax_max_volume_overlap_small)):
        if w[0] <= 0:
            raise InputError("overlap check requires -w or an input image")
        blobs = B.discard_overlapping_blobs(
            blobs, s.nonmax_min_radial_separation_ratio,
            s.nonmax_max_volume_overlap_large,
            s.nonmax_max_volume_overlap_small,
            B.SORT_DECREASING_MAGNITUDE)
    print(f" {len(blobs)} blobs remaining", file=sys.stderr)

    if (s.auto_thresh_score and s.training_pos_crds is not None
            and len(s.training_pos_crds)
            and s.training_neg_crds is not None
            and len(s.training_neg_crds)):
        print("  discarding blobs based on score using training data",
              file=sys.stderr)
        blobs, lo, hi = SUP.discard_blobs_by_score_supervised(
            blobs, s.training_pos_crds, s.training_neg_crds,
            report=sys.stderr)
        print(f" {len(blobs)} blobs remaining", file=sys.stderr)
    return blobs


def handle_blob_nms(s, mask_np, w):
    blobs = load_blobs_for_nms(s, mask_np, w)
    if s.out_crds_file_name and is_writer():
        vw = w[0] if w[0] > 0 else 1.0
        write_blob_coords_file(s.out_crds_file_name, blobs.crds * vw,
                               blobs.diameters * vw, blobs.scores)
    return blobs


def handle_supervised_multi(s, w):
    """``HandleBlobScoreSupervisedMulti`` (``handlers.cpp:646-706``) +
    the -supervised-multi file parsing (each line: pos neg blobs)."""
    blob_lists, pos_lists, neg_lists = [], [], []
    with open(s.supervised_multi_fname) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            pos_f, neg_f, blobs_f = parts[:3]
            pos, pos_vox = read_coordinates(pos_f)
            neg, neg_vox = read_coordinates(neg_f)
            crds, diams, scores, _ = read_blob_coords_file(
                blobs_f, diameter_override=s.sphere_decals_diameter,
                score_default=s.sphere_decals_foreground,
                diameter_factor=s.sphere_decals_scale)
            if w[0] > 0:
                diams = diams / w[0]
                crds = np.floor(crds / w[0] + 0.5)
                if not pos_vox:
                    pos = pos / w[0]
                if not neg_vox:
                    neg = neg / w[0]
            blob_lists.append(B.BlobList(crds, diams, scores))
            pos_lists.append(pos)
            neg_lists.append(neg)
    SUP.choose_blob_score_thresholds_multi(
        blob_lists, pos_lists, neg_lists, report=sys.stderr)


def handle_draw_spheres(s, x_np, mask_np, w):
    """``HandleDrawSpheres`` (``handlers.cpp:711-780``)."""
    blobs = load_blobs_for_nms(s, None, w)  # mask not applied here
    n = len(blobs)
    scores = blobs.scores.copy()
    if not s.sphere_decals_foreground_use_score:
        scores[:] = s.sphere_decals_foreground
    shell = np.empty(n)
    for i in range(n):
        th = s.sphere_decals_shell_thickness
        if s.sphere_decals_shell_thickness_is_ratio:
            th *= blobs.diameters[i]
            if th < s.sphere_decals_shell_thickness_min:
                th = 1.0
        shell[i] = th
    # reversed order so earlier (better) blobs paint last
    order = slice(None, None, -1)
    return D.draw_spheres(
        x_np.shape, blobs.crds[order], blobs.diameters[order],
        shell[order], scores[order],
        background=x_np, mask=mask_np,
        background_offset=s.sphere_decals_background,
        background_rescale=s.sphere_decals_background_scale,
        background_normalize=s.sphere_decals_background_norm,
        foreground_normalize=s.sphere_decals_foreground_norm)


def _read_points_vox(s, w):
    """Coordinate files -> rounded integer voxel coordinates.
    IMOD-notation (parenthesized) rows are 1-based voxel indices;
    plain rows are physical units (``handlers_unsupported.cpp:
    1401-1423``)."""
    pts = []
    for fname in s.in_crds_file_names:
        crds, _, _, in_vox = read_blob_coords_file(fname)
        if in_vox:
            crds = crds - 1.0
        elif w[0] > 0:
            crds = crds / np.asarray(w)[None, :]
        pts.append(np.floor(crds + 0.5).astype(np.int64))
    return (np.concatenate(pts, 0) if pts
            else np.zeros((0, 3), np.int64))


def handle_distance_points(s, x_np, mask_np, w):
    """``HandleDistanceToPoints``
    (``handlers_unsupported.cpp:1393-1466``)."""
    from visfd_jax.features import experimental as E
    pts = _read_points_vox(s, w)
    vw = w[0] if w[0] > 0 else 1.0
    return E.distance_to_points(x_np.shape, pts, vw, mask=mask_np,
                                background=x_np)


def handle_distance_to_voxels(s, x_np, mask_np, w):
    """``HandleDistancePointsToFeature``
    (``handlers_unsupported.cpp:1470-1551``)."""
    from visfd_jax.features import experimental as E
    pts = _read_points_vox(s, w)
    vw = w[0] if w[0] > 0 else 1.0
    dists = E.distance_points_to_feature(
        x_np, pts, s.out_thresh_a_value, s.out_thresh_b_value, vw,
        mask=mask_np)
    with open(s.out_distances_file_name, "w") as fh:
        for d in dists:
            fh.write(f"{d}\n")
    return x_np


def handle_random_spheres(s, x_np, mask_np, w):
    """``HandleRandomSpheres``
    (``handlers_unsupported.cpp:1569-1665``)."""
    from visfd_jax.features import experimental as E
    vw = w[0] if w[0] > 0 else 1.0
    centers, occ = E.random_spheres(
        x_np, s.rand_crds_n, s.rand_crds_diameter / vw,
        s.out_thresh_a_value, s.out_thresh_b_value,
        seed=s.rand_crds_seed, mask=mask_np)
    with open(s.out_crds_file_name, "w") as fh:
        for ix, iy, iz in centers:
            fh.write(f"{ix * vw} {iy * vw} {iz * vw}\n")
    return occ


def handle_template_gauss(s, x, mask):
    """``HandleTemplateGauss`` (``handlers_unsupported.cpp:787-1061``):
    least-squares spherical template amplitude image."""
    from visfd_jax.features import experimental as E
    ratio = s.filter_truncate_ratio if s.filter_truncate_ratio > 0 else 2.5
    return E.template_gen_gauss(
        x, s.width_a, s.template_background_radius,
        m_exp=s.m_exp, n_exp=s.template_background_exponent,
        mask=mask, truncate_ratio=ratio,
        normalize_near_boundaries=s.normalize_near_boundaries)


def handle_doggxy(s, x, mask):
    """``HandleDoggXY`` (``handlers_unsupported.cpp:19-160``)."""
    from visfd_jax.features import experimental as E
    ratio = s.filter_truncate_ratio if s.filter_truncate_ratio > 0 else 2.5
    return E.dogg_xy(x, s.width_a[:2], s.width_b[:2], s.width_a[2],
                     m_exp=s.m_exp, n_exp=s.n_exp, mask=mask,
                     truncate_ratio=ratio)


def handle_blob_radial_intensity(s, x_np, mask_np, w):
    """``HandleBlobRadialIntensity``
    (``handlers_unsupported.cpp:162-455``): per-blob intensity-vs-
    radius profile files ``<base>_<i>.txt``."""
    from visfd_jax.features import experimental as E
    vw = w[0] if w[0] > 0 else 1.0
    crds_all, diams_all = [], []
    for fname in s.in_crds_file_names:
        crds, diams, _, in_vox = read_blob_coords_file(
            fname, diameter_override=s.sphere_decals_diameter,
            score_default=s.sphere_decals_foreground,
            diameter_factor=s.sphere_decals_scale)
        if in_vox:
            crds = crds - 1.0
        else:
            crds = crds / vw
            diams = diams / vw
        crds_all.append(crds)
        diams_all.append(diams)
    crds = np.concatenate(crds_all, 0) if crds_all else np.zeros((0, 3))
    diams = np.concatenate(diams_all, 0) if diams_all else np.zeros(0)
    if mask_np is not None and len(crds):
        keep = []
        for i, c in enumerate(crds):
            ix, iy, iz = (int(np.floor(v + 0.5)) for v in c)
            nzs, nys, nxs = mask_np.shape
            if 0 <= iz < nzs and 0 <= iy < nys and 0 <= ix < nxs \
               and mask_np[iz, iy, ix] != 0:
                keep.append(i)
        crds, diams = crds[keep], diams[keep]
    print(f"  creating intensity-vs-radius profiles for {len(crds)} "
          f"blobs.", file=sys.stderr)
    for i in range(len(crds)):
        profile, _ = E.blob_radial_intensity(
            x_np, crds[i], diams[i],
            center_criteria=s.blob_profiles_center_criteria,
            mask=mask_np)
        fname = f"{s.blob_profiles_file_name_base}_{i + 1}.txt"
        with open(fname, "w") as fh:
            for ir, v in enumerate(profile):
                fh.write(f"{ir * vw} {v}\n")
    return x_np


def handle_tv(s, img, x_np, mask_np, w):
    """``HandleTV`` (``handlers.cpp:1501-2357``)."""
    from visfd_jax.utils import Report, stage, record_path, format_paths
    rep = Report(sys.stderr)
    order = (sym3.EigenOrder.INCREASING if s.ridges_are_maxima
             else sym3.EigenOrder.DECREASING)
    sigma = s.width_a[0]
    tr = _truncate_ratio(s)
    x = _maybe_shard(s, jnp.asarray(x_np))
    mask = _maybe_shard(s, _mask_or_none(mask_np))

    # the whole dense pipeline below stays device-resident (sharded
    # when -mesh is given): score/direction/vote are jnp arrays, and
    # numpy copies are materialized only at terminal consumers (file
    # writes, the host floods, the PLY walker)
    background = None
    if s.width_b[0] > 0:
        hw = max(1, int(np.floor(s.width_b[0] * tr)))
        background = F.apply_gauss(
            x, s.width_b[0], mask=mask, truncate_halfwidth=(hw,) * 3,
            normalize=s.normalize_near_boundaries)

    kind = {S.CURVE: "linear", S.SURFACE_EDGE: "edge"}.get(
        s.filter_type, "planar")
    with stage("gaussian blur + hessian + eigendecomposition", rep):
        record_path("hessian_eigen", "xla")
        score, direction = jax.block_until_ready(FH.ridge_score_direction(
            x, mask, float(sigma), float(tr), order, kind))
    if background is not None:
        score = score * (x - background)
    if mask is not None:
        score = jnp.where(mask != 0, score, 0.0)

    if mask is not None and s.filter_type != S.SURFACE_EDGE:
        direction = direction * (mask[..., None] != 0)

    # saliency thresholding (top fraction) -- handlers.cpp:1751-1797.
    # The reference sorts every voxel on the host; we compute the same
    # threshold as an exact distributed order statistic (4 psum'd radix
    # rounds, parallel.reduce), so -tv-best scales with the mesh.
    thr = s.hessian_score_threshold
    if s.hessian_score_threshold_is_a_fraction:
        from visfd_jax.parallel.reduce import fraction_threshold
        print(" -- sorting all voxels by ridge saliency --\n",
              file=sys.stderr)
        thr = fraction_threshold(
            score, thr, mesh=_cli_mesh(s),
            mask=None if mask is None else (mask != 0).astype(jnp.float32))
    score = jnp.where(score < thr, 0.0, score)

    vote = None
    vev1 = None              # principal eigenvector of the vote tensor
    if s.tv_sigma > 0:
        if s.load_progress_sharded:
            # numpy phase checkpoint (extension); the .rec
            # -load-progress path below stays for reference compat
            from visfd_jax.io.checkpoint import load_state
            print(f'loading phase checkpoint '
                  f'"{s.load_progress_sharded}"', file=sys.stderr)
            vote = _maybe_shard(s, jnp.asarray(
                load_state(s.load_progress_sharded)["vote"]))
            if mask is not None:
                vote = vote * (mask[..., None] != 0)
        elif not s.load_intermediate_fname_base:
            # -tv-best kept only the top `thr` fraction of saliencies
            # (default 0.05): the sparse kernel skips empty source
            # windows, the counterpart of the reference's source-skip
            # branch (feature.hpp:1704-1709, "up to 64 times faster")
            tv_sparse = bool(s.hessian_score_threshold_is_a_fraction
                             and float(s.hessian_score_threshold) <= 0.5)
            with stage("dense stick tensor voting", rep):
                vote = TV.tv_dense_stick(
                    score, direction,
                    s.tv_sigma, exponent=s.tv_exponent,
                    mask_src=mask, mask_dest=mask,
                    detect_curves=(s.filter_type == S.CURVE),
                    truncate_ratio=s.tv_truncate_ratio,
                    normalize=False, sparse=tv_sparse)
                jax.block_until_ready(vote)
        else:
            chans = []
            for d in range(6):
                fname = (f"{s.load_intermediate_fname_base}_tensor_{d}.rec")
                print(f'loading "{fname}"', file=sys.stderr)
                chans.append(mrc.read_mrc(fname).data)
            vote = _maybe_shard(s, jnp.asarray(
                np.stack(chans, axis=-1).astype(np.float32)))
            if mask is not None:
                vote = vote * (mask[..., None] != 0)
        # one pass over the vote field yields both the saliency and the
        # principal eigenvector -connect consumes
        new_score, vev1 = FH.tensor_score_direction(
            vote, order, s.filter_type == S.CURVE)
        if background is not None:
            new_score = new_score * (x - background)
        if mask is not None:
            new_score = jnp.where(mask != 0, new_score, score)
        score = new_score

    if s.save_intermediate_fname_base and vote is not None:
        # the gather is a collective: every process joins it, only
        # process 0 writes the files
        with stage("save progress", rep):
            vote_np = to_host_np(vote)
            if is_writer():
                for d in range(6):
                    fname = (f"{s.save_intermediate_fname_base}"
                             f"_tensor_{d}.rec")
                    print(f'writing "{fname}"', file=sys.stderr)
                    mrc.write_mrc(fname,
                                  vote_np[..., d].astype(np.float32),
                                  header=img.header)

    if s.save_progress_sharded and vote is not None:
        from visfd_jax.io.checkpoint import save_state
        print(f'writing phase checkpoint "{s.save_progress_sharded}"',
              file=sys.stderr)
        save_state(s.save_progress_sharded, {
            "vote": vote, "saliency": score, "direction": direction})

    labels_img = None
    direction_np = None

    if s.cluster_connected_voxels and vote is not None:
        # directions <- principal eigenvector of vote tensor (device);
        # label_connected consumes the device arrays directly and, on
        # the compact/mesh path, transfers only candidate lists
        with stage("connected components", rep):
            res = label_connected(
                score, mask=mask_np,
                threshold_saliency=s.connect_threshold_saliency,
                vector=vev1,
                threshold_vector_saliency=s.connect_threshold_vector_saliency,
                threshold_vector_neighbor=s.connect_threshold_vector_neighbor,
                consider_dot_product_sign=False,
                tensor=vote,
                threshold_tensor_saliency=s.connect_threshold_tensor_saliency,
                threshold_tensor_neighbor=s.connect_threshold_tensor_neighbor,
                tensor_is_positive_definite_near_target=True,
                connectivity=1,
                label_undefined=-1,
                standardize_vector_sign=True,
                must_link=s.must_link_constraints or None,
                must_link_directions=s.must_link_directions or None,
                start_from_saliency_maxima=True,
                mesh=_cli_mesh(s),
                # the dense standardized direction field is only consumed
                # by the PLY writer; skipping it avoids a full-volume
                # download when -normals-file was not requested
                want_dense_vectors=bool(s.out_normals_fname),
                report=sys.stderr)
        # res.vector_standardized is populated exactly when a dense
        # consumer exists (want_dense_vectors above); otherwise leave
        # direction_np unset -- gathering vev1 here would download the
        # full direction volume that nothing reads
        if res.vector_standardized is not None:
            direction_np = res.vector_standardized
        labels = np.where(res.labels > res.num_clusters, -1, res.labels)
        max_label = labels.max() if labels.size else 0
        out = labels.astype(np.float32)
        undef = labels == -1
        if s.undefined_voxels_are_max:
            out[undef] = max_label + 1
        else:
            out[undef] = s.undefined_voxel_brightness
        labels_img = out
    else:
        out = to_host_np(score, np.float32)

    if s.out_normals_fname:
        # the gathers are collectives (every process joins); the
        # host-side surface walker + PLY write run on process 0 only
        if direction_np is None:
            direction_np = to_host_np(direction)
        score_np = to_host_np(score)
        if is_writer():
            crds_list, norms_list = [], []
            nz, ny, nx = score_np.shape
            sel = np.ones(score_np.shape, bool)
            if mask_np is not None:
                sel &= mask_np != 0
            if not s.cluster_connected_voxels:
                zz, yy, xx = np.nonzero(sel)
                for z, y, xq in zip(zz, yy, xx):
                    crds_list.append((xq * w[0], y * w[1], z * w[2]))
                    norms_list.append(tuple(direction_np[z, y, xq]))
            else:
                sel &= labels_img == s.select_cluster
                zz, yy, xx = np.nonzero(sel)
                for z, y, xq in zip(zz, yy, xx):
                    xyz, normal = _surface_point(
                        s, score_np, direction_np, labels_img, mask_np,
                        int(xq), int(y), int(z))
                    if xyz is None:
                        continue
                    crds_list.append(tuple(c * wi for c, wi
                                           in zip(xyz, w)))
                    norms_list.append(tuple(normal))
            write_oriented_pointcloud_ply(
                s.out_normals_fname,
                np.asarray(crds_list).reshape(-1, 3),
                np.asarray(norms_list).reshape(-1, 3))
    print(format_paths(), file=sys.stderr)
    return out


def _surface_point(s, saliency, direction, labels_img, mask_np, ix, iy, iz):
    """Per-voxel surface-point refinement for -normals-file
    (``handlers.cpp:2088-2307``): curve-integration averaging along the
    normal direction, then optional sub-voxel ridge projection."""
    nz, ny, nx = saliency.shape
    norm_v = np.linalg.norm(direction[iz, iy, ix])
    if norm_v == 0:
        return None, None
    normal = direction[iz, iy, ix] / norm_v * saliency[iz, iy, ix]
    xyz = np.array([ix, iy, iz], float)

    if s.surface_normal_curve_ds > 0:
        ds = s.surface_normal_curve_ds
        my_cluster = labels_img[iz, iy, ix]

        def walk(sign):
            out_s, out_xyz, out_w = [], [], []
            r = np.array([ix, iy, iz], float)
            ixyz = np.array([ix, iy, iz], int)
            sacc = 0.0
            if sign > 0:
                while True:
                    if not (0 <= ixyz[0] < nx and 0 <= ixyz[1] < ny
                            and 0 <= ixyz[2] < nz):
                        break
                    if mask_np is not None and \
                       mask_np[ixyz[2], ixyz[1], ixyz[0]] == 0:
                        break
                    if labels_img[ixyz[2], ixyz[1], ixyz[0]] != my_cluster:
                        break
                    out_s.append(sacc)
                    out_xyz.append(r.copy())
                    out_w.append(saliency[ixyz[2], ixyz[1], ixyz[0]])
                    d = direction[ixyz[2], ixyz[1], ixyz[0]]
                    nrm = np.linalg.norm(d)
                    if nrm == 0:
                        break
                    sacc += ds
                    r = r + ds * d / nrm
                    ixyz = np.round(r).astype(int)
            else:
                while True:
                    d = direction[ixyz[2], ixyz[1], ixyz[0]]
                    nrm = np.linalg.norm(d)
                    if nrm == 0:
                        break
                    sacc -= ds
                    r = r - ds * d / nrm
                    ixyz = np.round(r).astype(int)
                    if not (0 <= ixyz[0] < nx and 0 <= ixyz[1] < ny
                            and 0 <= ixyz[2] < nz):
                        break
                    if mask_np is not None and \
                       mask_np[ixyz[2], ixyz[1], ixyz[0]] == 0:
                        break
                    if labels_img[ixyz[2], ixyz[1], ixyz[0]] != my_cluster:
                        break
                    out_s.append(sacc)
                    out_xyz.append(r.copy())
                    out_w.append(saliency[ixyz[2], ixyz[1], ixyz[0]])
            return out_s, out_xyz, out_w

        vs, vxyz, vw_ = walk(+1)
        bs, bxyz, bw = walk(-1)
        vs = list(reversed(bs)) + vs
        vxyz = list(reversed(bxyz)) + vxyz
        vw_ = list(reversed(bw)) + vw_
        if not vs or sum(vw_) == 0:
            return None, None
        ave_s = float(np.dot(vw_, vs) / np.sum(vw_))
        i = 0
        while i + 1 < len(vs):
            i += 1
            if vs[i - 1] <= ave_s <= vs[i]:
                break
        ixyz2 = np.round(vxyz[i]).astype(int)
        ixyz2 = np.clip(ixyz2, 0, [nx - 1, ny - 1, nz - 1])
        d = direction[ixyz2[2], ixyz2[1], ixyz2[0]]
        nrm = np.linalg.norm(d)
        if nrm > 0:
            normal = d / nrm
        if i + 1 < len(vs) and vs[i] != vs[i - 1]:
            frac = (ave_s - vs[i - 1]) / (vs[i] - vs[i - 1])
            xyz = np.asarray(vxyz[i - 1]) + (
                np.asarray(vxyz[i]) - np.asarray(vxyz[i - 1])) * frac
        else:
            xyz = np.asarray(vxyz[i])
        normal = normal * saliency[iz, iy, ix]

    if s.surface_find_ridge:
        ix0, iy0, iz0 = (int(np.round(c)) for c in xyz)
        ix0 = min(max(ix0, 0), nx - 1)
        iy0 = min(max(iy0, 0), ny - 1)
        iz0 = min(max(iz0, 0), nz - 1)
        # local FD hessian/gradient of the saliency at this voxel
        h = _local_hessian(saliency, ix0, iy0, iz0)
        g = _local_gradient(saliency, ix0, iy0, iz0)
        vals, vects = sym3.diagonalize_sym3(
            jnp.asarray(h[None]), order=sym3.EigenOrder.DECREASING_ABS)
        v1 = np.asarray(vects)[0, 0]
        lam1 = float(np.asarray(vals)[0, 0])
        gv = float(g @ v1)
        if gv < 0:
            gv = -gv
            v1 = -v1
        elif gv == 0:
            return None, None
        dist = gv / lam1 if lam1 != 0 else np.inf
        if s.max_distance_to_feature > 0 and abs(dist) > \
           s.max_distance_to_feature:
            return None, None
        xyz = np.array([ix0, iy0, iz0], float) - dist * v1
        if not (0 <= xyz[0] <= nx and 0 <= xyz[1] <= ny
                and 0 <= xyz[2] <= nz):
            return None, None
    return xyz, normal


def _clamp_idx(i, n):
    return min(max(i, 1), n - 2)


def _local_hessian(a, ix, iy, iz):
    nz, ny, nx = a.shape
    ix = _clamp_idx(ix, nx); iy = _clamp_idx(iy, ny); iz = _clamp_idx(iz, nz)
    hxx = a[iz, iy, ix + 1] + a[iz, iy, ix - 1] - 2 * a[iz, iy, ix]
    hyy = a[iz, iy + 1, ix] + a[iz, iy - 1, ix] - 2 * a[iz, iy, ix]
    hzz = a[iz + 1, iy, ix] + a[iz - 1, iy, ix] - 2 * a[iz, iy, ix]
    hxy = 0.25 * (a[iz, iy + 1, ix + 1] + a[iz, iy - 1, ix - 1]
                  - a[iz, iy - 1, ix + 1] - a[iz, iy + 1, ix - 1])
    hyz = 0.25 * (a[iz + 1, iy + 1, ix] + a[iz - 1, iy - 1, ix]
                  - a[iz - 1, iy + 1, ix] - a[iz + 1, iy - 1, ix])
    hxz = 0.25 * (a[iz + 1, iy, ix + 1] + a[iz - 1, iy, ix - 1]
                  - a[iz + 1, iy, ix - 1] - a[iz - 1, iy, ix + 1])
    return np.array([[hxx, hxy, hxz], [hxy, hyy, hyz], [hxz, hyz, hzz]],
                    np.float32)


def _local_gradient(a, ix, iy, iz):
    nz, ny, nx = a.shape
    ix = _clamp_idx(ix, nx); iy = _clamp_idx(iy, ny); iz = _clamp_idx(iz, nz)
    return np.array([
        0.5 * (a[iz, iy, ix + 1] - a[iz, iy, ix - 1]),
        0.5 * (a[iz, iy + 1, ix] - a[iz, iy - 1, ix]),
        0.5 * (a[iz + 1, iy, ix] - a[iz - 1, iy, ix])], np.float32)


def handle_thresholds(s, x_in_np, out_np, mask_np):
    """``HandleThresholds`` (``handlers.cpp:1003-1081``). Note the
    reference reads from tomo_in (which, after most handlers, still
    holds a copy of the handler's input image); our driver passes the
    image the thresholds should be computed from."""
    a, b = s.in_threshold_01_a, s.in_threshold_01_b
    src = x_in_np
    if s.out_thresh2_use_clipping_sigma:
        sel = slice(None) if mask_np is None else (mask_np != 0)
        vals = src[sel] if mask_np is not None else src
        ave = float(vals.mean(dtype=np.float64))
        std = float(vals.std(dtype=np.float64))
        a = ave + s.in_threshold_01_a * std
        b = ave + s.in_threshold_01_b * std
        print(f"ave={fmt_g(ave)}, stddev={fmt_g(std)}", file=sys.stderr)
        print(f"  Clipping intensities between [{fmt_g(a)}, {fmt_g(b)}]",
              file=sys.stderr)
    xj = jnp.asarray(src)
    if s.use_rescale_multiply:
        out = (jnp.asarray(out_np) * s.out_rescale_multiply
               + s.out_rescale_offset)
    elif s.use_gauss_thresholds:
        out = T.select_intensity_range_gauss(
            xj, s.out_thresh_gauss_x0, s.out_thresh_gauss_sigma,
            s.out_thresh_a_value, s.out_thresh_b_value)
    elif not s.use_dual_thresholds:
        if a == b:
            out = jnp.where(xj > a, s.out_thresh_b_value,
                            s.out_thresh_a_value)
        else:
            oa = a if s.out_thresh2_use_clipping else s.out_thresh_a_value
            ob = b if s.out_thresh2_use_clipping else s.out_thresh_b_value
            out = T.threshold2(xj, a, b, oa, ob)
    else:
        out = T.threshold4(xj, s.in_threshold_01_a, s.in_threshold_01_b,
                           s.in_threshold_10_a, s.in_threshold_10_b,
                           s.out_thresh_a_value, s.out_thresh_b_value)
    return np.asarray(out)


# ---------------------------------------------------------------------------

def run(argv) -> int:
    s = S.parse_args(list(argv))

    from visfd_jax.utils import enable_compile_cache
    enable_compile_cache()

    # per-invocation telemetry: a prior run's stage paths (e.g. a
    # recorded fallback) must not leak into this run's summary line
    from visfd_jax.utils import reset_paths
    reset_paths()

    if getattr(s, "mesh_devices", 0):
        # multi-host runs: join the cluster before any backend use so
        # jax.devices() (and thus -mesh) is global; single-process
        # no-op unless VISFD_COORDINATOR/... or a pod env is present
        from visfd_jax.parallel.distributed import init_distributed
        init_distributed()

    img = None
    if s.in_file_name:
        print(f'Reading tomogram "{s.in_file_name}"', file=sys.stderr)
        img = mrc.read_mrc(s.in_file_name)
        img.header.print_stats(sys.stderr)
    elif all(v > 0 for v in s.in_set_image_size):
        nx, ny, nz = s.in_set_image_size
        img = mrc.MrcImage(
            header=mrc.MrcHeader(nvoxels=(nx, ny, nz),
                                 cellA=(float(nx), float(ny), float(nz))),
            data=np.zeros((nz, ny, nx), np.float32))
    else:
        img = mrc.MrcImage(header=mrc.MrcHeader(),
                           data=np.zeros((0, 0, 0), np.float32))

    mask_np = None
    if s.mask_file_name:
        print(f'Reading mask "{s.mask_file_name}"', file=sys.stderr)
        m = mrc.read_mrc(s.mask_file_name)
        if m.data.shape != img.data.shape:
            raise InputError("Error: The size of the mask image does not "
                             "match the size of the input image.")
        mask_np = m.data
        if s.use_mask_select:
            mask_np = np.where(mask_np == s.mask_select, 1.0, 0.0
                               ).astype(np.float32)

    w = determine_voxel_width(s, img)
    s.image_size_orig = img.data.shape
    s.cellA_orig = img.header.cellA

    # binning (explicit or automatic; filter_mrc.cpp:122-210)
    if s.resize_with_binning > 1:
        img, mask_np = handle_binning(s, img, mask_np, w)
    elif s.resize_with_binning == 0:
        s.resize_with_binning = 1
        if s.tv_sigma > 0:
            if s.width_a[0] > 1.8 * w[0]:
                s.resize_with_binning = int(np.ceil(s.width_a[0]
                                                    / (1.8 * w[0])))
                print(f"--- BINNING THE IMAGE BY A FACTOR OF "
                      f"{s.resize_with_binning}", file=sys.stderr)
                img, mask_np = handle_binning(s, img, mask_np, w)
        elif s.blob_diameters:
            if s.blob_diameters[0] > 15.0 * w[0]:
                s.resize_with_binning = int(np.ceil(
                    s.blob_diameters[0] / (15.0 * w[0])))
                print(f"--- BINNING THE IMAGE BY A FACTOR OF "
                      f"{s.resize_with_binning}", file=sys.stderr)
                img, mask_np = handle_binning(s, img, mask_np, w)

    # mask regions (filter_mrc.cpp:222-287)
    if s.mask_regions:
        if mask_np is None:
            mask_np = np.zeros(img.data.shape, np.float32)
        scale = (1.0 / s.resize_with_binning if s.is_mask_crds_in_voxels
                 else 1.0 / w[0])
        regions = []
        for reg in s.mask_regions:
            p = tuple(v * scale for v in reg.params)
            if reg.kind == "rect":
                regions.append(D.Rect(*p, value=reg.value))
            else:
                regions.append(D.Sphere(*p, value=reg.value))
        mask_np = D.draw_regions(mask_np, regions,
                                 negative_means_subtract=True)

    # unit rescaling (filter_mrc.cpp:290-380)
    s.morphology_r /= w[0]
    s.morphology_rmax /= w[0]
    s.median_radius /= w[0]
    if s.max_distance_to_feature < 0:
        s.max_distance_to_feature /= -w[0]
    else:
        s.max_distance_to_feature /= s.resize_with_binning
    s.tv_sigma /= w[0]
    for d in range(3):
        s.width_a[d] /= w[d]
        s.width_b[d] /= w[d]
        s.log_width[d] /= w[d]
        s.template_background_radius[d] /= w[d]
    s.blob_diameters = [dd / w[0] for dd in s.blob_diameters]
    if not s.sphere_decals_shell_thickness_is_ratio:
        s.sphere_decals_shell_thickness /= w[0]
    else:
        s.sphere_decals_shell_thickness /= s.resize_with_binning
    if s.training_pos_crds is not None:
        s.training_pos_crds = (
            s.training_pos_crds / s.resize_with_binning
            if s.is_training_pos_in_voxels else s.training_pos_crds / w[0])
    if s.training_neg_crds is not None:
        s.training_neg_crds = (
            s.training_neg_crds / s.resize_with_binning
            if s.is_training_neg_in_voxels else s.training_neg_crds / w[0])
    if s.must_link_constraints:
        div = (s.resize_with_binning if s.is_must_link_in_voxels else w[0])
        s.must_link_constraints = [
            [tuple(c / div for c in pt) for pt in grp]
            for grp in s.must_link_constraints]

    if s.rescale_min_max_in:
        img.rescale01(mask_np, s.in_rescale_min, s.in_rescale_max)

    x_np = img.data
    x = jnp.asarray(x_np) if x_np.size else None
    mask = _mask_or_none(mask_np)
    if s.mesh_devices:
        x = _maybe_shard(s, x)
        mask = _maybe_shard(s, mask)
    out = x_np.copy() if x_np.size else x_np

    ft = s.filter_type
    if ft == S.NONE:
        print("filter_type = Intensity Map <No convolution filter "
              "specified>", file=sys.stderr)
    elif ft == S.GAUSS:
        out = handle_gauss(s, x, mask)
    elif ft == S.GGAUSS:
        out = handle_ggauss(s, x, mask)
    elif ft == S.DOG:
        out = handle_dog(s, x, mask)
    elif ft == S.DOGG:
        out = handle_dogg(s, x, mask)
    elif ft == S.LOG_DOG:
        out = handle_log(s, x, mask)
    elif ft == S.MEDIAN:
        out = handle_median(s, x, mask)
    elif ft in (S.DILATION, S.EROSION, S.OPENING, S.CLOSING,
                S.TOP_HAT_WHITE, S.TOP_HAT_BLACK):
        out = handle_morphology(s, x, mask)
    elif ft == S.LOCAL_FLUCTUATIONS:
        out = handle_fluct(s, x, mask)
    elif ft == S.FIND_EXTREMA:
        out = handle_extrema(s, x_np, mask_np, w)
    elif ft == S.WATERSHED:
        out = handle_watershed(s, x_np, mask_np)
    elif ft == S.LABEL_CONNECTED:
        out = handle_label_connected(s, x_np, mask_np)
    elif ft in (S.SURFACE_RIDGE, S.SURFACE_EDGE, S.CURVE):
        out = handle_tv(s, img, x_np, mask_np, w)
    elif ft == S.BLOB:
        out = handle_blob_detector(s, x, mask, mask_np, w, x_np.shape)
    elif ft == S.BLOB_NONMAX_SUPPRESSION:
        handle_blob_nms(s, mask_np, w)
        out = None
    elif ft == S.BLOB_NONMAX_SUPERVISED_MULTI:
        handle_supervised_multi(s, w)
        out = None
    elif ft == S.DRAW_SPHERES:
        out = handle_draw_spheres(s, x_np, mask_np, w)
    elif ft == S.DOGGXY:
        out = handle_doggxy(s, x, mask)
    elif ft == S.TEMPLATE_GAUSS:
        out = handle_template_gauss(s, x, mask)
    elif ft == S.DISTANCE_TO_POINTS:
        out = handle_distance_points(s, x_np, mask_np, w)
    elif ft == S.DISTANCE_TO_VOXELS:
        out = handle_distance_to_voxels(s, x_np, mask_np, w)
    elif ft == S.RANDOM_SPHERES:
        out = handle_random_spheres(s, x_np, mask_np, w)
    elif ft == S.BLOB_RADIAL_INTENSITY:
        out = handle_blob_radial_intensity(s, x_np, mask_np, w)
    else:
        raise InputError(f"unhandled filter type {ft}")

    if out is None or not s.out_file_name:
        return 0

    out = to_host_np(out, np.float32)

    if s.invert_output:
        oimg = mrc.MrcImage(header=img.header, data=out)
        oimg.invert(mask_np)
        out = oimg.data

    if s.use_intensity_map:
        out = handle_thresholds(s, out, out, mask_np)

    if mask_np is not None and s.specify_masked_brightness:
        out = np.where(mask_np == 0, s.masked_voxel_brightness, out)

    if s.rescale_min_max_out:
        oimg = mrc.MrcImage(header=img.header, data=np.asarray(out,
                                                               np.float32))
        oimg.rescale01(mask_np, s.out_rescale_min, s.out_rescale_max)
        out = oimg.data

    # undo automatic binning for TV (handlers.cpp:2320-2355)
    if (s.resize_with_binning != 1 and not s.resize_with_binning_explicit
            and ft in (S.SURFACE_RIDGE, S.SURFACE_EDGE, S.CURVE)):
        out = np.asarray(R.unbin_array3d(jnp.asarray(out),
                                         s.image_size_orig))
        img.header.cellA = s.cellA_orig

    hdr = img.header
    if w[0] > 0 and img.data.shape[2]:
        nzo, nyo, nxo = out.shape
        import dataclasses as _dc
        hdr = _dc.replace(hdr)
        if not np.isclose(w[0], hdr.cellA[0] / max(nxo, 1)):
            hdr.cellA = (nxo * w[0], nyo * w[1], nzo * w[2])
    if is_writer():
        print("writing tomogram (in 32-bit float mode)", file=sys.stderr)
        mrc.write_mrc(s.out_file_name, out, header=hdr)
    else:
        print("skipping tomogram write (process "
              "!= 0 in a multi-process run)", file=sys.stderr)
    return 0


def main():
    try:
        return run(sys.argv[1:])
    except (InputError, OSError, ValueError) as e:
        print(f"\n{e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
