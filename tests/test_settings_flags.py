"""Flag-parser coverage for the reference's full flag surface."""

import numpy as np
import pytest

from visfd_jax.cli import settings as S
from visfd_jax.cli.settings import InputError, parse_args


def test_soft_morphology_flags():
    s = parse_args(["-dilate-binary-soft", "2", "3", "0.5"])
    assert s.filter_type == S.DILATION
    assert (s.morphology_r, s.morphology_rmax, s.morphology_bmax) \
        == (2.0, 3.0, 0.5)
    s = parse_args(["-erosion-binary-soft", "2", "3", "0.5"])
    assert s.filter_type == S.EROSION

    s = parse_args(["-dilate-gauss", "4"])
    assert s.filter_type == S.GAUSS and s.width_a == [4.0] * 3
    assert s.use_intensity_map
    assert s.in_threshold_01_a == pytest.approx(1 - 0.8427007929497149)
    s = parse_args(["-erode-gauss", "4"])
    assert s.in_threshold_01_a == pytest.approx(0.8427007929497149)


def test_exponent_and_dog_delta_flags():
    s = parse_args(["-exponents", "3", "5"])
    assert (s.m_exp, s.n_exp, s.template_background_exponent) == (3, 5, 5)
    s = parse_args(["-exponent", "6"])
    assert (s.m_exp, s.n_exp) == (6, 6)
    s = parse_args(["-dog-delta", "0.05"])
    assert s.delta_sigma_over_sigma == pytest.approx(0.05)


def test_fill_norescale_threshrange():
    s = parse_args(["-fill", "7"])
    assert s.use_rescale_multiply and s.out_rescale_multiply == 0.0 \
        and s.out_rescale_offset == 7.0
    s = parse_args(["-no-rescale"])
    assert not s.rescale_min_max_out
    s = parse_args(["-thresh-range", "2", "9"])
    assert (s.out_thresh_a_value, s.out_thresh_b_value) == (2.0, 9.0)
    s = parse_args(["-rescale-min-max", "1", "3"])
    assert (s.out_rescale_min, s.out_rescale_max) == (1.0, 3.0)
    s = parse_args(["-rescale-min-max", "-invert"])
    assert (s.out_rescale_min, s.out_rescale_max) == (0.0, 1.0)
    assert s.invert_output


def test_score_bound_aliases():
    s = parse_args(["-score-upper-bound", "5"])
    assert s.score_upper_bound == 5.0 and not s.score_bounds_are_ratios
    s = parse_args(["-score-lower-bound-ratio", "0.5"])
    # reference quirk: "-score-lower-bound-ratio" sets the UPPER bound
    # (settings.cpp:1948-1963 alias of -minima-ratio)
    assert s.score_upper_bound == 0.5 and s.score_bounds_are_ratios
    s = parse_args(["-spheres-nonmax-score-range", "1", "2"])
    assert (s.score_lower_bound, s.score_upper_bound) == (1.0, 2.0)
    s = parse_args(["-spheres-nonmax-radii-range", "1", "2"])
    assert (s.sphere_diameters_lower_bound,
            s.sphere_diameters_upper_bound) == (1.0, 2.0)


def test_nms_aliases():
    s = parse_args(["-max-overlap", "0.1"])
    assert s.nonmax_max_volume_overlap_large == pytest.approx(0.1)
    assert s.nonmax_min_radial_separation_ratio == 0.0
    s = parse_args(["-radial-separation", "0.9"])
    assert s.nonmax_min_radial_separation_ratio == pytest.approx(0.9)
    s = parse_args(["-blobs-nonmax", "a.txt", "b.txt"])
    assert s.filter_type == S.BLOB_NONMAX_SUPPRESSION


def test_renamed_flags_error():
    for flag in ("-surface", "-planar", "-planar-tv",
                 "--membrane-normals-file"):
        with pytest.raises(InputError):
            parse_args([flag] + (["x"] if flag != "-planar-tv" else []))


def test_tv_flags():
    s = parse_args(["-membrane", "minima", "30", "-membrane-background",
                    "90", "-detection-threshold", "0.2", "-best", "0.1"])
    assert s.filter_type == S.SURFACE_RIDGE
    assert s.width_b == [90.0] * 3
    # -best (alias of -tv-best) wins as the last flag
    assert s.hessian_score_threshold == pytest.approx(0.1)
    assert s.hessian_score_threshold_is_a_fraction
    s = parse_args(["-max-distance-to-membrane", "12"])
    assert s.max_distance_to_feature == -12.0
    s = parse_args(["-max-voxels-to-membrane", "12"])
    assert s.max_distance_to_feature == 12.0
    s = parse_args(["-max-distance-to-membrane", "disable"])
    assert s.max_distance_to_feature == 0.0


def test_sphere_decal_aliases():
    s = parse_args(["-draw-hollow-spheres", "f.txt"])
    assert s.filter_type == S.DRAW_SPHERES
    assert s.sphere_decals_shell_thickness == pytest.approx(0.05)
    s = parse_args(["-spheres", "f.txt", "-sphere-diameter-voxels", "5",
                    "-spheres01"])
    assert s.sphere_decals_diameter == 5.0
    assert s.sphere_decals_diameter_in_voxels
    assert not s.sphere_decals_foreground_norm
    s = parse_args(["-sphere-shell-thickness-min", "2"])
    assert s.sphere_decals_shell_thickness_min == 2.0
    assert s.user_set_thickness_manually


def test_misc_flags():
    s = parse_args(["-outf", "x.mrc"])
    assert s.out_file_name == "x.mrc"
    s = parse_args(["-normalize-filters", "no"])
    assert not s.normalize_near_boundaries
    with pytest.raises(InputError):
        parse_args(["-normalize-filters", "maybe"])
    s = parse_args(["-ignore-boundary-extrema"])
    assert not s.extrema_on_boundary
    s = parse_args(["-mask-crds-units", "voxels"])
    assert s.is_mask_crds_in_voxels
    s = parse_args(["-log-aniso", "2", "3", "4"])
    assert s.filter_type == S.LOG_DOG and s.log_width == [2.0, 3.0, 4.0]
    s = parse_args(["-ggauss-aniso", "2", "3", "4"])
    assert s.filter_type == S.GGAUSS
    s = parse_args(["-truncate-thresold", "0.01"])  # reference typo alias
    assert s.filter_truncate_threshold == pytest.approx(0.01)
