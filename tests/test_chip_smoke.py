"""chip_smoke.py's phases, run on the CPU at small sizes (its ``main``
refuses anything but a GPU)."""

import numpy as np
import pytest

import chip_smoke


def test_kernel_phase_interpret_small():
    """The kernel phase's comparison at hw=2, the kernel interpreted:
    dense and sparse within the stated tolerance of the XLA sum."""
    rows = chip_smoke.kernel_phase(shape=(8, 32, 32), hws=(2,),
                                   interpret=True)
    assert [(hw, sp) for hw, sp, *_ in rows] == [(2, False), (2, True)]
    assert all(err <= chip_smoke.TV_TOL for _, _, err, _, _ in rows)


def test_main_path_phase_small(tmp_path):
    """Both CLI phases on a small phantom: outputs, recorded paths, and
    the planted sheets as the largest clusters.  At ``-tv 1.5`` (vote
    half-width 3): the XLA formulation the CPU runs takes minutes to
    compile at the smoke's half-width 9."""
    sal, labels = chip_smoke.main_path_phase(
        str(tmp_path), shape=(96, 256, 32), runs=1, tv=1.5)
    assert sal.shape == labels.shape == (96, 256, 32)
    assert np.isfinite(sal).all()


def test_check_clusters_rejects_a_stray_cluster():
    """A large cluster off every planted sheet fails the check."""
    from visfd_jax.utils.phantom import sheet_distances
    shape = (64, 64, 16)
    d = [np.broadcast_to(x, shape) for x in sheet_distances(shape)]
    labels = np.full(shape, 5.0, np.float32)        # background = max
    for i, di in enumerate(d):
        labels[di <= 1.0] = i + 1
    chip_smoke.check_clusters(labels)
    labels[30:34, 0:6, :] = 4                       # off every sheet
    with pytest.raises(AssertionError):
        chip_smoke.check_clusters(labels)


def test_main_refuses_without_gpu(monkeypatch):
    """No result is printed and the exit code is nonzero off the GPU."""
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "no card")
    assert chip_smoke.main([]) != 0


def test_mesh4_phase_on_cpu_stops_at_the_nccl_check(tmp_path):
    """The four-device phase on four CPU devices, the kernel
    interpreted, at ``-tv 1.5``: the -mesh 4 run matches the one-device
    run (else an earlier assertion fires), and the check that the
    collectives ran as NCCL kernels fails, as it must where none runs."""
    with pytest.raises(AssertionError, match="NCCL"):
        chip_smoke.mesh4_phase(str(tmp_path), shape=(96, 256, 32),
                               interpret=True, tv=1.5)
