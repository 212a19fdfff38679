"""MRC/REC I/O tests: header parsing on the reference's checked-in
fixtures, roundtrip fidelity, mode decoding, rescale/invert semantics."""

import io

import numpy as np
import pytest

from visfd_jax.io import mrc


def test_read_reference_fixtures(reference_fixture_dir):
    # 22x32x27 mode-0; IMOD stamp with imodFlags=9 (bit 0 set)
    # overrides the .rec unsigned default => signed bytes
    img = mrc.read_mrc(reference_fixture_dir / "test_blob_detect.rec")
    assert img.header.nvoxels == (22, 32, 27)
    assert img.header.mode == mrc.MODE_BYTE
    assert img.header.use_signed_bytes
    assert img.data.shape == (27, 32, 22)
    assert img.data.dtype == np.float32
    assert img.data.min() >= -128.0 and img.data.max() <= 127.0

    # 16x16x16 mode-1 (int16)
    img2 = mrc.read_mrc(reference_fixture_dir / "test_image_membrane.rec")
    assert img2.header.nvoxels == (16, 16, 16)
    assert img2.header.mode == mrc.MODE_SHORT

    # 161x1x1 mode-2 (float)
    img3 = mrc.read_mrc(reference_fixture_dir / "test_1d_example.rec")
    assert img3.header.nvoxels[0] == 161
    assert img3.header.mode == mrc.MODE_FLOAT


def test_roundtrip_float(tmp_path, rng):
    data = rng.normal(size=(5, 7, 11)).astype(np.float32)
    p = tmp_path / "t.mrc"
    mrc.write_mrc(p, data, voxel_width=(18.6, 18.6, 18.6))
    back = mrc.read_mrc(p)
    np.testing.assert_array_equal(back.data, data)
    assert back.header.mode == mrc.MODE_FLOAT
    w = back.header.voxel_width_xyz
    assert w == pytest.approx((18.6,) * 3, rel=1e-6)
    assert back.header.dmin == pytest.approx(float(data.min()))
    assert back.header.dmax == pytest.approx(float(data.max()))
    assert back.header.dmean == pytest.approx(float(data.mean()), rel=1e-6)


def test_mode_decoding_roundtrip_through_reference_header(tmp_path, rng):
    """Synthesize mode 0/1/6 files byte-by-byte and check decode."""
    for mode, dt, vals in [
        (mrc.MODE_BYTE, "u1", np.arange(8, dtype=np.uint8)),
        (mrc.MODE_SHORT, "<i2", np.arange(-4, 4, dtype=np.int16)),
        (mrc.MODE_USHORT, "<u2", np.arange(8, dtype=np.uint16) * 1000),
    ]:
        h = mrc.MrcHeader(nvoxels=(2, 2, 2), mode=mode)
        raw = mrc._write_header(h) + vals.astype(dt).tobytes()
        img = mrc.read_mrc(io.BytesIO(raw))
        np.testing.assert_array_equal(
            img.data.ravel(), vals.astype(np.float32)
        )


def test_signed_byte_detection_imod_stamp():
    vals = np.array([0x80, 0x7F, 0, 1, 2, 3, 4, 5], dtype=np.uint8)
    extra = bytearray(100)
    # word 38 of the header = word 14 of 'extra' region (words 24..48)
    extra[(38 - 24) * 4 : (38 - 24) * 4 + 4] = np.int32(
        mrc.IMOD_STAMP
    ).tobytes()
    extra[(39 - 24) * 4 : (39 - 24) * 4 + 4] = np.int32(1).tobytes()  # signed
    h = mrc.MrcHeader(nvoxels=(2, 2, 2), mode=mrc.MODE_BYTE,
                      extra_raw=bytes(extra))
    raw = mrc._write_header(h) + vals.tobytes()
    img = mrc.read_mrc(io.BytesIO(raw))
    assert img.header.use_signed_bytes
    assert img.data.ravel()[0] == -128.0
    assert img.data.ravel()[1] == 127.0


def test_axis_permutation():
    """A mapCRS=(2,3,1) file must be permuted to row-major on read
    (mrc_simple.cpp:104-174)."""
    # Build a row-major volume, then store it with X slowest.
    nx, ny, nz = 2, 3, 4
    vol = np.arange(nx * ny * nz, dtype=np.float32).reshape(nz, ny, nx)
    # file fastest index i runs along y (mapCRS[0]=2), j along z, k along x
    # file array[k][j][i] = vol[z=j][y=i][x=k]
    file_arr = np.transpose(vol, (2, 0, 1))  # (x, z, y)
    h = mrc.MrcHeader(
        nvoxels=(ny, nz, nx),  # counts per file index
        mode=mrc.MODE_FLOAT,
        mapCRS=(2, 3, 1),
        cellA=(20.0, 30.0, 10.0),
    )
    raw = mrc._write_header(h) + file_arr.astype("<f4").tobytes()
    img = mrc.read_mrc(io.BytesIO(raw))
    assert img.header.nvoxels == (nx, ny, nz)
    assert img.header.mapCRS == (1, 2, 3)
    assert img.header.cellA == (10.0, 20.0, 30.0)
    np.testing.assert_array_equal(img.data, vol)


def test_rescale01_and_invert(rng):
    data = rng.uniform(-3, 9, size=(4, 5, 6)).astype(np.float32)
    img = mrc.MrcImage(header=mrc.MrcHeader(), data=data.copy())
    img.rescale01(None)
    assert img.data.min() == pytest.approx(0.0, abs=1e-6)
    assert img.data.max() == pytest.approx(1.0, abs=1e-6)

    img2 = mrc.MrcImage(header=mrc.MrcHeader(), data=data.copy())
    ave = data.mean(dtype=np.float64)
    img2.invert()
    np.testing.assert_allclose(img2.data, 2.0 * ave - data, rtol=1e-5)
