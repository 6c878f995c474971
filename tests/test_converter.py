"""Converter round-trips (the reference's CI correctness gate, ci.yml:46-56)
plus dtype breadth and reference-file interop."""

import numpy as np
import pytest

from flac_raster_tpu.converter import RasterFLACConverter
from flac_raster_tpu.io.geo import Affine
from flac_raster_tpu.io.geotiff import open_geotiff, write_geotiff

REF = "/root/reference/test_data"
ALL_DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
              np.float32, np.float64]


def _make_tif(tmp_path, rng, dtype, bands=1, h=64, w=80, name="in.tif"):
    if np.issubdtype(dtype, np.floating):
        data = rng.normal(0, 1000, (bands, h, w)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        data = rng.integers(info.min, info.max, (bands, h, w), endpoint=True).astype(dtype)
    p = tmp_path / name
    write_geotiff(p, data, crs="EPSG:32610",
                  transform=Affine.from_origin(500000, 4000000, 10, 10))
    return p, data


@pytest.mark.parametrize("dtype", ALL_DTYPES)
def test_lossless_roundtrip_every_dtype(tmp_path, rng, dtype):
    src, data = _make_tif(tmp_path, rng, dtype, bands=2)
    conv = RasterFLACConverter()
    conv.tiff_to_flac(src, tmp_path / "x.flac")
    conv.flac_to_tiff(tmp_path / "x.flac", tmp_path / "back.tif")
    with open_geotiff(tmp_path / "back.tif") as b:
        back = b.read()
        assert str(b.dtype) == str(np.dtype(dtype))
        assert b.crs == "EPSG:32610"
    assert np.array_equal(back.view(np.uint8), data.view(np.uint8))


@pytest.mark.parametrize("dtype", [np.int16, np.float64])
def test_decode_rows_window(tmp_path, rng, dtype):
    """Row-window random access on a plain whole-raster FLAC: only the
    covering frames are parsed (FRTP index), values match a full decode."""
    src, data = _make_tif(tmp_path, rng, dtype, bands=2, h=120, w=64)
    conv = RasterFLACConverter()
    conv.tiff_to_flac(src, tmp_path / "x.flac")
    blob = (tmp_path / "x.flac").read_bytes()
    for row0, n_rows in [(0, 10), (37, 41), (110, 10), (0, 120)]:
        win, meta = conv.decode_rows(blob, row0, n_rows)
        assert win.shape == (2, n_rows, 64)
        assert np.array_equal(
            win.view(np.uint8), data[:, row0 : row0 + n_rows].view(np.uint8)
        )
    with pytest.raises(ValueError):
        conv.decode_rows(blob, 115, 10)


def test_minmax_mode_roundtrip(tmp_path, rng):
    src, data = _make_tif(tmp_path, rng, np.uint8, bands=3)
    conv = RasterFLACConverter(lossless=False)
    conv.tiff_to_flac(src, tmp_path / "x.flac")
    conv.flac_to_tiff(tmp_path / "x.flac", tmp_path / "back.tif")
    assert np.array_equal(open_geotiff(tmp_path / "back.tif").read(), data)


def test_reference_fixture_roundtrips(tmp_path):
    import pathlib

    for name in ("sample_dem.tif", "sample_rgb.tif", "sample_multispectral.tif"):
        p = pathlib.Path(REF) / name
        if not p.exists():
            pytest.skip("reference data missing")
        conv = RasterFLACConverter()
        conv.tiff_to_flac(p, tmp_path / "x.flac")
        conv.flac_to_tiff(tmp_path / "x.flac", tmp_path / "b.tif")
        a, b = open_geotiff(p), open_geotiff(tmp_path / "b.tif")
        assert np.array_equal(a.read(), b.read())
        assert a.crs == b.crs
        assert tuple(a.transform) == tuple(b.transform)


def test_decode_reference_produced_flac(tmp_path):
    """Files written by the reference toolchain (libFLAC + sidecar) decode to
    exactly what the reference itself reconstructs."""
    import pathlib
    import shutil

    flac = pathlib.Path(REF) / "sample_rgb.flac"
    if not flac.exists():
        pytest.skip("reference data missing")
    shutil.copy(flac, tmp_path / "r.flac")
    shutil.copy(pathlib.Path(REF) / "sample_rgb.json", tmp_path / "r.json")
    conv = RasterFLACConverter()
    conv.flac_to_tiff(tmp_path / "r.flac", tmp_path / "r_back.tif")
    ref_recon = open_geotiff(pathlib.Path(REF) / "sample_rgb_reconstructed.tif").read()
    assert np.array_equal(open_geotiff(tmp_path / "r_back.tif").read(), ref_recon)


def test_missing_metadata_raises(tmp_path, rng):
    from flac_raster_tpu.codec.encoder import encode_flac

    blob = encode_flac(rng.integers(-5, 5, (100, 1)).astype(np.int32), 44100, 16)
    (tmp_path / "bare.flac").write_bytes(blob)
    conv = RasterFLACConverter()
    with pytest.raises(ValueError, match="metadata"):
        conv.flac_to_tiff(tmp_path / "bare.flac", tmp_path / "out.tif")


def test_nodata_and_transform_preserved(tmp_path, rng):
    data = rng.integers(0, 100, (1, 32, 32)).astype(np.int16)
    t = Affine.from_origin(-105.5, 40.5, 0.001, 0.001)
    write_geotiff(tmp_path / "n.tif", data, crs="EPSG:4326", transform=t, nodata=-32768)
    conv = RasterFLACConverter()
    conv.tiff_to_flac(tmp_path / "n.tif", tmp_path / "n.flac")
    conv.flac_to_tiff(tmp_path / "n.flac", tmp_path / "n_back.tif")
    b = open_geotiff(tmp_path / "n_back.tif")
    assert b.nodata == -32768.0
    assert tuple(b.transform) == tuple(t)


def test_compare_tiffs(tmp_path, rng):
    from flac_raster_tpu.compare import compare_tiffs, display_comparison_table

    src, data = _make_tif(tmp_path, rng, np.int16, bands=3)
    src2, _ = _make_tif(tmp_path, rng, np.int16, bands=3, name="in2.tif")
    same = compare_tiffs(src, src)
    assert same["arrays_equal"] and same["max_difference"] == 0.0
    diff = compare_tiffs(src, src2)
    assert not diff["arrays_equal"]
    assert len(diff["bands"]) == 3
    display_comparison_table(same)  # must not raise


@pytest.mark.parametrize("dtype", ALL_DTYPES)
def test_decode_bytes_device_lossless_exact(rng, dtype):
    """End-to-end device ingest: device decode + device denormalization must be
    bit-exact vs the host path for every lossless mode.  float64 outputs
    fall back to the exact host array (no f64 on device with x64 off)."""
    import jax

    conv = RasterFLACConverter(lossless=True)
    if np.issubdtype(dtype, np.floating):
        data = rng.normal(0, 1000, (2, 40, 56)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        data = rng.integers(
            info.min, info.max, (2, 40, 56), endpoint=True
        ).astype(dtype)
    blob = conv.encode_array(data)
    host, _ = conv.decode_bytes(blob)
    dev, meta = conv.decode_bytes_device(blob)
    got = np.asarray(dev)
    assert got.dtype == host.dtype == dtype
    assert np.array_equal(got, host)
    if dtype != np.float64:
        assert isinstance(dev, jax.Array)


def test_decode_bytes_device_minmax(rng):
    """Minmax (lossy) mode: device float32 inverse stays within one
    quantization level of the host float64 inverse."""
    conv = RasterFLACConverter(lossless=False)
    data = rng.normal(0, 50, (1, 48, 48)).astype(np.float32)
    blob = conv.encode_array(data)
    host, _ = conv.decode_bytes(blob)
    dev, _ = conv.decode_bytes_device(blob)
    rng_ = float(host.max() - host.min())
    assert np.max(np.abs(np.asarray(dev) - host)) <= rng_ / 65534 + 1e-6

    datau = rng.integers(0, 10000, (1, 48, 48)).astype(np.uint16)
    blob = conv.encode_array(datau)
    hostu, _ = conv.decode_bytes(blob)
    devu, _ = conv.decode_bytes_device(blob)
    assert np.asarray(devu).dtype == np.uint16
    assert np.max(np.abs(np.asarray(devu).astype(np.int64)
                         - hostu.astype(np.int64))) <= 1


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16])
def test_encode_array_device_identical_bytes(rng, dtype):
    """Device egress: encoding a device-resident raster must produce the same
    bytes as encode_array on the host copy (MD5 off on both), and the full
    device round trip (encode_array_device -> decode_bytes_device) must be
    bit-exact."""
    import jax.numpy as jnp

    conv = RasterFLACConverter(lossless=True, compute_md5=False)
    info = np.iinfo(dtype)
    data = rng.integers(
        info.min, info.max, (2, 56, 72), endpoint=True
    ).astype(dtype)
    blob_host = conv.encode_array(data)
    blob_dev = conv.encode_array_device(jnp.asarray(data))
    assert blob_dev == blob_host
    back, _ = conv.decode_bytes_device(blob_dev)
    assert np.array_equal(np.asarray(back), data)


def test_encode_array_device_fallback_dtypes(rng):
    """float32 / int32 rasters are outside the int32 device planner's
    in-graph shift lane: they pull to host once and still round-trip."""
    import jax.numpy as jnp

    conv = RasterFLACConverter(lossless=True, compute_md5=False)
    for data in (
        rng.normal(0, 10, (1, 33, 47)).astype(np.float32),
        rng.integers(-2**31, 2**31, (1, 33, 47)).astype(np.int32),
    ):
        blob = conv.encode_array_device(jnp.asarray(data))
        back, _ = conv.decode_bytes(blob)
        assert np.array_equal(back, data)
