"""Per-platform execution table, compile-cache helper, and the decode
engine that a DecodedStream reports."""

from pathlib import Path

import jax
import numpy as np
import pytest

from flac_raster_tpu import backend
from flac_raster_tpu.backend import (
    BackendConfig,
    backend_config,
    compile_cache_dir,
    enable_compile_cache,
)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "platform,encoder,planner",
    [("cpu", "host", "native"), ("gpu", "device", "xla")],
)
def test_platform_table_entries(platform, encoder, planner):
    cfg = backend_config(platform)
    assert isinstance(cfg, BackendConfig)
    assert (cfg.encoder, cfg.planner) == (encoder, planner)
    assert cfg.chunk_frames > 0


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL", ""])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no execution settings"):
        backend_config(platform)


def test_default_platform_is_jax_backend():
    assert backend_config() is backend_config(jax.default_backend())


def test_converter_encoder_follows_table(monkeypatch):
    from flac_raster_tpu import converter

    assert converter._best_encoder() is converter.encode_flac_fast
    monkeypatch.setitem(backend._TABLE, "cpu", backend_config("gpu"))
    assert converter._best_encoder() is converter.encode_flac_device


def test_cache_env_var_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache_dir() is None
    assert enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache_dir()
    assert path == str(REPO / ".jax_cache")
    assert path == compile_cache_dir()  # no pid / time component
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_enable_compile_cache_sets_jax_config(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache() == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_decode_chunk_frames_from_table(monkeypatch):
    """decode_flac_device chunks by the table's chunk_frames: a 3-frame
    chunk entry splits a 7-frame stream into three dispatches."""
    from flac_raster_tpu.codec.device_decoder import decode_flac_device
    from flac_raster_tpu.codec.fast_encoder import encode_flac_fast
    from flac_raster_tpu.ops import device_decode

    x = np.cumsum(np.random.default_rng(3).integers(-9, 10, (7 * 256, 1)),
                  axis=0).astype(np.int32)
    blob = encode_flac_fast(x, 44100, 16, 5, blocksize=256)
    cfg = backend_config("cpu")
    monkeypatch.delenv("FRTPU_DECODE_CHUNK", raising=False)
    monkeypatch.setitem(backend._TABLE, "cpu", BackendConfig(
        cfg.encoder, cfg.planner, chunk_frames=3))
    calls = []
    orig = device_decode.decode_frames_device
    monkeypatch.setattr(device_decode, "decode_frames_device",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    dec = decode_flac_device(blob)
    assert len(calls) == 3
    assert np.array_equal(np.asarray(dec.samples), x)


def test_decoded_stream_names_its_engine(caplog):
    """Device decodes say so; a stream the device lane cannot take (no FRTP
    layout index) falls back to the host decoder with a warning and says
    that instead."""
    from flac_raster_tpu.codec.decoder import decode_flac
    from flac_raster_tpu.codec.device_decoder import decode_flac_device
    from flac_raster_tpu.codec.encoder import encode_flac
    from flac_raster_tpu.codec.fast_encoder import encode_flac_fast

    x = np.cumsum(np.random.default_rng(5).integers(-9, 10, (3 * 256 + 9, 1)),
                  axis=0).astype(np.int32)
    assert decode_flac(encode_flac_fast(x, 44100, 16, 5, blocksize=256)).engine == "host"
    ours = decode_flac_device(encode_flac_fast(x, 44100, 16, 5, blocksize=256))
    assert ours.engine == "device"
    foreign = encode_flac(x, 44100, 16, 5, blocksize=250)  # not a power of 2
    with caplog.at_level("WARNING", logger="flac_raster_tpu.device_decoder"):
        dec = decode_flac_device(foreign)
    assert dec.engine == "host-fallback"
    assert np.array_equal(np.asarray(dec.samples), x)
    assert any("fell back to the host decoder" in r.message for r in caplog.records)
