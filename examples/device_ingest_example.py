#!/usr/bin/env python3
"""Device-resident ML ingest walkthrough.

The decode path the reference cannot offer (its libFLAC decode lands PCM on
the host, ``converter.py:181-182``): compressed FLAC bytes upload to the
accelerator, frames decode in parallel ON DEVICE (ops/device_decode), and
the pixel tensor stays in device memory for the model -- including windowed reads
through the FRTP decode index, so an input pipeline can stream row blocks
of a huge raster without ever materializing it.

Run: python examples/device_ingest_example.py
(uses whatever jax backend is active; on CPU it demonstrates the same API.)
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp

from flac_raster_tpu import decode_flac_device, encode_flac_fast


def main() -> None:
    # --- a synthetic two-band raster, FLAC-compressed once ------------------
    rng = np.random.default_rng(0)
    h, w, bands = 512, 512, 2
    terrain = np.cumsum(
        np.cumsum(rng.integers(-3, 4, (h, w)), axis=0), axis=1
    ) % 4000
    raster = np.stack([terrain, terrain // 2 + rng.integers(0, 50, (h, w))])
    samples = raster.transpose(1, 2, 0).reshape(h * w, bands).astype(np.int32)
    blob = encode_flac_fast(samples, 44100, 16, compression_level=5)
    print(f"raster {raster.nbytes/1e6:.1f} MB -> {len(blob)/1e6:.2f} MB FLAC "
          f"(x{raster.nbytes/len(blob):.2f})")

    # --- full-stream device decode: PCM never visits the host ---------------
    dec = decode_flac_device(blob, verify_crc=True)
    assert isinstance(dec.samples, jax.Array)
    pixels = dec.samples.reshape(h, w, bands)  # still on device

    @jax.jit
    def band_stats(px):
        p = px.astype(jnp.float32)
        return jnp.stack([p.mean(axis=(0, 1)), p.std(axis=(0, 1))])

    stats = band_stats(pixels)  # device -> device; only the stats come back
    print("on-device band stats (mean/std):\n", np.asarray(stats).round(2))

    # --- windowed ingest: upload + decode ONLY the rows you need ------------
    row0, n_rows = 200, 64
    win = decode_flac_device(
        blob, sample_range=(row0 * w, n_rows * w)
    ).samples.reshape(n_rows, w, bands)
    full_slice = pixels[row0 : row0 + n_rows]
    assert bool(jnp.array_equal(win, full_slice))
    print(f"windowed decode rows {row0}..{row0+n_rows}: "
          f"{win.shape} on {win.devices()} -- matches the full decode")

    # --- feed a training-style step straight from compressed storage --------
    @jax.jit
    def normalize_patch(px):
        p = px.astype(jnp.float32)
        return (p - p.mean()) / (p.std() + 1e-6)

    batch = normalize_patch(win)
    print(f"model-ready patch: {batch.shape} {batch.dtype}, "
          f"mean {float(batch.mean()):+.4f}")

    # --- full device round trip: raster dtype in, raster dtype out ----------
    # decode_bytes_device inverse-normalizes IN-GRAPH (original dtype, band-
    # major layout, never on host); encode_array_device is the egress mirror
    # (in-graph interleave + shift normalization, only compressed words
    # cross the wire) -- e.g. writing augmented tiles or model outputs back
    # to FLAC from HBM.
    from flac_raster_tpu import RasterFLACConverter

    conv = RasterFLACConverter(compute_md5=False)
    tile = jnp.asarray(raster.astype(np.uint16))          # "model output"
    tile_blob = conv.encode_array_device(tile)            # device egress
    back, meta = conv.decode_bytes_device(tile_blob)      # device ingest
    assert isinstance(back, jax.Array) and back.dtype == jnp.uint16
    assert bool(jnp.array_equal(back, tile))
    print(f"device round trip: {tile.nbytes/1e6:.1f} MB uint16 -> "
          f"{len(tile_blob)/1e6:.2f} MB FLAC -> bit-exact, never on host")

    tmp = Path(tempfile.mkdtemp(prefix="flac_raster_ingest_"))
    (tmp / "scene.flac").write_bytes(blob)
    print(f"wrote {tmp/'scene.flac'}")


if __name__ == "__main__":
    main()
