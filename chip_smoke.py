"""Smoke run of the GeoTIFF -> FLAC -> GeoTIFF main path on a GPU.

    python chip_smoke.py [--seed N]   # one card: phases 0-6 below
    python chip_smoke.py --four       # four cards: the tile-mesh path only

Everything runs in this one process; the data is made from ``--seed``.
Phases (one card):

  0. device     -- require a GPU; print nvidia-smi's name/power limit, the
                   JAX version, device kind and count, native-library state
  1. scene      -- a 10980^2 uint16 terrain scene (Sentinel-2 band shape,
                   BASELINE.md row 4) written as a GeoTIFF, converted to
                   FLAC and back through the CLI in process: bit-exact,
                   CRC + MD5 verified, encoded by the device encoder
  2. crosscheck -- the first 1,024 frames encoded on the device and by the
                   host encoder on the CPU: same samples after decode,
                   sizes within 0.5%, first differing frame reported
  3. resident   -- device decode of the scene's FLAC and device-resident
                   re-encode (the scanned dispatch), no host-decoder fallback
  4. spatial    -- the scene as a 512-px spatial container (484 tiles),
                   three bbox queries: device decode == host decode
  5. wide       -- a 3600^2 float32 DEM (Copernicus GLO-30 tile shape, an
                   assumption) through the 32-bps lane: exact bit patterns
                   from the host and the device decoder
  6. fuzz       -- byte-flip mutants through the verified device decoder:
                   every result exact or an exception, and the process
                   (and its device context) survives

``--four`` runs only the (tiles x blocks) mesh encode and decode of the
phase-4 tiles on four cards, compared with the one-card batch encoder.

Each phase prints one ``smoke-timing`` line (wall, first call including
compilation, warm repeat, peak device memory, the engines that ran): these
are smoke timings, not benchmark metrics.  Any failed gate raises, so the
exit code is non-zero; the last line of a passing run is the JSON object
``{"ok": true, "device": {...}}``.  Without a GPU the script exits non-zero
and prints no such line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SCENE_SIZE = 10980        # Sentinel-2 10 m band (BASELINE.md row 4)
TILE_SIZE = 512           # spatial container tile (BASELINE.md row 5)
CROSS_FRAMES = 1024       # phase-2 slice
DEM_SIZE = 3600           # Copernicus GLO-30 1-degree tile at the equator
FUZZ_VERIFIED = 300
FUZZ_DIFFERENTIAL = 100
BLOCKSIZE = 4096
SIZE_TOLERANCE = 0.005    # device vs host stream size (float LPC rounding)


class SmokeFailure(AssertionError):
    """A gate of the smoke run failed."""


def gate(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# data


def make_dem(size: int, seed: int) -> np.ndarray:
    """float32 elevation field (metres) with a fractional part."""
    rng = np.random.default_rng(seed)
    t = np.arange(size, dtype=np.float64)
    x, y = t[None, :], t[:, None]
    z = 1200.0 + 600.0 * np.sin(x / 517.0) * np.cos(y / 389.0)
    z += 150.0 * np.sin(x / 61.0) * np.cos(y / 83.0)
    z += rng.normal(0.0, 0.25, z.shape)
    return z.astype(np.float32)


# ---------------------------------------------------------------------------
# observation helpers


class _FallbackCounter(logging.Handler):
    """Counts the device decoder's host-fallback warnings."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.count = 0

    def emit(self, record):
        self.count += 1


@contextlib.contextmanager
def observe_fallbacks():
    """Yield a counter of device-decode host fallbacks inside the block."""
    log = logging.getLogger("flac_raster_tpu.device_decoder")
    counter = _FallbackCounter()
    log.addHandler(counter)
    try:
        yield counter
    finally:
        log.removeHandler(counter)


@contextlib.contextmanager
def spy(module, name: str, record: dict):
    """Count calls of ``module.name`` into ``record[name]`` and keep the
    first call's argument shapes under ``record[name + ".args"]``."""
    import jax

    orig = getattr(module, name)

    def as_struct(x):
        if isinstance(x, (jax.Array, np.ndarray)):
            return jax.ShapeDtypeStruct(x.shape, x.dtype)
        return x

    def wrapper(*args, **kwargs):
        record[name] = record.get(name, 0) + 1
        if name + ".args" not in record:
            record[name + ".args"] = jax.tree_util.tree_map(
                as_struct, (args, kwargs)
            )
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield record
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def capture_mesh_index(record: list):
    """Record, for every call of the tile-mesh emitting step, the byte-range
    index it computed on the devices (``tile_body_bytes``, ``offsets``)."""
    import jax

    from flac_raster_tpu.parallel import tile_engine

    orig = tile_engine.make_tile_emit_step

    def make(*args, **kwargs):
        step = orig(*args, **kwargs)

        def run(tiles):
            out = step(tiles)
            record.append(jax.device_get(
                {k: out[k] for k in ("tile_body_bytes", "offsets")}))
            return out

        run._words_per_shard = step._words_per_shard
        run._blocks_axis = step._blocks_axis
        return run

    tile_engine.make_tile_emit_step = make
    try:
        yield record
    finally:
        tile_engine.make_tile_emit_step = orig


def full_frame_bytes(blob: bytes) -> int:
    """Bytes of a stream's full-blocksize frames (the partial tail frame,
    which the host emits, excluded)."""
    from flac_raster_tpu.models.flac_format import (
        parse_flac_metadata,
        parse_layout_block,
    )

    si, blocks, _ = parse_flac_metadata(blob)
    sizes = parse_layout_block(blocks).sizes
    return int(np.sum(sizes[: si.total_samples // si.max_blocksize]))


def peak_bytes() -> "int | None":
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def timed(fn, *args, **kwargs):
    """(result, seconds) of one call that ends in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def cli(*argv) -> None:
    from flac_raster_tpu import cli as cli_mod

    rc = cli_mod.main([str(a) for a in argv])
    gate(rc == 0, f"CLI {' '.join(map(str, argv))} exited {rc}")


def first_differing_frame(a: bytes, b: bytes) -> "int | None":
    """Index of the first frame whose bytes differ (None if identical)."""
    from flac_raster_tpu.models.flac_format import (
        parse_flac_metadata,
        parse_layout_block,
    )

    if a == b:
        return None
    spans = []
    for blob in (a, b):
        _, blocks, start = parse_flac_metadata(blob)
        offs = parse_layout_block(blocks).absolute_offsets(start)
        spans.append(offs)
    for i in range(min(len(spans[0]), len(spans[1])) - 1):
        fa = a[spans[0][i] : spans[0][i + 1]]
        fb = b[spans[1][i] : spans[1][i + 1]]
        if fa != fb:
            return i
    return -1  # frames equal; metadata differs


# ---------------------------------------------------------------------------
# phases


def phase_scene(workdir: Path, raster: np.ndarray) -> dict:
    """GeoTIFF -> FLAC -> GeoTIFF through the CLI; the main path."""
    from flac_raster_tpu import converter
    from flac_raster_tpu.backend import backend_config
    from flac_raster_tpu.codec import device_encoder
    from flac_raster_tpu.codec.decoder import decode_flac
    from flac_raster_tpu.io.geo import Affine
    from flac_raster_tpu.io.geotiff import open_geotiff, write_geotiff

    tif = workdir / "scene.tif"
    flac = workdir / "scene.flac"
    back = workdir / "scene_back.tif"
    # UTM zone 33N, 10 m pixels (a Sentinel-2 tile's grid)
    transform = Affine.from_origin(399960.0, 5000040.0, 10.0, 10.0)
    write_geotiff(tif, raster, crs="EPSG:32633", transform=transform)

    calls: dict = {}
    with spy(converter, "encode_flac_device", calls), \
            spy(converter, "encode_flac_fast", calls), \
            spy(device_encoder, "plan_and_emit", calls):
        t0 = time.perf_counter()
        cli("convert", tif, "-o", flac)
        first = time.perf_counter() - t0
        blob = flac.read_bytes()
        t0 = time.perf_counter()
        cli("convert", tif, "-o", flac, "--force")
        warm = time.perf_counter() - t0
    gate(flac.read_bytes() == blob, "repeat conversion wrote different bytes")
    ran = [n for n in ("encode_flac_device", "encode_flac_fast") if calls.get(n)]
    want = ("encode_flac_device" if backend_config().encoder == "device"
            else "encode_flac_fast")
    gate(ran == [want], f"encoders that ran: {ran}, expected [{want}]")

    cli("convert", flac, "-o", back)
    with open_geotiff(back) as src:
        restored = src.read()
        crs = src.crs
    gate(restored.dtype == raster.dtype
         and np.array_equal(restored.reshape(raster.shape), raster),
         "restored GeoTIFF differs from the original raster")
    gate("32633" in str(crs), f"CRS lost: {crs!r}")
    dec = decode_flac(blob, verify_crc=True, verify_md5=True)
    n = raster.size
    gate(dec.samples.shape == (n, 1), f"decoded shape {dec.samples.shape}")
    return {
        "blob": blob, "tif": tif, "first_s": first, "warm_s": warm,
        "encoder": ran[0], "plan_and_emit.args": calls.get("plan_and_emit.args"),
        "frames": n // BLOCKSIZE, "tail_samples": n % BLOCKSIZE,
        "flac_bytes": len(blob),
    }


def phase_crosscheck(raster: np.ndarray, n_frames: int) -> dict:
    """Device encoder vs the host encoder on the CPU, same PCM."""
    import jax

    from flac_raster_tpu.codec.decoder import decode_flac
    from flac_raster_tpu.codec.device_encoder import encode_flac_device
    from flac_raster_tpu.codec.fast_encoder import encode_flac_fast

    pcm = (raster.ravel()[: n_frames * BLOCKSIZE].astype(np.int32) - 32768)[:, None]
    args = (pcm, 44100, 16, 5)
    dev, first = timed(encode_flac_device, *args)
    dev, warm = timed(encode_flac_device, *args)
    with jax.default_device(jax.devices("cpu")[0]):
        host = encode_flac_fast(*args)
    for name, blob in (("device", dev), ("host", host)):
        d = decode_flac(blob, verify_crc=True, verify_md5=True)
        gate(np.array_equal(d.samples, pcm), f"{name} stream decodes wrong")
    rel = abs(len(dev) - len(host)) / len(host)
    gate(rel <= SIZE_TOLERANCE,
         f"device {len(dev)} B vs host {len(host)} B differ by {rel:.4%}")
    return {
        "first_s": first, "warm_s": warm, "identical": dev == host,
        "first_diff_frame": first_differing_frame(dev, host),
        "device_bytes": len(dev), "host_bytes": len(host), "size_rel": rel,
    }


def phase_resident(blob: bytes, raster: np.ndarray) -> dict:
    """Device decode of the FLAC, device-resident re-encode."""
    import jax

    from flac_raster_tpu.codec import device_encoder
    from flac_raster_tpu.codec.device_decoder import decode_flac_device
    from flac_raster_tpu.converter import RasterFLACConverter
    from flac_raster_tpu.ops import device_decode

    conv = RasterFLACConverter()
    calls: dict = {}
    with observe_fallbacks() as fallbacks, \
            spy(device_decode, "decode_frames_device", calls), \
            spy(device_encoder, "_plan_emit_scan", calls):
        (data, _), first = timed(conv.decode_bytes_device, blob)
        (data, _), warm = timed(conv.decode_bytes_device, blob)
        gate(isinstance(data, jax.Array), "decode_bytes_device left the device")
        gate(np.array_equal(np.asarray(data), raster[None]),
             "device-decoded raster differs from the original")
        dec = decode_flac_device(blob, verify_crc=True)
        gate(dec.engine == "device", f"decode engine {dec.engine}")
        blob2, enc_s = timed(conv.encode_array_device, data)
        back, _ = conv.decode_bytes(blob2)
        gate(np.array_equal(back, raster[None]),
             "device-resident re-encode does not decode to the raster")
        back_dev, _ = conv.decode_bytes_device(blob2)
        gate(np.array_equal(np.asarray(back_dev), raster[None]),
             "device decode of the re-encoded stream differs")
    gate(fallbacks.count == 0, f"{fallbacks.count} host-decoder fallbacks")
    return {
        "first_s": first, "warm_s": warm, "encode_device_resident_s": enc_s,
        "scanned_dispatches": calls.get("_plan_emit_scan", 0),
        "decode_engine": dec.engine,
        "decode_frames_device.args": calls.get("decode_frames_device.args"),
    }


def phase_spatial(workdir: Path, tif: Path, raster: np.ndarray,
                  tile_size: int) -> dict:
    """Spatial container encode + three bbox queries, device vs host."""
    import jax

    from flac_raster_tpu.models.spatial import SpatialFLACStreamer

    sflac = workdir / "scene_spatial.flac"
    t0 = time.perf_counter()
    cli("convert", tif, "-o", sflac, "--spatial", "--tile-size", tile_size)
    enc_s = time.perf_counter() - t0
    streamer = SpatialFLACStreamer(str(sflac))
    frames = streamer.spatial_index.frames
    h, w = raster.shape
    grid_h, grid_w = -(-h // tile_size), -(-w // tile_size)
    gate(len(frames) == grid_h * grid_w, f"{len(frames)} tiles")
    tr = streamer.spatial_index.transform
    eps = 0.25  # pixels: keep query edges off tile boundaries

    def bbox(r0, c0, r1, c1):
        """Pixel-space tile range [r0, r1) x [c0, c1) -> inset geo bbox."""
        rows = (r0 * tile_size + eps, min(r1 * tile_size, h) - eps)
        cols = (c0 * tile_size + eps, min(c1 * tile_size, w) - eps)
        x0, y0 = tr * (cols[0], rows[1])
        x1, y1 = tr * (cols[1], rows[0])
        return (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))

    rm, cm = grid_h // 2, grid_w // 2
    queries = {
        "one_tile": (bbox(rm, cm, rm + 1, cm + 1), 1),
        "block_2x2": (bbox(rm, cm, rm + 2, cm + 2), 4),
        "edge_tile": (bbox(grid_h - 1, grid_w - 1, grid_h, grid_w), 1),
    }

    def run_device():
        return {k: streamer.decode_bbox_device(b) for k, (b, _) in queries.items()}

    with observe_fallbacks() as fallbacks:
        dev, first = timed(run_device)
        dev, warm = timed(run_device)
    gate(fallbacks.count == 0, f"{fallbacks.count} host-decoder fallbacks")
    for name, (b, n_tiles) in queries.items():
        host = streamer.decode_bbox(b)
        gate(len(host) == n_tiles == len(dev[name]),
             f"{name}: {len(host)} host / {len(dev[name])} device tiles")
        for (fh, ah), (fd, ad) in zip(host, dev[name]):
            gate(fh.frame_id == fd.frame_id, f"{name}: tile order differs")
            gate(isinstance(ad, jax.Array), f"{name}: tile left the device")
            win = fh.window
            ref = raster[win.row_off : win.row_off + win.height,
                         win.col_off : win.col_off + win.width]
            gate(np.array_equal(np.asarray(ad), ah), f"{name}: device != host")
            gate(np.array_equal(ah[0], ref), f"{name}: tile != scene pixels")
    edge = dev["edge_tile"][0][0].window
    return {
        "first_s": first, "warm_s": warm, "encode_s": enc_s,
        "tiles": len(frames), "edge_tile": f"{edge.height}x{edge.width}",
        "container_bytes": sflac.stat().st_size,
    }


def phase_wide(dem: np.ndarray) -> dict:
    """float32 DEM through the 32-bps limb-pair lane."""
    from flac_raster_tpu.codec.decoder import decode_flac
    from flac_raster_tpu.converter import RasterFLACConverter

    conv = RasterFLACConverter()
    blob, first = timed(conv.encode_array, dem)
    blob, warm = timed(conv.encode_array, dem)
    dec = decode_flac(blob, verify_crc=True, verify_md5=True)
    gate(dec.streaminfo.bits_per_sample == 32, "DEM did not take the 32-bps lane")
    bits = dem.view(np.uint32)
    host, _ = conv.decode_bytes(blob)
    gate(np.array_equal(host[0].view(np.uint32), bits), "host decode bits differ")
    with observe_fallbacks() as fallbacks:
        dev, dec_s = timed(lambda: conv.decode_bytes_device(blob)[0])
    gate(fallbacks.count == 0, f"{fallbacks.count} host-decoder fallbacks")
    gate(np.array_equal(np.asarray(dev)[0].view(np.uint32), bits),
         "device decode bits differ")
    return {"first_s": first, "warm_s": warm, "device_decode_s": dec_s,
            "ratio": dem.nbytes / len(blob)}


def phase_fuzz(seed: int, n_verified: int, n_differential: int) -> dict:
    """Byte-flip mutants through decode_flac_device on the device."""
    import jax

    from flac_raster_tpu.codec.decoder import decode_flac
    from flac_raster_tpu.codec.device_decoder import decode_flac_device
    from flac_raster_tpu.codec.device_encoder import encode_flac_device

    rng = np.random.default_rng(seed)
    n = 3 * 1024 + 50
    left = np.cumsum(rng.integers(-40, 41, n)).astype(np.int32)
    right = (left + rng.integers(-5, 6, n)).astype(np.int32)
    x = np.stack([left, right], axis=1)
    blob0 = encode_flac_device(x, 44100, 16, 5, blocksize=1024)

    def decode_clean():
        dec = decode_flac_device(blob0, verify_crc=True, verify_md5=True)
        jax.block_until_ready(dec.samples)
        return dec

    clean, first = timed(decode_clean)
    gate(clean.engine == "device", f"clean stream engine {clean.engine}")
    gate(np.array_equal(np.asarray(clean.samples), x), "clean stream decodes wrong")

    outcome = {"exact": 0, "raised": 0, "agree": 0}
    blob = bytearray(blob0)
    with observe_fallbacks() as fallbacks:
        t0 = time.perf_counter()
        for _ in range(n_verified):
            pos = int(rng.integers(0, len(blob)))
            old, blob[pos] = blob[pos], int(rng.integers(0, 256))
            try:
                dec = decode_flac_device(bytes(blob), verify_crc=True,
                                         verify_md5=True)
            except Exception:  # noqa: BLE001 -- rejecting a mutant is a pass
                outcome["raised"] += 1
            else:
                gate(np.array_equal(np.asarray(dec.samples), x),
                     f"verified mutant at byte {pos} decoded wrong samples")
                outcome["exact"] += 1
            blob[pos] = old
        for _ in range(n_differential):
            pos = int(rng.integers(0, len(blob)))
            old, blob[pos] = blob[pos], int(rng.integers(0, 256))
            try:
                host = decode_flac(bytes(blob), verify_crc=False).samples
            except Exception:  # noqa: BLE001
                host = None
            try:
                dev = np.asarray(
                    decode_flac_device(bytes(blob), verify_crc=False).samples
                )
            except Exception:  # noqa: BLE001
                dev = None
            if dev is not None:
                want = x if host is None else host
                gate(np.array_equal(dev, want),
                     f"unverified mutant at byte {pos}: device != host")
                outcome["agree"] += 1
            blob[pos] = old
        loop_s = time.perf_counter() - t0
    # the device context survived: a clean decode still runs on the device
    again = decode_clean()
    gate(again.engine == "device"
         and np.array_equal(np.asarray(again.samples), x),
         "device decoder broken after the mutants")
    return {"first_s": first, "warm_s": loop_s, "host_fallbacks": fallbacks.count,
            **outcome}


def four_mesh(raster: np.ndarray, tile_size: int, workdir: Path) -> dict:
    """The (tiles x blocks) mesh encode/decode on four devices vs the
    one-device batch encoder on device 0."""
    import jax

    from flac_raster_tpu.codec.decoder import decode_flac
    from flac_raster_tpu.codec.fast_encoder import encode_flac_batch
    from flac_raster_tpu.io.geo import Affine
    from flac_raster_tpu.io.geotiff import write_geotiff
    from flac_raster_tpu.models.spatial import (
        SpatialFLACStreamer,
        compute_tile_grid,
    )
    from flac_raster_tpu.ops.normalization import normalize_lossless
    from flac_raster_tpu.parallel import (
        decode_flac_batch_mesh,
        encode_flac_batch_mesh,
        tile_mesh,
    )

    gate(len(jax.devices()) >= 4, f"{len(jax.devices())} devices, need 4")
    meshes = {"4x1": tile_mesh(4), "2x2": tile_mesh(4, blocks_axis=2)}
    groups: dict = {}
    for r, c, th, tw in compute_tile_grid(*raster.shape, tile_size):
        pcm, _ = normalize_lossless(raster[r : r + th, c : c + tw].reshape(-1, 1))
        groups.setdefault((th, tw), []).append(pcm)
    out = {"tiles": sum(len(v) for v in groups.values())}
    t_mesh = t_ref = 0.0
    worst = 0.0
    index_groups = 0
    for shape, pcms in groups.items():
        batch = np.stack(pcms)                       # (T, n, 1) int32
        t0 = time.perf_counter()
        with jax.default_device(jax.devices()[0]):
            ref = encode_flac_batch(batch, 44100, 16, 5, use_mesh=False)
        t_ref += time.perf_counter() - t0
        for name, mesh in meshes.items():
            t0 = time.perf_counter()
            with capture_mesh_index([]) as index:
                streams = encode_flac_batch_mesh(batch, 44100, 16, 5, mesh=mesh)
            t_mesh += time.perf_counter() - t0
            # the byte-range index the devices built (psum over blocks,
            # all_gather + prefix sum over tiles) against the streams'
            # written bytes (tiles without a full frame never reach the mesh)
            g_tiles = mesh.shape["tiles"]
            steps = -(-len(batch) // g_tiles) if batch.shape[1] >= BLOCKSIZE else 0
            gate(len(index) == steps,
                 f"{name} {shape}: {len(index)} mesh steps recorded, want {steps}")
            for g, res in enumerate(index):
                body = np.array([full_frame_bytes(b) for b in
                                 streams[g * g_tiles : (g + 1) * g_tiles]])
                real = len(body)
                gate(np.array_equal(res["tile_body_bytes"][:real], body),
                     f"{name} {shape} group {g}: index sizes != stream bytes")
                gate(np.array_equal(res["offsets"][:real],
                                    np.cumsum(body) - body),
                     f"{name} {shape} group {g}: index offsets != exclusive "
                     "prefix sum of the stream bytes")
            index_groups += len(index)
            for t, (sm, sr) in enumerate(zip(streams, ref)):
                d = decode_flac(sm, verify_crc=True, verify_md5=True)
                gate(np.array_equal(d.samples, batch[t]),
                     f"{name} {shape} tile {t}: mesh stream decodes wrong")
            tot_m = sum(map(len, streams))
            tot_r = sum(map(len, ref))
            rel = abs(tot_m - tot_r) / tot_r
            gate(rel <= SIZE_TOLERANCE,
                 f"{name} {shape}: mesh {tot_m} B vs one-device {tot_r} B")
            worst = max(worst, rel)
            out[f"identical_{name}_{shape[0]}x{shape[1]}"] = streams == ref
            decs = decode_flac_batch_mesh(streams, verify_crc=True, mesh=mesh)
            for t, d in enumerate(decs):
                gate(d.engine == "device-mesh", f"{name} tile {t}: {d.engine}")
                gate(np.array_equal(np.asarray(d.samples), batch[t]),
                     f"{name} {shape} tile {t}: mesh decode differs")
        print(f"four_mesh {len(pcms)} tiles of {shape[0]}x{shape[1]} done at "
              f"mesh {t_mesh:.1f}s / one-device {t_ref:.1f}s", flush=True)
    out["size_rel_max"] = worst
    out["mesh_encode_s"] = t_mesh
    out["one_device_encode_s"] = t_ref

    out["index_groups_exact"] = index_groups

    # multi-tile bbox through the mesh decoder vs the host decoder
    tif, sflac = workdir / "scene.tif", workdir / "scene_spatial.flac"
    write_geotiff(tif, raster, crs="EPSG:32633",
                  transform=Affine.from_origin(399960.0, 5000040.0, 10.0, 10.0))
    cli("convert", tif, "-o", sflac, "--spatial", "--tile-size", tile_size)
    streamer = SpatialFLACStreamer(str(sflac))
    x0, y0, x1, y1 = (
        streamer.spatial_index.frames[0].bbox[0],
        streamer.spatial_index.frames[-1].bbox[1],
        streamer.spatial_index.frames[-1].bbox[2],
        streamer.spatial_index.frames[0].bbox[3],
    )
    q = (x0 + 0.3 * (x1 - x0), y0 + 0.3 * (y1 - y0),
         x0 + 0.55 * (x1 - x0), y0 + 0.55 * (y1 - y0))
    dev, first = timed(streamer.decode_bbox_device, q)
    host = streamer.decode_bbox(q)
    gate(len(dev) == len(host) > 1, f"bbox tiles {len(dev)} vs {len(host)}")
    for (_, ad), (_, ah) in zip(dev, host):
        gate(np.array_equal(np.asarray(ad), ah), "mesh bbox decode != host")
    out["bbox_tiles"] = len(dev)
    out["bbox_first_s"] = first
    return out


# ---------------------------------------------------------------------------
# driver


def _print_memory_analysis(label: str, jitted, recorded) -> None:
    if recorded is None:
        print(f"memory_analysis {label}: not captured")
        return
    args, kwargs = recorded
    compiled = jitted.lower(*args, **kwargs).compile()
    print(f"memory_analysis {label}: {compiled.memory_analysis()}")


def _line(phase: str, wall: float, info: dict, **engines) -> None:
    shown = {k: v for k, v in info.items()
             if not k.endswith(".args") and k not in ("blob", "tif")}
    eng = " ".join(f"{k}={v}" for k, v in engines.items())
    print(
        f"smoke-timing phase={phase} wall_s={wall:.3f} "
        f"first_call_s={shown.pop('first_s', float('nan')):.3f} "
        f"warm_s={shown.pop('warm_s', float('nan')):.3f} "
        f"peak_bytes_in_use={peak_bytes()} {eng} {json.dumps(shown, default=str)}",
        flush=True,
    )


def _prepare_environment(four: bool) -> None:
    """Before JAX starts: expose exactly the cards this run uses, and keep
    a CPU backend for the phase-2 host cross-check."""
    if "jax" in sys.modules:
        return
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0,1,2,3" if four else "0")
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card tile-mesh path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    _prepare_environment(args.four)

    import jax

    from bench import make_raster, require_gpu
    from flac_raster_tpu import native
    from flac_raster_tpu.backend import enable_compile_cache

    enable_compile_cache()
    try:
        device = require_gpu()
    except RuntimeError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if device["count"] != want:
        print(f"chip_smoke: {device['count']} devices visible, this run "
              f"needs {want}", file=sys.stderr)
        return 2
    print(f"nvidia-smi: {device['gpu']}")
    print(f"jax {jax.__version__} platform={device['platform']} "
          f"kind={device['kind']} count={device['count']} "
          f"native={native.available()}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        workdir = Path(tmp)
        t0 = time.perf_counter()
        raster = make_raster(SCENE_SIZE, seed=args.seed)
        print(f"scene {raster.shape} {raster.dtype} made in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        if args.four:
            t0 = time.perf_counter()
            info = four_mesh(raster, TILE_SIZE, workdir)
            _line("four_mesh", time.perf_counter() - t0, info,
                  encoder="encode_flac_batch_mesh", decoder="device-mesh",
                  scan="xla-scan")
        else:
            run_phases(workdir, raster, args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


def run_phases(workdir: Path, raster: np.ndarray, seed: int) -> None:
    from flac_raster_tpu.ops import device_decode, device_emit

    t0 = time.perf_counter()
    scene = phase_scene(workdir, raster)
    _line("1_scene", time.perf_counter() - t0, scene,
          encoder=scene["encoder"], decoder="host")

    t0 = time.perf_counter()
    info = phase_crosscheck(raster, CROSS_FRAMES)
    _line("2_crosscheck", time.perf_counter() - t0, info,
          encoder="encode_flac_device|encode_flac_fast@cpu", decoder="host")

    t0 = time.perf_counter()
    res = phase_resident(scene["blob"], raster)
    _line("3_resident", time.perf_counter() - t0, res,
          encoder="encode_flac_device(scanned)", decoder=res["decode_engine"],
          scan="xla-scan")
    _print_memory_analysis("plan_and_emit", device_emit.plan_and_emit,
                           scene["plan_and_emit.args"])
    _print_memory_analysis("decode_frames_device",
                           device_decode.decode_frames_device,
                           res["decode_frames_device.args"])

    t0 = time.perf_counter()
    info = phase_spatial(workdir, scene["tif"], raster, TILE_SIZE)
    _line("4_spatial", time.perf_counter() - t0, info,
          encoder="encode_flac_batch", decoder="device", scan="xla-scan")

    t0 = time.perf_counter()
    print("phase 5 DEM: 3600x3600 float32 is the Copernicus GLO-30 tile shape "
          "(an assumption; data synthetic)", flush=True)
    info = phase_wide(make_dem(DEM_SIZE, seed))
    _line("5_wide", time.perf_counter() - t0, info,
          encoder="encode_flac_device(32-bps)", decoder="host+device",
          scan="xla-scan")

    t0 = time.perf_counter()
    info = phase_fuzz(seed, FUZZ_VERIFIED, FUZZ_DIFFERENTIAL)
    _line("6_fuzz", time.perf_counter() - t0, info,
          decoder="device", scan="xla-scan")


if __name__ == "__main__":
    sys.exit(main())
