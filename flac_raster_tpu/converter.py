"""Bidirectional GeoTIFF <-> FLAC conversion (public API).

Drop-in counterpart of the reference's ``RasterFLACConverter``
(``converter.py:34-400``): same method names/signatures and the same
GEOSPATIAL_* metadata contract, on this framework's own stack (no GDAL, no
libFLAC, no mutagen):

  * raster I/O        -> flac_raster_tpu.io.geotiff
  * dtype -> PCM      -> ops.normalization (exact-lossless by default;
                         reference-minmax mode for compatibility)
  * FLAC codec        -> codec.encoder / codec.decoder (device path when
                         available, host numpy otherwise)
  * metadata          -> written into the stream at encode time
                         (no post-hoc header rewrite; fixes SURVEY.md Q3a)

Key behavioral upgrade (SURVEY.md Q1): default mode round-trips EVERY
supported dtype bit-exactly, including float32/float64 and full-range
uint16/uint32 -- cases where the reference's min-max quantization is lossy.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from .codec.decoder import decode_flac
from .codec.device_encoder import encode_flac_device
from .codec.fast_encoder import encode_flac_batch, encode_flac_fast
from .io.geo import Affine
from .io.geotiff import open_geotiff, write_geotiff
from .models.metadata import build_geospatial_comments, parse_geospatial_comments
from .ops.normalization import (
    MODE_MINMAX,
    NormalizationParams,
    calculate_audio_params,
    denormalize_from_audio,
    denormalize_lossless,
    normalize_lossless,
    normalize_to_audio,
)

logger = logging.getLogger("flac_raster_tpu.converter")

__all__ = ["RasterFLACConverter"]


def _best_encoder():
    """The platform's whole-stream encoder (backend.py's ``encoder`` entry):
    the device-resident pipeline on an accelerator, the host emitter on
    the CPU.

    Both produce byte-identical streams on the CPU (tested); the device
    path keeps the plan in device memory and downloads only compressed
    words.
    """
    from .backend import backend_config

    if backend_config().encoder == "device":
        return encode_flac_device
    return encode_flac_fast


def _interleave(data: np.ndarray) -> tuple[np.ndarray, int]:
    """(bands, h, w) -> (h*w, bands); single band -> (h*w, 1).

    Same layout as the reference (``converter.py:99-110``) so files are
    sample-compatible; on device this is a fused transpose.
    """
    if data.ndim == 3:
        bands = data.shape[0]
        return np.ascontiguousarray(data.transpose(1, 2, 0).reshape(-1, bands)), bands
    return data.reshape(-1, 1), 1


class RasterFLACConverter:
    """Converts between GeoTIFF and FLAC (reference API parity).

    Args:
        lossless: use exact bijective normalization (default).  Set False for
            reference-identical min-max quantization output.
        compute_md5: write the PCM MD5 into STREAMINFO (cheap; disable for
            maximum throughput benchmarking).
    """

    def __init__(self, lossless: bool = True, compute_md5: bool = True):
        self.metadata_key = "RASTER_METADATA"  # reference attr parity
        self.lossless = lossless
        self.compute_md5 = compute_md5
        self.logger = logger

    # -- TIFF -> FLAC ------------------------------------------------------
    def tiff_to_flac(
        self,
        tiff_path,
        flac_path,
        compression_level: int = 5,
        spatial_tiling: bool = False,
        tile_size: int = 512,
    ):
        """Convert a GeoTIFF to FLAC.  With ``spatial_tiling`` delegates to
        the spatial encoder and returns its SpatialIndex (reference
        ``converter.py:66-71``)."""
        tiff_path, flac_path = Path(tiff_path), Path(flac_path)
        if spatial_tiling:
            from .models.spatial import SpatialFLACEncoder

            encoder = SpatialFLACEncoder(tile_size=tile_size, lossless=self.lossless)
            return encoder.encode_spatial_flac(tiff_path, flac_path, compression_level)

        with open_geotiff(tiff_path) as src:
            data = src.read()
            meta = src.meta
            bounds = src.bounds
            transform = src.transform
        blob = self.encode_array(
            data,
            crs=meta["crs"],
            transform=transform,
            bounds=bounds,
            nodata=meta["nodata"],
            compression_level=compression_level,
        )
        flac_path.write_bytes(blob)
        in_size = tiff_path.stat().st_size
        logger.info(
            "converted %s (%d bytes) -> %s (%d bytes, %.2fx)",
            tiff_path, in_size, flac_path, len(blob), in_size / max(1, len(blob)),
        )
        return None

    def encode_array(
        self,
        data: np.ndarray,
        *,
        crs: str | None = None,
        transform: Affine | None = None,
        bounds=None,
        nodata: float | None = None,
        compression_level: int = 5,
        extra_comments: dict | None = None,
    ) -> bytes:
        """Encode an in-memory raster array (bands, h, w) to FLAC bytes.

        This is the array-level entry point the tile engine batches over;
        ``tiff_to_flac`` is a thin file wrapper around it.
        """
        from .utils.profiling import StageTimer

        timer = StageTimer(enabled=logger.isEnabledFor(logging.DEBUG))
        if data.ndim == 2:
            data = data[None]
        count, height, width = data.shape
        with timer.stage("interleave", data.nbytes):
            interleaved, bands = _interleave(data)
        sample_rate, ref_bps = calculate_audio_params(data, data.dtype)

        # Fast lane: integer dtypes on an accelerator normalize IN-GRAPH
        # (ops/device_emit zero_point prologue) -- raw samples upload
        # directly, no host normalization pass, half the transfer bytes.
        from .ops.normalization import _SHIFT_SPECS

        if (
            self.lossless
            and np.dtype(data.dtype) in _SHIFT_SPECS
            and _SHIFT_SPECS[np.dtype(data.dtype)][0] <= 26
            and _best_encoder() is encode_flac_device
        ):
            bps, zero = _SHIFT_SPECS[np.dtype(data.dtype)]
            with timer.stage("stats", data.nbytes):
                params = NormalizationParams(
                    data_min=float(data.min()), data_max=float(data.max()),
                    original_dtype=str(np.dtype(data.dtype)),
                    bits_per_sample=bps, scale_factor=1, mode="shift",
                    zero_point=zero,
                )
            comments = build_geospatial_comments(
                crs=crs, width=width, height=height, count=count,
                dtype=str(data.dtype), transform=transform,
                bounds=bounds if bounds is not None else [],
                data_min=params.data_min, data_max=params.data_max,
                nodata=nodata, norm_params=params,
            )
            if extra_comments:
                comments.update(extra_comments)
            sample_rate_, _ = calculate_audio_params(data, data.dtype)
            with timer.stage("encode", data.nbytes):
                blob = encode_flac_device(
                    interleaved, sample_rate_, bps,
                    compression_level=compression_level, comments=comments,
                    compute_md5=self.compute_md5, zero_point=zero,
                )
            timer.report(logging.DEBUG)
            return blob

        with timer.stage("normalize", data.nbytes):
            if self.lossless:
                audio, params = normalize_lossless(interleaved)
                flac_bps = params.bits_per_sample
            else:
                audio, params = normalize_to_audio(interleaved, ref_bps)
                # the reference's "24-bit" files are really 32 bps (pyflac
                # override, SURVEY.md Q2) -- match that so its tooling can
                # read our files
                flac_bps = 16 if params.bits_per_sample == 16 else 32
                audio = audio.astype(np.int32)

        channels = audio.shape[1]
        if channels > 8:
            raise ValueError(
                f"{count} bands x {params.channels_per_band} channels/band "
                "exceeds FLAC's 8-channel limit; use spatial tiling with "
                "fewer bands or minmax mode"
            )

        comments = build_geospatial_comments(
            crs=crs,
            width=width,
            height=height,
            count=count,
            dtype=str(data.dtype),
            transform=transform,
            bounds=bounds if bounds is not None else [],
            data_min=params.data_min,
            data_max=params.data_max,
            nodata=nodata,
            norm_params=params,
        )
        if extra_comments:
            comments.update(extra_comments)
        with timer.stage("encode", data.nbytes):
            blob = _best_encoder()(
                audio.astype(np.int32),
                sample_rate,
                flac_bps,
                compression_level=compression_level,
                comments=comments,
                compute_md5=self.compute_md5,
            )
        timer.report(logging.DEBUG)
        return blob

    def encode_array_device(
        self,
        data,
        *,
        crs: str | None = None,
        transform: Affine | None = None,
        bounds=None,
        nodata: float | None = None,
        compression_level: int = 5,
        extra_comments: dict | None = None,
        compute_md5: bool = False,
    ) -> bytes:
        """encode_array for a DEVICE-RESIDENT raster: device egress.

        ``data`` is a (bands, h, w) or (h, w) jax.Array already in HBM
        (a model output, an augmentation result, a decode_bytes_device
        raster).  Band interleave and the lossless shift normalization run
        in-graph, the device encoder consumes HBM slices directly, and only
        COMPRESSED words cross the wire -- the raw raster never visits the
        host (the reference round-trips raw PCM through libFLAC on host,
        ``converter.py:99-180``).  Bytes are identical to encode_array on
        the pulled array except the MD5 field, which is left unset by
        default: an MD5 is a sequential host hash over raw samples, so
        ``compute_md5=True`` pulls the PCM equivalent on a worker thread
        OVERLAPPED with the compressed-word drain and patches the hash into
        STREAMINFO -- opt-in because the pull costs ~raw-size of
        device->host bandwidth (``flac-raster info`` distinguishes unset
        MD5s; see docs/FORMATS.md).

        In-graph lanes: every integer dtype of the lossless shift mode
        (uint8..int32 -- 32-bps streams plan on device via ops/wide_codec)
        plus the float32 bit-fold (the order-preserving involution of
        ops/normalization._float_bits_fold, run as a device bitcast).
        float64 rasters (host arrays: JAX's default x64-off config carries
        no f64 on device)
        split hi/lo into two 32-bps channels per band ON HOST (a cheap
        elementwise bit view, ops/normalization MODE_FLOAT64_BITS) and the
        heavy planning/emission runs through the wide device lane; NaN,
        inf, and -0.0 round-trip exactly.  Only minmax mode falls back to
        encode_array.
        """
        import jax
        import jax.numpy as jnp

        from .ops.normalization import (
            MODE_FLOAT32_BITS,
            MODE_SHIFT,
            _SHIFT_SPECS,
            normalize_lossless,
        )

        # float64 first: jnp.asarray under the default x64-off config would
        # silently downcast to float32 -- never let an f64 raster hit that.
        if np.dtype(getattr(data, "dtype", np.float32)) == np.float64:
            if not self.lossless:
                return self.encode_array(
                    np.asarray(data), crs=crs, transform=transform,
                    bounds=bounds, nodata=nodata,
                    compression_level=compression_level,
                    extra_comments=extra_comments,
                )
            arr = np.asarray(data)
            if arr.ndim == 2:
                arr = arr[None]
            count, height, width = arr.shape
            if 2 * count > 8:
                raise ValueError(
                    f"{count} float64 bands x 2 channels/band exceeds "
                    "FLAC's 8-channel limit"
                )
            interleaved, _ = _interleave(arr)
            # host work ends here: the exact hi/lo bit split (elementwise
            # views); planning/emission runs on device via ops/wide_codec
            audio, params = normalize_lossless(interleaved)
            comments = build_geospatial_comments(
                crs=crs, width=width, height=height, count=count,
                dtype="float64", transform=transform,
                bounds=bounds if bounds is not None else [],
                data_min=params.data_min, data_max=params.data_max,
                nodata=nodata, norm_params=params,
            )
            if extra_comments:
                comments.update(extra_comments)
            sample_rate, _ = calculate_audio_params(arr, arr.dtype)
            return encode_flac_device(
                audio, sample_rate, 32,
                compression_level=compression_level, comments=comments,
                compute_md5=compute_md5,
            )

        if not isinstance(data, jax.Array):
            data = jnp.asarray(np.asarray(data))
        if data.ndim == 2:
            data = data[None]
        count, height, width = data.shape
        dt = np.dtype(data.dtype)
        is_f32 = dt == np.dtype(np.float32)
        if not (self.lossless and (dt in _SHIFT_SPECS or is_f32)):
            logger.debug(
                "encode_array_device: %s/%s outside the in-graph lane; "
                "pulling to host", dt, "lossless" if self.lossless else "minmax",
            )
            return self.encode_array(
                np.asarray(data), crs=crs, transform=transform, bounds=bounds,
                nodata=nodata, compression_level=compression_level,
                extra_comments=extra_comments,
            )
        if is_f32:
            bps, zero, mode = 32, 0, MODE_FLOAT32_BITS
            # stats BEFORE folding (nan-aware, matching normalize_lossless)
            data_min = float(jnp.nanmin(data))
            data_max = float(jnp.nanmax(data))
            u = jax.lax.bitcast_convert_type(data, jnp.uint32)
            folded = jnp.where(
                (u >> jnp.uint32(31)).astype(bool),
                u ^ jnp.uint32(0x7FFFFFFF),
                u,
            )
            data = jax.lax.bitcast_convert_type(folded, jnp.int32)
        else:
            (bps, zero), mode = _SHIFT_SPECS[dt], MODE_SHIFT
            data_min, data_max = float(data.min()), float(data.max())
        interleaved = jnp.transpose(data, (1, 2, 0)).reshape(
            height * width, count
        )
        # stats for the metadata block: device reduce, two-scalar pull
        params = NormalizationParams(
            data_min=data_min, data_max=data_max,
            original_dtype=str(dt), bits_per_sample=bps, scale_factor=1,
            mode=mode, zero_point=zero,
        )
        comments = build_geospatial_comments(
            crs=crs, width=width, height=height, count=count,
            dtype=str(dt), transform=transform,
            bounds=bounds if bounds is not None else [],
            data_min=params.data_min, data_max=params.data_max,
            nodata=nodata, norm_params=params,
        )
        if extra_comments:
            comments.update(extra_comments)
        sample_rate, _ = calculate_audio_params(data, dt)
        md5_thread = None
        md5_box: dict = {}
        if compute_md5:
            # opt-in MD5 (VERDICT r4 #7): the sequential host hash pulls the
            # PCM equivalent on a worker thread while the main thread runs
            # the encode + word drain, so the two device->host transfers
            # overlap.
            import threading

            from .codec.decoder import md5_of_samples

            def _hash(arr=interleaved, zp=zero, width_=bps):
                md5_box["md5"] = md5_of_samples(
                    np.asarray(arr).astype(np.int64) - zp, width_
                )

            md5_thread = threading.Thread(
                target=_hash, daemon=True, name="frtpu-md5"
            )
            md5_thread.start()
        blob = encode_flac_device(
            interleaved, sample_rate, bps,
            compression_level=compression_level, comments=comments,
            compute_md5=False, zero_point=zero,
        )
        if md5_thread is not None:
            md5_thread.join()
            # STREAMINFO md5 field: bytes 26..42 ("fLaC" + 4B block header
            # + 18B of stream parameters -- models/flac_format layout)
            blob = blob[:26] + md5_box["md5"] + blob[42:]
        return blob

    def encode_array_batch(
        self,
        tiles: np.ndarray,
        *,
        crs=None,
        transforms=None,
        bounds_list=None,
        nodata=None,
        compression_level: int = 5,
        extra_comments_list=None,
    ) -> list[bytes]:
        """Encode a batch of same-shaped raster tiles in one device pass.

        Each tile is normalized independently (per-tile min/max, matching the
        reference's spatial behavior -- SURVEY.md Q4) and carries its own
        GEOSPATIAL_* metadata, but all tiles' FLAC encode runs batched on
        device (codec/fast_encoder.encode_flac_batch); with more than one
        visible device the whole batch is planned, emitted, and scatter-
        packed by the (tiles x blocks) shard_map step
        (parallel/tile_engine.encode_flac_batch_mesh).  Either way this
        replaces the reference's sequential per-tile temp-file loop
        (``spatial_encoder.py:196-245``).

        Args:
            tiles: (T, bands, h, w) array.
            transforms / bounds_list / extra_comments_list: per-tile, len T.
        Returns:
            list of T complete FLAC byte streams.
        """
        tiles = np.asarray(tiles)
        T, count, height, width = tiles.shape
        audio_batch = []
        comments_list = []
        sample_rate = ref_bps = None
        for t in range(T):
            data = tiles[t]
            interleaved, _ = _interleave(data)
            sample_rate, ref_bps = calculate_audio_params(data, data.dtype)
            if self.lossless:
                audio, params = normalize_lossless(interleaved)
                flac_bps = params.bits_per_sample
            else:
                audio, params = normalize_to_audio(interleaved, ref_bps)
                flac_bps = 16 if params.bits_per_sample == 16 else 32
                audio = audio.astype(np.int32)
            comments = build_geospatial_comments(
                crs=crs,
                width=width,
                height=height,
                count=count,
                dtype=str(data.dtype),
                transform=transforms[t] if transforms is not None else None,
                bounds=bounds_list[t] if bounds_list is not None else [],
                data_min=params.data_min,
                data_max=params.data_max,
                nodata=nodata,
                norm_params=params,
            )
            if extra_comments_list is not None and extra_comments_list[t]:
                comments.update(extra_comments_list[t])
            audio_batch.append(audio.astype(np.int32))
            comments_list.append(comments)
        return encode_flac_batch(
            np.stack(audio_batch),
            sample_rate,
            flac_bps,
            compression_level=compression_level,
            comments_list=comments_list,
            compute_md5=self.compute_md5,
        )

    # -- FLAC -> TIFF ------------------------------------------------------
    def flac_to_tiff(self, flac_path, tiff_path):
        """Convert a FLAC file (ours or reference-produced) back to GeoTIFF."""
        flac_path, tiff_path = Path(flac_path), Path(tiff_path)
        blob = flac_path.read_bytes()
        data, meta = self.decode_bytes(blob, sidecar_path=flac_path.with_suffix(".json"))
        transform = None
        if meta.get("transform"):
            t = meta["transform"]
            transform = Affine(t[0], t[1], t[2], t[3], t[4], t[5])
        write_geotiff(
            tiff_path,
            data,
            crs=meta.get("crs") or None,
            transform=transform,
            nodata=meta.get("nodata"),
        )
        logger.info("converted %s -> %s %s", flac_path, tiff_path, data.shape)


    @staticmethod
    def _load_meta(comments: dict, sidecar_path: Path | None) -> dict | None:
        """GEOSPATIAL_* metadata from Vorbis comments, else the JSON sidecar."""
        meta = parse_geospatial_comments(comments)
        if meta is None and sidecar_path is not None and sidecar_path.exists():
            raw = json.loads(sidecar_path.read_text())
            meta = {k: raw.get(k) for k in (
                "crs", "width", "height", "count", "dtype", "nodata",
                "data_min", "data_max", "transform", "bounds", "scale_factor",
            )}
            if raw.get("normalization"):
                meta["normalization"] = NormalizationParams.from_dict(raw["normalization"])
        return meta

    @staticmethod
    def _denormalize_samples(decoded, meta) -> np.ndarray:
        """Shared inverse-normalization: DecodedStream samples -> flat data.

        Every normalization mode is elementwise per sample row, so this is
        valid for any contiguous slice of the stream (used by decode_rows).
        """
        samples = decoded.samples  # (n, channels) int32
        if decoded.streaminfo.bits_per_sample == 16:
            # scale selection in denormalize_from_audio is dtype-driven
            # (mirroring the reference's soundfile behavior)
            samples = samples.astype(np.int16)
        params: NormalizationParams | None = meta.get("normalization")

        if params is not None and params.mode != MODE_MINMAX:
            return denormalize_lossless(samples, params)
        if params is None:
            # reference-produced file: reconstruct params from fields
            # (``converter.py:221-229``) and decode exactly as its
            # soundfile path would
            bps = 16 if decoded.streaminfo.bits_per_sample == 16 else 24
            params = NormalizationParams(
                data_min=meta["data_min"],
                data_max=meta["data_max"],
                original_dtype=meta["dtype"],
                bits_per_sample=bps,
                scale_factor=meta.get("scale_factor", 32767 if bps == 16 else 8388607),
            )
            return denormalize_from_audio(samples, params, soundfile_compat=True)
        return denormalize_from_audio(samples, params)

    def decode_rows(
        self,
        blob: bytes,
        row0: int,
        n_rows: int,
        sidecar_path: Path | None = None,
    ) -> tuple[np.ndarray, dict]:
        """Decode only raster rows [row0, row0 + n_rows) from a FLAC blob.

        Random access through the FRTP decode index
        (codec/decoder.decode_flac_range): rows map to the contiguous
        sample span [row0*width, (row0+n_rows)*width), and only the frames
        covering it are parsed.  Returns ((bands, n_rows, width), metadata).
        The reference can only do windowed reads through its tiled
        spatial/streaming containers; this works on plain whole-raster
        FLAC files.
        """
        from .codec.decoder import decode_flac_range
        from .models.flac_format import (
            BLOCK_VORBIS_COMMENT,
            parse_flac_metadata,
            parse_vorbis_comments,
        )

        # metadata straight from the header blocks: O(metadata) even for
        # foreign streams (a zero-sample decode_flac_range would fall back
        # to a FULL decode when the FRTP index is absent)
        comments: dict = {}
        for b in parse_flac_metadata(bytes(blob))[1]:
            if b.block_type == BLOCK_VORBIS_COMMENT:
                _, comments = parse_vorbis_comments(b.data)
        meta = self._load_meta(comments, sidecar_path)
        if not meta:
            raise ValueError("no geospatial metadata found in FLAC file or sidecar")
        width, height, count = meta["width"], meta["height"], meta["count"]
        if row0 < 0 or n_rows < 0 or row0 + n_rows > height:
            raise ValueError("row range outside the raster")

        decoded = decode_flac_range(
            blob, row0 * width, n_rows * width, verify_crc=False
        )
        flat = self._denormalize_samples(decoded, meta)
        return self._reshape_rows(flat, n_rows, width, count), meta

    @staticmethod
    def _reshape_rows(flat: np.ndarray, n_rows: int, width: int, count: int) -> np.ndarray:
        if count > 1 or (flat.ndim > 1 and flat.shape[1] > 1):
            data = flat.reshape(n_rows, width, count).transpose(2, 0, 1)
        else:
            data = flat.reshape(n_rows, width)[None]
        return np.ascontiguousarray(data)

    # initial/metadata prefetch for ranged remote row decode; doubles until
    # the metadata section parses (reference prefetches a flat 1 MB,
    # ``spatial_encoder.py:450`` -- ours starts smaller and grows)
    _HEADER_PREFETCH = 256 * 1024
    _HEADER_PREFETCH_MAX = 32 * 1024 * 1024

    def decode_rows_ranged(
        self,
        source,
        row0: int,
        n_rows: int,
        sidecar_path: Path | None = None,
    ) -> tuple[np.ndarray, dict, int]:
        """decode_rows over a byte-range source (RemoteFile-like) -- the
        plain-FLAC analog of the reference's streaming-container extract
        (``cli.py:297-306``), which fetches only the covering tile's bytes.

        Fetches (1) a growing header prefix until the metadata section
        parses, then (2) exactly the frame span covering the row window,
        located through the FRTP layout index -- never the whole file.
        ``source`` needs ``read_range(start, end)`` (inclusive end) and a
        ``file_size`` attribute (both on io.remote.RemoteFile); falls back
        to a whole-file fetch + :meth:`decode_rows` when the stream carries
        no layout index.  Returns ``(data, meta, bytes_fetched)``.
        """
        from .codec.decoder import decode_flac
        from .models.flac_format import (
            BLOCK_VORBIS_COMMENT,
            StreamInfo,
            build_flac_header,
            parse_flac_metadata,
            parse_layout_block,
            parse_vorbis_comments,
        )

        size = source.file_size
        fetched = 0
        want = min(self._HEADER_PREFETCH, size or self._HEADER_PREFETCH)
        header = b""
        while True:
            header += source.read_range(len(header), want - 1)
            fetched = len(header)
            try:
                si, blocks, frame_start = parse_flac_metadata(header)
                break
            except ValueError as e:
                if "truncated" not in str(e):
                    raise
                if (size is not None and want >= size) or want >= self._HEADER_PREFETCH_MAX:
                    raise
                want = min(want * 4, size or self._HEADER_PREFETCH_MAX)

        comments: dict = {}
        for b in blocks:
            if b.block_type == BLOCK_VORBIS_COMMENT:
                _, comments = parse_vorbis_comments(b.data)
        meta = self._load_meta(comments, sidecar_path)
        if not meta:
            raise ValueError("no geospatial metadata found in FLAC file or sidecar")
        width, height, count = meta["width"], meta["height"], meta["count"]
        if row0 < 0 or n_rows < 0 or row0 + n_rows > height:
            raise ValueError("row range outside the raster")

        layout = parse_layout_block(blocks)
        N = si.max_blocksize
        offsets = layout.absolute_offsets(frame_start) if layout is not None else None
        if (
            layout is None
            or si.min_blocksize != N
            or N == 0
            or si.total_samples == 0
            or (size is not None and offsets[-1] != size)
        ):
            # foreign stream without a usable decode index: whole-file path
            blob = header
            if size is not None and size > len(header):
                blob = header + source.read_range(len(header), size - 1)
            data, meta = self.decode_rows(blob, row0, n_rows, sidecar_path)
            return data, meta, len(blob)

        start_sample, num_samples = row0 * width, n_rows * width
        n_frames = len(layout.sizes)
        f0 = min(start_sample // N, n_frames - 1)
        f1 = min(-(-(start_sample + num_samples) // N), n_frames)
        span_samples = min(si.total_samples, f1 * N) - f0 * N

        lo_byte, hi_byte = int(offsets[f0]), int(offsets[f1])
        if hi_byte <= len(header) and lo_byte >= 0:
            span = header[lo_byte:hi_byte]
        elif lo_byte < len(header):
            span = header[lo_byte:] + source.read_range(len(header), hi_byte - 1)
            fetched += hi_byte - len(header)
        else:
            span = source.read_range(lo_byte, hi_byte - 1)
            fetched += hi_byte - lo_byte

        mini_si = StreamInfo(
            min_blocksize=si.min_blocksize, max_blocksize=N,
            min_framesize=0, max_framesize=0,
            sample_rate=si.sample_rate, channels=si.channels,
            bits_per_sample=si.bits_per_sample, total_samples=span_samples,
        )
        dec = decode_flac(build_flac_header(mini_si) + span, verify_crc=False)
        lo = start_sample - f0 * N
        dec.samples = dec.samples[lo : lo + num_samples]
        dec.streaminfo = si
        flat = self._denormalize_samples(dec, meta)
        return self._reshape_rows(flat, n_rows, width, count), meta, fetched

    def decode_bytes_device(
        self,
        blob: bytes,
        sidecar_path: Path | None = None,
        override_dims: tuple[int, int] | None = None,
    ):
        """decode_bytes, but the raster never visits the host.

        The compressed bytes decode through codec/device_decoder and the
        inverse normalization applies on device (ops/device_normalize), so
        the returned array is a device-resident jax.Array of the raster's
        original dtype in (bands, h, w) layout -- the end-to-end device-ingest
        path (the reference host-decodes via libFLAC then denormalizes in
        numpy, ``converter.py:181-229``).  Lossless-mode outputs are
        bit-exact vs decode_bytes (tested); minmax computes in float32 on
        device (see ops/device_normalize).  File classes with float64
        output fall back to decode_bytes and return the exact HOST array
        (device_put under the default x64-off config would silently
        downcast f64).
        """
        from .codec.device_decoder import decode_flac_device
        from .ops.device_normalize import device_denorm_supported

        decoded = decode_flac_device(blob, verify_crc=False)
        meta = self._load_meta(decoded.comments, sidecar_path)
        if meta is None:
            raise ValueError("no geospatial metadata found in FLAC file or sidecar")
        if not device_denorm_supported(meta.get("normalization")):
            # float64 outputs: device_put under the default x64-off config
            # would silently downcast -- the stream
            # already decoded through the device wide lane above, so pull
            # the int32 PCM and run only the exact hi/lo recombine (a cheap
            # elementwise bit view) in numpy, returning the exact host array
            import copy as _copy

            host_dec = _copy.copy(decoded)
            host_dec.samples = np.asarray(decoded.samples)
            flat = self._denormalize_samples(host_dec, meta)
            width, height, count = meta["width"], meta["height"], meta["count"]
            if override_dims is not None:
                width, height = override_dims
                meta = dict(meta, width=width, height=height)
            if flat.shape[0] != width * height:
                raise ValueError(
                    f"decoded sample count {flat.shape[0]} != width*height "
                    f"{width * height}"
                )
            if count > 1 or (flat.ndim > 1 and flat.shape[1] > 1):
                data = flat.reshape(height, width, count).transpose(2, 0, 1)
            else:
                data = flat.reshape(height, width)[None]
            return np.ascontiguousarray(data), meta
        return self._denormalize_device_stream(decoded, meta, override_dims)

    def _denormalize_device_stream(self, decoded, meta, override_dims=None):
        """Device denorm + band-major reshape of a device DecodedStream.

        Shared tail of decode_bytes_device and the spatial streamer's
        decode_bbox_device; caller has checked device_denorm_supported.
        """
        from .ops.device_normalize import denormalize_device

        params = meta.get("normalization")
        width, height, count = meta["width"], meta["height"], meta["count"]
        if override_dims is not None:
            width, height = override_dims
            meta = dict(meta, width=width, height=height)
        bps = decoded.streaminfo.bits_per_sample
        if params is None:
            # reference-produced file (converter.py:221-229 semantics)
            ref_bps = 16 if bps == 16 else 24
            params = NormalizationParams(
                data_min=meta["data_min"], data_max=meta["data_max"],
                original_dtype=meta["dtype"], bits_per_sample=ref_bps,
                scale_factor=meta.get(
                    "scale_factor", 32767 if ref_bps == 16 else 8388607
                ),
            )
            flat = denormalize_device(
                decoded.samples, params, bits_per_sample=bps,
                soundfile_compat=True,
            )
        else:
            flat = denormalize_device(
                decoded.samples, params, bits_per_sample=bps
            )
        if flat.shape[0] != width * height:
            raise ValueError(
                f"decoded sample count {flat.shape[0]} != width*height "
                f"{width * height}"
            )
        if count > 1 or (flat.ndim > 1 and flat.shape[1] > 1):
            data = flat.reshape(height, width, count).transpose(2, 0, 1)
        else:
            data = flat.reshape(height, width)[None]
        return data, meta

    def decode_bytes(
        self,
        blob: bytes,
        sidecar_path: Path | None = None,
        override_dims: tuple[int, int] | None = None,
    ) -> tuple[np.ndarray, dict]:
        """Decode FLAC bytes to ((bands, h, w) array, metadata dict).

        Handles three provenances:
          * our lossless files   -> exact inverse normalization
          * our minmax files     -> exact inverse of the stored scale factor
          * reference files      -> libsndfile-compatible semantics, so the
            output matches the reference's own round-trip byte-for-byte
        """
        decoded = decode_flac(blob, verify_crc=False)
        meta = self._load_meta(decoded.comments, sidecar_path)
        if not meta:
            raise ValueError("no geospatial metadata found in FLAC file or sidecar")

        width, height, count = meta["width"], meta["height"], meta["count"]
        if override_dims is not None:
            # spatial tile 0 advertises the GLOBAL raster dims (reference
            # layout); callers that know the tile window pass it here
            width, height = override_dims
            meta = dict(meta, width=width, height=height)
        flat = self._denormalize_samples(decoded, meta)

        n_expected = width * height
        if flat.shape[0] != n_expected:
            raise ValueError(
                f"decoded sample count {flat.shape[0]} != width*height {n_expected}"
            )
        if count > 1 or flat.ndim > 1 and flat.shape[1] > 1:
            data = flat.reshape(height, width, count).transpose(2, 0, 1)
        else:
            data = flat.reshape(height, width)[None]
        return np.ascontiguousarray(data), meta
