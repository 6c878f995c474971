"""Device-resident FLAC encoder: plan + emit + pack on device, download
only compressed words.

The full-device sibling of codec/fast_encoder.py (identical output bytes,
tested): planning (ops/device_codec) and bitstream assembly (ops/device_emit)
run in one jit program per chunk; the host receives

  * ``total_bits``  -- a scalar,
  * ``frame_bits``  -- (F,) int32 for CRC span layout,
  * the used prefix of the word buffer, pulled in fixed-size pages
    (static-shape slices; the worst-case tail of the buffer never moves),

then byteswaps to big-endian, patches CRC8/16 with the native C pass
(native/bitpack.cpp), and writes STREAMINFO/metadata.  Device->host traffic
is ~compressed_size + O(F) instead of ~2x raw (samples back + plan).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

logger = logging.getLogger("flac_raster_tpu.device_encoder")

import jax.numpy as jnp

import functools

import jax

from ..models.flac_format import (
    LAYOUT_FLAG_TOK32,
    StreamInfo,
    build_flac_header,
)
from ..ops.device_emit import plan_and_emit, worst_case_words
from .decoder import md5_of_samples
from .encoder import _BPS_CODES, _SAMPLE_RATE_CODES, EncoderConfig
from .fast_encoder import _blocksize_header, _emit_tail_frame
from ..ops.device_codec import MAX_DEVICE_BPS

__all__ = ["encode_flac_device"]

_PAGE_WORDS = 1 << 18  # 1 MB pages for device->host pulls


@functools.partial(jax.jit, static_argnames=("f_pad", "N", "C"))
def _rows_to_fcn(x_rows, *, f_pad: int, N: int, C: int):
    """(rows, C) sample rows -> zero-padded (f_pad, C, N) frame tensor.

    Runs ON DEVICE so the host never materializes the transposed or padded
    copy; the upload stays the raw contiguous row slice.
    """
    rows = x_rows.shape[0]
    x = jnp.zeros((f_pad * N, C), x_rows.dtype)
    x = jax.lax.dynamic_update_slice(x, x_rows, (0, 0)) if rows != f_pad * N \
        else x_rows
    return x.reshape(f_pad, N, C).transpose(0, 2, 1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "K", "F", "N", "C", "n_words", "blocksize", "bps", "sr_code",
        "bps_code", "bs_code", "bs_tail_bits", "bs_tail_val", "max_lpc_order",
        "max_partition_order", "use_lpc", "zero_point", "mid_side",
        "apodizations",
    ),
)
def _plan_emit_scan(rows, f0s, *, K: int, F: int, N: int, C: int,
                    n_words: int, **static_kw):
    """ONE dispatch for K full chunks: lax.scan of plan_and_emit.

    Scanning K chunks inside one jit pays the per-call host dispatch cost
    once instead of K times; the body is the exact per-chunk program, so
    bytes are unchanged.

    Args:
        rows: (K*F*N, C) samples, any integer dtype (raw rasters fine --
            the fused normalization runs per chunk inside plan_and_emit).
        f0s: (K,) int32 absolute first-frame index per chunk.
    Returns:
        dict of stacked outputs: words (K, n_words) uint32,
        frame_bits (K, F) int32, subframe_bits (K, F, C) int32.
    """
    x = rows.reshape(K, F, N, C)

    def step(carry, it):
        xc, f0 = it
        out = plan_and_emit(
            xc.transpose(0, 2, 1), f0, n_words=n_words, **static_kw
        )
        return carry, (out["words"], out["frame_bits"], out["subframe_bits"])

    _, (w, fb, sfb) = jax.lax.scan(step, jnp.int32(0), (x, f0s))
    return {"words": w, "frame_bits": fb, "subframe_bits": sfb}


def _pull_pages(used_pages: int, n_pages: int) -> int:
    """Device->host readback slice size in pages.

    Quarter steps above the power of two BELOW ``used_pages``, so the
    overfetch is <= 25% while the number of distinct compiled slice shapes
    stays O(log n); pulls of <= 4 pages are exact.  (An earlier version
    bucketed quarters of the power of two ABOVE, which always collapsed to
    that power of two -- up to 100% overfetch.)
    """
    used_pages = max(1, used_pages)
    if used_pages <= 4:
        return min(used_pages, n_pages)
    lo = 1 << (used_pages.bit_length() - 1)  # power of two <= used_pages
    for num in (4, 5, 6, 7, 8):              # lo, 1.25*lo, ..., 2*lo
        cand = (lo * num) // 4               # lo >= 4 -> exact quarters
        if used_pages <= cand:
            return min(cand, n_pages)
    return min(2 * lo, n_pages)              # not reachable


def _patch_crcs(buf: np.ndarray, frame_bits: np.ndarray, hdr_bits: np.ndarray) -> None:
    """Patch per-frame CRC8 (header) and CRC16 (frame) in place."""
    from .. import native

    frame_start = (np.cumsum(frame_bits) - frame_bits) >> 3
    hdr_len = hdr_bits >> 3
    fr_len = (frame_bits >> 3) - 2
    if native.available():
        native.crc8_patch(buf, frame_start, hdr_len)
        native.crc16_patch(buf, frame_start, fr_len)
        return
    from ..ops.crc import crc16, crc8

    for s, hl, fl in zip(frame_start.tolist(), hdr_len.tolist(), fr_len.tolist()):
        buf[s + hl] = crc8(buf[s : s + hl].tobytes())
        c = crc16(buf[s : s + fl].tobytes())
        buf[s + fl] = c >> 8
        buf[s + fl + 1] = c & 0xFF


def _utf8_nbytes(fi: np.ndarray) -> np.ndarray:
    thr = np.array([0x80, 0x800, 0x10000, 0x200000, 0x4000000], np.int64)
    return np.sum(fi[:, None] >= thr[None, :], axis=1) + 1


def emit_static_kwargs(
    channels: int,
    bits_per_sample: int,
    compression_level: int,
    blocksize: int,
    sample_rate: int,
) -> dict:
    """The static keyword arguments ``plan_and_emit`` / ``_plan_emit_scan``
    take for one stream configuration (``zero_point`` and ``n_words``
    excepted): frame-header codes, the level's search space, mid-side."""
    from ..ops.stereo import midside_ok

    cfg = EncoderConfig.from_level(compression_level)
    bs_code, bs_tail_val, bs_tail_bits = _blocksize_header(blocksize)
    return dict(
        blocksize=blocksize,
        bps=bits_per_sample,
        sr_code=_SAMPLE_RATE_CODES.get(sample_rate, 0),
        bps_code=_BPS_CODES[bits_per_sample],
        bs_code=bs_code,
        bs_tail_bits=bs_tail_bits,
        bs_tail_val=bs_tail_val,
        max_lpc_order=cfg.max_lpc_order,
        apodizations=cfg.apodizations,
        max_partition_order=min(cfg.max_partition_order, 6),
        use_lpc=cfg.use_lpc,
        mid_side=midside_ok(
            channels, bits_per_sample, cfg.mid_side, device=True
        ),
    )


def encode_flac_device(
    samples: np.ndarray,
    sample_rate: int,
    bits_per_sample: int,
    compression_level: int = 5,
    blocksize: int = 4096,
    comments: dict[str, str] | None = None,
    vendor: str = "flac-raster-tpu",
    compute_md5: bool = True,
    padding: int = 0,
    plan_chunk_frames: int = 2048,
    zero_point: int = 0,
) -> bytes:
    """Encode int samples (n, channels) to FLAC, fully on device.

    Output bytes are identical to encode_flac_fast's (same planner, same
    layout arithmetic); only the execution placement differs.

    Args:
        zero_point: when nonzero (or when samples have a narrow unsigned
            dtype), the lossless shift normalization runs IN-GRAPH -- pass
            raw uint16/uint8/int16/int8 rasters directly and halve the
            host->device upload.  samples - zero_point must fit
            bits_per_sample.

    Device-resident input: ``samples`` may be a jax.Array already in HBM
    (e.g. a model output or a decode_bytes_device raster) -- the upload
    pipeline is skipped entirely and chunks are device-side slices; only
    compressed words cross the wire.  The range check pulls two scalars;
    ``compute_md5=True`` pulls the whole tensor (the MD5 is a sequential
    host hash), so device-egress callers pass ``compute_md5=False``
    (converter.encode_array_device does).
    """
    import jax as _jax

    dev_input = isinstance(samples, _jax.Array)
    if not dev_input:
        samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, channels = samples.shape
    if not 1 <= channels <= 8:
        raise ValueError("FLAC supports 1..8 channels")
    if bits_per_sample not in _BPS_CODES:
        raise ValueError(f"unsupported bits_per_sample {bits_per_sample}")
    n_full = n // blocksize
    # narrow (<= MAX_DEVICE_BPS) and wide (32, ops/wide_codec) lanes both
    # run on device; only 27..31 -- not emittable FLAC widths anyway
    # (_BPS_CODES) -- would fall through
    if (
        n_full == 0
        or MAX_DEVICE_BPS < bits_per_sample < 32
        or (blocksize & (blocksize - 1)) != 0
        or blocksize % 64 != 0
    ):
        if dev_input:
            samples = np.asarray(samples)  # honest host fallback
        host_samples = (
            samples.astype(np.int64) - zero_point if zero_point else samples
        )
        from .fast_encoder import encode_flac_fast

        return encode_flac_fast(
            host_samples, sample_rate, bits_per_sample, compression_level,
            blocksize, comments, vendor, compute_md5, padding,
        )
    # keep per-chunk worst-case bits < 2^31 (int32 offsets in-graph)
    plan_chunk_frames = int(
        os.environ.get("FRTPU_CHUNK_FRAMES", plan_chunk_frames)
    )
    max_frames = (1 << 30) // (channels * blocksize * (bits_per_sample + 2))
    plan_chunk_frames = max(1, min(plan_chunk_frames, max_frames))

    lo = -(1 << (bits_per_sample - 1))
    hi = (1 << (bits_per_sample - 1)) - 1
    smp = samples
    if zero_point:
        # shift fast lane: the dtype endpoints must be safe because the
        # subtraction happens in-graph on the raw upload
        info = np.iinfo(samples.dtype)
        if info.min - zero_point < lo or info.max - zero_point > hi:
            raise ValueError("dtype range exceeds bits_per_sample under zero_point")
    else:
        # match encode_flac_fast's drop-in contract: check the ACTUAL sample
        # range, not the dtype's (int64/int16 data that fits bps is fine);
        # for device input this is a device reduce + two-scalar pull
        if int(smp.min()) < lo or int(smp.max()) > hi:
            raise ValueError("samples exceed bits_per_sample range")
        if smp.dtype != np.int32:
            smp = smp.astype(np.int32)

    cfg = EncoderConfig.from_level(compression_level)
    static_kw = emit_static_kwargs(
        channels, bits_per_sample, compression_level, blocksize, sample_rate
    )
    use_ms = static_kw["mid_side"]
    sr_code, bps_code = static_kw["sr_code"], static_kw["bps_code"]
    bs_tail_bits = static_kw["bs_tail_bits"]

    rows = smp[: n_full * blocksize]  # (F*N, C) contiguous view, any int dtype

    # Pipeline: every branch below issues chunk i's dispatch before it
    # drains chunk i-1,
    #
    #   upload(i) -> dispatch(i) -> [download(i-1) + CRC(i-1)]
    #
    # so device compute of chunk i overlaps the download and host CRC pass
    # of chunk i-1.
    bounds = [
        (c0, min(c0 + plan_chunk_frames, n_full))
        for c0 in range(0, n_full, plan_chunk_frames)
    ]
    chunks: list[bytes] = []
    sizes: list[np.ndarray] = []
    subs: list[np.ndarray] = []

    debug = logger.isEnabledFor(logging.DEBUG)

    def dispatch(c0: int, c1: int, xr_dev) -> dict:
        t0 = time.perf_counter() if debug else 0.0
        Fc = c1 - c0
        f_pad = min(1 << max(0, (Fc - 1)).bit_length(), plan_chunk_frames)
        # pad + (F,N,C)->(F,C,N) relayout happen in-graph (_rows_to_fcn)
        xc = _rows_to_fcn(xr_dev, f_pad=f_pad, N=blocksize, C=channels)
        n_words = worst_case_words(
            f_pad, channels, blocksize, bits_per_sample + (1 if use_ms else 0)
        )
        n_words = ((n_words + _PAGE_WORDS - 1) // _PAGE_WORDS) * _PAGE_WORDS
        out = plan_and_emit(
            xc, jnp.int32(c0), n_words=n_words,
            zero_point=zero_point, **static_kw
        )
        if debug:
            logger.debug("dispatch f%d..%d: %.3fs", c0, c1, time.perf_counter() - t0)
        return out

    def drain(c0: int, c1: int, out: dict) -> None:
        """Sync the chunk's per-frame bit counts (tiny pull; blocks until
        its compute lands), download the used word prefix (the one large
        device->host read), then byteswap + CRC-patch + assemble on host.

        Scan-batched chunks arrive as STACKED outputs plus a row index
        (``out["row"]``); the row and the prefix slice are taken in one
        basic-indexing expression so each pull is a single device op --
        ``stacked[j]`` alone would first copy the whole chunk's row.
        """
        t0 = time.perf_counter() if debug else 0.0
        Fc = c1 - c0
        j = out.get("row")

        def sel(a, *sl):
            return a[(j, *sl)] if j is not None else a[sl]

        frame_bits = np.asarray(sel(out["frame_bits"], slice(0, Fc)))
        # padded frames emit past the real frames' total bits; truncate there
        total_bits = int(frame_bits.sum())
        used_words = (total_bits + 31) // 32
        # pull the used prefix in one bucketed slice (_pull_pages: quarter
        # steps above the power of two BELOW used_pages -> <= 25% overfetch,
        # O(log n) distinct compiled slice shapes)
        used_pages = (used_words + _PAGE_WORDS - 1) // _PAGE_WORDS
        n_pages = out["words"].shape[-1] // _PAGE_WORDS
        p2 = _pull_pages(used_pages, n_pages)
        t1 = time.perf_counter() if debug else 0.0
        words = np.asarray(sel(out["words"], slice(0, p2 * _PAGE_WORDS)))
        if debug:
            logger.debug(
                "drain f%d..%d: compute-sync %.3fs, pull %.1f MB %.3fs",
                c0, c1, t1 - t0, p2 * _PAGE_WORDS * 4 / 1e6,
                time.perf_counter() - t1,
            )
        n_bytes = (total_bits + 7) // 8
        buf = np.frombuffer(
            words.astype(">u4", copy=False).tobytes(), np.uint8
        )[:n_bytes].copy()
        fi = np.arange(c0, c1)
        hdr_bits = 32 + _utf8_nbytes(fi) * 8 + bs_tail_bits
        _patch_crcs(buf, frame_bits.astype(np.int64), hdr_bits.astype(np.int64))
        chunks.append(buf.tobytes())
        sizes.append((frame_bits >> 3).astype(np.int64))
        subs.append(np.asarray(
            sel(out["subframe_bits"], slice(0, Fc), slice(0, -1))
        ).astype(np.int64))

    # FRTPU_PIPELINE=duplex (default) stages the uploads on a worker thread
    # one chunk ahead, so upload(i+1) can overlap download(i-1); =alt
    # uploads each chunk on the main thread right before its dispatch.
    # Device-resident input has no uploads to stage: chunks are device
    # slices, and groups of full chunks go out as one scanned dispatch.
    duplex = (
        os.environ.get("FRTPU_PIPELINE", "duplex") == "duplex"
        and not dev_input
    )
    pending: tuple | None = None
    # bounds are full plan_chunk_frames chunks except possibly the last
    n_fullc = len(bounds)
    if bounds and bounds[-1][1] - bounds[-1][0] != plan_chunk_frames:
        n_fullc -= 1
    if dev_input and n_fullc >= 2:
        # Device-resident input: batch K full chunks per dispatch with ONE
        # scanned executable (_plan_emit_scan), paying the host dispatch
        # cost once per group.
        F = plan_chunk_frames
        n_words = worst_case_words(
            F, channels, blocksize, bits_per_sample + (1 if use_ms else 0)
        )
        n_words = ((n_words + _PAGE_WORDS - 1) // _PAGE_WORDS) * _PAGE_WORDS
        cap = max(1, int(os.environ.get("FRTPU_DISPATCH_CHUNKS", "8")))
        cap = max(1, min(cap, int(1.5e9) // (n_words * 4)))  # words memory cap
        i = 0
        while i < n_fullc:
            K = min(cap, n_fullc - i)
            grp = bounds[i : i + K]
            if K == 1:
                out = dispatch(*grp[0], rows[grp[0][0] * blocksize : grp[0][1] * blocksize])
                if pending is not None:
                    drain(*pending)
                pending = (grp[0][0], grp[0][1], out)
            else:
                r0, r1 = grp[0][0] * blocksize, grp[-1][1] * blocksize
                outs = _plan_emit_scan(
                    rows[r0:r1],
                    jnp.asarray([c0 for c0, _ in grp], jnp.int32),
                    K=K, F=F, N=blocksize, C=channels, n_words=n_words,
                    zero_point=zero_point, **static_kw,
                )
                for j, (c0, c1) in enumerate(grp):
                    o = dict(outs, row=j)  # stacked outputs + row index
                    if pending is not None:
                        drain(*pending)
                    pending = (c0, c1, o)
            i += K
        for c0, c1 in bounds[n_fullc:]:  # the partial tail chunk, if any
            out = dispatch(c0, c1, rows[c0 * blocksize : c1 * blocksize])
            if pending is not None:
                drain(*pending)
            pending = (c0, c1, out)
    elif duplex and len(bounds) > 1:
        import queue
        import threading

        up_q: queue.Queue = queue.Queue(maxsize=1)
        stop = threading.Event()

        def _producer() -> None:
            try:
                for c0_, c1_ in bounds:
                    x = jax.device_put(rows[c0_ * blocksize : c1_ * blocksize])
                    jax.block_until_ready(x)  # finish the transfer HERE
                    while not stop.is_set():
                        try:
                            up_q.put((c0_, c1_, x), timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as exc:  # noqa: BLE001 -- re-raised by main
                # retry until delivered or cancelled: a drain can outlast
                # any fixed timeout, and dropping the error would leave
                # main blocked on up_q.get() forever
                while not stop.is_set():
                    try:
                        up_q.put(exc, timeout=0.5)
                        return
                    except queue.Full:
                        continue

        threading.Thread(target=_producer, daemon=True, name="frtpu-up").start()
        try:
            for _ in bounds:
                item = up_q.get()
                if isinstance(item, BaseException):
                    raise item
                c0, c1, xr_dev = item
                out = dispatch(c0, c1, xr_dev)
                if pending is not None:
                    drain(*pending)
                pending = (c0, c1, out)
        finally:
            stop.set()
            try:
                up_q.get_nowait()
            except queue.Empty:
                pass
    else:
        for c0, c1 in bounds:
            t0 = time.perf_counter() if debug else 0.0
            if dev_input:
                xr_dev = rows[c0 * blocksize : c1 * blocksize]  # device slice
            else:
                # contiguous row slice uploads copy-free; finish the
                # transfer before the dispatch so the debug timing below
                # measures the upload alone
                xr_dev = jax.device_put(rows[c0 * blocksize : c1 * blocksize])
                jax.block_until_ready(xr_dev)
            if debug:
                logger.debug(
                    "upload f%d..%d: %.3fs", c0, c1, time.perf_counter() - t0
                )
            out = dispatch(c0, c1, xr_dev)
            if pending is not None:
                drain(*pending)
            pending = (c0, c1, out)
    if pending is not None:
        drain(*pending)

    if n_full * blocksize < n:
        # tiny pull for device input (< one block of rows); int64 math must
        # happen in numpy (jnp under default x64-off would silently narrow)
        tail = np.asarray(smp[n_full * blocksize :]).astype(np.int64) - zero_point
        chunks.append(
            _emit_tail_frame(tail, n_full, bits_per_sample, sr_code, bps_code, cfg)
        )
        sizes.append(np.array([len(chunks[-1])], np.int64))
        subs.append(np.zeros((1, channels - 1), np.int64))

    all_sizes = np.concatenate(sizes)
    all_subs = np.concatenate(subs) if channels > 1 else None
    md5 = (
        md5_of_samples(
            np.asarray(samples).astype(np.int64) - zero_point, bits_per_sample
        )
        if compute_md5
        else b"\x00" * 16
    )
    streaminfo = StreamInfo(
        min_blocksize=blocksize,
        max_blocksize=blocksize,
        min_framesize=int(all_sizes.min()),
        max_framesize=int(all_sizes.max()),
        sample_rate=sample_rate,
        channels=channels,
        bits_per_sample=bits_per_sample,
        total_samples=n,
        md5=md5,
    )
    header = build_flac_header(streaminfo, comments, vendor, padding,
                               frame_sizes=all_sizes, sub_bits=all_subs,
                               layout_flags=LAYOUT_FLAG_TOK32)
    return bytes(header) + b"".join(chunks)
