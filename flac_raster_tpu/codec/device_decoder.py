"""Device-resident FLAC decoding: compressed bytes up, PCM stays in HBM.

Host responsibilities are O(metadata) + one linear CRC pass: parse the
header, read the FRTP layout index (models/flac_format), verify frame
CRC-16s over the *compressed* bytes (native C), and compute per-frame
header bit lengths.  All per-sample work -- Rice chain, predictor restore,
stereo un-decorrelation -- runs batched on device (ops/device_decode).

Replaces the reference's libFLAC host decode role (``converter.py:181-182``)
for device-resident ML ingest: the decoded tensor is returned as a jax.Array
that never visits the host.  Streams without the layout index (foreign
files), with wasted bits / escape partitions / other structure our encoders
never emit, or wider than the device's int32 math fall back to the host
decoder (still returning a device array); the fallback logs a warning and
the result's ``engine`` field says ``"host-fallback"``.
"""

from __future__ import annotations

import functools
import logging
import os

import numpy as np

from ..models.flac_format import parse_flac_metadata, parse_layout_block
from ..ops.device_codec import MAX_DEVICE_BPS
from .decoder import DecodedStream, decode_flac, md5_of_samples

logger = logging.getLogger("flac_raster_tpu.device_decoder")

__all__ = ["decode_flac_device"]


def _utf8_len_bytes(fi: np.ndarray) -> np.ndarray:
    thr = np.array([0x80, 0x800, 0x10000, 0x200000, 0x4000000], np.int64)
    return np.sum(fi[:, None] >= thr[None, :], axis=1) + 1


def _bs_tail_bits(blocksize: int) -> int:
    from .fast_encoder import _blocksize_header

    return _blocksize_header(blocksize)[2]


_WROW = 32  # words per gathered row (128 bytes)


def _gather_windows_jit(maxW: int):
    """Jitted (B, maxW)-word window gather from the device-resident body.

    ``body_w`` is the whole compressed stream as big-endian uint32 words
    (length a multiple of ``_WROW``); ``row0`` is each frame's starting ROW
    index (byte_offset >> 7).  Fetching aligned 32-word ROWS (XLA gather
    with slice_sizes=(1,32)) instead of per-word elements cuts the gather's
    index count 32x -- the frame's sub-row byte offset moves into
    ``bit_base``.
    """
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=())
    def gather(body_w, row0):
        rows = body_w.reshape(-1, _WROW)
        iota = jnp.arange(maxW // _WROW, dtype=jnp.int32)
        idx = jnp.clip(row0[:, None] + iota[None, :], 0, rows.shape[0] - 1)
        return jnp.take(rows, idx, axis=0).reshape(-1, maxW)

    return gather


def _body_words_host(body: np.ndarray) -> np.ndarray:
    """Big-endian 32-bit words of the padded byte body, built ON HOST.

    One numpy byteswap pass on host uploads the same number of bytes as
    the raw body and keeps a (N/4, 4)-shaped intermediate -- a tiny minor
    dimension that device layouts may pad -- out of the graph.
    """
    return body.view(">u4").astype(np.uint32)


# one jitted gather per window width (module-level cache: re-calling
# decode_flac_device must not re-trace)
_GATHER_CACHE: dict[int, object] = {}


def _host_fallback(
    buf: bytes,
    verify_crc: bool,
    reason: str,
    sample_range: "tuple[int, int] | None" = None,
) -> DecodedStream:
    import jax.numpy as jnp

    logger.warning("device decode fell back to the host decoder (%s)", reason)
    if sample_range is not None:
        from .decoder import decode_flac_range

        dec = decode_flac_range(buf, *sample_range, verify_crc=verify_crc)
    else:
        dec = decode_flac(buf, verify_crc=verify_crc)
    dec.samples = jnp.asarray(dec.samples)
    dec.engine = "host-fallback"
    return dec


def decode_flac_device(
    data,
    verify_crc: bool = True,
    verify_md5: bool = False,
    chunk_frames: "int | None" = None,
    sample_range: "tuple[int, int] | None" = None,
) -> DecodedStream:
    """Decode a FLAC stream with the device pipeline.

    ``chunk_frames`` (frames per device dispatch) defaults to the
    platform's entry in backend.py; FRTPU_DECODE_CHUNK overrides it.

    Returns a DecodedStream whose ``samples`` is a **jax.Array** of shape
    (total_samples, channels) int32 resident on the default device and
    whose ``engine`` is ``"device"`` (``"host-fallback"`` when the stream
    had to take the host decoder).  Output values are bit-identical to
    codec/decoder.decode_flac (tested).

    ``sample_range=(start, count)`` decodes only the frames covering that
    window (random access via the FRTP layout index): only the covering
    byte span is uploaded and decoded, and ``samples`` holds exactly
    ``count`` rows.  Incompatible with ``verify_md5`` (the MD5 covers the
    whole stream).
    """
    if sample_range is not None and verify_md5:
        raise ValueError("verify_md5 requires a full decode")
    import jax.numpy as jnp

    if chunk_frames is None:
        env = os.environ.get("FRTPU_DECODE_CHUNK")
        if env is not None:
            chunk_frames = int(env)
        else:
            from ..backend import backend_config

            chunk_frames = backend_config().chunk_frames

    from ..ops.device_decode import decode_frames_device

    from ..models.flac_format import LAYOUT_FLAG_TOK32

    buf = bytes(data) if not isinstance(data, (bytes, bytearray)) else bytes(data)
    streaminfo, blocks, frame_start = parse_flac_metadata(buf)
    si = streaminfo
    layout = parse_layout_block(blocks)
    N = si.max_blocksize
    C, bps = si.channels, si.bits_per_sample

    eligible = (
        layout is not None
        and layout.version >= 2
        and (layout.flags & LAYOUT_FLAG_TOK32)
        and (C == 1 or layout.sub_bits is not None)
        and si.min_blocksize == si.max_blocksize
        and N >= 64
        and (N & (N - 1)) == 0
        and 1 <= C <= 8
        # narrow lane: bps (+1 for a 2-channel side subframe) within the
        # int32 planner width; wide lane: exactly 32 (never mid-side -- a
        # 33-bit side channel would break TOK32; foreign mid-side frames
        # trip the in-graph err flag and fall back to the host decoder)
        and (bps + (1 if C == 2 else 0) <= MAX_DEVICE_BPS + 1 or bps == 32)
        and si.total_samples > 0
    )
    if not eligible:
        return _host_fallback(
            buf, verify_crc, "no v2 layout index / unsupported shape",
            sample_range,
        )

    total = si.total_samples
    full_frames = total // N
    tail_samples = total - full_frames * N
    if len(layout.sizes) != full_frames + (1 if tail_samples else 0):
        return _host_fallback(
            buf, verify_crc, "layout/frame-count mismatch", sample_range
        )

    if sample_range is not None:
        s0, cnt = sample_range
        if s0 < 0 or cnt < 0 or s0 + cnt > total:
            raise ValueError("sample range outside the stream")
        rf0 = min(s0 // N, max(len(layout.sizes) - 1, 0))
        rf1 = min(-(-(s0 + cnt) // N), len(layout.sizes)) if cnt else rf0
    else:
        s0, cnt = 0, total
        rf0, rf1 = 0, len(layout.sizes)
    rf1_full = min(rf1, full_frames)
    range_tail = rf1 > full_frames and tail_samples

    arr = np.frombuffer(buf, np.uint8)
    sizes = np.asarray(layout.sizes, np.int64)
    offsets = layout.absolute_offsets(frame_start)
    if offsets[-1] != len(buf):
        return _host_fallback(
            buf, verify_crc, "layout/body-size mismatch", sample_range
        )

    if verify_crc:
        from .. import native

        if native.available():
            o_r, s_r = offsets[rf0:rf1], sizes[rf0:rf1]
            calc = native.crc16_spans(arr, o_r, s_r - 2)
            stored = (
                arr[o_r + s_r - 2].astype(np.uint16) << 8
            ) | arr[o_r + s_r - 1]
            bad = np.nonzero(calc != stored)[0]
            if bad.size:
                raise ValueError(
                    f"frame CRC-16 mismatch at byte {int(o_r[bad[0]])}"
                )

    vendor, comments = "", {}
    from ..models.flac_format import BLOCK_VORBIS_COMMENT, parse_vorbis_comments

    for b in blocks:
        if b.block_type == BLOCK_VORBIS_COMMENT:
            vendor, comments = parse_vorbis_comments(b.data)

    if sample_range is not None and cnt == 0:
        return DecodedStream(
            jnp.zeros((0, C), jnp.int32), si, comments, vendor, engine="device"
        )

    # header bits incl. CRC-8 (fixed-blocksize: frame number = index),
    # computed only for the frame range in play (O(window), not O(file))
    fi = np.arange(rf0, rf1_full, dtype=np.int64)
    hdr_bits_r = (32 + _utf8_len_bytes(fi) * 8 + _bs_tail_bits(N) + 8).astype(
        np.int32
    )

    if rf1_full > rf0:
        max_size = int(sizes[rf0:rf1_full].max())
    else:
        max_size = 16
    # window words: up to a row of leading slack (frames start mid-row) +
    # frame bytes + the Rice scan's window lookahead
    from ..ops.device_decode import _WIN_SLACK_WORDS

    maxW = _WROW + (max_size + 3) // 4 + _WIN_SLACK_WORDS

    # pad the body upload to a {1, 1.5} x power-of-two bucket (bounds
    # compile count at O(log) shapes while capping upload overfetch at
    # ~33%); zero slack so window reads past the last frame land on zeros,
    # not clip-duplicated stream bytes
    align_bytes = 4 * _WROW
    byte_lo = int(offsets[rf0]) & ~(align_bytes - 1)  # aligned re-base
    byte_hi = int(offsets[rf1])
    arr_eff = arr[byte_lo:byte_hi]
    need = len(arr_eff) + 4 * _WIN_SLACK_WORDS
    body_len = 1 << max(8, (need - 1).bit_length())
    if need <= (body_len * 3) // 4:
        body_len = (body_len * 3) // 4  # stays a multiple of 4*_WROW (>= 192)
    body = np.zeros(body_len, np.uint8)
    body[: len(arr_eff)] = arr_eff
    body_w = jnp.asarray(_body_words_host(body))
    # bucket the window width so compiled shapes stay O(log) across files
    # (power-of-two >= _WROW keeps it row-divisible)
    maxW = 1 << max(5, (maxW - 1).bit_length())
    gather_windows = _GATHER_CACHE.setdefault(maxW, _gather_windows_jit(maxW))

    # per-frame subframe start offsets (relative to the frame start): col 0
    # is the header, later columns add the layout block's subframe lengths;
    # rows cover only frames [rf0, rf1_full)
    n_r = rf1_full - rf0
    sf_rel = np.zeros((n_r, C), np.int64)
    sf_rel[:, 0] = hdr_bits_r[:n_r]
    if C > 1:
        sf_rel[:, 1:] = sf_rel[:, :1] + np.cumsum(
            layout.sub_bits[rf0:rf1_full], axis=1
        )

    # dispatch every chunk before syncing anything: the device queue
    # pipelines gather + decode across chunks; the error flags are pulled
    # once at the end (a per-chunk sync would serialize the pipeline)
    parts = []
    errs = []
    for f0 in range(rf0, rf1_full, chunk_frames):
        f1 = min(f0 + chunk_frames, rf1_full)
        B = f1 - f0
        Bp = 1 << max(0, (B - 1)).bit_length()
        offs = np.zeros(Bp, np.int64)
        offs[:B] = offsets[f0:f1] - byte_lo
        bit_base = ((offs & (align_bytes - 1)) * 8).astype(np.int32)
        sf = np.zeros((Bp, C), np.int32)
        sf[:B] = sf_rel[f0 - rf0 : f1 - rf0]
        sf[B:] = sf_rel[f0 - rf0]
        sf += bit_base[:, None]
        windows = gather_windows(
            body_w, jnp.asarray((offs >> (2 + 5)).astype(np.int32))
        )
        # window-local frame end for the last-subframe boundary check
        # (padded rows carry garbage and are sliced off with err[:B])
        fe = np.zeros(Bp, np.int32)
        fe[:B] = bit_base[:B] + (sizes[f0:f1] * 8).astype(np.int32)
        fe[B:] = fe[0]
        samples, err = decode_frames_device(
            windows, jnp.asarray(bit_base), jnp.asarray(sf), jnp.asarray(fe),
            C=C, bps=bps, N=N,
        )
        errs.append(err[:B])
        parts.append(samples[:B].reshape(B * N, C))
    if errs and any(bool(np.asarray(e).any()) for e in errs):
        return _host_fallback(
            buf, verify_crc, "in-graph structure flag", sample_range
        )

    if range_tail:
        # the tail frame is a partial block: decode it on host (tiny) by
        # wrapping its bytes in a minimal stream
        from ..models.flac_format import StreamInfo, build_flac_header

        tail_si = StreamInfo(
            min_blocksize=si.min_blocksize,
            max_blocksize=si.max_blocksize,
            min_framesize=0,
            max_framesize=0,
            sample_rate=si.sample_rate,
            channels=C,
            bits_per_sample=bps,
            total_samples=tail_samples,
        )
        mini = build_flac_header(tail_si) + buf[offsets[full_frames] :]
        tail_dec = decode_flac(mini, verify_crc=verify_crc)
        parts.append(jnp.asarray(tail_dec.samples))

    samples_dev = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
    if sample_range is not None:
        lo = s0 - rf0 * N
        samples_dev = samples_dev[lo : lo + cnt]
    result = DecodedStream(samples_dev, si, comments, vendor, engine="device")
    if verify_md5 and si.md5 != b"\x00" * 16:
        if md5_of_samples(np.asarray(samples_dev), bps) != si.md5:
            raise ValueError("decoded audio MD5 mismatch")
    return result
