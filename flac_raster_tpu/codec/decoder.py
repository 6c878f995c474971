"""FLAC stream decoder (host orchestration, vectorized numpy internals).

Replaces the reference's pyflac ``FileDecoder`` (libFLAC + libsndfile,
SURVEY.md §2.2).  Two deliberate contract changes vs the reference:

  * Decodes straight to **integer** samples -- no float64 WAV detour, which is
    what makes exact inverse normalization possible (fixes SURVEY.md Q1).
  * Supports every FLAC feature libFLAC emits (fixed + LPC subframes, all four
    channel assignments, wasted bits, 4/5-bit Rice, escape partitions,
    variable blocksize), so files produced by the reference toolchain decode
    bit-perfectly (validated against STREAMINFO MD5 in tests).

Structure: a sequential parse pass walks frame/subframe headers (tiny), Rice
partitions are decoded by the vectorized binary-lifting path (ops/rice.py),
and LPC restore is deferred and batched across all subframes of the stream
(ops/lpc.py) so the only per-sample Python loop is vectorized over subframes.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from ..models.flac_format import (
    BLOCK_VORBIS_COMMENT,
    StreamInfo,
    build_flac_header,
    parse_flac_metadata,
    parse_layout_block,
    parse_vorbis_comments,
)
from ..ops.bitpack import BitReader, bits_of
from ..ops.crc import crc8, crc16
from ..ops.fixed import fixed_restore
from ..ops.lpc import lpc_restore_batch
from ..ops.rice import decode_rice_vectorized

__all__ = [
    "decode_flac",
    "decode_flac_range",
    "DecodedStream",
    "md5_of_samples",
]

_BLOCKSIZE_TABLE = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768,
}
_SAMPLE_RATE_TABLE = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
_BPS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

# channel assignment codes
_CH_LEFT_SIDE = 8
_CH_RIGHT_SIDE = 9
_CH_MID_SIDE = 10


@dataclass
class DecodedStream:
    samples: np.ndarray  # (total_samples, channels) int32
    streaminfo: StreamInfo
    comments: dict[str, list[str]]
    vendor: str = ""
    # which decoder produced ``samples``: "host" (this module), "device"
    # (codec/device_decoder), "device-mesh" (parallel/decode_mesh) or
    # "host-fallback" (a device call that had to take the host decoder)
    engine: str = "host"

    @property
    def sample_rate(self) -> int:
        return self.streaminfo.sample_rate


@dataclass
class _Subframe:
    kind: str  # constant | verbatim | fixed | lpc
    order: int
    wasted: int
    warmup: np.ndarray | None
    residual: np.ndarray | None
    qcoeffs: np.ndarray | None
    shift: int
    n: int
    value: int = 0  # for constant
    verbatim: np.ndarray | None = None


def _read_coded_number(br: BitReader) -> int:
    """UTF-8-style frame/sample number (up to 36 bits)."""
    first = br.read_uint(8)
    if first < 0x80:
        return first
    n_ones = 0
    probe = first
    while probe & 0x80:
        n_ones += 1
        probe = (probe << 1) & 0xFF
    if n_ones < 2 or n_ones > 7:
        raise ValueError(f"invalid coded number lead byte {first:#x}")
    val = first & (0x7F >> n_ones)
    for _ in range(n_ones - 1):
        b = br.read_uint(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("invalid coded number continuation byte")
        val = (val << 6) | (b & 0x3F)
    return val


class _LazyBits:
    """Unpacked bit array computed on first use (the native decode path
    never needs it; the numpy fallback and verbatim reads do)."""

    def __init__(self, arr: np.ndarray):
        self._arr = arr
        self._bits: np.ndarray | None = None

    def get(self) -> np.ndarray:
        if self._bits is None:
            self._bits = bits_of(self._arr)
        return self._bits


class _LazyOnes:
    def __init__(self, arr: np.ndarray):
        self._arr = arr
        self._ones: np.ndarray | None = None

    def get(self, bits: "_LazyBits") -> np.ndarray:
        if self._ones is None:
            self._ones = np.flatnonzero(bits.get()).astype(np.int64)
        return self._ones


def _parse_subframe(
    br: BitReader,
    bits: np.ndarray,
    ones: np.ndarray,
    n: int,
    bps: int,
) -> _Subframe:
    if br.read_uint(1):
        raise ValueError("subframe padding bit set")
    sf_type = br.read_uint(6)
    wasted = 0
    if br.read_uint(1):
        wasted = br.read_unary() + 1
    ebps = bps - wasted

    if sf_type == 0:
        return _Subframe("constant", 0, wasted, None, None, None, 0, n,
                         value=br.read_sint(ebps))
    if sf_type == 1:
        from ..ops.bitpack import read_kbits_at

        pos = br.bit_pos + np.arange(n, dtype=np.int64) * ebps
        vals = read_kbits_at(bits.get(), pos, ebps)
        sign = np.int64(1) << (ebps - 1)
        vals = (vals ^ sign) - sign
        br.seek_bits(br.bit_pos + n * ebps)
        return _Subframe("verbatim", 0, wasted, None, None, None, 0, n, verbatim=vals)
    if 8 <= sf_type <= 12:
        order = sf_type - 8
        warmup = np.array([br.read_sint(ebps) for _ in range(order)], dtype=np.int64)
        residual = _parse_residual(br, bits, ones, n, order)
        return _Subframe("fixed", order, wasted, warmup, residual, None, 0, n)
    if sf_type >= 32:
        order = sf_type - 31
        warmup = np.array([br.read_sint(ebps) for _ in range(order)], dtype=np.int64)
        precision = br.read_uint(4) + 1
        if precision == 16:
            raise ValueError("invalid qlp precision escape")
        shift = br.read_sint(5)
        qcoeffs = np.array([br.read_sint(precision) for _ in range(order)], dtype=np.int64)
        residual = _parse_residual(br, bits, ones, n, order)
        return _Subframe("lpc", order, wasted, warmup, residual, qcoeffs, shift, n)
    raise ValueError(f"reserved subframe type {sf_type:#08b}")


def _parse_residual(
    br: BitReader, bits: np.ndarray, ones: np.ndarray, blocksize: int, order: int
) -> np.ndarray:
    from .. import native

    if native.available():
        # native sequential hot loop (plays libFLAC's role, SURVEY.md §2.2);
        # the vectorized numpy path below is the no-toolchain fallback and
        # stays the reference implementation for tests
        res, end = native.decode_residual(br._bytes, br.bit_pos, blocksize, order)
        br.seek_bits(end)
        return res
    method = br.read_uint(2)
    if method > 1:
        raise ValueError(f"reserved residual coding method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    part_order = br.read_uint(4)
    n_parts = 1 << part_order
    base = blocksize >> part_order
    if base << part_order != blocksize or base <= order:
        raise ValueError("invalid partition order")
    chunks = []
    for p in range(n_parts):
        count = base - order if p == 0 else base
        k = br.read_uint(param_bits)
        if k == escape:
            raw = br.read_uint(5)
            if raw == 0:
                chunks.append(np.zeros(count, dtype=np.int64))
            else:
                from ..ops.bitpack import read_kbits_at

                pos = br.bit_pos + np.arange(count, dtype=np.int64) * raw
                vals = read_kbits_at(bits.get(), pos, raw)
                sign = np.int64(1) << (raw - 1)
                vals = (vals ^ sign) - sign
                chunks.append(vals)
                br.seek_bits(br.bit_pos + count * raw)
        else:
            vals, end_bit = decode_rice_vectorized(bits.get(), br.bit_pos, count, k, ones.get(bits))
            chunks.append(vals)
            br.seek_bits(end_bit)
    return np.concatenate(chunks) if len(chunks) > 1 else chunks[0]


def decode_flac(
    data: bytes | np.ndarray,
    verify_crc: bool = True,
    verify_md5: bool = False,
) -> DecodedStream:
    """Decode a complete FLAC stream from memory.

    Returns int32 samples shaped (total_samples, channels) with the original
    bit depth preserved (no float scaling -- cf. reference ``converter.py:182``
    which receives float64 from libsndfile).

    Note on validation: the native fast path verifies every frame's CRC-16
    (which covers the header bytes) but skips the per-frame header CRC-8
    check and some header sanity diagnostics the Python walk performs, so
    error *messages* for corrupt input can differ between the two paths.
    For precise diagnostics decode with the Python fallback
    (``native`` unavailable); both paths reject corrupt frames.
    """
    buf = bytes(data) if not isinstance(data, (bytes, bytearray)) else bytes(data)
    streaminfo, blocks, frame_start = parse_flac_metadata(buf)
    vendor, comments = "", {}
    for b in blocks:
        if b.block_type == BLOCK_VORBIS_COMMENT:
            vendor, comments = parse_vorbis_comments(b.data)

    arr = np.frombuffer(buf, dtype=np.uint8)

    # Fast path: one native C pass over all frames (subframe parse, Rice
    # decode, predictor restore, stereo un-decorrelation).  CRC-16 of every
    # frame is verified from the returned spans; the Python walk below is
    # the fallback and precise-diagnostics path.
    from .. import native

    if native.available() and streaminfo.total_samples and streaminfo.channels:
        got = native.decode_frames(
            arr, frame_start, streaminfo.total_samples,
            streaminfo.channels, streaminfo.bits_per_sample,
        )
        if got is not None:
            out, fstarts, fsizes = got
            if verify_crc and len(fstarts):
                calc = native.crc16_spans(arr, fstarts, fsizes - 2)
                stored = (
                    arr[fstarts + fsizes - 2].astype(np.uint16) << 8
                ) | arr[fstarts + fsizes - 1]
                bad = np.nonzero(calc != stored)[0]
                if bad.size:
                    raise ValueError(
                        f"frame CRC-16 mismatch at byte {int(fstarts[bad[0]])}"
                    )
            result = DecodedStream(out, streaminfo, comments, vendor)
            if verify_md5 and streaminfo.md5 != b"\x00" * 16:
                if md5_of_samples(out, streaminfo.bits_per_sample) != streaminfo.md5:
                    raise ValueError("decoded audio MD5 mismatch")
            return result

    bits, ones = _LazyBits(arr), _LazyOnes(arr)

    br = BitReader(arr, frame_start * 8)
    frames: list[tuple[int, list[_Subframe], int]] = []  # (blocksize, subframes, chan_code)
    total = 0
    expected = streaminfo.total_samples

    while (expected and total < expected) or (
        not expected and br.remaining_bits() >= 16
    ):
        hdr_start_byte = br.bit_pos >> 3
        sync = br.read_uint(14)
        if sync != 0x3FFE:
            raise ValueError(f"lost frame sync at byte {hdr_start_byte}")
        if br.read_uint(1):
            raise ValueError("frame header reserved bit set")
        variable_blocksize = br.read_uint(1)
        bs_code = br.read_uint(4)
        sr_code = br.read_uint(4)
        chan_code = br.read_uint(4)
        size_code = br.read_uint(3)
        if br.read_uint(1):
            raise ValueError("frame header reserved bit 2 set")
        _num = _read_coded_number(br)
        if bs_code == 0:
            raise ValueError("reserved blocksize code 0")
        elif bs_code == 6:
            blocksize = br.read_uint(8) + 1
        elif bs_code == 7:
            blocksize = br.read_uint(16) + 1
        else:
            blocksize = _BLOCKSIZE_TABLE[bs_code]
        if sr_code == 12:
            br.read_uint(8)
        elif sr_code in (13, 14):
            br.read_uint(16)
        elif sr_code == 15:
            raise ValueError("invalid sample rate code")
        hdr_end_byte = br.bit_pos >> 3
        crc_expect = br.read_uint(8)
        if verify_crc:
            got = crc8(arr[hdr_start_byte:hdr_end_byte])
            if got != crc_expect:
                raise ValueError(
                    f"frame header CRC-8 mismatch at byte {hdr_start_byte}"
                )

        if chan_code > 10:
            raise ValueError(f"reserved channel assignment {chan_code}")
        if chan_code <= 7:
            n_ch = chan_code + 1
            ch_bps = [streaminfo.bits_per_sample] * n_ch
        else:
            n_ch = 2
            side_idx = 1 if chan_code in (_CH_LEFT_SIDE, _CH_MID_SIDE) else 0
            ch_bps = [streaminfo.bits_per_sample] * 2
            ch_bps[side_idx] += 1
        if streaminfo.channels and n_ch != streaminfo.channels:
            raise ValueError(
                f"frame channel count {n_ch} != STREAMINFO {streaminfo.channels}"
            )
        if size_code:
            base_bps = _BPS_TABLE.get(size_code)
            if base_bps is None:
                raise ValueError(f"reserved sample size code {size_code}")
            if chan_code <= 7:
                ch_bps = [base_bps] * n_ch
            else:
                ch_bps = [base_bps] * 2
                ch_bps[1 if chan_code in (_CH_LEFT_SIDE, _CH_MID_SIDE) else 0] += 1

        subframes = [
            _parse_subframe(br, bits, ones, blocksize, ch_bps[c]) for c in range(n_ch)
        ]
        br.align_to_byte()
        frame_end_byte = br.bit_pos >> 3
        crc16_expect = br.read_uint(16)
        if verify_crc:
            from .. import native

            if native.available():
                got16 = int(
                    native.crc16_spans(
                        arr,
                        np.array([hdr_start_byte]),
                        np.array([frame_end_byte - hdr_start_byte]),
                    )[0]
                )
            else:
                got16 = crc16(arr[hdr_start_byte:frame_end_byte])
            if got16 != crc16_expect:
                raise ValueError(f"frame CRC-16 mismatch at byte {hdr_start_byte}")
        frames.append((blocksize, subframes, chan_code))
        total += blocksize
        if not variable_blocksize and expected and total > expected:
            raise ValueError("decoded more samples than STREAMINFO declares")

    channels = streaminfo.channels
    out = np.empty((total, channels), dtype=np.int32)
    _restore_all(frames, out)

    result = DecodedStream(out, streaminfo, comments, vendor)
    if verify_md5 and streaminfo.md5 != b"\x00" * 16:
        got = md5_of_samples(out, streaminfo.bits_per_sample)
        if got != streaminfo.md5:
            raise ValueError("decoded audio MD5 mismatch")
    return result


def decode_flac_range(
    data: bytes | np.ndarray,
    start_sample: int,
    num_samples: int | None = None,
    verify_crc: bool = True,
) -> DecodedStream:
    """Decode only the frames covering ``[start_sample, start_sample+num)``.

    Random access without walking the stream: the FRTP layout block (the
    decode index our encoders embed, ``models/flac_format``) maps the
    requested sample window to a frame byte span, and only that span is
    parsed -- O(window) work + O(metadata), not O(file).  The reference
    has no equivalent for plain FLAC files (its range access exists only
    in the tiled spatial/streaming containers, ``spatial_encoder.py``).

    Falls back to a full decode + slice for foreign streams without the
    index.  Returns a DecodedStream whose ``samples`` holds exactly the
    requested rows; ``streaminfo``/``comments`` are the ORIGINAL stream's.
    """
    buf = bytes(data) if not isinstance(data, (bytes, bytearray)) else bytes(data)
    si, blocks, frame_start = parse_flac_metadata(buf)
    total = si.total_samples
    if start_sample < 0 or (num_samples is not None and num_samples < 0):
        raise ValueError("sample range outside the stream")
    if total == 0:
        # STREAMINFO leaves the length unknown (reference libFLAC streaming
        # files do this): nothing to index against, decode fully and slice
        dec = decode_flac(buf, verify_crc=verify_crc)
        end = None if num_samples is None else start_sample + num_samples
        dec.samples = dec.samples[start_sample:end]
        return dec
    if num_samples is None:
        num_samples = max(total - start_sample, 0)
    if start_sample + num_samples > total:
        raise ValueError("sample range outside the stream")
    vendor, comments = "", {}
    for b in blocks:
        if b.block_type == BLOCK_VORBIS_COMMENT:
            vendor, comments = parse_vorbis_comments(b.data)

    if num_samples == 0:
        return DecodedStream(
            np.empty((0, si.channels), np.int32), si, comments, vendor
        )

    layout = parse_layout_block(blocks)
    N = si.max_blocksize
    if layout is None or si.min_blocksize != N or N == 0:
        dec = decode_flac(buf, verify_crc=verify_crc)
        dec.samples = dec.samples[start_sample : start_sample + num_samples]
        return dec

    offsets = layout.absolute_offsets(frame_start)
    if offsets[-1] != len(buf):
        dec = decode_flac(buf, verify_crc=verify_crc)
        dec.samples = dec.samples[start_sample : start_sample + num_samples]
        return dec
    n_frames = len(layout.sizes)
    f0 = min(start_sample // N, n_frames - 1)
    f1 = min(-(-(start_sample + num_samples) // N), n_frames)
    span_samples = min(total, f1 * N) - f0 * N

    # wrap the frame span in a minimal stream so the normal (native-
    # accelerated) decode path handles it; frame numbers are informational
    # in fixed-blocksize streams and are not re-validated
    mini_si = StreamInfo(
        min_blocksize=si.min_blocksize,
        max_blocksize=N,
        min_framesize=0,
        max_framesize=0,
        sample_rate=si.sample_rate,
        channels=si.channels,
        bits_per_sample=si.bits_per_sample,
        total_samples=span_samples,
    )
    mini = build_flac_header(mini_si) + buf[offsets[f0] : offsets[f1]]
    dec = decode_flac(mini, verify_crc=verify_crc)
    lo = start_sample - f0 * N
    return DecodedStream(
        dec.samples[lo : lo + num_samples], si, comments, vendor
    )


def _restore_all(frames, out: np.ndarray) -> None:
    """Restore every subframe; LPC subframes are batched across the stream."""
    # First pass: everything except LPC; collect LPC jobs.
    lpc_jobs: list[tuple[int, int, _Subframe]] = []  # (frame_idx, ch, sf)
    signals: dict[tuple[int, int], np.ndarray] = {}
    for fi, (blocksize, subframes, chan_code) in enumerate(frames):
        for ci, sf in enumerate(subframes):
            if sf.kind == "constant":
                sig = np.full(sf.n, sf.value, dtype=np.int64)
            elif sf.kind == "verbatim":
                sig = sf.verbatim
            elif sf.kind == "fixed":
                sig = fixed_restore(sf.warmup, sf.residual, sf.order)
            else:
                lpc_jobs.append((fi, ci, sf))
                continue
            if sf.wasted:
                sig = sig << np.int64(sf.wasted)
            signals[(fi, ci)] = sig

    if lpc_jobs:
        # Group by order so each batch has rectangular coeff/warmup arrays.
        by_order: dict[int, list[tuple[int, int, _Subframe]]] = {}
        for job in lpc_jobs:
            by_order.setdefault(job[2].order, []).append(job)
        for order, jobs in by_order.items():
            max_len = max(j[2].n for j in jobs)
            b = len(jobs)
            warm = np.zeros((b, order), dtype=np.int64)
            res = np.zeros((b, max_len - order), dtype=np.int64)
            co = np.zeros((b, order), dtype=np.int64)
            sh = np.zeros(b, dtype=np.int64)
            lens = np.zeros(b, dtype=np.int64)
            for i, (fi, ci, sf) in enumerate(jobs):
                warm[i] = sf.warmup
                res[i, : sf.n - order] = sf.residual
                co[i] = sf.qcoeffs
                sh[i] = sf.shift
                lens[i] = sf.n
            from .. import native

            if native.available():
                sigs = native.lpc_restore(warm, res, co, sh)
            else:
                sigs = lpc_restore_batch(warm, res, co, sh, lens)
            for i, (fi, ci, sf) in enumerate(jobs):
                sig = sigs[i, : sf.n]
                if sf.wasted:
                    sig = sig << np.int64(sf.wasted)
                signals[(fi, ci)] = sig

    # Stereo un-decorrelation + write out.
    pos = 0
    for fi, (blocksize, subframes, chan_code) in enumerate(frames):
        chans = [signals[(fi, ci)] for ci in range(len(subframes))]
        if chan_code <= 7:
            pcm = chans
        elif chan_code == _CH_LEFT_SIDE:
            left, side = chans
            pcm = [left, left - side]
        elif chan_code == _CH_RIGHT_SIDE:
            side, right = chans
            pcm = [right + side, right]
        elif chan_code == _CH_MID_SIDE:
            mid, side = chans
            mid2 = (mid << np.int64(1)) | (side & np.int64(1))
            pcm = [(mid2 + side) >> np.int64(1), (mid2 - side) >> np.int64(1)]
        else:
            raise ValueError(f"reserved channel assignment {chan_code}")
        for ci, sig in enumerate(pcm):
            out[pos : pos + blocksize, ci] = sig
        pos += blocksize


def md5_of_samples(samples: np.ndarray, bits_per_sample: int) -> bytes:
    """MD5 of the interleaved little-endian PCM, as libFLAC computes it for
    STREAMINFO.  Sample width is the byte-padded bit depth."""
    s = np.ascontiguousarray(samples)
    if bits_per_sample <= 8:
        raw = s.astype("<i1").tobytes()
    elif bits_per_sample <= 16:
        raw = s.astype("<i2").tobytes()
    elif bits_per_sample <= 24:
        le32 = s.astype("<i4")
        b = le32.view(np.uint8).reshape(-1, 4)[:, :3]
        raw = np.ascontiguousarray(b).tobytes()
    else:
        raw = s.astype("<i4").tobytes()
    return hashlib.md5(raw).digest()
