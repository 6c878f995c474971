"""FLAC stream encoder (host reference implementation).

Replaces pyflac/libFLAC's ``StreamEncoder`` (reference ``converter.py:139-154``,
``spatial_encoder.py:291-304``).  Compression-level presets mirror libFLAC's
*behavioral* contract at level 5 -- fixed(0-4)+LPC(<=8) predictor search,
tukey(0.5) apodization, Rice partition orders up to 6, blocksize 4096
(``docs/sonos-pyflac.txt:6910-6937`` describes the presets; nothing here is a
translation of libFLAC code).

Unlike libFLAC's sequential bitwriter, emission is a token stream: every
field becomes a (value, bit-length) token, the whole stream is packed in one
vectorized scatter (ops/bitpack.py), and frame CRCs are patched in one
batched pass (ops/crc.py).  This is the same emission model the device
path uses, so host and device share all format logic.

Contract fixes vs the reference (SURVEY.md §2.3):
  * true bits-per-sample is written (the reference's "24-bit" files are
    actually 32 bps due to a pyflac override -- Q2);
  * STREAMINFO carries real total_samples / min-max frame sizes / MD5
    (pyflac's streaming path left them zero).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.flac_format import (
    LAYOUT_FLAG_TOK32,
    StreamInfo,
    build_flac_header,
)
from ..ops import lpc as lpc_ops
from ..ops.bitpack import pack_tokens
from ..ops.crc import crc8_rows, crc16_rows
from ..ops.fixed import fixed_residual
from ..ops.device_codec import MAX_RICE_TOKEN_BITS
from ..ops.rice import MAX_RICE_PARAM_4, MAX_RICE_PARAM_5, zigzag
from .decoder import md5_of_samples

__all__ = ["encode_flac", "EncoderConfig"]

_BLOCKSIZE_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5,
                    256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12,
                    8192: 13, 16384: 14, 32768: 15}
_SAMPLE_RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
                      22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
                      96000: 11}
_BPS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


@dataclass
class EncoderConfig:
    """Per-level search knobs (our own preset table, level-5 centered).

    ``mid_side`` mirrors libFLAC's ``-m``/``-M`` columns (full mid-side
    search at levels 1-2 and 4-8, reference preset table
    ``docs/sonos-pyflac.txt:6910-6937``); we run the full 4-assignment
    search wherever libFLAC enables either mode.
    """

    max_lpc_order: int
    max_partition_order: int
    use_lpc: bool
    mid_side: bool = False
    apodizations: tuple = ("tukey(0.5)",)

    @classmethod
    def from_level(cls, level: int) -> "EncoderConfig":
        level = max(0, min(8, level))
        ms = level in (1, 2) or level >= 4
        if level <= 2:
            return cls(max_lpc_order=0, max_partition_order=3 + level,
                       use_lpc=False, mid_side=ms)
        order = {3: 6, 4: 8, 5: 8, 6: 8, 7: 12, 8: 12}[level]
        # levels 7-8 search extra apodization windows (libFLAC's -A column
        # adds windows at 8; we use cheap tukey/welch variants)
        apod = ("tukey(0.5)",)
        if level == 7:
            apod = ("tukey(0.5)", "tukey(0.25)")
        elif level == 8:
            apod = ("tukey(0.5)", "tukey(0.25)", "welch")
        return cls(max_lpc_order=order, max_partition_order=6, use_lpc=True,
                   mid_side=ms, apodizations=apod)


class _TokenSink:
    """Accumulates (value, length) tokens as numpy chunks; packed once."""

    def __init__(self):
        self.values: list[np.ndarray] = []
        self.lengths: list[np.ndarray] = []
        self._bits = 0

    def put(self, value: int, length: int) -> None:
        self.values.append(np.array([value], dtype=np.uint64))
        self.lengths.append(np.array([length], dtype=np.int64))
        self._bits += length

    def put_array(self, values: np.ndarray, lengths: np.ndarray) -> None:
        self.values.append(values.astype(np.uint64, copy=False))
        self.lengths.append(lengths.astype(np.int64, copy=False))
        self._bits += int(lengths.sum())

    def put_signed_array(self, vals: np.ndarray, nbits: int) -> None:
        u = vals.astype(np.int64) & ((1 << nbits) - 1) if nbits < 64 else vals.astype(np.int64)
        self.put_array(u.astype(np.uint64), np.full(vals.shape, nbits, dtype=np.int64))

    @property
    def bit_pos(self) -> int:
        return self._bits

    def pack(self) -> bytes:
        values = np.concatenate(self.values) if self.values else np.zeros(0, np.uint64)
        lengths = np.concatenate(self.lengths) if self.lengths else np.zeros(0, np.int64)
        return pack_tokens(values, lengths)


def _utf8_coded_number(num: int) -> list[tuple[int, int]]:
    """FLAC's UTF-8-style frame-number encoding as (value, nbits) tokens."""
    if num < 0x80:
        return [(num, 8)]
    for n_bytes, bits in ((2, 11), (3, 16), (4, 21), (5, 26), (6, 31), (7, 36)):
        if num < (1 << bits):
            toks = [((0xFF << (8 - n_bytes)) & 0xFF | (num >> (6 * (n_bytes - 1))), 8)]
            for i in range(n_bytes - 2, -1, -1):
                toks.append((0x80 | ((num >> (6 * i)) & 0x3F), 8))
            return toks
    raise ValueError("frame number too large")


def _partition_plan(
    z: np.ndarray, order: int, blocksize: int, max_po: int
) -> tuple[int, int, np.ndarray, int]:
    """Choose (method, partition_order, ks per partition, payload_bits).

    Cost of Rice(k) on a partition = n*(k+1) + sum(z >> k), computed for all k
    at the finest partition level and merged upward (children's per-k costs
    add), so the whole search is a handful of vectorized reductions.
    """
    n = z.size
    # deepest partition order: blocksize divisible, first partition non-empty
    max_po_eff = 0
    while (
        max_po_eff < max_po
        and blocksize % (1 << (max_po_eff + 1)) == 0
        and (blocksize >> (max_po_eff + 1)) > order
    ):
        max_po_eff += 1

    need_big_k = bool(z.size) and int(z.max()) >> MAX_RICE_PARAM_4 > 0
    kmax = MAX_RICE_PARAM_5 if need_big_k else MAX_RICE_PARAM_4

    # per-k shifted sums at the finest level
    parts = 1 << max_po_eff
    base = blocksize >> max_po_eff
    # split z into finest partitions (partition 0 is short by `order`)
    bounds = np.arange(parts + 1, dtype=np.int64) * base - order
    bounds[0] = 0
    counts = np.diff(bounds)
    ks = np.arange(kmax + 1, dtype=np.uint64)
    # sums[p, k] = sum over partition p of (z >> k)
    shifted = z[None, :] >> ks[:, None]  # (k, n)
    csum = np.zeros((kmax + 1, n + 1), dtype=np.int64)
    np.cumsum(shifted, axis=1, out=csum[:, 1:])
    sums = csum[:, bounds[1:]] - csum[:, bounds[:-1]]  # (k, parts)

    best_total = None
    best = None
    cost = sums + (counts[None, :] * (ks[:, None].astype(np.int64) + 1))  # (k, parts)
    po = max_po_eff
    while True:
        pbits = 5 if need_big_k else 4
        per_part_best_k = np.argmin(cost, axis=0)
        per_part_bits = cost[per_part_best_k, np.arange(cost.shape[1])]
        total = int(per_part_bits.sum()) + (1 << po) * pbits
        if best_total is None or total < best_total:
            best_total = total
            best = (1 if need_big_k else 0, po, per_part_best_k.copy())
        if po == 0:
            break
        cost = cost[:, 0::2] + cost[:, 1::2]
        counts = counts[0::2] + counts[1::2]
        po -= 1
    method, po, part_ks = best
    # enforce token length q+1+k <= MAX_RICE_TOKEN_BITS per partition by
    # bumping k (always satisfiable for bps <= 30 streams; wider residuals
    # may exceed the cap at kmax -- still valid FLAC, but such streams must
    # not claim the TOK32 layout flag, see encode_flac's layout block)
    nparts = 1 << po
    base = blocksize >> po
    start = 0
    for p in range(nparts):
        cnt = base - order if p == 0 else base
        zp = z[start : start + cnt]
        if zp.size:
            k = int(part_ks[p])
            while k < kmax and (int(zp.max()) >> k) + 1 + k > MAX_RICE_TOKEN_BITS:
                k += 1
            part_ks[p] = k
        start += cnt
    return method, po, part_ks, best_total


@dataclass
class _SubframePlan:
    kind: str  # constant | verbatim | fixed | lpc
    order: int
    bits: int
    residual: np.ndarray | None = None
    qcoeffs: np.ndarray | None = None
    shift: int = 0
    precision: int = 0
    method: int = 0
    part_order: int = 0
    part_ks: np.ndarray | None = None
    value: int = 0


def _plan_subframe(x: np.ndarray, bps: int, cfg: EncoderConfig) -> _SubframePlan:
    n = x.size
    x = x.astype(np.int64, copy=False)
    if n == 0:
        raise ValueError("empty subframe")
    if np.all(x == x[0]):
        return _SubframePlan("constant", 0, 8 + bps, value=int(x[0]))

    verbatim_bits = 8 + n * bps
    best = _SubframePlan("verbatim", 0, verbatim_bits)

    max_fixed = min(4, n - 1)
    residual_limit = np.int64(1) << 31
    for order in range(max_fixed + 1):
        res = fixed_residual(x, order)
        if res.size and (np.abs(res) >= residual_limit).any():
            continue
        z = zigzag(res)
        method, po, part_ks, payload = _partition_plan(z, order, n, cfg.max_partition_order)
        bits = 8 + order * bps + 2 + 4 + payload
        if bits < best.bits:
            best = _SubframePlan(
                "fixed", order, bits, residual=res,
                method=method, part_order=po, part_ks=part_ks,
            )

    if cfg.use_lpc and n > cfg.max_lpc_order * 2:
        from ..ops.device_codec import apodization_window

        order = min(cfg.max_lpc_order, n - 1)
        for wname in cfg.apodizations:
            window = apodization_window(wname, n).astype(np.float64)
            r = lpc_ops.autocorrelation(x, order, window)
            coeffs, err = lpc_ops.levinson_durbin(r, order)
            if not (np.isfinite(coeffs).all() and np.abs(coeffs).max() > 0):
                continue
            qc, shift = lpc_ops.quantize_lpc_coeffs(coeffs)
            res = lpc_ops.lpc_residual(x, qc, shift)
            if res.size and (np.abs(res) >= residual_limit).any():
                continue
            z = zigzag(res)
            method, po, part_ks, payload = _partition_plan(
                z, order, n, cfg.max_partition_order
            )
            precision = lpc_ops.MAX_QLP_PRECISION
            bits = 8 + order * bps + 4 + 5 + order * precision + 2 + 4 + payload
            if bits < best.bits:
                best = _SubframePlan(
                    "lpc", order, bits, residual=res, qcoeffs=qc.astype(np.int64),
                    shift=shift, precision=precision,
                    method=method, part_order=po, part_ks=part_ks,
                )
    return best


def _emit_residual(sink: _TokenSink, plan: _SubframePlan, blocksize: int) -> None:
    sink.put(plan.method, 2)
    sink.put(plan.part_order, 4)
    z = zigzag(plan.residual)
    pbits = 4 if plan.method == 0 else 5
    escape = (1 << pbits) - 1
    nparts = 1 << plan.part_order
    base = blocksize >> plan.part_order
    start = 0
    for p in range(nparts):
        cnt = base - plan.order if p == 0 else base
        zp = z[start : start + cnt]
        k = int(plan.part_ks[p])
        sink.put(k, pbits)
        if cnt:
            k64 = np.uint64(k)
            q = (zp >> k64).astype(np.int64)
            rem = zp & ((np.uint64(1) << k64) - np.uint64(1))
            values = (np.uint64(1) << k64) | rem
            lengths = q + 1 + k
            # honest TOK32 layout flag: record the widest emitted token
            sink.max_token_bits = max(
                getattr(sink, "max_token_bits", 0), int(lengths.max())
            )
            sink.put_array(values, lengths)
        start += cnt
    assert start == blocksize - plan.order


def _emit_subframe(
    sink: _TokenSink, plan: _SubframePlan, x: np.ndarray, bps: int
) -> None:
    sink.put(0, 1)  # padding bit
    if plan.kind == "constant":
        sink.put(0b000000, 6)
        sink.put(0, 1)  # no wasted bits
        sink.put(plan.value & ((1 << bps) - 1), bps)
        return
    if plan.kind == "verbatim":
        sink.put(0b000001, 6)
        sink.put(0, 1)
        sink.put_signed_array(x, bps)
        return
    if plan.kind == "fixed":
        sink.put(0b001000 | plan.order, 6)
        sink.put(0, 1)
        if plan.order:
            sink.put_signed_array(x[: plan.order], bps)
        _emit_residual(sink, plan, x.size)
        return
    # lpc
    sink.put(0b100000 | (plan.order - 1), 6)
    sink.put(0, 1)
    sink.put_signed_array(x[: plan.order], bps)
    sink.put(plan.precision - 1, 4)
    sink.put(plan.shift & 0x1F, 5)
    sink.put_signed_array(plan.qcoeffs, plan.precision)
    _emit_residual(sink, plan, x.size)


def _choose_stereo(
    L: np.ndarray, R: np.ndarray, bps: int, cfg: EncoderConfig
) -> tuple[int, list[tuple["_SubframePlan", np.ndarray, int]]]:
    """Full mid-side search for one 2-channel frame.

    Plans L, R, mid=(L+R)>>1 at ``bps`` and side=L-R at ``bps+1``, then keeps
    the channel assignment with the fewest exact bits (libFLAC ``-m``).
    Returns (chan_code, [(plan, signal, slot_bps), (plan, signal, slot_bps)]).
    """
    L = L.astype(np.int64, copy=False)
    R = R.astype(np.int64, copy=False)
    mid = (L + R) >> 1
    side = L - R
    pL = _plan_subframe(L, bps, cfg)
    pR = _plan_subframe(R, bps, cfg)
    pM = _plan_subframe(mid, bps, cfg)
    pS = _plan_subframe(side, bps + 1, cfg)
    options = [
        (pL.bits + pR.bits, 1, [(pL, L, bps), (pR, R, bps)]),
        (pL.bits + pS.bits, 8, [(pL, L, bps), (pS, side, bps + 1)]),
        (pS.bits + pR.bits, 9, [(pS, side, bps + 1), (pR, R, bps)]),
        (pM.bits + pS.bits, 10, [(pM, mid, bps), (pS, side, bps + 1)]),
    ]
    _, chan_code, slots = min(options, key=lambda o: o[0])
    return chan_code, slots


def encode_flac(
    samples: np.ndarray,
    sample_rate: int,
    bits_per_sample: int,
    compression_level: int = 5,
    blocksize: int = 4096,
    comments: dict[str, str] | None = None,
    vendor: str = "flac-raster-tpu",
    compute_md5: bool = True,
    padding: int = 0,
) -> bytes:
    """Encode int samples (n, channels) into a complete FLAC stream.

    The output is spec-conformant FLAC decodable by any FLAC decoder
    (validated round-trip against our independent decoder and against frame
    CRC/MD5 invariants in tests).
    """
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, channels = samples.shape
    if not 1 <= channels <= 8:
        raise ValueError("FLAC supports 1..8 channels")
    if bits_per_sample not in _BPS_CODES:
        raise ValueError(f"unsupported bits_per_sample {bits_per_sample}")
    lo = -(1 << (bits_per_sample - 1))
    hi = (1 << (bits_per_sample - 1)) - 1
    smp = samples.astype(np.int64, copy=False)
    if smp.min() < lo or smp.max() > hi:
        raise ValueError("samples exceed bits_per_sample range")

    cfg = EncoderConfig.from_level(compression_level)
    sink = _TokenSink()
    frame_spans: list[tuple[int, int]] = []  # (header_bits_start, end) for CRC patching
    header_spans: list[tuple[int, int]] = []
    sub_bits_rows: list = []  # per-frame subframe bit lengths (channels 0..C-2)

    sr_code = _SAMPLE_RATE_CODES.get(sample_rate, 0)
    bps_code = _BPS_CODES[bits_per_sample]

    n_frames = (n + blocksize - 1) // blocksize
    min_fs = None
    max_fs = None
    use_ms = channels == 2 and cfg.mid_side and bits_per_sample + 1 <= 32
    for fi in range(n_frames):
        fstart = fi * blocksize
        bs = min(blocksize, n - fstart)
        # frame-level stereo decorrelation (libFLAC -m; planned up front
        # because the channel assignment lands in the frame header)
        if use_ms:
            chan_code, slots = _choose_stereo(
                smp[fstart : fstart + bs, 0],
                smp[fstart : fstart + bs, 1],
                bits_per_sample,
                cfg,
            )
        else:
            chan_code, slots = channels - 1, None
        frame_bit_start = sink.bit_pos
        assert frame_bit_start % 8 == 0
        # --- frame header ---
        sink.put(0b11111111111110, 14)
        sink.put(0, 1)  # mandatory 0
        sink.put(0, 1)  # fixed blocksize stream
        if bs == blocksize and blocksize in _BLOCKSIZE_CODES:
            bs_code, bs_tail = _BLOCKSIZE_CODES[blocksize], None
        elif bs <= 256:
            bs_code, bs_tail = 6, (bs - 1, 8)
        else:
            bs_code, bs_tail = 7, (bs - 1, 16)
        sink.put(bs_code, 4)
        sink.put(sr_code, 4)
        sink.put(chan_code, 4)
        sink.put(bps_code, 3)
        sink.put(0, 1)
        for val, nbits in _utf8_coded_number(fi):
            sink.put(val, nbits)
        if bs_tail is not None:
            sink.put(*bs_tail)
        if sr_code == 0 and sample_rate:
            pass  # rate comes from STREAMINFO
        header_bits_end = sink.bit_pos
        assert header_bits_end % 8 == 0
        header_spans.append((frame_bit_start // 8, header_bits_end // 8))
        sink.put(0, 8)  # crc8 placeholder

        # --- subframes ---
        sub_pos = []
        if slots is not None:
            for plan, x, slot_bps in slots:
                sub_pos.append(sink.bit_pos)
                _emit_subframe(sink, plan, x, slot_bps)
        else:
            for ci in range(channels):
                x = smp[fstart : fstart + bs, ci]
                plan = _plan_subframe(x, bits_per_sample, cfg)
                sub_pos.append(sink.bit_pos)
                _emit_subframe(sink, plan, x, bits_per_sample)
        sub_pos.append(sink.bit_pos)
        sub_bits_rows.append(np.diff(sub_pos)[:-1] if channels > 1 else None)

        # byte align + crc16 placeholder
        pad_bits = (-sink.bit_pos) % 8
        if pad_bits:
            sink.put(0, pad_bits)
        frame_bytes_end = sink.bit_pos // 8
        frame_spans.append((frame_bit_start // 8, frame_bytes_end))
        sink.put(0, 16)
        fs_bytes = frame_bytes_end + 2 - frame_bit_start // 8
        min_fs = fs_bytes if min_fs is None else min(min_fs, fs_bytes)
        max_fs = fs_bytes if max_fs is None else max(max_fs, fs_bytes)

    body = bytearray(sink.pack())

    # --- batch-patch CRCs ---
    if header_spans:
        hmax = max(e - s for s, e in header_spans)
        hmat = np.zeros((len(header_spans), hmax), dtype=np.uint8)
        for i, (s, e) in enumerate(header_spans):
            hmat[i, hmax - (e - s):] = np.frombuffer(body, np.uint8, e - s, s)
        h8 = crc8_rows(hmat)
        for i, (s, e) in enumerate(header_spans):
            body[e] = int(h8[i])
        fmax = max(e - s for s, e in frame_spans)
        fmat = np.zeros((len(frame_spans), fmax), dtype=np.uint8)
        for i, (s, e) in enumerate(frame_spans):
            fmat[i, fmax - (e - s):] = np.frombuffer(body, np.uint8, e - s, s)
        f16 = crc16_rows(fmat)
        for i, (s, e) in enumerate(frame_spans):
            body[e] = int(f16[i]) >> 8
            body[e + 1] = int(f16[i]) & 0xFF

    md5 = md5_of_samples(samples.astype(np.int32), bits_per_sample) if compute_md5 else b"\x00" * 16
    streaminfo = StreamInfo(
        min_blocksize=blocksize if n_frames <= 1 else blocksize,
        max_blocksize=blocksize,
        min_framesize=min_fs or 0,
        max_framesize=max_fs or 0,
        sample_rate=sample_rate,
        channels=channels,
        bits_per_sample=bits_per_sample,
        total_samples=n,
        md5=md5,
    )
    frame_sizes = [e + 2 - s for s, e in frame_spans]
    tok32 = getattr(sink, "max_token_bits", 0) <= MAX_RICE_TOKEN_BITS
    sub_bits = (
        np.asarray(sub_bits_rows, np.int64)
        if channels > 1 and sub_bits_rows and tok32
        else None
    )
    header = build_flac_header(
        streaminfo, comments, vendor, padding,
        frame_sizes=frame_sizes or None,
        sub_bits=sub_bits,
        layout_flags=LAYOUT_FLAG_TOK32 if tok32 else 0,
    )
    return bytes(header) + bytes(body)
