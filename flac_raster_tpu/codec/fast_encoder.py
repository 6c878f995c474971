"""Batched FLAC encoder: device block planning + vectorized array emission.

The reference encodes through libFLAC's sequential bitwriter one 4096-sample
block at a time (``converter.py:153``, SURVEY.md §3.1 hot loop #2).  Here the
whole stream is encoded as a handful of array programs:

  1. **Plan** (device, jit): ops/device_codec.plan_blocks chooses predictor,
     Rice partitioning, and exact bit counts for every block at once.
  2. **Layout** (host, vectorized): every token's absolute bit offset is
     *computed arithmetically* from the plan's exact bit counts -- frame
     starts are a cumsum of frame sizes, subframe starts a cumsum of
     subframe sizes, sample offsets a cumsum of token lengths plus the
     Rice-parameter prefix ``pbits * (partition_index + 1)``.  No sequential
     bitwriter exists at all.
  3. **Pack** (host, vectorized): all tokens scatter-OR into the output
     buffer in one ``pack_tokens`` call per chunk (ops/bitpack.py).
  4. **Patch**: frame CRC8/CRC16 are computed for all frames in a chunk in
     one table-driven batch pass (ops/crc.py) and written in place.

Output is spec-conformant FLAC, decoded bit-exactly by codec/decoder.py and
byte-compatible with the reference toolchain's readers.  The tail frame (a
partial block) and sub-block streams reuse the scalar reference encoder
(codec/encoder.py), which shares all format logic.

Stream structure notes: fixed-blocksize stream; wasted-bits never used.
2-channel streams get the full frame-level mid-side search (libFLAC ``-m``,
levels 1-2 and 4-8): variants L/R/mid/side are planned in the same batched
pass (side at bps+1 via the planner's per-block ``bps_arr``) and each frame
keeps the cheapest of the four channel assignments (ops/stereo.py).
"""

from __future__ import annotations

import os

import numpy as np

from ..models.flac_format import (
    LAYOUT_FLAG_TOK32,
    StreamInfo,
    build_flac_header,
)
from ..ops.bitpack import pack_tokens
from ..ops.crc import crc8_rows, crc16_rows
from ..ops.device_codec import (
    KIND_CONSTANT,
    KIND_FIXED,
    KIND_LPC,
    KIND_VERBATIM,
    MAX_DEVICE_BPS,
    make_planner,
)
from .decoder import md5_of_samples
from .encoder import (
    _BLOCKSIZE_CODES,
    _BPS_CODES,
    _SAMPLE_RATE_CODES,
    EncoderConfig,
    _emit_subframe,
    _plan_subframe,
    _TokenSink,
    _utf8_coded_number,
    encode_flac,
)

__all__ = ["encode_flac_fast", "encode_flac_batch"]


def _default_planner(blocksize: int, bps: int, cfg: "EncoderConfig"):
    """Device planner for narrow samples; numpy host planner for bps > 26.

    With more than one visible device the block batch is sharded across all
    of them (blocks are independent, so this is pure data parallelism --
    SURVEY.md §2.4's block-parallel mapping); padding in the callers keeps
    batch sizes divisible.
    """
    if bps > MAX_DEVICE_BPS:
        from ..ops.host_planner import plan_blocks_host

        def planner(blocks, bps_arr=None):
            return plan_blocks_host(
                blocks,
                bps_arr,
                blocksize=blocksize,
                bps=bps,
                max_lpc_order=cfg.max_lpc_order,
                apodizations=cfg.apodizations,
                max_partition_order=min(cfg.max_partition_order, 6),
                use_lpc=cfg.use_lpc,
            )

        return planner
    import jax

    from ..backend import backend_config

    devs = jax.local_devices()  # per-host planning under jax.distributed
    if (
        len(devs) <= 1
        and backend_config().planner == "native"
        and os.environ.get("FRTPU_NATIVE_PLAN", "1") != "0"
    ):
        # CPU-only host: the C++ integer search (ops/native_planner) beats
        # XLA:CPU several-fold at byte-identical output; the accelerator
        # and multi-device mesh paths keep the XLA planner
        from ..ops.native_planner import make_native_planner

        nat = make_native_planner(
            blocksize=blocksize,
            bps=bps,
            max_lpc_order=cfg.max_lpc_order,
            apodizations=cfg.apodizations,
            max_partition_order=min(cfg.max_partition_order, 6),
            use_lpc=cfg.use_lpc,
        )
        if nat is not None:
            return nat
    base = make_planner(
        blocksize=blocksize,
        bps=bps,
        max_lpc_order=cfg.max_lpc_order,
        apodizations=cfg.apodizations,
        max_partition_order=min(cfg.max_partition_order, 6),
        use_lpc=cfg.use_lpc,
    )
    if len(devs) <= 1:
        return base
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(devs), ("blocks",))
    shard = NamedSharding(mesh, P("blocks"))

    def sharded_planner(blocks, bps_arr=None):
        n_dev = len(devs)
        B = blocks.shape[0]
        pad = (-B) % n_dev
        if pad:
            blocks = np.concatenate(
                [blocks, np.zeros((pad, blocks.shape[1]), blocks.dtype)]
            )
            if bps_arr is not None:
                bps_arr = np.concatenate(
                    [bps_arr, np.full(pad, bps, bps_arr.dtype)]
                )
        import jax.numpy as jnp

        barg = (
            None
            if bps_arr is None
            else jax.device_put(jnp.asarray(bps_arr, jnp.int32), shard)
        )
        plan = base(jax.device_put(jnp.asarray(blocks), shard), barg)
        if pad:
            plan = {k: v[:B] for k, v in plan.items()}
        return plan

    return sharded_planner

_UTF8_THRESHOLDS = np.array(
    [0x80, 0x800, 0x10000, 0x200000, 0x4000000, 0x80000000], dtype=np.int64
)
_UTF8_PREFIX = np.array([0x00, 0xC0, 0xE0, 0xF0, 0xF8, 0xFC], dtype=np.int64)


def _utf8_tokens(frame_numbers: np.ndarray):
    """Vectorized FLAC UTF-8-style frame-number coding.

    Args:
        frame_numbers: (F,) int64 frame indices (< 2^31).
    Returns:
        values (F, 6) uint64, lengths (F, 6) int64 (0 for unused slots),
        n_bytes (F,) int64.
    """
    fi = frame_numbers.astype(np.int64)
    n_bytes = np.searchsorted(_UTF8_THRESHOLDS, fi, side="right") + 1  # (F,)
    j = np.arange(6)[None, :]
    nb = n_bytes[:, None]
    used = j < nb
    # continuation shift for byte j: 6 * (n_bytes - 1 - j)
    shift = np.maximum(6 * (nb - 1 - j), 0)
    payload = fi[:, None] >> shift
    first = j == 0
    vals = np.where(
        first,
        _UTF8_PREFIX[nb.clip(1, 6) - 1] | payload,
        0x80 | (payload & 0x3F),
    )
    vals = np.where(used, vals, 0)
    lens = np.where(used, 8, 0)
    return vals.astype(np.uint64), lens.astype(np.int64), n_bytes


def _blocksize_header(blocksize: int) -> tuple[int, int, int]:
    """(bs_code, tail_value, tail_bits) for a full frame of ``blocksize``."""
    if blocksize in _BLOCKSIZE_CODES:
        return _BLOCKSIZE_CODES[blocksize], 0, 0
    if blocksize <= 256:
        return 6, blocksize - 1, 8
    return 7, blocksize - 1, 16


class _Group:
    """Accumulates token arrays (values, lengths, absolute bit offsets)."""

    def __init__(self):
        self.v: list[np.ndarray] = []
        self.l: list[np.ndarray] = []
        self.o: list[np.ndarray] = []

    def add(self, values, lengths, offsets):
        self.v.append(np.ascontiguousarray(values, dtype=np.uint64).ravel())
        self.l.append(np.ascontiguousarray(lengths, dtype=np.int64).ravel())
        self.o.append(np.ascontiguousarray(offsets, dtype=np.int64).ravel())

    def pack_array(self, total_bits: int, out: np.ndarray | None = None) -> np.ndarray:
        """Pack to a mutable uint8 array (native C packer when available).

        ``out`` may be a preallocated zeroed buffer (with >= 8 bytes slack)
        to OR into; the native subframe emitter shares it afterwards.
        """
        v = np.concatenate(self.v)
        l = np.concatenate(self.l)
        o = np.concatenate(self.o)
        # zero-length tokens may carry garbage offsets; neutralize them
        o = np.where(l > 0, o, 0)
        from .. import native

        if native.available():
            return native.pack_tokens_native(v, l, o, total_bits, out=out)
        packed = np.frombuffer(pack_tokens(v, l, o, total_bits), np.uint8)
        if out is not None:
            out[: len(packed)] |= packed
            return out[: len(packed)]
        return packed.copy()


def _emit_chunk(
    x: np.ndarray,
    plan: dict,
    frame0: int,
    blocksize: int,
    bps: int,
    sr_code: int,
    bps_code: int,
    chan_code: np.ndarray | None = None,
    ch_bps: np.ndarray | None = None,
) -> tuple[bytes, np.ndarray]:
    """Emit one chunk of full frames.

    Args:
        x: (F, C, N) int64 subframe signals (post stereo-decorrelation when
            mid-side is active -- slot values, not necessarily L/R).
        plan: planner output arrays reshaped to (F, C, ...), numpy.
        frame0: absolute index of the first frame in this chunk.
        chan_code: optional (F,) frame-header channel assignment codes
            (default independent channels, C-1).
        ch_bps: optional (F, C) per-slot bit depths (side slots are bps+1).
    Returns:
        (packed bytes, per-frame byte sizes (F,), subframe bits (F, C))
    """
    F, C, N = x.shape
    log2n = N.bit_length() - 1
    assert (1 << log2n) == N, "full-frame path requires power-of-two blocksize"
    if ch_bps is None:
        ch_bps = np.full((F, C), bps, np.int64)
    else:
        ch_bps = ch_bps.astype(np.int64)
    if chan_code is None:
        chan_code = np.full(F, C - 1, np.int64)
    else:
        chan_code = chan_code.astype(np.int64)
    bmask = (np.int64(1) << ch_bps) - 1  # (F, C)

    kind = plan["kind"].astype(np.int64)
    order = plan["order"].astype(np.int64)
    method = plan["method"].astype(np.int64)
    po = plan["po"].astype(np.int64)
    ks = plan["ks"].astype(np.int64)          # (F, C, 64)
    precision = plan["precision"].astype(np.int64)
    shift = plan["shift"].astype(np.int64)
    qcoeffs = plan["qcoeffs"].astype(np.int64)  # (F, C, 8)
    sf_bits = plan["subframe_bits"].astype(np.int64)
    residual_raw = plan["residual"]               # (F, C, N)

    is_rice = (kind == KIND_FIXED) | (kind == KIND_LPC)
    is_lpc = kind == KIND_LPC
    is_verb = kind == KIND_VERBATIM
    is_const = kind == KIND_CONSTANT

    # ---- frame/subframe layout (pure arithmetic) --------------------------
    utf8_v, utf8_l, n_bytes = _utf8_tokens(np.arange(frame0, frame0 + F))
    bs_code, bs_tail_val, bs_tail_bits = _blocksize_header(blocksize)
    hdr_bits = 32 + n_bytes * 8 + bs_tail_bits          # (F,) before crc8
    body_bits = sf_bits.sum(axis=1)                     # (F,)
    raw = hdr_bits + 8 + body_bits
    pad = (-raw) % 8
    frame_bits = raw + pad + 16
    frame_start = np.zeros(F, np.int64)
    np.cumsum(frame_bits[:-1], out=frame_start[1:])
    total_bits = int(frame_start[-1] + frame_bits[-1]) if F else 0

    sf_excl = np.zeros((F, C), np.int64)
    np.cumsum(sf_bits[:, :-1], axis=1, out=sf_excl[:, 1:])
    sf_start = (frame_start + hdr_bits + 8)[:, None] + sf_excl  # (F, C)

    lpcmeta_bits = np.where(is_lpc, 4 + 5 + order * precision, 0)
    payload_base = np.where(is_rice, 8 + order * ch_bps + lpcmeta_bits + 6, 8)
    pbits = 4 + method

    g = _Group()

    # ---- frame header ------------------------------------------------------
    hdr32 = (
        (0b11111111111110 << 18)
        | (bs_code << 12)
        | (sr_code << 8)
        | (chan_code << 4)
        | (bps_code << 1)
    ).astype(np.uint64)
    g.add(hdr32, np.full(F, 32, np.int64), frame_start)
    g.add(utf8_v, utf8_l, frame_start[:, None] + 32 + np.arange(6)[None, :] * 8)
    if bs_tail_bits:
        g.add(
            np.full(F, bs_tail_val, np.uint64),
            np.full(F, bs_tail_bits, np.int64),
            frame_start + 32 + n_bytes * 8,
        )
    # crc8 / crc16 are zero in the packed buffer and patched afterwards.

    # ---- subframe headers ----------------------------------------------------
    type_code = np.select(
        [is_const, is_verb, kind == KIND_FIXED, is_lpc],
        [0, 1, 0b001000 | order, 0b100000 | np.maximum(order - 1, 0)],
    )
    g.add((type_code.astype(np.uint64)) << np.uint64(1), np.full((F, C), 8, np.int64), sf_start)

    # warmup samples (fixed + lpc)
    from ..ops.device_codec import MAX_ORDER_SLOTS

    j8 = np.arange(MAX_ORDER_SLOTS)
    wu_used = (j8[None, None, :] < order[:, :, None]) & is_rice[:, :, None]
    wu_vals = (
        x[:, :, :MAX_ORDER_SLOTS].astype(np.int64) & bmask[:, :, None]
    ).astype(np.uint64)
    g.add(
        np.where(wu_used, wu_vals, 0),
        np.where(wu_used, ch_bps[:, :, None], 0),
        sf_start[:, :, None] + 8 + j8[None, None, :] * ch_bps[:, :, None],
    )

    # lpc meta: precision-1 (4), shift (5), qcoeffs (order x precision)
    lpc_base = sf_start + 8 + order * ch_bps
    g.add(
        np.where(is_lpc, precision - 1, 0).astype(np.uint64),
        np.where(is_lpc, 4, 0),
        lpc_base,
    )
    g.add(
        np.where(is_lpc, shift & 0x1F, 0).astype(np.uint64),
        np.where(is_lpc, 5, 0),
        lpc_base + 4,
    )
    cf_used = (j8[None, None, :] < order[:, :, None]) & is_lpc[:, :, None]
    prec_mask = (np.int64(1) << precision) - 1
    cf_vals = (qcoeffs & prec_mask[:, :, None]).astype(np.uint64)
    g.add(
        np.where(cf_used, cf_vals, 0),
        np.where(cf_used, precision[:, :, None], 0),
        lpc_base[:, :, None] + 9 + j8[None, None, :] * precision[:, :, None],
    )

    # residual coding method + partition order (6 bits)
    g.add(
        np.where(is_rice, (method << 4) | po, 0).astype(np.uint64),
        np.where(is_rice, 6, 0),
        lpc_base + lpcmeta_bits,
    )

    # constant value
    g.add(
        np.where(is_const, x[:, :, 0] & bmask, 0).astype(np.uint64),
        np.where(is_const, ch_bps, 0),
        sf_start + 8,
    )

    # ---- sample tokens -------------------------------------------------------
    from .. import native

    use_native_emit = (
        native.available()
        and residual_raw.dtype == np.int32
        and int(ch_bps.max()) <= 27
        and os.environ.get("FRTPU_NATIVE_EMIT", "1") != "0"
    )
    if use_native_emit:
        # sequential native writer (bitpack.cpp emit_subframes_c): header
        # tokens pack first, then the payloads OR in over them.  Constant
        # subframes have no payload; check their exact size here (the
        # native pass checks every other kind token-for-token).
        if not np.array_equal(sf_bits[is_const], (8 + ch_bps)[is_const]):
            raise AssertionError("emitter/planner bit mismatch on constant subframes")
        n_bytes_total = (total_bits + 7) // 8
        buf_base = np.zeros(n_bytes_total + 8, np.uint8)
        g.pack_array(total_bits, out=buf_base)
        start_bits = (sf_start + payload_base).ravel()
        expect = np.where(
            is_rice | is_verb, sf_bits - payload_base, 0
        ).ravel()
        err = native.emit_subframes(
            x.reshape(F * C, N), residual_raw.reshape(F * C, N),
            kind.ravel(), order.ravel(), method.ravel(), po.ravel(),
            ks.reshape(F * C, 64), ch_bps.ravel(),
            start_bits, expect, buf_base, total_bits,
        )
        if err >= 0:
            raise AssertionError(
                f"emitter/planner bit mismatch at subframe {divmod(err, C)}"
            )
        buf = buf_base[:n_bytes_total]
    else:
        residual = residual_raw.astype(np.int64)            # (F, C, N)
        i = np.arange(N)[None, None, :]
        part = i >> (log2n - po)[:, :, None]                    # (F, C, N)
        k = np.take_along_axis(ks, part, axis=2)                # (F, C, N)
        z = ((residual << 1) ^ (residual >> 63)).astype(np.uint64)
        ku = k.astype(np.uint64)
        q = (z >> ku).astype(np.int64)
        in_resid = i >= order[:, :, None]
        rice_tok = is_rice[:, :, None] & in_resid
        L = np.where(rice_tok, q + 1 + k, np.where(is_verb[:, :, None], ch_bps[:, :, None], 0))
        vals = np.where(
            rice_tok,
            (np.uint64(1) << ku) | (z & ((np.uint64(1) << ku) - np.uint64(1))),
            (x & bmask[:, :, None]).astype(np.uint64),
        )
        E = np.zeros_like(L)
        np.cumsum(L[:, :, :-1], axis=2, out=E[:, :, 1:])        # exclusive cumsum
        sample_off = (
            sf_start[:, :, None]
            + payload_base[:, :, None]
            + np.where(rice_tok, pbits[:, :, None] * (part + 1), 0)
            + E
        )
        g.add(vals, L, sample_off)

        # rice partition-parameter tokens
        p64 = np.arange(64)[None, None, :]
        p_used = (p64 < (np.int64(1) << po)[:, :, None]) & is_rice[:, :, None]
        sp = np.minimum(p64 << (log2n - po)[:, :, None], N - 1)  # partition start sample
        Ep = np.take_along_axis(E, sp, axis=2)
        k_off = sf_start[:, :, None] + payload_base[:, :, None] + pbits[:, :, None] * p64 + Ep
        g.add(
            np.where(p_used, ks, 0).astype(np.uint64),
            np.where(p_used, pbits[:, :, None], 0),
            k_off,
        )

        # consistency: computed layout must match the planner's exact bit counts
        sf_total = payload_base + np.where(is_rice, (pbits << po), 0) + E[:, :, -1] + L[:, :, -1]
        sf_expected = np.where(is_const, 8 + ch_bps, sf_bits)
        if not np.array_equal(np.where(is_const, 8 + ch_bps, sf_total), sf_expected):
            bad = np.argwhere(np.where(is_const, 8 + ch_bps, sf_total) != sf_expected)
            raise AssertionError(f"emitter/planner bit mismatch at {bad[:4]}")

        buf = g.pack_array(total_bits)

    # ---- CRC patching --------------------------------------------------------
    from .. import native

    fs_byte = frame_start >> 3
    hdr_len = (hdr_bits >> 3).astype(np.int64)
    fr_len = ((frame_bits >> 3) - 2).astype(np.int64)
    if native.available():
        native.crc8_patch(buf, fs_byte, hdr_len)
        native.crc16_patch(buf, fs_byte, fr_len)
        return buf.tobytes(), (frame_bits >> 3), sf_bits

    hmax = int(hdr_len.max())
    hmat = np.zeros((F, hmax), np.uint8)
    for fidx in range(F):
        s, ln = int(fs_byte[fidx]), int(hdr_len[fidx])
        hmat[fidx, hmax - ln :] = buf[s : s + ln]
    h8 = crc8_rows(hmat)
    for fidx in range(F):
        buf[int(fs_byte[fidx] + hdr_len[fidx])] = int(h8[fidx])

    fmax = int(fr_len.max())
    fmat = np.zeros((F, fmax), np.uint8)
    for fidx in range(F):
        s, ln = int(fs_byte[fidx]), int(fr_len[fidx])
        fmat[fidx, fmax - ln :] = buf[s : s + ln]
    f16 = crc16_rows(fmat)
    for fidx in range(F):
        e = int(fs_byte[fidx] + fr_len[fidx])
        buf[e] = int(f16[fidx]) >> 8
        buf[e + 1] = int(f16[fidx]) & 0xFF

    return buf.tobytes(), (frame_bits >> 3), sf_bits


def _plan_frames_chunk(
    xc: np.ndarray,
    planner,
    blocksize: int,
    bps: int,
    block_dtype,
    mid_side: bool,
):
    """Plan one chunk of full frames, including the mid-side variant search.

    Args:
        xc: (F, C, N) int64 frame-major samples.
    Returns:
        (plan dict with (F, C, ...) arrays, x_emit (F, C, N) slot signals,
         chan_code (F,) or None, ch_bps (F, C) or None)
    """
    Fc, C, N = xc.shape
    if mid_side:
        from ..ops.stereo import build_variants, select_plans

        var = build_variants(xc)                     # (F, 4, N) int64
        blocks = var.reshape(Fc * 4, N).astype(block_dtype)
        bps_arr = np.tile(np.array([bps, bps, bps, bps + 1], np.int32), Fc)
        B = blocks.shape[0]
        b_pad = 1 << max(0, (B - 1)).bit_length()
        if b_pad != B:
            blocks = np.concatenate(
                [blocks, np.zeros((b_pad - B, N), block_dtype)]
            )
            bps_arr = np.concatenate([bps_arr, np.full(b_pad - B, bps, np.int32)])
        plan_dev = planner(blocks, bps_arr)
        plan4 = {k: np.asarray(v)[:B] for k, v in plan_dev.items()}
        return select_plans(plan4, var, bps)
    blocks = xc.reshape(Fc * C, N).astype(block_dtype)
    B = blocks.shape[0]
    b_pad = 1 << max(0, (B - 1)).bit_length()
    if b_pad != B:
        blocks = np.concatenate([blocks, np.zeros((b_pad - B, N), block_dtype)])
    plan_dev = planner(blocks)
    plan = {
        k: np.asarray(v)[:B].reshape((Fc, C) + np.asarray(v).shape[1:])
        for k, v in plan_dev.items()
    }
    return plan, xc, None, None


def _emit_tail_frame(
    x_tail: np.ndarray,
    frame_number: int,
    bps: int,
    sr_code: int,
    bps_code: int,
    cfg: EncoderConfig,
) -> bytes:
    """Scalar emission of the final partial frame (shares encoder.py logic)."""
    from ..ops.crc import crc16 as crc16_one, crc8 as crc8_one

    bs, channels = x_tail.shape
    from ..ops.stereo import midside_ok

    slots = None
    chan_code = channels - 1
    if midside_ok(channels, bps, cfg.mid_side):
        from .encoder import _choose_stereo

        chan_code, slots = _choose_stereo(
            x_tail[:, 0], x_tail[:, 1], bps, cfg
        )
    sink = _TokenSink()
    sink.put(0b11111111111110, 14)
    sink.put(0, 1)
    sink.put(0, 1)
    if bs in _BLOCKSIZE_CODES:
        code, tail = _BLOCKSIZE_CODES[bs], None
    elif bs <= 256:
        code, tail = 6, (bs - 1, 8)
    else:
        code, tail = 7, (bs - 1, 16)
    sink.put(code, 4)
    sink.put(sr_code, 4)
    sink.put(chan_code, 4)
    sink.put(bps_code, 3)
    sink.put(0, 1)
    for val, nbits in _utf8_coded_number(frame_number):
        sink.put(val, nbits)
    if tail is not None:
        sink.put(*tail)
    hdr_end = sink.bit_pos // 8
    sink.put(0, 8)  # crc8 placeholder
    if slots is not None:
        for plan, xc, slot_bps in slots:
            _emit_subframe(sink, plan, xc, slot_bps)
    else:
        for ci in range(channels):
            xc = x_tail[:, ci].astype(np.int64)
            plan = _plan_subframe(xc, bps, cfg)
            _emit_subframe(sink, plan, xc, bps)
    padb = (-sink.bit_pos) % 8
    if padb:
        sink.put(0, padb)
    body = bytearray(sink.pack())
    body[hdr_end] = crc8_one(bytes(body[:hdr_end]))
    c16 = crc16_one(bytes(body))
    return bytes(body) + bytes([c16 >> 8, c16 & 0xFF])


def encode_flac_fast(
    samples: np.ndarray,
    sample_rate: int,
    bits_per_sample: int,
    compression_level: int = 5,
    blocksize: int = 4096,
    comments: dict[str, str] | None = None,
    vendor: str = "flac-raster-tpu",
    compute_md5: bool = True,
    padding: int = 0,
    planner=None,
    plan_chunk_frames: int = 1024,
) -> bytes:
    """Encode int samples (n, channels) to FLAC via the device planner.

    Drop-in replacement for codec.encoder.encode_flac (same output contract;
    the byte stream may differ -- both are valid FLAC that decode to the same
    samples).  Falls back to the scalar encoder for streams shorter than one
    block or wider than MAX_DEVICE_BPS bits.

    Args:
        planner: optional ``fn(blocks (B, N) int32) -> plan`` override (e.g.
            a pre-jitted/sharded planner from parallel/).
        plan_chunk_frames: frames planned+emitted per chunk (bounds memory).
    """
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, channels = samples.shape
    if not 1 <= channels <= 8:
        raise ValueError("FLAC supports 1..8 channels")
    if bits_per_sample not in _BPS_CODES:
        raise ValueError(f"unsupported bits_per_sample {bits_per_sample}")
    n_full = n // blocksize
    if (
        n_full == 0
        or (blocksize & (blocksize - 1)) != 0
        or blocksize % 64 != 0
    ):
        return encode_flac(
            samples, sample_rate, bits_per_sample, compression_level,
            blocksize, comments, vendor, compute_md5, padding,
        )
    lo = -(1 << (bits_per_sample - 1))
    hi = (1 << (bits_per_sample - 1)) - 1
    smp = samples.astype(np.int64, copy=False)
    if smp.min() < lo or smp.max() > hi:
        raise ValueError("samples exceed bits_per_sample range")

    cfg = EncoderConfig.from_level(compression_level)
    from ..ops.stereo import midside_ok

    use_ms = midside_ok(channels, bits_per_sample, cfg.mid_side)
    nominal_bps = bits_per_sample + 1 if use_ms else bits_per_sample
    wide = nominal_bps > MAX_DEVICE_BPS
    if planner is None:
        planner = _default_planner(blocksize, nominal_bps, cfg)
    sr_code = _SAMPLE_RATE_CODES.get(sample_rate, 0)
    bps_code = _BPS_CODES[bits_per_sample]
    block_dtype = np.int64 if wide else np.int32

    # (n, C) -> (F, C, N) full blocks
    full = smp[: n_full * blocksize].reshape(n_full, blocksize, channels)
    full = np.ascontiguousarray(full.transpose(0, 2, 1))  # (F, C, N)

    chunks: list[bytes] = []
    sizes: list[np.ndarray] = []
    subs: list[np.ndarray] = []
    for c0 in range(0, n_full, plan_chunk_frames):
        c1 = min(c0 + plan_chunk_frames, n_full)
        # Batches are padded to power-of-two buckets inside _plan_frames_chunk
        # so jit compiles only O(log(max_chunk)) distinct shapes.
        plan, x_emit, chan_code, ch_bps = _plan_frames_chunk(
            full[c0:c1], planner, blocksize, bits_per_sample, block_dtype, use_ms
        )
        data, fsizes, sf_bits = _emit_chunk(
            x_emit, plan, c0, blocksize, bits_per_sample, sr_code, bps_code,
            chan_code=chan_code, ch_bps=ch_bps,
        )
        chunks.append(data)
        sizes.append(fsizes)
        subs.append(sf_bits[:, :-1])

    if n_full * blocksize < n:
        tail = smp[n_full * blocksize :]
        chunks.append(
            _emit_tail_frame(tail, n_full, bits_per_sample, sr_code, bps_code, cfg)
        )
        sizes.append(np.array([len(chunks[-1])], np.int64))
        subs.append(np.zeros((1, channels - 1), np.int64))  # tail: host decode

    all_sizes = np.concatenate(sizes)
    all_subs = np.concatenate(subs) if channels > 1 else None
    md5 = md5_of_samples(samples.astype(np.int32), bits_per_sample) if compute_md5 else b"\x00" * 16
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


def encode_flac_batch(
    samples_batch: np.ndarray,
    sample_rate: int,
    bits_per_sample: int,
    compression_level: int = 5,
    blocksize: int = 4096,
    comments_list=None,
    vendor: str = "flac-raster-tpu",
    compute_md5: bool = True,
    planner=None,
    plan_chunk_blocks: int = 4096,
    use_mesh: bool | None = None,
) -> list[bytes]:
    """Encode a batch of same-shaped streams with ONE device planning pass.

    This is the tile-data-parallel entry point (SURVEY.md §2.4).  With more
    than one visible device the whole batch is planned AND emitted by the
    (tiles x blocks) shard_map step (parallel/tile_engine
    .encode_flac_batch_mesh -- byte-identical output, tested); otherwise all
    tiles' blocks are planned in a single batched device program and the
    vectorized host emitter assembles the bytes.

    Args:
        samples_batch: (T, n, channels) int samples.
        comments_list: optional per-tile VORBIS comment dicts (len T).
        use_mesh: force (True) or forbid (False) the mesh path; default
            auto-selects on device count.
    Returns:
        list of T complete FLAC streams.
    """
    samples_batch = np.asarray(samples_batch)
    if samples_batch.ndim == 2:
        samples_batch = samples_batch[:, :, None]
    T, n, channels = samples_batch.shape
    if comments_list is None:
        comments_list = [None] * T
    n_full = n // blocksize
    if use_mesh is not False and planner is None:
        import jax

        if (
            len(jax.local_devices()) > 1
            and T > 0
            and n_full > 0
            # narrow and wide (32-bps, ops/wide_codec) lanes both ride the
            # mesh; 27..31 are not emittable FLAC widths (_BPS_CODES)
            and not (MAX_DEVICE_BPS < bits_per_sample < 32)
            and (blocksize & (blocksize - 1)) == 0
            and blocksize % 64 == 0
        ):
            from ..parallel.tile_engine import encode_flac_batch_mesh

            return encode_flac_batch_mesh(
                samples_batch, sample_rate, bits_per_sample,
                compression_level, blocksize, comments_list, vendor,
                compute_md5,
            )
    if (
        T == 0
        or n_full == 0
        or (blocksize & (blocksize - 1)) != 0
        or blocksize % 64 != 0
    ):
        return [
            encode_flac(
                samples_batch[t], sample_rate, bits_per_sample,
                compression_level, blocksize, comments_list[t], vendor,
                compute_md5,
            )
            for t in range(T)
        ]

    cfg = EncoderConfig.from_level(compression_level)
    from ..ops.stereo import midside_ok

    use_ms = midside_ok(channels, bits_per_sample, cfg.mid_side)
    nominal_bps = bits_per_sample + 1 if use_ms else bits_per_sample
    if planner is None:
        planner = _default_planner(blocksize, nominal_bps, cfg)
    sr_code = _SAMPLE_RATE_CODES.get(sample_rate, 0)
    bps_code = _BPS_CODES[bits_per_sample]
    block_dtype = np.int64 if nominal_bps > MAX_DEVICE_BPS else np.int32

    smp = samples_batch.astype(np.int64, copy=False)
    full = smp[:, : n_full * blocksize].reshape(T, n_full, blocksize, channels)
    full = np.ascontiguousarray(full.transpose(0, 1, 3, 2))  # (T, F, C, N)

    # one batched planning pass over all tiles' frames, chunked + bucketed
    # to bound memory/compiles
    frames_all = full.reshape(T * n_full, channels, blocksize)
    FT = T * n_full
    vars_per_frame = 4 if use_ms else channels
    step = max(plan_chunk_blocks // vars_per_frame, n_full)
    plan_parts: dict[str, list[np.ndarray]] = {}
    x_parts: list[np.ndarray] = []
    cc_parts: list[np.ndarray] = []
    cb_parts: list[np.ndarray] = []
    for f0 in range(0, FT, step):
        f1 = min(f0 + step, FT)
        plan, x_emit, cc, cb = _plan_frames_chunk(
            frames_all[f0:f1], planner, blocksize, bits_per_sample,
            block_dtype, use_ms,
        )
        for key, val in plan.items():
            plan_parts.setdefault(key, []).append(val)
        x_parts.append(x_emit)
        if use_ms:
            cc_parts.append(cc)
            cb_parts.append(cb)
    plan_all = {
        key: np.concatenate(parts).reshape(
            (T, n_full) + parts[0].shape[1:]
        )
        for key, parts in plan_parts.items()
    }
    x_all = np.concatenate(x_parts).reshape(T, n_full, channels, blocksize)
    cc_all = np.concatenate(cc_parts).reshape(T, n_full) if use_ms else None
    cb_all = (
        np.concatenate(cb_parts).reshape(T, n_full, channels) if use_ms else None
    )

    out: list[bytes] = []
    for t in range(T):
        plan_t = {key: val[t] for key, val in plan_all.items()}
        data, fsizes, sf_bits = _emit_chunk(
            x_all[t], plan_t, 0, blocksize, bits_per_sample, sr_code, bps_code,
            chan_code=None if cc_all is None else cc_all[t],
            ch_bps=None if cb_all is None else cb_all[t],
        )
        chunks = [data]
        sizes = [fsizes]
        subs = [sf_bits[:, :-1]]
        if n_full * blocksize < n:
            tail = smp[t, n_full * blocksize :]
            chunks.append(
                _emit_tail_frame(tail, n_full, bits_per_sample, sr_code, bps_code, cfg)
            )
            sizes.append(np.array([len(chunks[-1])], np.int64))
            subs.append(np.zeros((1, channels - 1), np.int64))
        all_sizes = np.concatenate(sizes)
        all_subs = np.concatenate(subs) if channels > 1 else None
        md5 = (
            md5_of_samples(samples_batch[t].astype(np.int32), bits_per_sample)
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
        header = build_flac_header(streaminfo, comments_list[t], vendor,
                                   frame_sizes=all_sizes, sub_bits=all_subs,
                                   layout_flags=LAYOUT_FLAG_TOK32)
        out.append(bytes(header) + b"".join(chunks))
    return out
