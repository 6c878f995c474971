"""On-device FLAC bitstream emission: tokens, offsets, and scatter-pack.

Completes the device encode pipeline (north star: BASELINE.json -- "bitstream
packing run[s] block-parallel over HBM-resident sample tiles"): after
ops/device_codec.plan_blocks chooses per-block plans, this module computes
every token's absolute bit offset *in-graph* (the same arithmetic layout as
codec/fast_encoder._emit_chunk -- cumsums of exact bit counts, no sequential
bitwriter) and scatter-ORs all tokens into a uint32 word buffer on device.

Only the **compressed words** ever leave the device -- the plan (residuals,
Rice parameters) stays in device memory, which saves about a raw-size of
device->host traffic per tile compared with shipping plans to a host
emitter.

Key trick: FLAC's unary quotients need no explicit zero-writing -- the word
buffer starts zeroed, so a Rice code is just TWO 1-scatter tokens: the
terminator bit at ``offset + q`` and the k-bit remainder after it.  Because
all token bit-ranges are disjoint by construction, scatter-ADD equals
scatter-OR (no carries), which XLA lowers to integer scatter-adds.

CRC8/CRC16 fields are left zero and patched on host (native/bitpack.cpp) over
the downloaded compressed buffer -- a linear table pass over ~ratio-compressed
bytes, never over raw data.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from . import device_codec
from .device_codec import (
    KIND_CONSTANT,
    KIND_FIXED,
    KIND_LPC,
    KIND_VERBATIM,
    MAX_ORDER_SLOTS,
    plan_blocks,
)

__all__ = ["plan_and_emit", "worst_case_words"]

_UTF8_THRESH = np.array([0x80, 0x800, 0x10000, 0x200000, 0x4000000], np.int32)
_UTF8_PREFIX = np.array([0x00, 0xC0, 0xE0, 0xF0, 0xF8, 0xFC], np.int32)


def worst_case_words(F: int, C: int, N: int, bps: int) -> int:
    """Static upper bound on chunk words: every subframe verbatim + headers."""
    per_frame = 64 + 48 + 8 + 16 + 8  # hdr32 + utf8max + crc8 + crc16 + pad
    per_sub = 8 + N * bps
    bits = F * (per_frame + C * per_sub)
    return (bits + 31) // 32 + 2


def _utf8_tokens_jnp(fi):
    """(F,) int32 -> values (F,6) uint32, lengths (F,6) int32, n_bytes (F,)."""
    thr = jnp.asarray(_UTF8_THRESH)
    n_bytes = jnp.sum(fi[:, None] >= thr[None, :], axis=1) + 1  # (F,)
    j = jax.lax.broadcasted_iota(jnp.int32, (fi.shape[0], 6), 1)
    nb = n_bytes[:, None]
    used = j < nb
    shift = jnp.maximum(6 * (nb - 1 - j), 0)
    payload = fi[:, None] >> shift
    prefix = jnp.asarray(_UTF8_PREFIX)[jnp.clip(nb - 1, 0, 5)]
    vals = jnp.where(j == 0, prefix | payload, 0x80 | (payload & 0x3F))
    vals = jnp.where(used, vals, 0)
    lens = jnp.where(used, 8, 0)
    return vals.astype(jnp.uint32), lens.astype(jnp.int32), n_bytes


def _scatter_tokens(words, vals, lens, offs):
    """Scatter-OR tokens (value<=32 bits) into the uint32 word buffer.

    Each token spans at most two words.  Disjoint bit ranges make add == or.
    Token offsets are monotone within every group (layout order), so both
    scatter index streams are sorted, and every index is in bounds by
    construction (worst_case_words pads +2), so the unchecked scatter path
    is safe.  Zero-length tokens contribute 0 at their clamped offsets.
    """
    vals = vals.ravel().astype(jnp.uint32)
    lens = lens.ravel().astype(jnp.int32)
    # NOTE: offsets must be non-decreasing INCLUDING dead (length-0) tokens --
    # callers clamp dead slots onto their last live neighbor; zeroing them
    # here would break the sorted-indices promise.
    offs = offs.ravel().astype(jnp.int32)
    live = lens > 0
    mask = jnp.where(
        lens >= 32, jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << jnp.clip(lens, 0, 31).astype(jnp.uint32)) - jnp.uint32(1),
    )
    v = jnp.where(live, vals & mask, jnp.uint32(0))
    end = offs + lens
    w0 = offs >> 5
    # bits of v that land in w0: shift left by (w0+1)*32 - end when positive,
    # else shift right by end - (w0+1)*32
    sh = (w0 + 1) * 32 - end
    shl = jnp.clip(sh, 0, 31).astype(jnp.uint32)
    shr = jnp.clip(-sh, 0, 31).astype(jnp.uint32)
    c0 = jnp.where(sh >= 0, v << shl, v >> shr)
    words = words.at[w0].add(c0, mode="promise_in_bounds", indices_are_sorted=True)
    # spillover into w0+1 (zero when the token fits in w0; w0+1 stays sorted)
    c1 = jnp.where(sh < 0, v << jnp.clip(32 + sh, 0, 31).astype(jnp.uint32), jnp.uint32(0))
    words = words.at[w0 + 1].add(c1, mode="promise_in_bounds", indices_are_sorted=True)
    return words


@functools.partial(
    jax.jit,
    static_argnames=(
        "blocksize", "bps", "sr_code", "bps_code", "bs_code", "bs_tail_bits",
        "bs_tail_val", "max_lpc_order", "max_partition_order", "use_lpc", "n_words",
        "zero_point", "mid_side", "apodizations",
    ),
)
def plan_and_emit(
    x,
    frame0,
    *,
    blocksize: int,
    bps: int,
    sr_code: int,
    bps_code: int,
    bs_code: int,
    bs_tail_bits: int = 0,
    bs_tail_val: int = 0,
    max_lpc_order: int = 8,
    max_partition_order: int = 6,
    use_lpc: bool = True,
    n_words: int | None = None,
    zero_point: int = 0,
    mid_side: bool = False,
    apodizations: tuple = ("tukey(0.5)",),
):
    """Plan and emit one chunk of full frames entirely on device.

    Args:
        x: (F, C, N) samples (frame-major, channel, sample); any integer
            dtype -- the fused normalization prologue maps it to int32 PCM
            by subtracting ``zero_point`` (the lossless shift mode of
            ops/normalization, run in-graph so raw rasters upload directly).
        frame0: scalar int32 -- absolute index of the first frame.
        n_words: static output word-buffer size (>= worst_case_words).
        mid_side: full frame-level stereo search (requires C == 2 and
            bps + 1 <= MAX_DEVICE_BPS): variants L/R/mid/side are planned
            in the same batched pass and the cheapest channel assignment
            is selected in-graph (libFLAC ``-m``; same selection as
            ops/stereo.select_plans, byte-identical to the host emitter).

    Returns:
        dict: words (n_words,) uint32 big-endian bit buffer,
              frame_bits (F,) int32, total_bits () int32.
    """
    F, C, N = x.shape
    log2n = N.bit_length() - 1
    assert (1 << log2n) == N
    if n_words is None:
        n_words = worst_case_words(F, C, N, bps + (1 if mid_side else 0))
    wide = bps > device_codec.MAX_DEVICE_BPS  # 32-bps lane (ops/wide_codec)
    # fused normalization: raw dtype -> int32 PCM (shift mode).  The
    # subtraction runs as uint32 wraparound so the uint32 dtype's
    # zero_point (2^31) is exact; for every narrower dtype this equals the
    # old int32 subtraction bit-for-bit (two's complement).
    if x.dtype == jnp.uint32:
        x = jax.lax.bitcast_convert_type(x, jnp.int32)
    else:
        x = x.astype(jnp.int32)
    if zero_point:
        x = jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(x, jnp.uint32)
            - jnp.uint32(zero_point & 0xFFFFFFFF),
            jnp.int32,
        )

    if mid_side:
        assert C == 2, "mid_side requires 2 channels"
        assert not wide, "mid_side side channel would exceed 32 bits"
        L, R = x[:, 0], x[:, 1]
        var = jnp.stack([L, R, (L + R) >> 1, L - R], axis=1)   # (F, 4, N)
        bps_arr = jnp.tile(
            jnp.asarray(np.array([bps, bps, bps, bps + 1], np.int32)), (F,)
        )
        plan = plan_blocks(
            var.reshape(F * 4, N),
            bps_arr,
            blocksize=blocksize,
            bps=bps + 1,
            max_lpc_order=max_lpc_order,
            max_partition_order=max_partition_order,
            use_lpc=use_lpc,
            apodizations=apodizations,
        )
        bits4 = plan["subframe_bits"].reshape(F, 4)
        bL, bR, bM, bS = bits4[:, 0], bits4[:, 1], bits4[:, 2], bits4[:, 3]
        tot = jnp.stack([bL + bR, bL + bS, bS + bR, bM + bS], axis=1)
        a = jnp.argmin(tot, axis=1)                            # (F,)
        s0 = jnp.asarray(np.array([0, 0, 3, 2], np.int32))[a]  # slot0 variant
        s1 = jnp.asarray(np.array([1, 3, 1, 3], np.int32))[a]  # slot1 variant
        chan_code = jnp.asarray(np.array([1, 8, 9, 10], np.int32))[a]
        sel = jnp.stack([s0, s1], axis=1)                      # (F, 2)

        def gather(v):
            v4 = v.reshape((F, 4) + v.shape[1:])
            idx = sel.reshape((F, 2) + (1,) * (v4.ndim - 2))
            return jnp.take_along_axis(v4, idx, axis=1)

        plan = {k: gather(v) for k, v in plan.items()}
        x = gather(var.reshape(F * 4, N))                      # slot signals
        ch_bps = bps + (sel == 3).astype(jnp.int32)            # (F, 2)
        kind = plan["kind"]
        order = plan["order"]
        method = plan["method"]
        po = plan["po"]
        ks = plan["ks"]
        precision = plan["precision"]
        shift = plan["shift"]
        qcoeffs = plan["qcoeffs"]
        sf_bits = plan["subframe_bits"]
        residual = plan["residual"]
    else:
        _plan = plan_blocks
        if wide:
            from .wide_codec import plan_blocks_wide as _plan
        plan = _plan(
            x.reshape(F * C, N),
            blocksize=blocksize,
            bps=bps,
            max_lpc_order=max_lpc_order,
            max_partition_order=max_partition_order,
            use_lpc=use_lpc,
            apodizations=apodizations,
        )
        chan_code = jnp.full((F,), C - 1, jnp.int32)
        ch_bps = jnp.full((F, C), bps, jnp.int32)
        kind = plan["kind"].reshape(F, C)
        order = plan["order"].reshape(F, C)
        method = plan["method"].reshape(F, C)
        po = plan["po"].reshape(F, C)
        ks = plan["ks"].reshape(F, C, 64)
        precision = plan["precision"].reshape(F, C)
        shift = plan["shift"].reshape(F, C)
        qcoeffs = plan["qcoeffs"].reshape(F, C, MAX_ORDER_SLOTS)
        sf_bits = plan["subframe_bits"].reshape(F, C)
        residual = plan["residual"].reshape(F, C, N)

    is_rice = (kind == KIND_FIXED) | (kind == KIND_LPC)
    is_lpc = kind == KIND_LPC
    is_verb = kind == KIND_VERBATIM
    is_const = kind == KIND_CONSTANT
    # (F, C) uint32 sample mask; the uint32 form is exact at ch_bps == 32
    # (the wide lane) where an int32 1 << 32 would be undefined
    bmask = jnp.uint32(0xFFFFFFFF) >> (32 - ch_bps).astype(jnp.uint32)
    xu = jax.lax.bitcast_convert_type(x, jnp.uint32)

    # ---- layout ----------------------------------------------------------
    frame0 = jnp.asarray(frame0, jnp.int32)
    if frame0.ndim == 0:
        fi = frame0 + jax.lax.broadcasted_iota(jnp.int32, (F, 1), 0)[:, 0]
    else:
        fi = frame0  # caller supplied absolute per-frame numbers (F,)
    utf8_v, utf8_l, n_bytes = _utf8_tokens_jnp(fi)
    hdr_bits = 32 + n_bytes * 8 + bs_tail_bits
    body_bits = sf_bits.sum(axis=1)
    raw = hdr_bits + 8 + body_bits
    pad = (-raw) % 8
    frame_bits = raw + pad + 16
    frame_start = jnp.cumsum(frame_bits) - frame_bits
    total_bits = frame_start[-1] + frame_bits[-1]

    sf_excl = jnp.cumsum(sf_bits, axis=1) - sf_bits
    sf_start = (frame_start + hdr_bits + 8)[:, None] + sf_excl

    lpcmeta = jnp.where(is_lpc, 4 + 5 + order * precision, 0)
    payload_base = jnp.where(is_rice, 8 + order * ch_bps + lpcmeta + 6, 8)
    pbits = 4 + method

    words = jnp.zeros(n_words, jnp.uint32)

    # ---- merged header/meta token stream -----------------------------------
    # Every non-sample token (frame header pieces, UTF-8 frame number,
    # subframe headers, warmups, LPC meta + coefficients, method/po, constant
    # values, Rice partition parameters) is laid out as ONE (F, S) slot array
    # in bitstream order and scattered with a single _scatter_tokens call (2
    # scatter ops) instead of ~14 calls (28 ops, each a full pass over the
    # word buffer).  Dead slots carry length 0 at an offset clamped between
    # their live neighbors, preserving the sorted-scatter promise.
    hdr_const = np.uint32(
        (0b11111111111110 << 18) | (bs_code << 12) | (sr_code << 8) | (bps_code << 1)
    )
    hdr32 = hdr_const | (chan_code.astype(jnp.uint32) << jnp.uint32(4))
    # frame-level slots: hdr hi/lo 16-bit pieces (token <= 2 words), 6 UTF-8
    # byte slots (dead ones clamp onto the last emitted byte), optional
    # blocksize tail
    j6 = jax.lax.broadcasted_iota(jnp.int32, (F, 6), 1)
    j6c = jnp.minimum(j6, n_bytes[:, None] - 1)
    frame_v = [hdr32 >> 16, hdr32 & 0xFFFF]
    frame_l = [jnp.full((F,), 16, jnp.int32)] * 2
    frame_o = [frame_start, frame_start + 16]
    frame_v.append(utf8_v)
    frame_l.append(utf8_l)
    frame_o.append(frame_start[:, None] + 32 + j6c * 8)
    if bs_tail_bits:
        frame_v.append(jnp.full((F,), bs_tail_val, jnp.uint32))
        frame_l.append(jnp.full((F,), bs_tail_bits, jnp.int32))
        frame_o.append(frame_start + 32 + n_bytes * 8)

    # per-subframe slots, in bitstream order: header byte, constant value,
    # warmups, LPC precision/shift/coefficients, method/po, partition params
    type_code = jnp.where(
        is_const, 0,
        jnp.where(is_verb, 1,
                  jnp.where(is_lpc, 32 | jnp.maximum(order - 1, 0), 8 | order)),
    )
    j8 = jax.lax.broadcasted_iota(jnp.int32, (F, C, MAX_ORDER_SLOTS), 2)
    j8w = jnp.minimum(j8, jnp.maximum(order - 1, 0)[:, :, None])
    lpc_base = sf_start + 8 + order * ch_bps
    cf_used = (j8 < order[:, :, None]) & is_lpc[:, :, None]
    prec_mask = (jnp.int32(1) << precision) - 1
    is_lpc4 = jnp.where(is_lpc, 4, 0)

    # warmup samples and the constant value ride the SAMPLE token stream
    # (their slots there are otherwise dead) -- 13 fewer header slots per
    # subframe through the XLA scatter
    sub_v = [
        (type_code << 1).astype(jnp.uint32),                 # subframe header
        jnp.where(is_lpc, precision - 1, 0).astype(jnp.uint32),
        jnp.where(is_lpc, shift & 0x1F, 0).astype(jnp.uint32),
        (qcoeffs & prec_mask[:, :, None]).astype(jnp.uint32),
        ((method << 4) | po).astype(jnp.uint32),             # residual meta
    ]
    sub_l = [
        jnp.full((F, C), 8, jnp.int32),
        is_lpc4,
        jnp.where(is_lpc, 5, 0),
        jnp.where(cf_used, precision[:, :, None], 0),
        jnp.where(is_rice, 6, 0),
    ]
    sub_o = [
        sf_start,
        lpc_base,
        lpc_base + is_lpc4,                                   # dead: stay at base
        lpc_base[:, :, None] + jnp.where(is_lpc, 9, 0)[:, :, None]
        + j8w * jnp.where(is_lpc, precision, 0)[:, :, None],
        lpc_base + lpcmeta,
    ]

    # ---- sample tokens ----------------------------------------------------
    # Per-sample Rice parameter WITHOUT a per-lane gather: every partition
    # spans >= N/2^MPO samples, so gather ks once per MICRO-partition (2^MPO
    # fixed-width slices per subframe) and broadcast over the slice: the
    # gather is F*C*2^MPO elements instead of a per-sample (F, C, N)
    # take_along_axis.
    MPO = min(max_partition_order, log2n)
    M = 1 << MPO
    sub = N >> MPO
    mi = jax.lax.broadcasted_iota(jnp.int32, (F, C, M), 2)
    partM = mi >> jnp.maximum(MPO - po, 0)[:, :, None]     # (F, C, M)
    kM = jnp.take_along_axis(ks[:, :, :M], partM, axis=2)
    part = jnp.broadcast_to(partM[:, :, :, None], (F, C, M, sub)).reshape(F, C, N)
    k = jnp.broadcast_to(kM[:, :, :, None], (F, C, M, sub)).reshape(F, C, N)
    i = jax.lax.broadcasted_iota(jnp.int32, (F, C, N), 2)
    ku = k.astype(jnp.uint32)
    z = ((residual.astype(jnp.uint32) << 1) ^ (residual >> 31).astype(jnp.uint32))
    q = (z >> ku).astype(jnp.int32)
    in_resid = i >= order[:, :, None]
    rice_tok = is_rice[:, :, None] & in_resid
    L = jnp.where(
        rice_tok, q + 1 + k, jnp.where(is_verb[:, :, None], ch_bps[:, :, None], 0)
    )
    E = jnp.cumsum(L, axis=-1) - L
    base_off = (
        sf_start[:, :, None]
        + payload_base[:, :, None]
        + jnp.where(rice_tok, pbits[:, :, None] * (part + 1), 0)
        + E
    )
    # rice: terminator + remainder are adjacent -> ONE token per sample
    # (1 << k) | rem with length 1 + k at bit base+q; the q unary zeros
    # before it cost nothing (the buffer starts zeroed).
    # verbatim: bps-bit sample value at base.
    # warmup samples (i < order) and the constant value ride this stream
    # too, in their otherwise-DEAD slots: xu & bmask is already the
    # non-rice token value, their offsets stay monotone (warmups precede
    # the residual payload; the constant sits at base_off), and the merged
    # header stream below shrinks by 13 scatter slots per subframe.
    is_wu = is_rice[:, :, None] & ~in_resid
    live_c0 = is_const[:, :, None] & (i == 0)
    rem = z & ((jnp.uint32(1) << ku) - jnp.uint32(1))
    tok_v = jnp.where(
        rice_tok,
        (jnp.uint32(1) << ku) | rem,
        xu & bmask[:, :, None],
    )
    tok_l = jnp.where(
        rice_tok, 1 + k,
        jnp.where(
            is_verb[:, :, None] | is_wu | live_c0, ch_bps[:, :, None], 0
        ),
    )
    tok_o = jnp.where(
        rice_tok,
        base_off + q,
        jnp.where(
            is_wu, sf_start[:, :, None] + 8 + i * ch_bps[:, :, None], base_off
        ),
    )

    # rice partition parameter slots (dead slots clamp to the last live one);
    # they interleave with sample tokens in the bitstream but ride the merged
    # header stream -- their offsets stay monotone within the subframe's slot
    # run and below the next subframe's header
    p64 = jax.lax.broadcasted_iota(jnp.int32, (F, C, 64), 2)
    p_used = (p64 < (jnp.int32(1) << po)[:, :, None]) & is_rice[:, :, None]
    pc = jnp.minimum(p64, (jnp.int32(1) << po)[:, :, None] - 1)
    sp = jnp.minimum(pc << (log2n - po)[:, :, None], N - 1)
    Ep = jnp.take_along_axis(E, sp, axis=2)
    k_off = sf_start[:, :, None] + payload_base[:, :, None] + pbits[:, :, None] * pc + Ep
    sub_v.append(ks.astype(jnp.uint32))
    sub_l.append(jnp.where(p_used, pbits[:, :, None], 0))
    sub_o.append(k_off)

    # single merged scatter: frame slots then channel-major subframe slots
    def _slots(pieces, dtype):
        cols = [
            p[:, :, None].astype(dtype) if p.ndim == 2 else p.astype(dtype)
            for p in pieces
        ]
        return jnp.concatenate(cols, axis=2).reshape(F, -1)

    merged_v = jnp.concatenate(
        [
            jnp.concatenate(
                [p[:, None] if p.ndim == 1 else p for p in frame_v], axis=1
            ).astype(jnp.uint32),
            _slots(sub_v, jnp.uint32),
        ],
        axis=1,
    )
    merged_l = jnp.concatenate(
        [
            jnp.concatenate(
                [p[:, None] if p.ndim == 1 else p for p in frame_l], axis=1
            ).astype(jnp.int32),
            _slots(sub_l, jnp.int32),
        ],
        axis=1,
    )
    merged_o = jnp.concatenate(
        [
            jnp.concatenate(
                [p[:, None] if p.ndim == 1 else p for p in frame_o], axis=1
            ).astype(jnp.int32),
            _slots(sub_o, jnp.int32),
        ],
        axis=1,
    )
    words = _scatter_tokens(words, merged_v, merged_l, merged_o)

    words = _scatter_tokens(words, tok_v, tok_l, tok_o)

    return {
        "words": words,
        "frame_bits": frame_bits,
        "total_bits": total_bits,
        # (F, C) exact per-subframe bit counts: the encoder writes these
        # into the FRTP v2 layout block so the device decoder can start
        # every subframe in one batched pass (models/flac_format)
        "subframe_bits": sf_bits,
    }
