"""On-device FLAC frame decoding (JAX/XLA): device-resident raster ingest.

Completes the device pipeline's decode half (BASELINE "FLAC encode/decode
core ... reimplemented as [device] kernels").  The reference decodes through
libFLAC on the host and ships raw PCM to the consumer
(``converter.py:181-182``); here the *compressed* stream uploads to device
memory (ratio x smaller than raw) and frames decode in parallel on device.
The decoded tensor STAYS on device for ML consumers.

Design (fixed-blocksize streams carrying the FRTP layout block our encoders
write -- see models/flac_format.serialize_layout_block):

  * frame byte offsets come from the layout index, so a whole chunk of
    frames is gathered into a padded (frames, words) window matrix and
    decoded as one batch -- no sequential stream walk anywhere;
  * subframe start offsets come from the FRTP v2 layout block, so all C
    subframes of all frames parse in ONE batched pass (C*B lanes) -- no
    sequential walk across channels either;
  * Rice residuals: the code chain runs as a ``lax.scan`` over code index
    with all subframes as vector lanes, ``_GROUP`` codes per step served
    by ONE ``_TW``-word gather.  Our planners enforce q + 1 + k <= 32 on
    every Rice token (device_codec.MAX_RICE_TOKEN_BITS; the TOK32 layout
    flag advertises it), so a group of codes is guaranteed to fit the
    register-resident window, which is shifted left between codes with
    elementwise selects; terminators are found with ``lax.clz`` -- no
    per-bit "next one" table, no large intermediate state, and per-lane
    gathers drop to ~1.3 words/code.  A missing terminator within the
    32-bit budget sets the error flag (foreign streams fall back to the
    host decoder);
  * predictor restore is a batched integer IIR ``lax.scan`` over the block
    (fixed orders use constant binomial taps, LPC its quantized taps --
    identical int32 arithmetic to the encoder, whose overflow guard makes
    int32 safe for any stream our encoders produced), unrolled
    ``_IIR_UNROLL`` samples per step;
  * stereo un-decorrelation fuses in; verbatim sample reads are gated
    behind a ``lax.cond`` since verbatim subframes are rare.

Correctness: byte-level frame CRC-16 is verified on HOST over the compressed
bytes (native C table pass -- linear in compressed size), and any in-graph
structural surprise (reserved type, wasted bits, escape partition, oversized
Rice code) sets a per-frame error flag; the caller falls back to the host
decoder when any flag is set, so unsupported-but-valid FLAC still decodes
correctly.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["decode_frames_device", "DEVICE_DECODE_MAX_ORDER"]

DEVICE_DECODE_MAX_ORDER = 12  # matches MAX_ORDER_SLOTS

_TW = 13           # words gathered per Rice scan step (416 bits)
# codes decoded per window: floor((32*_TW - 31) / (5 + 32)) with the TOK32
# cap -- each code consumes at most 5 partition-parameter bits + 32 code
# bits, and up to 31 bits of the gathered window are pre-alignment slack
_GROUP = (32 * _TW - 31) // 37
# samples restored per IIR scan step: a wider unroll halves scan steps at
# the cost of register pressure (trace-time constant; identical output)
_IIR_UNROLL = int(__import__("os").environ.get("FRTPU_IIR_UNROLL", "8"))

# device_decoder must provision at least this much window slack past the
# largest frame: the Rice scan reads _TW words from the word holding the
# current position (the window start is clipped to W - _TW)
_WIN_SLACK_WORDS = _TW + 1

_FIXED_COEFS = np.zeros((5, DEVICE_DECODE_MAX_ORDER), np.int32)
_FIXED_COEFS[1, :1] = [1]
_FIXED_COEFS[2, :2] = [2, -1]
_FIXED_COEFS[3, :3] = [3, -3, 1]
_FIXED_COEFS[4, :4] = [4, -6, 4, -1]


def _take1(mat, idx):
    """Per-lane gather: mat (B, W), idx (B,) -> (B,)."""
    return jnp.take_along_axis(mat, idx[:, None], axis=1)[:, 0]


def _read32(words, pos):
    """32 bits (MSB-first) at bit position ``pos`` in each lane.

    words: (B, W) uint32 big-endian bit buffer; pos (B,) int32.
    Out-of-range positions read clamped words (windows carry slack).
    """
    W = words.shape[1]
    wi = jnp.clip(pos >> 5, 0, W - 2)
    s = (pos & 31).astype(jnp.uint32)
    a = _take1(words, wi)
    b = _take1(words, wi + 1)
    # (b >> (32 - s)) without the undefined shift-by-32: (b >> 1) >> (31 - s)
    return (a << s) | ((b >> jnp.uint32(1)) >> (jnp.uint32(31) - s))


def _read96(words, pos):
    """96 aligned bits at ``pos``: one (B, 4)-word gather -> three uint32.

    Enough for one Rice code (<= 5 param bits + 64 code bits < 96 - 31).
    """
    W = words.shape[1]
    wi = jnp.clip(pos >> 5, 0, W - 4)
    w4 = jnp.take_along_axis(
        words, wi[:, None] + jnp.arange(4, dtype=jnp.int32)[None, :], axis=1
    )
    s = (pos & 31).astype(jnp.uint32)
    t = jnp.uint32(31) - s
    w0, w1, w2, w3 = w4[:, 0], w4[:, 1], w4[:, 2], w4[:, 3]
    a = (w0 << s) | ((w1 >> jnp.uint32(1)) >> t)
    b = (w1 << s) | ((w2 >> jnp.uint32(1)) >> t)
    c = (w2 << s) | ((w3 >> jnp.uint32(1)) >> t)
    return a, b, c


def _read32_2d(words, pos):
    """Vector variant: pos (B, K) -> (B, K) uint32."""
    W = words.shape[1]
    wi = jnp.clip(pos >> 5, 0, W - 2)
    s = (pos & 31).astype(jnp.uint32)
    a = jnp.take_along_axis(words, wi, axis=1)
    b = jnp.take_along_axis(words, wi + 1, axis=1)
    return (a << s) | ((b >> jnp.uint32(1)) >> (jnp.uint32(31) - s))


def _take_bits(v32, nbits):
    """Top ``nbits`` (0..31) of a 32-bit read; nbits may be 0 (-> 0)."""
    nb = jnp.asarray(nbits, jnp.uint32)
    shifted = (v32 >> jnp.uint32(1)) >> (jnp.uint32(31) - jnp.minimum(nb, 31))
    return jnp.where(nb == 0, jnp.uint32(0), shifted)


def _sext(v, nbits):
    """Sign-extend the low ``nbits`` of uint32 v to int32 (nbits >= 1)."""
    nb = jnp.asarray(nbits, jnp.uint32)
    sign = jnp.uint32(1) << (nb - jnp.uint32(1))
    vv = v & ((sign << jnp.uint32(1)) - jnp.uint32(1))
    return ((vv ^ sign).astype(jnp.int32)) - sign.astype(jnp.int32)


def _parse_subframe(words, pos, eb, err, *, N, wide=False):
    """Parse + decode one subframe across all lanes.

    Args:
        words: (B, W) uint32 window bits.
        pos: (B,) int32 bit position of the subframe header.
        eb: (B,) int32 effective bits per sample of this channel slot.
        err: (B,) bool error accumulator.
        wide: static -- the 32-bps lane (ops/wide_codec streams).  eb is
            exactly 32 on every lane (the caller err-flags mid-side frames,
            whose 33-bit side would break TOK32), so sample reads take the
            full 32-bit word, and the predictor restore accumulates in
            (hi, lo) limb pairs (coef * sample products reach ~2^49; the
            narrow path's int32 accumulator stays untouched).  The Rice
            scan itself needs no widening: TOK32 bounds every codable
            zigzag below 2^31 regardless of bps.
    Returns:
        (signal (B, N) int32, end_pos (B,), err)
    """
    B = pos.shape[0]
    M = DEVICE_DECODE_MAX_ORDER

    W = words.shape[1]

    if wide:
        # eb == 32 everywhere: a full-width read IS the sample
        def take_eb(v32, _eb):
            return v32

        def sext_eb(v, _eb):
            return jax.lax.bitcast_convert_type(v, jnp.int32)

    else:
        take_eb = _take_bits
        sext_eb = _sext

    hdr = (_read32(words, pos) >> jnp.uint32(24)).astype(jnp.int32)
    err = err | ((hdr & 1) != 0)  # wasted bits: not emitted by our encoders
    t6 = (hdr >> 1) & 0x3F
    is_const = t6 == 0
    is_verb = t6 == 1
    is_fixed = (t6 >= 8) & (t6 <= 12)
    is_lpc = t6 >= 32
    is_rice = is_fixed | is_lpc
    err = err | ~(is_const | is_verb | is_fixed | is_lpc)
    order = jnp.where(is_fixed, t6 - 8, jnp.where(is_lpc, t6 - 31, 0))
    err = err | (order > M)
    order = jnp.minimum(order, M)
    pos0 = pos + 8

    # ---- constant ----------------------------------------------------------
    const_val = sext_eb(take_eb(_read32(words, pos0), eb), eb)

    # ---- verbatim (rare: gate the (B, N) bit-gather behind a cond) ---------
    iota_n = jax.lax.broadcasted_iota(jnp.int32, (B, N), 1)

    def read_verbatim(_):
        vpos = pos0[:, None] + iota_n * eb[:, None]
        return sext_eb(
            take_eb(_read32_2d(words, vpos), eb[:, None]), eb[:, None]
        )

    verb = jax.lax.cond(
        jnp.any(is_verb),
        read_verbatim,
        lambda _: jnp.zeros((B, N), jnp.int32),
        operand=None,
    )

    # ---- warmups + LPC meta ------------------------------------------------
    iota_m = jax.lax.broadcasted_iota(jnp.int32, (B, M), 1)
    wpos = pos0[:, None] + iota_m * eb[:, None]
    warm = sext_eb(take_eb(_read32_2d(words, wpos), eb[:, None]), eb[:, None])
    warm = jnp.where(iota_m < order[:, None], warm, 0)
    pos_w = pos0 + order * eb

    prec = (_take_bits(_read32(words, pos_w), 4) + 1).astype(jnp.int32)
    shiftv = _sext(_take_bits(_read32(words, pos_w + 4), 5), 5)
    err = err | (is_lpc & ((prec == 16) | (shiftv < 0)))
    qpos = pos_w[:, None] + 9 + iota_m * prec[:, None]
    qcoef = _sext(
        _take_bits(_read32_2d(words, qpos), prec[:, None]), prec[:, None]
    )
    qcoef = jnp.where((iota_m < order[:, None]) & is_lpc[:, None], qcoef, 0)
    lpcmeta = jnp.where(is_lpc, 9 + order * prec, 0)

    coefs = jnp.where(
        is_lpc[:, None],
        qcoef,
        jnp.asarray(_FIXED_COEFS)[jnp.clip(order, 0, 4)],
    )
    shift_eff = jnp.where(is_lpc, shiftv, 0)

    # ---- residual: method/po then the unrolled Rice chain scan -------------
    rpos = pos_w + lpcmeta
    method = (_take_bits(_read32(words, rpos), 2)).astype(jnp.int32)
    po = (_take_bits(_read32(words, rpos + 2), 4)).astype(jnp.int32)
    err = err | (is_rice & (method > 1))
    pbits = 4 + method
    escape = (jnp.int32(1) << pbits) - 1
    log2n = N.bit_length() - 1
    psize_mask = (jnp.int32(1) << (log2n - po)) - 1  # psize = N >> po
    rstart = rpos + 6
    n_codes = N - order

    # Grouped chain scan: ONE bounded-window fetch serves a guaranteed group
    # of consecutive codes.  The TOK32 planner cap
    # (device_codec.MAX_RICE_TOKEN_BITS = 32) bounds each code at 5 param +
    # 32 code = 37 bits, so the group is guaranteed inside the aligned
    # window; the window is then shifted left in registers between codes
    # (elementwise selects/shifts).  Streams violating the cap set the error
    # flag (host-decoder fallback).
    iota_tw = jnp.arange(_TW, dtype=jnp.int32)
    zero_w = jnp.zeros((B,), jnp.uint32)
    n_steps = -(-N // _GROUP)

    def rice_step(carry, j0):
        cpos, k, cerr = carry
        wi = jnp.clip(cpos >> 5, 0, W - _TW)
        win = jnp.take_along_axis(
            words, wi[:, None] + iota_tw[None, :], axis=1
        )
        # pre-align so window bit 0 == cpos
        sh = (cpos & 31).astype(jnp.uint32)
        t31 = jnp.uint32(31) - sh
        w = [
            (win[:, t] << sh) | ((win[:, t + 1] >> jnp.uint32(1)) >> t31)
            for t in range(_TW - 1)
        ]
        outs = []
        for g in range(_GROUP):
            j = j0 + g
            active = is_rice & (j < n_codes)
            boundary = active & ((j == 0) | (((order + j) & psize_mask) == 0))
            pb = jnp.where(boundary, pbits, 0)
            a, b, c = w[0], w[1], w[2]
            k_new = _take_bits(a, pbits).astype(jnp.int32)
            cerr = cerr | (boundary & (k_new == escape))
            k = jnp.where(boundary, k_new, k)
            # consume the (optional) partition parameter (pb <= 5 < 32)
            pbu = pb.astype(jnp.uint32)
            tp = jnp.uint32(31) - pbu
            a, b = (
                (a << pbu) | ((b >> jnp.uint32(1)) >> tp),
                (b << pbu) | ((c >> jnp.uint32(1)) >> tp),
            )
            q = jnp.where(
                a == 0,
                32 + jax.lax.clz(b).astype(jnp.int32),
                jax.lax.clz(a).astype(jnp.int32),
            )
            cerr = cerr | (active & (q + 1 + k > 32))
            q = jnp.minimum(q, 31)
            # remainder bits [q+1, q+1+k) lie inside (a, b); q+1 <= 32
            s2 = q + 1
            lo = jnp.minimum(s2, 31).astype(jnp.uint32)
            w1 = (a << lo) | ((b >> jnp.uint32(1)) >> (jnp.uint32(31) - lo))
            rem = _take_bits(jnp.where(s2 <= 31, w1, b), k)
            z = (q.astype(jnp.uint32) << k.astype(jnp.uint32)) | rem
            outs.append(jnp.where(active, z, jnp.uint32(0)))
            n_bits = jnp.where(active, pb + q + 1 + k, 0)
            cpos = cpos + n_bits
            if g < _GROUP - 1:
                # shift the window left by n_bits (<= 37: 1 word + 5 bits)
                nw1 = n_bits >= 32
                nb = (n_bits & 31).astype(jnp.uint32)
                tb = jnp.uint32(31) - nb
                L = len(w)

                def gw(i, w=w, L=L):
                    return w[i] if i < L else zero_w

                w = [
                    (jnp.where(nw1, gw(t + 1), gw(t)) << nb)
                    | ((jnp.where(nw1, gw(t + 2), gw(t + 1))
                        >> jnp.uint32(1)) >> tb)
                    for t in range(L)
                ]
        return (cpos, k, cerr), jnp.stack(outs)

    (rend, _, err), zs = jax.lax.scan(
        rice_step,
        (rstart, jnp.zeros(B, jnp.int32), err),
        jnp.arange(n_steps, dtype=jnp.int32) * _GROUP,
    )
    zs = zs.reshape(n_steps * _GROUP, B)[:N].T  # (B, N): code j per lane
    return _finish_subframe(
        zs, order, coefs, shift_eff, warm, is_const, const_val, is_verb,
        verb, iota_n, pos0, eb, rend, err, N=N, M=M, wide=wide,
    )


def _finish_subframe(zs, order, coefs, shift_eff, warm, is_const, const_val,
                     is_verb, verb, iota_n, pos0, eb, rend, err, *, N, M,
                     wide):
    """Shared post-scan tail: residual place, predictor restore, select."""
    B = zs.shape[0]
    # place code j at sample order + j without a per-lane gather:
    # log-doubling on the order's bits -- 4 conditional whole-array shifts
    # (same per-lane total shift, exact)
    zsh = zs
    bit = 1 << (M.bit_length() - 1)
    while bit:
        shifted = jnp.pad(zsh, ((0, 0), (bit, 0)))[:, :N]
        zsh = jnp.where((order[:, None] & bit) != 0, shifted, zsh)
        bit >>= 1
    res = ((zsh >> jnp.uint32(1)).astype(jnp.int32)) ^ -(
        (zsh & jnp.uint32(1)).astype(jnp.int32)
    )
    res = jnp.where(iota_n >= order[:, None], res, 0)

    # ---- predictor restore: batched integer IIR (unrolled) -----------------
    # state lives as M separate (B,) registers: a concat-based (B, M) shift
    # register forces a data copy per sample, the register list is pure SSA
    cs = [coefs[:, m] for m in range(M)]

    def iir_step(carry, inputs):
        w = list(carry)
        res_u, warm_u, i0 = inputs
        xs = []
        for u in range(_IIR_UNROLL):
            if wide:
                # coef * full-int32 sample reaches ~2^49: accumulate the
                # 16/16-split partial products as (hi int32, lo uint32)
                # pairs; pred's low limb is wraparound-exact for the final
                # x = res + pred (x itself fits int32 on valid streams)
                zi = jnp.zeros_like(w[0])
                ah, al = zi, zi.astype(jnp.uint32)
                bh, bl = zi, zi.astype(jnp.uint32)
                for m in range(M):
                    pa = (w[m] >> 16) * cs[m]
                    pb = (w[m] & 0xFFFF) * cs[m]
                    t = al + pa.astype(jnp.uint32)
                    ah, al = ah + (pa >> 31) + (t < al).astype(jnp.int32), t
                    t = bl + pb.astype(jnp.uint32)
                    bh, bl = bh + (pb >> 31) + (t < bl).astype(jnp.int32), t
                # (A << 16) + B, then arithmetic >> shift_eff (<= 15)
                ah2 = (ah << 16) | (al >> jnp.uint32(16)).astype(jnp.int32)
                al2 = al << jnp.uint32(16)
                sl = al2 + bl
                sh = ah2 + bh + (sl < al2).astype(jnp.int32)
                su = shift_eff.astype(jnp.uint32)
                pred = jax.lax.bitcast_convert_type(
                    (sl >> su)
                    | ((sh.astype(jnp.uint32) << jnp.uint32(1))
                       << (jnp.uint32(31) - su)),
                    jnp.int32,
                )
            else:
                acc = w[0] * cs[0]
                for m in range(1, M):
                    acc = acc + w[m] * cs[m]
                pred = acc >> shift_eff
            x_i = jnp.where(i0 + u < order, warm_u[u], res_u[u] + pred)
            w = [x_i] + w[:-1]
            xs.append(x_i)
        return tuple(w), jnp.stack(xs)

    n_pad = -(-N // _IIR_UNROLL)
    Np = n_pad * _IIR_UNROLL
    res_t = jnp.pad(res.T, ((0, Np - N), (0, 0))).reshape(n_pad, _IIR_UNROLL, B)
    warm_t = jnp.pad(warm.T, ((0, Np - M), (0, 0))).reshape(n_pad, _IIR_UNROLL, B)
    _, xs = jax.lax.scan(
        iir_step,
        tuple(jnp.zeros((B,), jnp.int32) for _ in range(M)),
        (res_t, warm_t, jnp.arange(n_pad, dtype=jnp.int32) * _IIR_UNROLL),
    )
    sig_rice = xs.reshape(Np, B)[:N].T  # (B, N)

    sig = jnp.where(
        is_const[:, None],
        const_val[:, None],
        jnp.where(is_verb[:, None], verb, sig_rice),
    )
    end = jnp.where(
        is_const,
        pos0 + eb,
        jnp.where(is_verb, pos0 + N * eb, rend),
    )
    return sig, end, err


@functools.partial(jax.jit, static_argnames=("C", "bps", "N"))
def decode_frames_device(
    windows, bit_base, sf_start, frame_end=None, *, C: int, bps: int, N: int,
):
    """Decode a batch of full FLAC frames on device.

    All C subframes of all B frames parse in ONE batched pass (C*B lanes):
    the per-subframe start offsets come from the FRTP v2 layout block, so
    no sequential walk across channels is needed.

    Args:
        windows: (B, W) uint32 -- each row one frame's bytes as big-endian
            words, starting at the word CONTAINING the frame's first byte
            (W must carry >= _WIN_SLACK_WORDS of slack past the largest
            frame), OR (B, maxB) uint8 rows (converted in-graph).
        bit_base: (B,) int32 -- window-local bit offset of the frame start
            ((byte_offset % 4) * 8 for word-gathered windows, 0 for
            byte-aligned uint8 rows).
        sf_start: (B, C) int32 -- window-local bit offset of each subframe:
            column 0 is bit_base + header bits (incl. CRC-8), column c adds
            the layout block's subframe bit lengths.
        C / bps / N: channel count, stream bit depth, blocksize (static).

    Returns:
        samples (B, N, C) int32, err (B,) bool.  err also covers
        subframe-chain mismatches (a parsed subframe not ending where the
        layout index says the next begins).  CRC verification is the
        caller's job (host, over the compressed bytes).
    """
    if windows.dtype == jnp.uint8:
        B, maxB = windows.shape
        wb = windows.reshape(B, maxB // 4, 4).astype(jnp.uint32)
        words = (
            (wb[:, :, 0] << 24) | (wb[:, :, 1] << 16)
            | (wb[:, :, 2] << 8) | wb[:, :, 3]
        )
    else:
        words = windows
    B = words.shape[0]

    wide = bps > 26  # device_codec.MAX_DEVICE_BPS: the 32-bps pair lane
    hdr32 = _read32(words, bit_base)
    chan_code = ((hdr32 >> jnp.uint32(4)) & jnp.uint32(0xF)).astype(jnp.int32)
    err = chan_code > 10
    if C == 2 and not wide:
        side0 = (chan_code == 9).astype(jnp.int32)          # right/side
        side1 = ((chan_code == 8) | (chan_code == 10)).astype(jnp.int32)
        ch_bps = jnp.stack([bps + side0, bps + side1])       # (C, B)
        err = err | ((chan_code <= 7) & (chan_code != 1))
    elif C == 2:
        # wide: a mid-side frame's 33-bit side channel cannot appear in our
        # streams (TOK32); foreign ones fall back to the host decoder
        ch_bps = jnp.full((C, B), bps, jnp.int32)
        err = err | (chan_code != 1)
    else:
        ch_bps = jnp.full((C, B), bps, jnp.int32)
        err = err | (chan_code != C - 1)

    # Frame-boundary validation for the LAST subframe (device-fuzz round 5):
    # the layout index provides the starts of subframes 0..C-1, so the
    # inter-channel chain check below cannot see a length corruption in the
    # final subframe -- the host walk catches it as a lost frame sync at
    # the next frame, and without this check the device lane would return
    # wrong samples with no err.  Frames start byte-aligned in the window,
    # so last_end -> byte pad -> 16-bit CRC must land exactly on the
    # frame's recorded end (bit_base + 8 * layout size).
    def _end_check(e, last_end):
        if frame_end is None:
            return e
        return e | ((((last_end + 7) & ~7) + 16) != frame_end)

    if C == 1:
        sig, end, err = _parse_subframe(
            words, sf_start[:, 0], ch_bps[0], err, N=N,
            wide=wide,
        )
        return sig[:, :, None], _end_check(err, end)

    wordsC = jnp.concatenate([words] * C, axis=0)            # (C*B, W)
    posC = sf_start.T.reshape(C * B)
    ebC = ch_bps.reshape(C * B)
    sigC, endC, errC = _parse_subframe(
        wordsC, posC, ebC, jnp.tile(err, C), N=N,
        wide=wide,
    )
    sigs = sigC.reshape(C, B, N)
    err = errC.reshape(C, B).any(axis=0)
    # chain validation: each subframe must end exactly where the layout
    # index says the next one starts
    ends = endC.reshape(C, B)
    for c in range(C - 1):
        err = err | (ends[c] != sf_start[:, c + 1])
    err = _end_check(err, ends[C - 1])

    if C == 2:
        a, b = sigs[0], sigs[1]
        is_ls = chan_code == 8
        is_rs = chan_code == 9
        is_ms = chan_code == 10
        mid2 = (a << 1) | (b & 1)
        left = jnp.where(
            is_ls[:, None], a,
            jnp.where(is_rs[:, None], b + a,
                      jnp.where(is_ms[:, None], (mid2 + b) >> 1, a)),
        )
        right = jnp.where(
            is_ls[:, None], a - b,
            jnp.where(is_rs[:, None], b,
                      jnp.where(is_ms[:, None], (mid2 - b) >> 1, b)),
        )
        out = jnp.stack([left, right], axis=2)
    else:
        out = jnp.stack([sigs[c] for c in range(C)], axis=2)
    return out, err
