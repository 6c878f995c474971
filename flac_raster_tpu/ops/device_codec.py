"""Device-side FLAC block planner: batched predictor + Rice search in JAX.

This is the device compute core of the encoder.  It replaces the per-block
Python search of ``codec/encoder.py:_plan_subframe`` (which itself replaces
libFLAC's sequential ``process()`` loop -- reference ``converter.py:153``,
SURVEY.md §2.2) with one jit-compiled program over a **batch of blocks**:

    plan = make_planner(...)(blocks)       # blocks: (B, 4096) int32

Every FLAC encode decision is made for all B blocks at once:

  * fixed predictors 0-4  -- finite differences, pure elementwise
  * LPC order<=8          -- tukey(0.5)-windowed autocorrelation (9 batched
                             reductions), batched Levinson-Durbin (static
                             8-step recursion), error-feedback coefficient
                             quantization, exact int32 residual
  * Rice parameter search -- per-partition cost table over k in [0, KMAX]
                             at the finest partition order, merged upward
                             (children's costs add) through orders 6..0,
                             for both 4-bit and 5-bit parameter methods
  * subframe-type choice  -- constant / verbatim / fixed / LPC by exact
                             emitted-bit count

The plan's ``subframe_bits`` is *exact*: the vectorized emitter
(codec/fast_encoder.py) lays out the bitstream arithmetically from these
counts, so planner and emitter must agree bit-for-bit (tested).

Integer-safety invariants (all arithmetic is int32 on device; JAX x64 stays
off):

  * samples are required to fit ``bps <= MAX_DEVICE_BPS`` (26): the order-4
    fixed residual is bounded by 16*2^(bps-1) = 2^(bps+3) < 2^31.
  * zigzag uses uint32 wraparound (exact for all int32).
  * Rice cost terms are per-sample token lengths clamped to ``_QCLAMP``;
    a partition/k pair is marked invalid unless every token fits in 64 bits
    ((zmax >> k) + 1 + k <= 64), so all *valid* costs are exact and sums
    stay far below 2^31.
  * the LPC accumulator bound ``sum|qcoef| * max|x| < 2^30`` is checked per
    block (conservative float32 margin) and LPC is disabled for blocks that
    could overflow -- the same blocks libFLAC silently widens to int64 for.

Blocks wider than MAX_DEVICE_BPS bits, partial tail blocks, and streams
shorter than one block take the host planner instead (codec/encoder.py).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "make_planner",
    "plan_blocks",
    "BlockPlan",
    "MAX_DEVICE_BPS",
    "KMAX",
    "KIND_CONSTANT",
    "KIND_VERBATIM",
    "KIND_FIXED",
    "KIND_LPC",
]

MAX_DEVICE_BPS = 26
KMAX = 20              # largest Rice parameter searched on device
# Every emitted Rice token obeys q + 1 + k <= MAX_RICE_TOKEN_BITS (k bumped /
# partition escaped otherwise; shared by all three planners so the encoders
# stay byte-identical).  32 -- rather than FLAC's implicit 2^q freedom --
# lets the device decoder group a guaranteed _GROUP (10) codes per 13-word
# window read (ops/device_decode) and lets every token span at most two
# words in the emit scatter.  Size cost: only partitions whose max quotient
# would exceed the budget pick a larger k; measured parity vs libFLAC -5
# holds.
MAX_RICE_TOKEN_BITS = 32
_QCLAMP = 1 << 17      # clamp on per-sample quotient inside cost sums
_BIG = np.int32(1 << 29)

KIND_CONSTANT = 0
KIND_VERBATIM = 1
KIND_FIXED = 2
KIND_LPC = 3

MAX_ORDER_SLOTS = 12   # warmup/coeff array width in the plan (levels 7-8)
PART_SLOTS = 64        # ks array width (max partition order 6 -> 64 parts)

def _tukey_window(n: int, alpha: float = 0.5) -> np.ndarray:
    """Host-precomputed tukey window (float32 constant on device)."""
    if n == 1:
        return np.ones(1, np.float32)
    t = np.linspace(0.0, 1.0, n)
    w = np.ones(n)
    edge = alpha / 2.0
    lo = t < edge
    hi = t >= 1.0 - edge
    w[lo] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * t[lo] / alpha - 1.0)))
    w[hi] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * t[hi] / alpha - 2.0 / alpha + 1.0)))
    return w.astype(np.float32)


def apodization_window(name: str, n: int) -> np.ndarray:
    """Resolve an apodization spec string to a host float32 window.

    Supported: ``tukey(ALPHA)`` (libFLAC's default family, reference preset
    table ``sonos-pyflac.txt:6910-6937``), ``welch``, ``hann``.
    """
    if name.startswith("tukey(") and name.endswith(")"):
        return _tukey_window(n, float(name[6:-1]))
    if name == "welch":
        t = np.linspace(-1.0, 1.0, n)
        return (1.0 - t * t).astype(np.float32)
    if name == "hann":
        return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / max(n - 1, 1))).astype(
            np.float32
        )
    raise ValueError(f"unknown apodization {name!r}")


def _zigzag_u32(r):
    """Signed int32 residual -> uint32 zigzag (wraparound-exact)."""
    u = r.astype(jnp.uint32)
    return (u << jnp.uint32(1)) ^ (r >> 31).astype(jnp.uint32)


def _fixed_residuals(x):
    """All fixed-order residuals of a block batch.

    Args:
        x: (B, N) int32.
    Returns:
        list of 5 arrays (B, N) int32; entry o is Delta^o x with positions
        i < o containing garbage (masked downstream).
    """
    rs = [x]
    r = x
    for _ in range(4):
        prev = jnp.concatenate([jnp.zeros_like(r[:, :1]), r[:, :-1]], axis=1)
        r = r - prev
        rs.append(r)
    return rs


def _rice_search(z, order, blocksize, max_po, idx):
    """Exact best (method, partition order, ks, payload_bits) per block.

    Args:
        z: (B, N) uint32 zigzag residuals; positions < order are garbage.
        order: static predictor order (0..8) -- excluded from partition 0.
        blocksize: static N (must be divisible by 2**max_po).
        max_po: static max partition order (<= 6 here).
        idx: (N,) int32 iota, passed in to share across candidates.

    Returns:
        method (B,) int32 in {0,1}; po (B,) int32; ks (B, 64) int32 (slots
        past 2**po are zero); payload_bits (B,) int32 = partition-parameter
        bits + all Rice token bits (excluding the 2+4 residual-coding-method
        header, which the caller adds); valid (B,) bool.
    """
    B = z.shape[0]
    parts = 1 << max_po
    base = blocksize >> max_po
    # ``order`` may be a static int or a per-block (B,) array (dynamic LPC
    # order selection); normalize to a broadcastable column.
    order_col = jnp.asarray(order, jnp.int32).reshape(-1, 1)
    mask = idx[None, :] >= order_col
    z = jnp.where(mask, z, jnp.uint32(0))

    zr = z.reshape(B, parts, base)
    zmax = zr.max(axis=-1)  # (B, parts) uint32 (unsigned: z may exceed 2^31)
    # Per-partition sample counts (partition 0 loses the warmup samples).
    part_iota = jax.lax.broadcasted_iota(jnp.int32, (1, parts), 1)
    counts_l = jnp.where(part_iota == 0, base - order_col, base)  # (B|1, parts)

    ks = np.arange(KMAX + 1, dtype=np.int32)
    # cost[b, k, p] = sum over partition of min(z >> k, QCLAMP) + cnt*(k+1);
    # the KMAX+1 shifted sums all read the one (B, parts, base) tensor
    sums = []
    for k in range(KMAX + 1):
        # clamp in uint32 first: values can exceed int32 range
        q = jnp.minimum(zr >> jnp.uint32(k), jnp.uint32(_QCLAMP)).astype(jnp.int32)
        sums.append(q.sum(axis=-1))
    cost = jnp.stack(sums, axis=1)  # (B, K+1, parts)
    cost = cost + counts_l[:, None, :] * (jnp.asarray(ks)[None, :, None] + 1)
    # validity: every token in the partition fits MAX_RICE_TOKEN_BITS (uint32
    # math -- zmax can exceed int32 range for wide LPC residuals)
    ks_u = jnp.asarray(ks.astype(np.uint32))
    vmask = (zmax[:, None, :] >> ks_u[None, :, None]) + jnp.uint32(1) + ks_u[None, :, None] <= jnp.uint32(MAX_RICE_TOKEN_BITS)
    cost = jnp.where(vmask, cost, _BIG)

    totals = []   # (B,) per (level, method)
    ks_sel = []   # (B, 64) per (level, method)
    lvl_cost = cost
    po = max_po
    while True:
        nparts = 1 << po
        for pbits, kcap in ((4, 14), (5, KMAX)):
            c = lvl_cost[:, : kcap + 1, :]
            best_k = jnp.argmin(c, axis=1).astype(jnp.int32)        # (B, nparts)
            best_c = jnp.min(c, axis=1)                             # (B, nparts)
            total = best_c.sum(axis=1) + pbits * nparts
            # invalid if any partition had no representable k
            bad = (best_c >= _BIG).any(axis=1)
            total = jnp.where(bad, _BIG, total).astype(jnp.int32)
            kpad = jnp.zeros((B, PART_SLOTS), jnp.int32)
            kpad = kpad.at[:, :nparts].set(best_k)
            totals.append(total)
            ks_sel.append(kpad)
        if po == 0:
            break
        # clamp so chains of invalid (_BIG) partitions cannot overflow int32
        lvl_cost = jnp.minimum(lvl_cost[:, :, 0::2] + lvl_cost[:, :, 1::2], _BIG)
        po -= 1

    tot = jnp.stack(totals, axis=1)           # (B, n_opts)
    choice = jnp.argmin(tot, axis=1)          # (B,)
    best_total = jnp.take_along_axis(tot, choice[:, None], axis=1)[:, 0]
    ks_all = jnp.stack(ks_sel, axis=1)        # (B, n_opts, 64)
    ks_best = jnp.take_along_axis(ks_all, choice[:, None, None], axis=1)[:, 0]
    # option i: level l = max_po - i//2, method = i % 2
    method = (choice % 2).astype(jnp.int32)
    po_best = (max_po - choice // 2).astype(jnp.int32)
    valid = best_total < _BIG
    return method, po_best, ks_best, best_total, valid


def _levinson(r):
    """Batched Levinson-Durbin for a fixed order.

    Args:
        r: (B, order+1) float32 autocorrelation.
    Returns:
        (B, order) float32 LPC coefficients (a[j] multiplies x[i-1-j]).
    """
    return _levinson_all(r)[0][:, -1, :]


def _levinson_all(r):
    """Batched Levinson-Durbin keeping every intermediate order.

    Args:
        r: (B, order+1) float32 autocorrelation.
    Returns:
        coeffs_all (B, order, order) float32 -- row i holds the order-(i+1)
        coefficients zero-padded to ``order`` taps;
        errs (B, order) float32 -- prediction error after each order.
    """
    B, om1 = r.shape
    order = om1 - 1
    a = jnp.zeros((B, order), jnp.float32)
    err = r[:, 0]
    rows, errs = [], []
    for i in range(order):
        # acc = r[i+1] - sum_{j<i} a[j] * r[i-j]
        if i:
            acc = r[:, i + 1] - jnp.sum(a[:, :i] * r[:, i:0:-1], axis=1)
        else:
            acc = r[:, i + 1]
        k = jnp.where(err > 0, acc / jnp.where(err > 0, err, 1.0), 0.0)
        new_a = a[:, :i] - k[:, None] * a[:, i - 1 :: -1] if i else a[:, :0]
        a = a.at[:, :i].set(new_a)
        a = a.at[:, i].set(k)
        err = err * (1.0 - k * k)
        rows.append(a)
        errs.append(err)
    return jnp.stack(rows, axis=1), jnp.stack(errs, axis=1)


def _quantize_coeffs(coeffs, precision):
    """Batched error-feedback quantization (mirrors ops/lpc.py semantics).

    Args:
        coeffs: (B, order) float32.
        precision: static int.
    Returns:
        (qcoeffs (B, order) int32, shift (B,) int32)
    """
    order = coeffs.shape[1]
    cmax = jnp.max(jnp.abs(coeffs), axis=1)
    safe_cmax = jnp.where(cmax > 0, cmax, 1.0)
    headroom = precision - 1 - jnp.floor(jnp.log2(safe_cmax)).astype(jnp.int32) - 1
    shift = jnp.clip(headroom, 0, 15)
    shift = jnp.where(cmax > 0, shift, 0).astype(jnp.int32)
    scale = jnp.exp2(shift.astype(jnp.float32))
    qmax = (1 << (precision - 1)) - 1
    qmin = -(1 << (precision - 1))
    q = []
    err = jnp.zeros(coeffs.shape[0], jnp.float32)
    for j in range(order):
        val = coeffs[:, j] * scale + err
        qj = jnp.clip(jnp.round(val), qmin, qmax).astype(jnp.int32)
        err = val - qj.astype(jnp.float32)
        q.append(qj)
    return jnp.stack(q, axis=1), shift


def _lpc_residual(x, qc, shift, order):
    """Exact int32 LPC residual r[i] = x[i] - ((sum_j qc[j]*x[i-1-j]) >> shift).

    Positions i < order contain garbage (masked downstream).  Caller must
    have verified the no-overflow bound.
    """
    acc = jnp.zeros_like(x)
    for j in range(order):
        xl = jnp.concatenate(
            [jnp.zeros_like(x[:, : j + 1]), x[:, : x.shape[1] - j - 1]], axis=1
        )
        acc = acc + qc[:, j : j + 1] * xl
    pred = acc >> shift[:, None]
    return x - pred


def _lpc_analyze(x, bps_e, order, precision, wname):
    """Float stage of one LPC window candidate (apodize -> autocorr ->
    Levinson -> estimated-order pick -> quantize -> exact int residual).

    Shared verbatim by plan_blocks and the native host planner
    (ops/native_planner): both trace the SAME ops so XLA:CPU produces
    bit-identical coefficients either way, keeping the integer remainder
    of the plan -- and therefore the emitted bytes -- byte-identical.

    Args:
        x: (B, N) int32 blocks.
        bps_e: (B,) int32 effective bit depths.
        order: static max LPC order.
        precision: static coefficient precision (15).
        wname: apodization window spec string.
    Returns:
        (order_arr (B,) int32, qc (B, order) int32, shift (B,) int32,
         lpc_safe (B,) bool, r_lpc (B, N) int32)
    """
    B, N = x.shape
    w = jnp.asarray(apodization_window(wname, N))
    xf = x.astype(jnp.float32) * w[None, :]
    rlags = [jnp.sum(xf * xf, axis=1)]
    for lag in range(1, order + 1):
        rlags.append(jnp.sum(xf[:, lag:] * xf[:, : N - lag], axis=1))
    rr = jnp.stack(rlags, axis=1)
    coeffs_all, errs = _levinson_all(rr)           # (B, M, M), (B, M)
    # order choice by estimated bits: (n-o) * 0.5*log2(err/n) header-adjusted
    o_f = jnp.arange(1, order + 1, dtype=jnp.float32)[None, :]
    bits_per_res = jnp.maximum(
        0.5 * jnp.log2(jnp.maximum(errs, 1e-9) / float(N)), 0.0
    )
    est = (float(N) - o_f) * bits_per_res + o_f * (
        bps_e.astype(jnp.float32)[:, None] + float(precision)
    )
    best_o = jnp.argmin(est, axis=1)               # (B,) 0-based
    order_arr = (best_o + 1).astype(jnp.int32)
    coeffs = jnp.take_along_axis(
        coeffs_all, best_o[:, None, None], axis=1
    )[:, 0]                                        # (B, M), zero-padded
    qc, shift = _quantize_coeffs(coeffs, precision)
    # error-feedback rounding can leak into padded taps; hard-zero them so
    # the emitted coefficients and the residual convolution agree exactly
    tap = jax.lax.broadcasted_iota(jnp.int32, qc.shape, 1)
    qc = jnp.where(tap < order_arr[:, None], qc, 0)
    # conservative int32-overflow guard (see module docstring)
    abs_sum = jnp.sum(jnp.abs(qc).astype(jnp.float32), axis=1)
    max_abs_x = jnp.max(jnp.abs(x), axis=1).astype(jnp.float32)
    lpc_safe = (abs_sum * max_abs_x) * 1.001 < float(1 << 30)
    lpc_safe = lpc_safe & (jnp.max(jnp.abs(qc), axis=1) > 0)
    # M-tap convolution with zero coefficients beyond order_arr computes
    # the exact order_arr-tap residual for every i >= order_arr
    r_lpc = _lpc_residual(x, qc, shift, order)
    return order_arr, qc, shift, lpc_safe, r_lpc


@functools.partial(
    jax.jit, static_argnames=("max_lpc_order", "precision", "apodizations")
)
def analyze_lpc_windows(
    blocks,
    bps_arr,
    *,
    max_lpc_order: int,
    precision: int = 15,
    apodizations: tuple = ("tukey(0.5)",),
):
    """Jitted float analysis for every apodization window (native-plan path).

    Returns a tuple of per-window ``_lpc_analyze`` tuples; the integer Rice
    search / candidate selection that plan_blocks would do next runs in
    native C++ instead (native/plan.cpp via ops/native_planner).
    """
    x = blocks.astype(jnp.int32)
    bps_e = jnp.asarray(bps_arr, jnp.int32)
    return tuple(
        _lpc_analyze(x, bps_e, max_lpc_order, precision, w)
        for w in apodizations
    )


BlockPlan = dict  # plain-dict pytree; keys documented in plan_blocks


@functools.partial(
    jax.jit,
    static_argnames=(
        "blocksize", "bps", "max_lpc_order", "max_partition_order", "use_lpc",
        "apodizations",
    ),
)
def plan_blocks(
    blocks,
    bps_arr=None,
    *,
    blocksize: int = 4096,
    bps: int = 16,
    max_lpc_order: int = 8,
    max_partition_order: int = 6,
    use_lpc: bool = True,
    apodizations: tuple = ("tukey(0.5)",),
):
    """Plan FLAC subframes for a batch of full blocks.

    Args:
        blocks: (B, blocksize) int32 samples, |x| < 2**(bps-1), bps <= 26.
        bps_arr: optional (B,) int32 per-block bit depth for the bit
            accounting (mid-side streams mix bps and bps+1 subframes --
            side channels carry one extra bit, reference preset behavior
            ``sonos-pyflac.txt:6910-6937``).  ``bps`` must be an upper
            bound; the search itself is depth-independent.

    Returns:
        BlockPlan pytree of int32 arrays:
          kind (B,)            0=constant 1=verbatim 2=fixed 3=lpc
          order (B,)
          method (B,), po (B,), ks (B, 64)
          precision (B,), shift (B,), qcoeffs (B, 8)
          residual (B, blocksize)   (positions < order are zeroed)
          subframe_bits (B,)        exact emitted size incl. 8-bit header
          const_value (B,)
    """
    if bps > MAX_DEVICE_BPS:
        raise ValueError(f"device planner supports bps <= {MAX_DEVICE_BPS}")
    # partition 0 must keep at least one sample after the deepest warmup
    while (blocksize >> max_partition_order) <= max(max_lpc_order, 4):
        max_partition_order -= 1
    x = blocks.astype(jnp.int32)
    B, N = x.shape
    assert N == blocksize
    idx = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0)[:, 0]
    bps_e = (
        jnp.full((B,), bps, jnp.int32)
        if bps_arr is None
        else jnp.asarray(bps_arr, jnp.int32)
    )

    # --- constant / verbatim -------------------------------------------------
    is_const = jnp.all(x == x[:, :1], axis=1)
    verbatim_bits = (8 + N * bps_e).astype(jnp.int32)

    # --- fixed orders 0..4 ---------------------------------------------------
    fixed_rs = _fixed_residuals(x)

    # --- LPC float stage first (estimated-best order, libFLAC level-5
    # style); levels 7-8 additionally search several apodization windows
    # and keep the cheapest (reference preset column -A,
    # ``sonos-pyflac.txt:6910-6937``).  The rice search for these
    # candidates happens in the batched call below. --------------------------
    order = max_lpc_order
    precision = 15
    if use_lpc and order > 0:
        lpc_float = [
            _lpc_analyze(x, bps_e, order, precision, wname)
            for wname in apodizations
        ]
    else:
        lpc_float = []

    # --- ONE rice search for ALL candidates (5 fixed + one per
    # apodization).  The search is row-independent integer math (exact
    # sums -- no float re-association), so stacking candidates along the
    # batch axis is decision- and byte-identical to searching each
    # separately, but runs ONE cost reduction + ONE level tree instead of
    # 5 + len(apodizations) of each. ------------------------------------------
    n_lpc = len(lpc_float)
    zall = jnp.concatenate(
        [_zigzag_u32(r) for r in fixed_rs]
        + [_zigzag_u32(c[4]) for c in lpc_float],
        axis=0,
    )
    oall = jnp.concatenate(
        [jnp.full((B,), o, jnp.int32) for o in range(5)]
        + [c[0] for c in lpc_float]
    )
    method_a, po_a, ks_a, payload_a, valid_a = _rice_search(
        zall, oall, N, max_partition_order, idx
    )

    def _cand(a, i):
        return a[i * B : (i + 1) * B]

    cand_bits, cand_plan = [], []
    for o in range(5):
        payload, valid = _cand(payload_a, o), _cand(valid_a, o)
        bits = 8 + o * bps_e + 2 + 4 + payload
        bits = jnp.where(valid, bits, _BIG).astype(jnp.int32)
        cand_bits.append(bits)
        cand_plan.append((_cand(method_a, o), _cand(po_a, o), _cand(ks_a, o),
                          fixed_rs[o]))

    def _lpc_candidate(j):
        order_arr, qc, shift, lpc_safe, r_lpc = lpc_float[j]
        method_l = _cand(method_a, 5 + j)
        po_l = _cand(po_a, 5 + j)
        ks_l = _cand(ks_a, 5 + j)
        payload_l = _cand(payload_a, 5 + j)
        valid_l = _cand(valid_a, 5 + j)
        lpc_bits = (
            8 + order_arr * bps_e + 4 + 5 + order_arr * precision + 2 + 4 + payload_l
        )
        lpc_bits = jnp.where(valid_l & lpc_safe, lpc_bits, _BIG).astype(jnp.int32)
        return order_arr, qc, shift, r_lpc, method_l, po_l, ks_l, lpc_bits

    if n_lpc:
        cands = [_lpc_candidate(j) for j in range(n_lpc)]
        order_arr, qc, shift, r_lpc, method_l, po_l, ks_l, lpc_bits = cands[0]
        for cand in cands[1:]:
            o2, q2, s2, r2, m2, p2, k2, b2 = cand
            pick = b2 < lpc_bits
            order_arr = jnp.where(pick, o2, order_arr)
            qc = jnp.where(pick[:, None], q2, qc)
            shift = jnp.where(pick, s2, shift)
            r_lpc = jnp.where(pick[:, None], r2, r_lpc)
            method_l = jnp.where(pick, m2, method_l)
            po_l = jnp.where(pick, p2, po_l)
            ks_l = jnp.where(pick[:, None], k2, ks_l)
            lpc_bits = jnp.where(pick, b2, lpc_bits)
    else:
        order_arr = jnp.zeros((B,), jnp.int32)
        qc = jnp.zeros((B, max(order, 1)), jnp.int32)
        shift = jnp.zeros((B,), jnp.int32)
        r_lpc = jnp.zeros_like(x)
        method_l = po_l = jnp.zeros((B,), jnp.int32)
        ks_l = jnp.zeros((B, PART_SLOTS), jnp.int32)
        lpc_bits = jnp.full((B,), _BIG, jnp.int32)

    # --- choose --------------------------------------------------------------
    all_bits = jnp.stack(cand_bits + [lpc_bits, verbatim_bits], axis=1)  # (B, 7)
    best = jnp.argmin(all_bits, axis=1).astype(jnp.int32)
    best_bits = jnp.take_along_axis(all_bits, best[:, None], axis=1)[:, 0]

    n_fixed = 5
    is_lpc = best == n_fixed
    is_verb = best == n_fixed + 1
    kind = jnp.where(
        is_const,
        KIND_CONSTANT,
        jnp.where(is_verb, KIND_VERBATIM, jnp.where(is_lpc, KIND_LPC, KIND_FIXED)),
    ).astype(jnp.int32)
    order_out = jnp.where(is_lpc, order_arr, jnp.minimum(best, 4)).astype(jnp.int32)
    order_out = jnp.where(is_const | is_verb, 0, order_out)

    # gather per-candidate plan fields with a where-chain (static 6 options)
    method = method_l
    po = po_l
    ks = ks_l
    resid = r_lpc
    for o in range(4, -1, -1):
        m, p, k, r = cand_plan[o]
        pick = best == o
        method = jnp.where(pick, m, method)
        po = jnp.where(pick, p, po)
        ks = jnp.where(pick[:, None], k, ks)
        resid = jnp.where(pick[:, None], r, resid)

    resid = jnp.where((idx[None, :] >= order_out[:, None]), resid, 0)
    bits_out = jnp.where(
        is_const, 8 + bps_e, jnp.where(is_verb, verbatim_bits, best_bits)
    ).astype(jnp.int32)

    qc_pad = jnp.zeros((B, MAX_ORDER_SLOTS), jnp.int32)
    qc_pad = qc_pad.at[:, : qc.shape[1]].set(qc)

    has_resid = (kind == KIND_FIXED) | (kind == KIND_LPC)
    return dict(
        kind=kind,
        order=order_out,
        method=jnp.where(has_resid, method, 0).astype(jnp.int32),
        po=jnp.where(has_resid, po, 0).astype(jnp.int32),
        ks=jnp.where(has_resid[:, None], ks, 0),
        precision=jnp.full((B,), precision, jnp.int32),
        shift=shift.astype(jnp.int32),
        qcoeffs=qc_pad,
        residual=resid,
        subframe_bits=bits_out,
        const_value=x[:, 0],
    )


def make_planner(
    blocksize: int = 4096,
    bps: int = 16,
    max_lpc_order: int = 8,
    max_partition_order: int = 6,
    use_lpc: bool = True,
    apodizations: tuple = ("tukey(0.5)",),
):
    """Bind static config; returns ``fn(blocks, bps_arr=None) -> BlockPlan``."""

    def fn(blocks, bps_arr=None):
        return plan_blocks(
            blocks,
            bps_arr,
            blocksize=blocksize,
            bps=bps,
            max_lpc_order=max_lpc_order,
            max_partition_order=max_partition_order,
            use_lpc=use_lpc,
            apodizations=apodizations,
        )

    return fn
