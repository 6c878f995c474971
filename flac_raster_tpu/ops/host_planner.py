"""Vectorized numpy block planner for wide samples (bps > 26).

The device planner (ops/device_codec) is int32-throughout, which caps it at
26-bit samples; 32-bps streams -- the float32/float64 lossless bit-fold modes
and the reference's "24-bit"-really-32-bps minmax mode (SURVEY.md Q2) -- land
here instead.  Same search space, same exact bit accounting, same plan
schema, so codec/fast_encoder's vectorized emitter consumes either planner's
output unchanged; all arithmetic is int64/uint64 numpy.

Byte identity with the device wide planner (ops/wide_codec) on the CPU
mesh: the integer halves agree because integer arithmetic is exact in both
(int64 numpy here, int32 limb pairs there), and the LPC float stage is ONE
shared jitted float32 function (``wide_codec.lpc_qc_f32``) -- the same
discipline that keeps the narrow native planner byte-identical
(ops/native_planner).  ``_lpc_qc`` below runs it on the CPU backend when
one is initialized and on the default backend otherwise (a process whose
JAX_PLATFORMS lists only an accelerator).

Remaining search-space notes (both valid FLAC):
  * Rice parameters search the full 5-bit range (k <= 30) -- wide residuals
    need large k and int64 costs are free on host.
  * LPC needs no overflow guard (int64 accumulator), but candidates whose
    residuals exceed 2^31 are dropped per the FLAC spec's residual bound,
    exactly like the scalar reference encoder (codec/encoder.py).
"""

from __future__ import annotations

import numpy as np

from .device_codec import (
    KIND_CONSTANT,
    KIND_FIXED,
    KIND_LPC,
    KIND_VERBATIM,
    MAX_ORDER_SLOTS,
    MAX_RICE_TOKEN_BITS,
    PART_SLOTS,
)
__all__ = ["plan_blocks_host"]

_KMAX = 30
_QCLAMP = np.uint64(1 << 20)
_BIG = np.int64(1) << 40


def _rice_search_host(z: np.ndarray, order: int, max_po: int):
    """Batched exact Rice search; mirrors device _rice_search in int64.

    Args:
        z: (B, N) uint64 zigzag residuals, positions < order zeroed.
    Returns:
        (method (B,), po (B,), ks (B, 64), payload_bits (B,), valid (B,))
    """
    B, N = z.shape
    parts = 1 << max_po
    base = N >> max_po
    zr = z.reshape(B, parts, base)
    zmax = zr.max(axis=-1)
    counts = np.full(parts, base, np.int64)
    counts[0] = base - order

    ks = np.arange(_KMAX + 1, dtype=np.uint64)
    cost = np.empty((B, _KMAX + 1, parts), np.int64)
    for k in range(_KMAX + 1):
        cost[:, k, :] = np.minimum(zr >> np.uint64(k), _QCLAMP).sum(
            axis=-1, dtype=np.int64
        )
    cost += counts[None, None, :] * (ks.astype(np.int64)[None, :, None] + 1)
    vmask = (zmax[:, None, :] >> ks[None, :, None]) + np.uint64(1) + ks[
        None, :, None
    ] <= np.uint64(MAX_RICE_TOKEN_BITS)
    cost = np.where(vmask, cost, _BIG)

    totals, ks_sel = [], []
    lvl = cost
    po = max_po
    while True:
        nparts = 1 << po
        for pbits, kcap in ((4, 14), (5, _KMAX)):
            c = lvl[:, : kcap + 1, :]
            best_k = c.argmin(axis=1)
            best_c = np.take_along_axis(c, best_k[:, None, :], axis=1)[:, 0, :]
            total = best_c.sum(axis=1) + pbits * nparts
            bad = (best_c >= _BIG).any(axis=1)
            total = np.where(bad, _BIG, total)
            kpad = np.zeros((B, PART_SLOTS), np.int64)
            kpad[:, :nparts] = best_k
            totals.append(total)
            ks_sel.append(kpad)
        if po == 0:
            break
        lvl = np.minimum(lvl[:, :, 0::2] + lvl[:, :, 1::2], _BIG)
        po -= 1

    tot = np.stack(totals, axis=1)
    choice = tot.argmin(axis=1)
    best_total = np.take_along_axis(tot, choice[:, None], axis=1)[:, 0]
    ks_best = np.stack(ks_sel, axis=1)[np.arange(B), choice]
    method = (choice % 2).astype(np.int64)
    po_best = (max_po - choice // 2).astype(np.int64)
    return method, po_best, ks_best, best_total, best_total < _BIG


def plan_blocks_host(
    blocks: np.ndarray,
    bps_arr: np.ndarray | None = None,
    *,
    blocksize: int,
    bps: int,
    max_lpc_order: int = 8,
    max_partition_order: int = 6,
    use_lpc: bool = True,
    apodizations: tuple = ("tukey(0.5)",),
) -> dict:
    """Plan FLAC subframes for a batch of full blocks (host, any bps<=32).

    ``bps_arr`` optionally gives per-block bit depths (mid-side side
    channels are bps+1); ``bps`` stays the nominal upper bound.
    """
    x = np.ascontiguousarray(blocks, dtype=np.int64)
    B, N = x.shape
    assert N == blocksize
    while (blocksize >> max_partition_order) <= max(max_lpc_order, 4):
        max_partition_order -= 1
    res_limit = np.int64(1) << 31
    bps_e = (
        np.full(B, bps, np.int64)
        if bps_arr is None
        else np.asarray(bps_arr, np.int64)
    )

    is_const = (x == x[:, :1]).all(axis=1)
    verbatim_bits = (8 + N * bps_e).astype(np.int64)

    idx = np.arange(N)
    cand_bits, cand_plan = [], []
    r = x
    for order in range(5):
        if order:
            r = np.diff(r, axis=1)
        rp = np.zeros((B, N), np.int64)
        rp[:, order:] = r if order else x
        ok = (np.abs(rp) < res_limit).all(axis=1)
        z = ((rp << 1) ^ (rp >> 63)).astype(np.uint64)
        z[:, :order] = 0
        method, po, kk, payload, valid = _rice_search_host(z, order, max_partition_order)
        bits = 8 + order * bps_e + 2 + 4 + payload
        bits = np.where(valid & ok, bits, _BIG)
        cand_bits.append(bits)
        cand_plan.append((method, po, kk, rp))

    order = max_lpc_order
    precision = 15

    def _lpc_qc(wname: str):
        """Shared float32 LPC stage (see module docstring); CPU-pinned when
        a CPU backend exists so the test mesh gets deterministic bytes."""
        import jax

        from .wide_codec import lpc_qc_f32

        x_f32 = x.astype(np.float32)
        try:
            cpu = jax.devices("cpu")[0]
        except Exception:
            cpu = None
        if cpu is not None:
            with jax.default_device(cpu):
                qc_j, shift_j = lpc_qc_f32(
                    x_f32, order=order, precision=precision, wname=wname
                )
        else:  # pragma: no cover - no CPU backend initialized
            qc_j, shift_j = lpc_qc_f32(
                x_f32, order=order, precision=precision, wname=wname
            )
        return (
            np.asarray(qc_j).astype(np.int64),
            np.asarray(shift_j).astype(np.int64),
        )

    def _lpc_candidate(wname: str):
        qc, shift = _lpc_qc(wname)
        acc = np.zeros((B, N), np.int64)
        for j in range(order):
            acc[:, j + 1 :] += qc[:, j : j + 1] * x[:, : N - j - 1]
        pred = acc >> shift[:, None]
        r_lpc = x - pred
        r_lpc[:, :order] = 0
        lpc_ok = (np.abs(r_lpc) < res_limit).all(axis=1) & (np.abs(qc).max(axis=1) > 0)
        z = ((r_lpc << 1) ^ (r_lpc >> 63)).astype(np.uint64)
        method_l, po_l, ks_l, payload_l, valid_l = _rice_search_host(
            z, order, max_partition_order
        )
        lpc_bits = 8 + order * bps_e + 4 + 5 + order * precision + 2 + 4 + payload_l
        lpc_bits = np.where(valid_l & lpc_ok, lpc_bits, _BIG)
        return qc, shift, r_lpc, method_l, po_l, ks_l, lpc_bits

    if use_lpc and order > 0:
        cands = [_lpc_candidate(w) for w in apodizations]
        qc, shift, r_lpc, method_l, po_l, ks_l, lpc_bits = cands[0]
        for qc2, s2, r2, m2, p2, k2, b2 in cands[1:]:
            pick = b2 < lpc_bits
            qc = np.where(pick[:, None], qc2, qc)
            shift = np.where(pick, s2, shift)
            r_lpc = np.where(pick[:, None], r2, r_lpc)
            method_l = np.where(pick, m2, method_l)
            po_l = np.where(pick, p2, po_l)
            ks_l = np.where(pick[:, None], k2, ks_l)
            lpc_bits = np.where(pick, b2, lpc_bits)
    else:
        qc = np.zeros((B, max(order, 1)), np.int64)
        shift = np.zeros(B, np.int64)
        r_lpc = np.zeros_like(x)
        method_l = po_l = np.zeros(B, np.int64)
        ks_l = np.zeros((B, PART_SLOTS), np.int64)
        lpc_bits = np.full(B, _BIG)

    all_bits = np.stack(cand_bits + [lpc_bits, verbatim_bits], axis=1)
    best = all_bits.argmin(axis=1)
    best_bits = np.take_along_axis(all_bits, best[:, None], axis=1)[:, 0]

    is_lpc = best == 5
    is_verb = best == 6
    kind = np.where(
        is_const, KIND_CONSTANT,
        np.where(is_verb, KIND_VERBATIM, np.where(is_lpc, KIND_LPC, KIND_FIXED)),
    )
    order_out = np.where(is_lpc, order, np.minimum(best, 4))
    order_out = np.where(is_const | is_verb, 0, order_out)

    method, po, kk, resid = method_l, po_l, ks_l, r_lpc
    for o in range(4, -1, -1):
        m, p, k, rr_ = cand_plan[o]
        pick = best == o
        method = np.where(pick, m, method)
        po = np.where(pick, p, po)
        kk = np.where(pick[:, None], k, kk)
        resid = np.where(pick[:, None], rr_, resid)
    resid = np.where(idx[None, :] >= order_out[:, None], resid, 0)
    bits_out = np.where(is_const, 8 + bps_e, np.where(is_verb, verbatim_bits, best_bits))

    has_resid = (kind == KIND_FIXED) | (kind == KIND_LPC)
    qc_pad = np.zeros((B, MAX_ORDER_SLOTS), np.int64)
    qc_pad[:, : qc.shape[1]] = qc
    # residuals are meaningful only on Rice-coded lanes (emitters gate on
    # kind); zeroing the rest keeps the plan int32-exact for the device
    # wide planner's byte-identity contract (verbatim lanes can carry
    # >=2^31 garbage here)
    resid = np.where(has_resid[:, None], resid, 0)
    return dict(
        kind=kind,
        order=order_out,
        method=np.where(has_resid, method, 0),
        po=np.where(has_resid, po, 0),
        ks=np.where(has_resid[:, None], kk, 0),
        precision=np.full(B, precision, np.int64),
        shift=shift,
        qcoeffs=qc_pad,
        residual=resid,
        subframe_bits=bits_out,
        const_value=x[:, 0],
    )
