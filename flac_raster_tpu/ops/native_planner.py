"""Native host block planner: jitted float analysis + C++ integer search.

The XLA planner (ops/device_codec.plan_blocks) is the right shape for an
accelerator -- one fused program, everything batched -- but on a CPU host the
exact Rice search dominates it (~95% of plan time measured on the dev box)
and XLA:CPU runs it at scalar speed.  This planner splits the work:

  * float stage (apodization, autocorrelation, Levinson-Durbin, coefficient
    quantization, exact int residuals): device_codec.analyze_lpc_windows --
    the SAME traced ops plan_blocks runs, so XLA:CPU produces bit-identical
    coefficients;
  * integer stage (fixed residuals, zigzag, Rice partition search, candidate
    selection): native/plan.cpp, an operation-for-operation replica.

Output is therefore byte-identical to the XLA planner's on CPU
(tests/test_native_planner.py asserts it stream-for-stream), at many times
the throughput.  Used by codec/fast_encoder._default_planner on
single-device hosts whose backend.py entry names the native planner (the
CPU); FRTPU_NATIVE_PLAN=0 disables.

Reference context: this is the libFLAC-C-core role (SURVEY.md §2.2,
reference ``converter.py`` delegating to pyflac/libFLAC) for hosts without
an accelerator.
"""

from __future__ import annotations

import logging

import numpy as np

from .. import native
from .device_codec import (
    MAX_DEVICE_BPS,
    MAX_ORDER_SLOTS,
    analyze_lpc_windows,
)

logger = logging.getLogger("flac_raster_tpu.ops.native_planner")

__all__ = ["make_native_planner"]


def make_native_planner(
    blocksize: int = 4096,
    bps: int = 16,
    max_lpc_order: int = 8,
    max_partition_order: int = 6,
    use_lpc: bool = True,
    apodizations: tuple = ("tukey(0.5)",),
):
    """Native-planner factory with make_planner's signature, or None.

    Returns None when the configuration is out of the native planner's
    range (wide samples, no compiled library) so callers can fall through
    to the XLA planner.
    """
    if bps > MAX_DEVICE_BPS or not native.available():
        return None
    max_po = min(max_partition_order, 6)
    # partition 0 must keep at least one sample after the deepest warmup
    # (same adjustment plan_blocks applies)
    while (blocksize >> max_po) <= max(max_lpc_order, 4):
        max_po -= 1
    precision = 15
    lpc_on = use_lpc and max_lpc_order > 0

    def planner(blocks, bps_arr=None):
        x = np.ascontiguousarray(np.asarray(blocks), dtype=np.int32)
        B, N = x.shape
        assert N == blocksize
        bps_e = (
            np.full(B, bps, np.int32)
            if bps_arr is None
            else np.ascontiguousarray(np.asarray(bps_arr), np.int32)
        )
        lpc = None
        if lpc_on:
            wins = analyze_lpc_windows(
                x, bps_e,
                max_lpc_order=max_lpc_order,
                precision=precision,
                apodizations=tuple(apodizations),
            )
            order_arr = np.stack([np.asarray(w[0]) for w in wins])
            qc = np.stack([np.asarray(w[1]) for w in wins])
            shift = np.stack([np.asarray(w[2]) for w in wins])
            safe = np.stack([np.asarray(w[3]) for w in wins])
            r_lpc = np.stack([np.asarray(w[4]) for w in wins])
            lpc = (r_lpc, order_arr, qc, shift, safe)
        return native.plan_rice(x, bps_e, max_po, lpc, precision,
                                MAX_ORDER_SLOTS)

    return planner
