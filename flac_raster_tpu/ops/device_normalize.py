"""Device-side inverse normalization: decoded PCM -> raster, staying on device.

Completes the device-ingest path end to end: ``codec/device_decoder`` /
``parallel/decode_mesh`` leave int32 PCM on device, and this module applies
the inverse of ``ops/normalization`` THERE, so the consumer receives the
actual raster (original dtype, band-major geometry) without the decoded
tensor ever visiting the host.  The reference always denormalizes on the
host after a libFLAC host decode (``converter.py:181-229``).

Exactness contract (mirrors ``converter._denormalize_samples``):

  * lossless modes are BIT-EXACT to the host inverse and implemented with
    pure integer/bit ops -- shift mode's 32-bit zero points use a uint32
    XOR instead of the host's int64 add (identical values mod 2^32, which
    is exact for the stored dtypes), float32_bits uses the same
    order-preserving fold + bitcast;
  * minmax mode computes in float32 on device (the host uses float64):
    for float rasters the result differs from the host inverse by float32
    rounding; for integer rasters the round-to-nearest can differ by 1
    level in rare ties.  Minmax is the lossy mode by construction -- for
    bit-parity with the host, use the host path;
  * float64_bits (split-channel float64) needs 64-bit integer folds the
    device path (x64 off) doesn't carry -- raises NotImplementedError; callers fall
    back to the host inverse.
"""

from __future__ import annotations

import numpy as np

from .normalization import (
    MODE_FLOAT32_BITS,
    MODE_FLOAT64_BITS,
    MODE_MINMAX,
    MODE_SHIFT,
    NormalizationParams,
)

__all__ = ["denormalize_device", "device_denorm_supported"]


def device_denorm_supported(params: "NormalizationParams | None") -> bool:
    """True when denormalize_device handles this file class (everything but
    the two float64 output paths, which need 64-bit math the device path
    (x64 off) doesn't carry)."""
    if params is None:
        return True
    if params.mode == MODE_FLOAT64_BITS:
        return False
    return np.dtype(params.original_dtype) != np.float64


def denormalize_device(samples, params, *, bits_per_sample: int,
                       soundfile_compat: bool = False):
    """Inverse-normalize device-resident PCM.

    Args:
        samples: (n, C) or (n,) int32 jax.Array (a DecodedStream's samples).
        params: NormalizationParams or None (None = reference-produced file;
            caller must pass the reconstructed params -- see
            converter._denormalize_samples -- with ``soundfile_compat=True``).
        bits_per_sample: the stream's bps (scale selection is dtype-driven
            exactly like the host path, where 16-bps streams view as int16).

    Returns:
        jax.Array of the raster's original dtype (float64 rasters excepted:
        NotImplementedError).
    """
    import jax
    import jax.numpy as jnp

    if params is None:
        raise ValueError("reconstruct params for reference files first")
    x = samples if isinstance(samples, jax.Array) else jnp.asarray(samples)
    dt = np.dtype(params.original_dtype)

    if params.mode == MODE_SHIFT:
        zp = int(params.zero_point)
        if dt.itemsize == 4:
            if dt == np.int32:
                return x  # shift spec (32, 0): stored verbatim
            # uint32: orig = (audio + 2^31) mod 2^32 == bitpattern ^ 2^31
            u = jax.lax.bitcast_convert_type(x, jnp.uint32)
            return u ^ jnp.uint32(zp) if zp else u
        # 8/16-bit dtypes: the shifted values are in-range by construction,
        # so the int32 add + narrowing convert is exact
        return (x + jnp.int32(zp)).astype(_jdt(dt))

    if params.mode == MODE_FLOAT32_BITS:
        u = x.astype(jnp.uint32)
        sign = (u >> jnp.uint32(31)) != 0
        folded = jnp.where(sign, u ^ jnp.uint32((1 << 31) - 1), u)
        return jax.lax.bitcast_convert_type(folded, jnp.float32)

    if params.mode == MODE_FLOAT64_BITS:
        raise NotImplementedError("float64_bits denorm runs on host")

    if params.mode != MODE_MINMAX:
        raise ValueError(f"unknown normalization mode: {params.mode}")

    # ---- minmax (float32 device compute; see module docstring) ------------
    as_i16 = bits_per_sample == 16
    if as_i16:
        x = x.astype(jnp.int16)  # wraps exactly like numpy astype
    if soundfile_compat:
        scale = 32768.0 if as_i16 else 2147483648.0
        if not as_i16 and params.scale_factor == 8388607:
            scale = 2147483648.0
    elif as_i16:
        scale = 32767.0
    else:
        scale = float(params.scale_factor)
    if dt == np.float64:
        raise NotImplementedError("float64 minmax denorm runs on host")
    norm = x.astype(jnp.float32) / jnp.float32(scale)
    rng = float(params.data_max - params.data_min)
    out = (norm + 1.0) * jnp.float32(rng / 2.0) + jnp.float32(params.data_min)
    if np.issubdtype(dt, np.integer):
        return jnp.round(out).astype(_jdt(dt))
    return out.astype(_jdt(dt))


def _jdt(dt: np.dtype):
    import jax.numpy as jnp

    return jnp.dtype(dt)
