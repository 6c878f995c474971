"""Benchmark: raster -> FLAC encode throughput (bit-exact, level 5) on one
GPU, with a per-stage breakdown, decode throughput and compression ratio.

Workload: a Sentinel-2-like single-band uint16 terrain raster (BASELINE.md's
headline scene is B04 10980^2 uint16; this uses a synthetic field of the
same statistical character, ``FRTPU_BENCH_SIZE`` pixels per side, default
8192).  The headline metric is the full encode_array path: lossless
normalization -> device block planning + on-device emission -> host CRC
patch + assembly.

Baseline: the reference (single-threaded libFLAC 1.4.3 via pyflac) publishes
no throughput numbers (SURVEY.md §6); 40 MB/s is a representative libFLAC -5
encode rate for 16-bit PCM on one CPU core, used as the fixed denominator.

The bench measures only on a GPU: without one it exits non-zero and prints
no result.  Its one JSON line (the last line of stdout) carries the device
it ran on -- JAX platform, device kind and count, and the card's name and
power limit from nvidia-smi -- beside every number.  Keys:

  value          -- encode_array MB/s (raw bytes / wall time)
  device_mbps    -- scanned plan_and_emit compute only
  upload_mbps / readback_mbps / host_mbps -- the other encode stages
  decode_host_mbps / decode_device_mbps   -- full-stream decode rates
  ratio          -- raw bytes / FLAC bytes
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_MBPS = 40.0
SIZE = int(os.environ.get("FRTPU_BENCH_SIZE", 8192))  # pixels per side


def make_raster(size: int, seed: int = 42) -> np.ndarray:
    """Synthetic terrain: smooth multiscale field + sensor noise, uint16."""
    rng = np.random.default_rng(seed)
    t = np.arange(size, dtype=np.float64)
    x, y = t[None, :], t[:, None]
    field = 8000.0 * np.sin(x / 901.0) * np.cos(y / 677.0)
    # sin((x + y) / 269) as a sum of separable products (no size^2 index grid)
    field += 3000.0 * (
        np.sin(x / 269.0) * np.cos(y / 269.0)
        + np.cos(x / 269.0) * np.sin(y / 269.0)
    )
    field += 500.0 * np.sin(x / 31.0) * np.sin(y / 47.0)
    field += rng.normal(0, 12.0, field.shape)
    field -= field.min()
    return field.astype(np.uint16)


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every visible card."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return r.stdout.strip() or f"nvidia-smi rc={r.returncode}: {r.stderr.strip()}"


def require_gpu() -> dict:
    """The device this process measures on; raises when JAX has no GPU.

    Returns platform, device_kind and device count as JAX reports them,
    plus the nvidia-smi name/power-limit line.
    """
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} ({dev.device_kind})"
        )
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "gpu": gpu_name_and_power_limit(),
    }


def stage_breakdown(samples: np.ndarray) -> dict:
    """Time the encode stages separately on the SAME chunking the production
    device-resident encoder uses (codec/device_encoder): upload, device
    compute, readback, host."""
    import jax
    import jax.numpy as jnp

    from flac_raster_tpu.codec.device_encoder import (
        _PAGE_WORDS,
        _patch_crcs,
        _plan_emit_scan,
        _pull_pages,
        _utf8_nbytes,
        emit_static_kwargs,
    )
    from flac_raster_tpu.ops.device_emit import worst_case_words

    n, channels = samples.shape
    blocksize, bps, zero_point = 4096, 16, 32768
    static_kw = emit_static_kwargs(channels, bps, 5, blocksize, 44100)
    bs_tail_bits = static_kw["bs_tail_bits"]
    chunk = 2048
    n_full = n // blocksize
    n_words = worst_case_words(chunk, channels, blocksize, bps)
    n_words = ((n_words + _PAGE_WORDS - 1) // _PAGE_WORDS) * _PAGE_WORDS

    bounds = [
        (c0, min(c0 + chunk, n_full)) for c0 in range(0, n_full, chunk)
    ]
    bounds = [(c0, c1) for c0, c1 in bounds if c1 - c0 == chunk]  # full chunks
    if not bounds:
        return {"stage_error": f"raster too small for {chunk}-frame chunking"}

    cap = max(1, int(os.environ.get("FRTPU_DISPATCH_CHUNKS", "8")))
    groups = [bounds[i : i + cap] for i in range(0, len(bounds), cap)]

    def run_group(rows_dev, grp):
        r0, r1 = grp[0][0] * blocksize, grp[-1][1] * blocksize
        return _plan_emit_scan(
            rows_dev[r0:r1],
            jnp.asarray([c0 for c0, _ in grp], jnp.int32),
            K=len(grp), F=chunk, N=blocksize, C=channels, n_words=n_words,
            zero_point=zero_point, **static_kw,
        )

    rows_host = samples[: n_full * blocksize]  # (frames*N, C) raw uint16

    # warm every distinct group size
    rows_dev = jax.block_until_ready(jax.device_put(rows_host))
    for K in sorted({len(g) for g in groups}):
        jax.block_until_ready(run_group(rows_dev, groups[0][:K]))
    del rows_dev

    raw_mb = len(bounds) * chunk * blocksize * channels * 2 / 1e6

    t0 = time.perf_counter()
    rows_dev = jax.block_until_ready(jax.device_put(rows_host))
    t_upload = time.perf_counter() - t0

    t0 = time.perf_counter()
    gouts = jax.block_until_ready([run_group(rows_dev, g) for g in groups])
    t_device = time.perf_counter() - t0
    outs = [(o, j) for g, o in zip(groups, gouts) for j in range(len(g))]

    t0 = time.perf_counter()
    pulled = []
    comp_bytes = 0
    for o, j in outs:
        fb = np.asarray(o["frame_bits"][j])
        used_words = (int(fb.sum()) + 31) // 32
        used_pages = (used_words + _PAGE_WORDS - 1) // _PAGE_WORDS
        p2 = _pull_pages(used_pages, o["words"].shape[-1] // _PAGE_WORDS)
        pulled.append((np.asarray(o["words"][j, : p2 * _PAGE_WORDS]), fb))
        comp_bytes += used_words * 4
    t_readback = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i, (w, fb) in enumerate(pulled):
        n_bytes = (int(fb.sum()) + 7) // 8
        buf = np.frombuffer(w.astype(">u4", copy=False).tobytes(), np.uint8)[
            :n_bytes
        ].copy()
        fi = np.arange(bounds[i][0], bounds[i][1])
        hdr_bits = 32 + _utf8_nbytes(fi) * 8 + bs_tail_bits
        _patch_crcs(buf, fb.astype(np.int64), hdr_bits.astype(np.int64))
    t_host = time.perf_counter() - t0

    return {
        "upload_mbps": raw_mb / t_upload,
        "device_mbps": raw_mb / t_device,
        "readback_mbps": raw_mb / t_readback,
        "host_mbps": raw_mb / t_host,
        "compressed_mb": comp_bytes / 1e6,
    }


def main() -> int:
    import jax

    from flac_raster_tpu.backend import enable_compile_cache

    enable_compile_cache()
    try:
        device = require_gpu()
    except RuntimeError as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    print(f"bench device: {device}", file=sys.stderr)

    from flac_raster_tpu.codec.decoder import decode_flac
    from flac_raster_tpu.codec.device_decoder import decode_flac_device
    from flac_raster_tpu.converter import RasterFLACConverter

    conv = RasterFLACConverter(lossless=True, compute_md5=False)
    data = make_raster(SIZE)[None]
    raw_mb = data.nbytes / 1e6
    # warmups: one full-size chunk compiles the executables, then one full
    # pass warms the allocator; the timed pass measures steady state
    conv.encode_array(data[:, :, : (2048 * 4096) // SIZE])
    conv.encode_array(data)

    t0 = time.perf_counter()
    blob = conv.encode_array(data)
    dt = time.perf_counter() - t0

    # bit-exact round-trip gate: a fast-but-wrong encode must not score
    back, _ = conv.decode_bytes(blob)
    if back.dtype != data.dtype or not np.array_equal(back, data):
        print("bench: encode round-trip failed", file=sys.stderr)
        return 1

    result = {
        "metric": "encode_throughput_uint16_level5",
        "value": raw_mb / dt,
        "unit": "MB/s",
        "vs_baseline": raw_mb / dt / BASELINE_MBPS,
        "ratio": data.nbytes / len(blob),
        "device": device,
    }
    result.update(stage_breakdown(data.reshape(-1, 1)))

    t0 = time.perf_counter()
    host = decode_flac(blob, verify_crc=True)
    result["decode_host_mbps"] = raw_mb / (time.perf_counter() - t0)

    jax.block_until_ready(decode_flac_device(blob, verify_crc=True).samples)
    t0 = time.perf_counter()
    dev = decode_flac_device(blob, verify_crc=True)
    jax.block_until_ready(dev.samples)
    mbps_dev = raw_mb / (time.perf_counter() - t0)
    if dev.engine != "device" or not np.array_equal(
        np.asarray(dev.samples), host.samples
    ):
        print("bench: device decode mismatch vs host", file=sys.stderr)
        return 1
    result["decode_device_mbps"] = mbps_dev
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
