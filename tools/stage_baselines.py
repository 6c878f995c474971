"""Device-stage baselines on one GPU: the XLA encode and decode steps alone.

    python tools/stage_baselines.py [--reps 10] [--out chiprun_out/stage_baselines.json]

Times, with ``block_until_ready`` and after warm-up:

  * ``plan_and_emit`` on one 2048-frame chunk (8.4 M uint16 samples) -- the
    whole encode device program;
  * ``decode_frames_device`` on one 4096-frame chunk -- the whole decode
    device program.

Each number is the median of ``--reps`` calls.  The JSON report names the
card (nvidia-smi name and power limit) and JAX's device kind.  Exits
non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ENC_FRAMES = 2048
DEC_FRAMES = 4096
N = 4096


def _median_ms(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())  # warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def encode_stage(raster: np.ndarray, reps: int) -> dict:
    import jax
    import jax.numpy as jnp

    from flac_raster_tpu.codec.device_encoder import (
        _PAGE_WORDS,
        emit_static_kwargs,
    )
    from flac_raster_tpu.ops import device_emit

    x = jnp.asarray(
        raster.ravel()[: ENC_FRAMES * N].reshape(ENC_FRAMES, 1, N)
    )
    kw = emit_static_kwargs(1, 16, 5, N, 44100)
    n_words = device_emit.worst_case_words(ENC_FRAMES, 1, N, 16)
    n_words = -(-n_words // _PAGE_WORDS) * _PAGE_WORDS

    def run():
        return device_emit.plan_and_emit(
            x, jnp.int32(0), n_words=n_words, zero_point=32768, **kw
        )

    t0 = time.perf_counter()
    ref = jax.block_until_ready(run())
    compile_s = time.perf_counter() - t0
    raw_mb = ENC_FRAMES * N * 2 / 1e6
    out = {"plan_and_emit_first_call_s": compile_s}

    ms = _median_ms(run, reps)
    out["plan_and_emit_ms"] = ms
    out["plan_and_emit_raw_mbps"] = raw_mb / (ms / 1e3)
    out["compressed_bytes"] = int(np.asarray(ref["total_bits"])) // 8
    return out


def decode_stage(raster: np.ndarray, reps: int) -> dict:
    from flac_raster_tpu.codec.device_decoder import decode_flac_device
    from flac_raster_tpu.codec.device_encoder import encode_flac_device
    from flac_raster_tpu.ops import device_decode

    pcm = (raster.ravel()[: DEC_FRAMES * N].astype(np.int32) - 32768)[:, None]
    blob = encode_flac_device(pcm, 44100, 16, 5, compute_md5=False)

    captured = {}
    orig = device_decode.decode_frames_device

    def capture(*args, **kwargs):
        captured.setdefault("call", (args, kwargs))
        return orig(*args, **kwargs)

    device_decode.decode_frames_device = capture
    try:
        dec = decode_flac_device(blob, chunk_frames=DEC_FRAMES)
    finally:
        device_decode.decode_frames_device = orig
    if dec.engine != "device" or not np.array_equal(np.asarray(dec.samples), pcm):
        raise AssertionError("device decode of the baseline chunk is wrong")
    args, kwargs = captured["call"]
    raw_mb = DEC_FRAMES * N * 2 / 1e6
    out = {"decode_window_words": int(args[0].shape[1])}
    ms = _median_ms(lambda: orig(*args, **kwargs), reps)
    out["decode_ms"] = ms
    out["decode_raw_mbps"] = raw_mb / (ms / 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/stage_baselines.json")
    args = ap.parse_args(argv)

    import jax

    from bench import make_raster, require_gpu
    from flac_raster_tpu.backend import enable_compile_cache

    enable_compile_cache()
    try:
        device = require_gpu()
    except RuntimeError as exc:
        print(f"stage_baselines: {exc}", file=sys.stderr)
        return 2
    raster = make_raster(N)  # 4096 x 4096 = 4096 frames of 4096 samples
    report = {"device": device, "jax": jax.__version__, "reps": args.reps}
    report.update(encode_stage(raster, args.reps))
    report.update(decode_stage(raster, args.reps))
    text = json.dumps(report, indent=1)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
