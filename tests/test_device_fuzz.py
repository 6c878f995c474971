"""Hostile-input fuzz for the DEVICE decode lane (VERDICT r4 #4).

The host decoder has had mutation fuzz since round 3 (test_malformed.py);
this module drives the same hostility through ``decode_flac_device``,
asserting the documented contract: the device pipeline never crashes the
process and never returns wrong samples without its err flag having engaged
the host fallback (``ops/device_decode.py`` frame-end check + structure
flags).
libFLAC's decoder is hardened by decades of fuzzing (SURVEY.md §2.2); this
is the device lane's equivalent gate.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from flac_raster_tpu.codec.decoder import decode_flac
from flac_raster_tpu.codec.device_decoder import decode_flac_device
from flac_raster_tpu.codec.fast_encoder import encode_flac_fast

N = 256


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(77)
    n = 3 * N + 50
    L = np.cumsum(rng.integers(-40, 41, n)).astype(np.int32)
    R = (L + rng.integers(-5, 6, n)).astype(np.int32)
    x = np.stack([L, R], axis=1)
    return x, encode_flac_fast(x, 44100, 16, 5, blocksize=N)


def test_device_mutation_fuzz_verified(stream, rng):
    """With CRC+MD5 verification on, every byte-flip mutant either raises
    or returns EXACTLY the original PCM -- wrong samples can never slip
    through the verified path."""
    x, blob0 = stream
    blob = bytearray(blob0)
    n = len(blob)
    n_iter = 120
    for _ in range(n_iter):
        pos = int(rng.integers(0, n))
        old = blob[pos]
        blob[pos] = int(rng.integers(0, 256))
        try:
            dec = decode_flac_device(
                bytes(blob), verify_crc=True, verify_md5=True
            )
        except Exception:
            pass
        else:
            assert np.array_equal(np.asarray(dec.samples), x), pos
        blob[pos] = old


def test_device_mutation_fuzz_differential(stream, rng):
    """With verification OFF, mutants reach the frame parsers themselves.
    Contract: the device pipeline agrees with the host decoder on every
    mutant -- same samples when both succeed (err-flagged lanes fall back
    to the host decoder, so divergence would mean wrong samples WITHOUT
    err), and it may only raise where the host path raises too."""
    x, blob0 = stream
    blob = bytearray(blob0)
    n = len(blob)
    n_iter = 60
    for _ in range(n_iter):
        pos = int(rng.integers(0, n))
        old = blob[pos]
        blob[pos] = int(rng.integers(0, 256))
        host_exc = dev_exc = None
        host = dev = None
        try:
            host = decode_flac(bytes(blob), verify_crc=False).samples
        except Exception as e:  # noqa: BLE001 - any python error is fine
            host_exc = e
        try:
            dev = decode_flac_device(bytes(blob), verify_crc=False).samples
        except Exception as e:  # noqa: BLE001
            dev_exc = e
        if dev_exc is None and host_exc is None:
            assert np.array_equal(np.asarray(dev), host), pos
        elif dev_exc is None and host_exc is not None:
            # the device lane is allowed to be MORE lenient than the host
            # walk (it reads frame positions from the layout index, so a
            # flipped sync/bs/bps header bit the host chokes on is simply
            # never consulted) -- but then the samples must be the true PCM
            assert np.array_equal(np.asarray(dev), x), (pos, host_exc)
        blob[pos] = old


def test_device_truncation_fuzz(stream):
    """Truncated bodies: the layout/body-size check or the err path must
    catch every tail length; no crash, no wrong samples."""
    x, blob0 = stream
    n = len(blob0)
    for cut in range(1, 120, 7):
        try:
            dec = decode_flac_device(blob0[: n - cut], verify_crc=True)
        except Exception:
            continue
        assert np.array_equal(np.asarray(dec.samples), x[: len(np.asarray(dec.samples))])


def test_hostile_layout_head_clip_errs():
    """A hostile subframe start past the frame (here at or past the gathered
    window's tail, where reads clip) must flag err deterministically
    instead of returning misaligned samples: every parse ends after its
    start, so it cannot end on the frame's recorded end."""
    from flac_raster_tpu.ops.device_decode import decode_frames_device

    W = 64
    words = jnp.zeros((4, W), jnp.uint32)
    bit_base = jnp.zeros((4,), jnp.int32)
    frame_end = jnp.full((4,), 32 * 8, jnp.int32)  # a 32-byte frame
    # lanes 1..3: subframe start claims to live at/past the window tail
    sf = jnp.asarray(
        np.array([[40], [W * 32 - 1], [W * 32 + 500], [(W - 16) * 32]], np.int32)
    )
    samples, err = decode_frames_device(
        words, bit_base, sf, frame_end, C=1, bps=16, N=N
    )
    e = np.asarray(err)
    assert e[1] and e[2] and e[3]


def test_hostile_sub_bits_in_stream(stream):
    """Corrupt the FRTP layout block's per-subframe bit table so the device
    decoder's in-graph sf_start lands nowhere valid: the err flag must fire
    and the host fallback must still return the exact PCM (the frames
    themselves are intact)."""
    x, blob0 = stream
    blob = bytearray(blob0)
    i = blob.find(b"FRTP")
    assert i > 0
    # stomp bytes well inside the layout block's tables; headers and frame
    # bytes stay intact, so the host decoder still produces exact PCM
    for j in range(i + 16, i + 40):
        blob[j] = 0xFF
    try:
        dec = decode_flac_device(bytes(blob), verify_crc=False)
    except Exception:
        return  # rejecting outright is fine too
    assert np.array_equal(np.asarray(dec.samples), x)
