"""Device planner (ops/device_codec) and batched encoder (codec/fast_encoder).

Strategy (SURVEY.md §4 rebuild additions): property tests for bit-exact
round-trip per signal class, cross-validation of the batched emitter against
the scalar reference encoder, and exactness checks of every plan field
against the trusted numpy implementations (ops/fixed, ops/lpc).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from flac_raster_tpu.codec.decoder import decode_flac
from flac_raster_tpu.codec.encoder import encode_flac
from flac_raster_tpu.codec.fast_encoder import _utf8_tokens, encode_flac_fast
from flac_raster_tpu.codec.encoder import _utf8_coded_number
from flac_raster_tpu.ops.device_codec import (
    KIND_CONSTANT,
    KIND_FIXED,
    KIND_LPC,
    KIND_VERBATIM,
    plan_blocks,
)
from flac_raster_tpu.ops.fixed import fixed_residual
from flac_raster_tpu.ops.lpc import lpc_residual

N = 4096


def _plan(x, bps=16, **kw):
    plan = plan_blocks(jnp.asarray(x.astype(np.int32)), blocksize=x.shape[1], bps=bps, **kw)
    return {k: np.asarray(v) for k, v in plan.items()}


@pytest.fixture(scope="module")
def mixed_blocks(request):
    rng = np.random.default_rng(0)
    t = np.arange(8 * N)
    x = (1000 * np.sin(t / 300.0) + rng.normal(0, 30, t.size)).astype(np.int32)
    x = x.reshape(8, N)
    x[3, :] = 42                                        # constant
    x[4, :] = rng.integers(-32768, 32768, N)            # incompressible
    x[5, :] = np.arange(N) - 2048                       # perfect ramp (fixed-2)
    return x


class TestPlanner:
    def test_kinds_and_residual_exactness(self, mixed_blocks):
        p = _plan(mixed_blocks)
        assert p["kind"][3] == KIND_CONSTANT
        assert p["kind"][4] == KIND_VERBATIM
        assert p["subframe_bits"][3] == 8 + 16
        assert p["subframe_bits"][4] == 8 + N * 16
        for b in range(8):
            o = int(p["order"][b])
            if p["kind"][b] == KIND_FIXED:
                ref = fixed_residual(mixed_blocks[b].astype(np.int64), o)
                assert np.array_equal(p["residual"][b][o:], ref)
            elif p["kind"][b] == KIND_LPC:
                ref = lpc_residual(
                    mixed_blocks[b].astype(np.int64),
                    p["qcoeffs"][b][:o].astype(np.int64),
                    int(p["shift"][b]),
                )
                assert np.array_equal(p["residual"][b][o:], ref)

    def test_exact_bit_accounting(self, mixed_blocks):
        """subframe_bits must equal the true emitted size, bit for bit."""
        p = _plan(mixed_blocks)
        for b in range(8):
            kind = int(p["kind"][b])
            if kind not in (KIND_FIXED, KIND_LPC):
                continue
            o, po, m = int(p["order"][b]), int(p["po"][b]), int(p["method"][b])
            pbits = 4 + m
            base = N >> po
            r = p["residual"][b].astype(np.int64)
            z = ((r << 1) ^ (r >> 63)).astype(np.uint64)
            total, start = 0, o
            for pp in range(1 << po):
                cnt = base - o if pp == 0 else base
                k = int(p["ks"][b][pp])
                zp = z[start : start + cnt]
                total += cnt * (k + 1) + int((zp >> np.uint64(k)).sum())
                # 64-bit token-length invariant required by the packer
                if zp.size:
                    assert (int(zp.max()) >> k) + 1 + k <= 64
                start += cnt
            expect = 8 + o * 16 + 2 + 4 + pbits * (1 << po) + total
            if kind == KIND_LPC:
                expect += 4 + 5 + o * 15
            assert expect == p["subframe_bits"][b]

    def test_beats_or_matches_verbatim(self, mixed_blocks):
        p = _plan(mixed_blocks)
        assert (p["subframe_bits"] <= 8 + N * 16).all()

    def test_no_lpc_config(self, mixed_blocks):
        p = _plan(mixed_blocks, use_lpc=False)
        assert not (p["kind"] == KIND_LPC).any()

    def test_wide_residuals_24bit(self):
        """Near-full-scale 24-bit alternation: token-length guard must hold."""
        rng = np.random.default_rng(1)
        x = rng.integers(-(1 << 23), 1 << 23, (2, N)).astype(np.int32)
        x[1] = ((np.arange(N) % 2) * 2 - 1) * ((1 << 23) - 1)  # worst-case alternation
        p = _plan(x, bps=24)
        # must still decode: full encode round-trip is the real check
        f = encode_flac_fast(x.reshape(-1, 1)[: 2 * N], 44100, 24, 5)
        dec = decode_flac(f)
        assert np.array_equal(dec.samples[:, 0].astype(np.int64), x.reshape(-1).astype(np.int64))


class TestUtf8Vectorized:
    def test_matches_scalar(self):
        nums = np.array(
            [0, 1, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10000, 0x1FFFFF,
             0x200000, 0x3FFFFFF, 0x4000000, 0x7FFFFFFF]
        )
        vals, lens, nb = _utf8_tokens(nums)
        for i, num in enumerate(nums):
            ref = _utf8_coded_number(int(num))
            got = [(int(vals[i, j]), int(lens[i, j])) for j in range(6) if lens[i, j]]
            assert got == [(v & 0xFF, 8) for v, _ in ref], hex(num)


class TestFastEncoder:
    @pytest.mark.parametrize(
        "name,gen,bps",
        [
            ("dem", lambda rng: (3000 * np.sin(np.arange(3 * N + 1000) / 500.0)
                                 + rng.normal(0, 20, 3 * N + 1000)).astype(np.int16)[:, None], 16),
            ("rgb3", lambda rng: np.cumsum(
                rng.integers(-128, 128, (2 * N + 77, 3)), axis=0
            ).clip(-30000, 30000).astype(np.int16), 16),
            ("const", lambda rng: np.full((2 * N, 1), 1234, np.int16), 16),
            ("tiny", lambda rng: rng.integers(-100, 100, (100, 2)).astype(np.int16), 16),
            ("noise", lambda rng: rng.integers(-32768, 32768, (N, 1)).astype(np.int16), 16),
            ("wide24", lambda rng: np.clip(
                rng.normal(0, 1e5, (2 * N + 5, 2)), -(1 << 23), (1 << 23) - 1
            ).astype(np.int32), 24),
            ("exact_blocks", lambda rng: rng.integers(-500, 500, (2 * N, 1)).astype(np.int16), 16),
        ],
    )
    def test_roundtrip_and_size_parity(self, name, gen, bps):
        rng = np.random.default_rng(7)
        x = gen(rng)
        fast = encode_flac_fast(x, 44100, bps, 5)
        dec = decode_flac(fast)
        assert np.array_equal(dec.samples.astype(np.int64), x.astype(np.int64))
        ref = encode_flac(x, 44100, bps, 5)
        # same search space -> sizes within 2% + small constant of each other
        assert len(fast) <= len(ref) * 1.02 + 256, (name, len(fast), len(ref))

    def test_streaminfo_and_md5(self):
        rng = np.random.default_rng(3)
        x = np.cumsum(rng.integers(-5, 6, (3 * N + 11, 2)), axis=0).astype(np.int16)
        fast = encode_flac_fast(x, 48000, 16, 5)
        dec = decode_flac(fast)
        assert dec.streaminfo.total_samples == x.shape[0]
        assert dec.streaminfo.channels == 2
        from flac_raster_tpu.codec.decoder import md5_of_samples
        assert dec.streaminfo.md5 == md5_of_samples(x.astype(np.int32), 16)

    def test_comments_survive(self):
        x = np.zeros((N, 1), np.int16)
        fast = encode_flac_fast(x, 44100, 16, 5, comments={"GEOSPATIAL_CRS": "EPSG:4326"})
        dec = decode_flac(fast)
        assert dec.comments.get("GEOSPATIAL_CRS") == ["EPSG:4326"]

    def test_compression_levels(self):
        rng = np.random.default_rng(11)
        x = np.cumsum(rng.integers(-8, 9, (2 * N, 1)), axis=0).astype(np.int16)
        sizes = {}
        for level in (0, 5, 8):
            f = encode_flac_fast(x, 44100, 16, level)
            assert np.array_equal(decode_flac(f).samples[:, 0], x[:, 0].astype(np.int32))
            sizes[level] = len(f)
        assert sizes[5] <= sizes[0]


class TestDeviceEncoder:
    """codec/device_encoder: full on-device emission must be byte-identical
    to the host emitter (same planner, same layout arithmetic)."""

    @pytest.mark.parametrize(
        "name,gen,bps",
        [
            ("dem", lambda rng: (3000 * np.sin(np.arange(3 * N + 1000) / 500.0)
                                 + rng.normal(0, 20, 3 * N + 1000)).astype(np.int16)[:, None], 16),
            ("rgb3", lambda rng: np.cumsum(
                rng.integers(-128, 128, (2 * N + 77, 3)), axis=0
            ).clip(-30000, 30000).astype(np.int16), 16),
            ("noise", lambda rng: rng.integers(-32768, 32768, (N, 1)).astype(np.int16), 16),
            ("wide24", lambda rng: np.clip(
                rng.normal(0, 1e5, (2 * N + 5, 2)), -(1 << 23), (1 << 23) - 1
            ).astype(np.int32), 24),
        ],
    )
    def test_byte_identical_to_host_emitter(self, name, gen, bps):
        from flac_raster_tpu.codec.device_encoder import encode_flac_device

        rng = np.random.default_rng(7)
        x = gen(rng)
        dev = encode_flac_device(x, 44100, bps, 5)
        fast = encode_flac_fast(x, 44100, bps, 5)
        assert dev == fast
        dec = decode_flac(dev, verify_crc=True)
        assert np.array_equal(dec.samples.astype(np.int64), x.astype(np.int64))

    def test_scanned_dispatch_byte_identical(self):
        """Device-resident input with >= 2 full chunks rides the scanned
        one-dispatch path (_plan_emit_scan); bytes must equal the host
        emitter and the per-chunk path exactly."""
        import jax

        from flac_raster_tpu.codec.device_encoder import encode_flac_device

        rng = np.random.default_rng(11)
        n = 9 * N + 123  # 2 full 4-frame chunks + partial chunk + tail
        x = (2000 * np.sin(np.arange(n) / 300.0)
             + rng.normal(0, 15, n)).astype(np.int16)[:, None]
        xd = jax.device_put(x.astype(np.int32))
        dev = encode_flac_device(x, 44100, 16, 5, plan_chunk_frames=4)
        scan = encode_flac_device(xd, 44100, 16, 5, plan_chunk_frames=4)
        fast = encode_flac_fast(x, 44100, 16, 5)
        assert scan == fast
        assert dev == fast
        dec = decode_flac(scan, verify_crc=True)
        assert np.array_equal(dec.samples.astype(np.int64), x.astype(np.int64))

    @pytest.mark.parametrize("cap", ["1", "2"])
    def test_scanned_dispatch_group_caps(self, cap, monkeypatch):
        """FRTPU_DISPATCH_CHUNKS grouping edges: cap=1 forces the K==1
        single-dispatch branch for every full chunk; cap=2 over 3 full
        chunks exercises a full group plus a 1-chunk remainder group."""
        import jax

        from flac_raster_tpu.codec.device_encoder import encode_flac_device

        monkeypatch.setenv("FRTPU_DISPATCH_CHUNKS", cap)
        rng = np.random.default_rng(5)
        n = 13 * N  # 3 full 4-frame chunks + one 1-frame partial chunk
        x = (1500 * np.cos(np.arange(n) / 250.0)
             + rng.normal(0, 10, n)).astype(np.int16)[:, None]
        xd = jax.device_put(x.astype(np.int32))
        scan = encode_flac_device(xd, 44100, 16, 5, plan_chunk_frames=4)
        fast = encode_flac_fast(x, 44100, 16, 5)
        assert scan == fast


class TestNativeRuntime:
    def test_pack_parity_with_numpy(self):
        from flac_raster_tpu import native
        from flac_raster_tpu.ops.bitpack import pack_tokens, token_bit_offsets

        if not native.available():
            pytest.skip("no native toolchain")
        rng = np.random.default_rng(0)
        lengths = rng.integers(1, 65, 50000)
        values = rng.integers(0, 2**63, 50000, dtype=np.uint64)
        off, tot = token_bit_offsets(lengths)
        assert pack_tokens(values, lengths, off, tot) == \
            native.pack_tokens_native(values, lengths, off, tot).tobytes()

    def test_crc_patch_parity(self):
        from flac_raster_tpu import native
        from flac_raster_tpu.ops.crc import crc8, crc16

        if not native.available():
            pytest.skip("no native toolchain")
        rng = np.random.default_rng(1)
        buf = rng.integers(0, 256, 5000).astype(np.uint8)
        ref = buf.copy()
        starts = np.array([0, 64, 1000]); lens = np.array([10, 100, 2000])
        native.crc8_patch(buf, starts, lens)
        native.crc16_patch(buf, starts + 2500, lens // 2)
        for s, l in zip(starts, lens):
            assert buf[s + l] == crc8(ref[s:s + l].tobytes())
        for s, l in zip(starts + 2500, lens // 2):
            c = crc16(ref[s:s + l].tobytes())
            assert buf[s + l] == c >> 8 and buf[s + l + 1] == (c & 0xFF)


class TestHostPlannerWideBps:
    """ops/host_planner: the bps>26 (float32/float64/minmax-32bps) fast path."""

    def test_32bps_matches_scalar_encoder_size(self, rng):
        from flac_raster_tpu.codec.fast_encoder import encode_flac_fast

        x = np.cumsum(rng.integers(-100000, 100000, (2 * N + 50, 2)), axis=0)
        x = np.clip(x, -(2**31), 2**31 - 1).astype(np.int32)
        fast = encode_flac_fast(x, 44100, 32, 5)
        dec = decode_flac(fast, verify_crc=True)
        assert np.array_equal(dec.samples.astype(np.int64), x.astype(np.int64))
        ref = encode_flac(x, 44100, 32, 5)
        assert len(fast) <= len(ref) * 1.02 + 256

    def test_float32_and_float64_lossless(self, rng):
        from flac_raster_tpu.converter import RasterFLACConverter

        conv = RasterFLACConverter()
        f32 = rng.normal(0, 100, (1, 128, 160)).astype(np.float32)
        f32[0, 5, 5] = np.nan        # NaN payload must survive bit-exactly
        f32[0, 6, 6] = -np.inf
        blob = conv.encode_array(f32)
        back, _ = conv.decode_bytes(blob)
        assert back.dtype == np.float32
        assert np.array_equal(back.view(np.uint32), f32.view(np.uint32))

        f64 = rng.normal(0, 1, (2, 64, 128)).astype(np.float64)
        blob = conv.encode_array(f64)
        back, _ = conv.decode_bytes(blob)
        assert back.dtype == np.float64
        assert np.array_equal(back.view(np.uint64), f64.view(np.uint64))

    def test_wide_noise_verbatim(self, rng):
        from flac_raster_tpu.codec.fast_encoder import encode_flac_fast

        x = rng.integers(-(2**31), 2**31, (N, 1), dtype=np.int64).astype(np.int32)
        f = encode_flac_fast(x, 44100, 32, 5)
        dec = decode_flac(f)
        assert np.array_equal(dec.samples[:, 0].astype(np.int64), x[:, 0].astype(np.int64))


class TestCompressionParity:
    def test_beats_libflac_on_reference_fixture(self, ref_rgb_flac):
        """BASELINE.json: 'ratio parity with libFLAC level 5'. We encode the
        exact samples libFLAC 1.4.3 encoded in the reference fixture and
        must produce a stream no larger (currently ~1.9% smaller)."""
        blob = ref_rgb_flac.read_bytes()
        dec = decode_flac(blob, verify_crc=True)
        ours = encode_flac_fast(
            dec.samples, dec.streaminfo.sample_rate,
            dec.streaminfo.bits_per_sample, 5,
        )
        # compare frame payloads only (the fixture carries metadata blocks)
        from flac_raster_tpu.models.flac_format import parse_flac_metadata

        _, _, ref_frames_at = parse_flac_metadata(blob)
        _, _, our_frames_at = parse_flac_metadata(ours)
        ref_body = len(blob) - ref_frames_at
        our_body = len(ours) - our_frames_at
        assert our_body <= ref_body, (our_body, ref_body)
        dec2 = decode_flac(ours, verify_crc=True)
        assert np.array_equal(dec2.samples, dec.samples)


class TestPropertyRoundtrip:
    """Randomized property test: decode(encode(x)) == x across the parameter
    space (channels, lengths incl. tails, levels, signal classes, bps)."""

    def test_random_configs(self):
        from flac_raster_tpu.codec.fast_encoder import encode_flac_fast

        rng = np.random.default_rng(2024)
        for trial in range(12):
            channels = int(rng.integers(1, 9))
            n = int(rng.integers(1, 4)) * 4096 + int(rng.integers(0, 4096))
            level = int(rng.integers(0, 9))
            bps = int(rng.choice([8, 16, 24]))
            lim = 1 << (bps - 1)
            kind = trial % 3
            if kind == 0:      # smooth random walk
                x = np.cumsum(rng.integers(-lim // 64, lim // 64, (n, channels)), axis=0)
                x = np.clip(x, -lim, lim - 1)
            elif kind == 1:    # noise
                x = rng.integers(-lim, lim, (n, channels))
            else:              # piecewise constant
                x = np.repeat(
                    rng.integers(-lim, lim, (max(1, n // 97) + 1, channels)),
                    97, axis=0)[:n]
            x = x.astype(np.int64)
            blob = encode_flac_fast(x, 44100, bps, level)
            dec = decode_flac(blob, verify_crc=True)
            assert np.array_equal(dec.samples.astype(np.int64), x), (
                trial, channels, n, level, bps)


class TestPipelinePlumbing:
    """Round-3 review-fix regressions: readback bucketing and the duplex
    upload producer's failure path."""

    def test_pull_pages_bounds(self):
        from flac_raster_tpu.codec.device_encoder import _pull_pages

        for used in range(1, 5000):
            got = _pull_pages(used, 10**9)
            assert used <= got <= max(int(used * 1.25), used + 1), (used, got)
        # exact under 5 pages, clamped by the buffer size
        assert [_pull_pages(u, 10**9) for u in range(1, 5)] == [1, 2, 3, 4]
        assert _pull_pages(65, 70) == 70
        # O(log n) distinct shapes
        assert len({_pull_pages(u, 10**9) for u in range(1, 4097)}) <= 60

    def test_duplex_producer_error_raises_not_hangs(self, monkeypatch):
        """A device_put failure mid-encode (relay death) must surface as an
        exception from encode_flac_device, not leave the main thread parked
        on the upload queue forever."""
        import jax

        from flac_raster_tpu.codec import device_encoder

        monkeypatch.setenv("FRTPU_PIPELINE", "duplex")
        real_put = jax.device_put
        calls = {"n": 0}

        def flaky_put(x, *a, **k):
            calls["n"] += 1
            if calls["n"] >= 3:
                raise RuntimeError("relay died")
            return real_put(x, *a, **k)

        monkeypatch.setattr(jax, "device_put", flaky_put)
        rng = np.random.default_rng(0)
        s = rng.integers(-1000, 1000, (4 * 4096, 1)).astype(np.int32)
        with pytest.raises(RuntimeError, match="relay died"):
            device_encoder.encode_flac_device(
                s, 44100, 16, 5, plan_chunk_frames=1, compute_md5=False
            )
