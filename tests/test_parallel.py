"""Mesh tile engine (parallel/) and batched tile encoding.

Multi-chip paths run on the 8-device virtual CPU mesh (conftest), per
SURVEY.md §4's strategy for testing mesh code without accelerators.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from flac_raster_tpu.codec.decoder import decode_flac
from flac_raster_tpu.codec.fast_encoder import encode_flac_batch
from flac_raster_tpu.models.flac_format import parse_flac_metadata
from flac_raster_tpu.parallel import make_tile_emit_step, tile_mesh

N = 256  # small blocksize keeps CPU-mesh compiles quick


@pytest.fixture(scope="module")
def tile_pcm():
    rng = np.random.default_rng(5)
    T, F, C = 8, 4, 1
    return np.cumsum(rng.integers(-8, 9, (T, F, C, N)), axis=-1).astype(np.int32)


def _index_groups(mesh, pcm, real_frames=None):
    """Run the emitting step over ``pcm`` (T, F, C, N) one group of
    tiles-axis tiles at a time; (tile_body_bytes, offsets) per group."""
    G = mesh.shape["tiles"]
    T, F, C, _ = pcm.shape
    step = make_tile_emit_step(
        mesh, blocksize=N, bps=16, channels=C, frames_per_tile=F,
        real_frames=real_frames, bs_code=8,  # blocksize 256
    )
    sharding = NamedSharding(mesh, P("tiles", "blocks", None, None))
    out = []
    for g0 in range(0, T, G):
        res = step(jax.device_put(jnp.asarray(pcm[g0 : g0 + G]), sharding))
        out.append((np.asarray(res["tile_body_bytes"]), np.asarray(res["offsets"])))
    return out


def _body_bytes(blob):
    return len(blob) - parse_flac_metadata(blob)[2]


class TestTileStep:
    @pytest.mark.parametrize("blocks_axis", [1, 2])
    def test_sharded_sizes_match_emitter(self, tile_pcm, blocks_axis):
        """The collective index (psum over blocks, all_gather + exclusive
        prefix sum over tiles) equals the bytes the encoder writes."""
        mesh = tile_mesh(8, blocks_axis=blocks_axis)
        T, F, C, _ = tile_pcm.shape
        streams = encode_flac_batch(
            tile_pcm.transpose(0, 1, 3, 2).reshape(T, F * N, C),
            44100, 16, compression_level=5, blocksize=N, compute_md5=False,
        )
        G = mesh.shape["tiles"]
        for g, (sizes, offsets) in enumerate(_index_groups(mesh, tile_pcm)):
            body = [_body_bytes(b) for b in streams[g * G : (g + 1) * G]]
            assert np.array_equal(sizes, body)
            assert np.array_equal(offsets, np.cumsum(sizes) - sizes)

    @pytest.mark.parametrize("blocks_axis", [2, 4])
    def test_index_counts_real_frames_only(self, tile_pcm, blocks_axis):
        """Frames padded up to the blocks axis stay out of the index: with
        3 real frames of 4 the sizes are those of the 3-frame streams."""
        mesh = tile_mesh(8, blocks_axis=blocks_axis)
        G = mesh.shape["tiles"]
        pcm = tile_pcm[:G].copy()
        pcm[:, 3] = 0
        streams = encode_flac_batch(
            pcm[:, :3].transpose(0, 1, 3, 2).reshape(G, 3 * N, 1),
            44100, 16, compression_level=5, blocksize=N, compute_md5=False,
        )
        [(sizes, offsets)] = _index_groups(mesh, pcm, real_frames=3)
        body = [_body_bytes(b) for b in streams]
        assert np.array_equal(sizes, body)
        assert np.array_equal(offsets, np.cumsum(body) - body)

    def test_emit_step_rejects_indivisible_frames(self):
        with pytest.raises(ValueError, match="blocks mesh axis"):
            make_tile_emit_step(tile_mesh(8, blocks_axis=2), frames_per_tile=3)

    def test_mesh_validation(self):
        with pytest.raises(ValueError):
            tile_mesh(1000)
        with pytest.raises(ValueError):
            tile_mesh(8, blocks_axis=3)


class TestEncodeBatch:
    def test_batch_equals_individual(self):
        rng = np.random.default_rng(9)
        T = 5
        pcm = np.cumsum(rng.integers(-30, 31, (T, 2 * 4096 + 100, 2)), axis=1)
        pcm = pcm.clip(-30000, 30000).astype(np.int16)
        comments = [{"GEOSPATIAL_TILE": str(t)} for t in range(T)]
        batch = encode_flac_batch(pcm, 44100, 16, 5, comments_list=comments)
        assert len(batch) == T
        from flac_raster_tpu.codec.fast_encoder import encode_flac_fast

        for t in range(T):
            dec = decode_flac(batch[t])
            assert np.array_equal(dec.samples.astype(np.int64), pcm[t].astype(np.int64))
            assert dec.comments["GEOSPATIAL_TILE"] == [str(t)]
            solo = encode_flac_fast(
                pcm[t], 44100, 16, 5, comments={"GEOSPATIAL_TILE": str(t)}
            )
            assert batch[t] == solo  # identical bytes: same plan, same layout

    def test_batch_fallback_short_streams(self):
        rng = np.random.default_rng(2)
        pcm = rng.integers(-100, 100, (3, 500, 1)).astype(np.int16)
        batch = encode_flac_batch(pcm, 44100, 16, 5)
        for t in range(3):
            dec = decode_flac(batch[t])
            assert np.array_equal(dec.samples[:, 0].astype(np.int64), pcm[t, :, 0].astype(np.int64))


class TestGraftEntry:
    def test_entry_compiles(self):
        import sys
        sys.path.insert(0, "/root/repo")
        from __graft_entry__ import entry

        fn, args = entry()
        out = jax.jit(fn)(*args)
        assert np.asarray(out["subframe_bits"]).shape == (64,)

    def test_dryrun_multichip(self):
        from __graft_entry__ import dryrun_multichip

        dryrun_multichip(8)


class TestShardedPlannerEncode:
    def test_encode_on_8_device_mesh_matches_single(self):
        """The default planner shards blocks over all visible devices; the
        stream must be byte-identical to the single-device result."""
        import jax
        from flac_raster_tpu.codec.encoder import EncoderConfig
        from flac_raster_tpu.codec.fast_encoder import _default_planner, encode_flac_fast
        from flac_raster_tpu.ops.device_codec import make_planner

        assert len(jax.devices()) == 8  # conftest virtual mesh
        rng = np.random.default_rng(21)
        x = np.cumsum(rng.integers(-30, 31, (5 * 4096 + 7, 1)), axis=0)
        x = x.clip(-30000, 30000).astype(np.int16)
        sharded = encode_flac_fast(x, 44100, 16, 5)  # uses sharded planner
        single = encode_flac_fast(
            x, 44100, 16, 5,
            planner=make_planner(blocksize=4096, bps=16),
        )
        assert sharded == single
        dec = decode_flac(sharded)
        assert np.array_equal(dec.samples[:, 0].astype(np.int64), x[:, 0].astype(np.int64))


class TestMeshEmit:
    """The (tiles x blocks) shard_map step must emit REAL FLAC bytes,
    byte-identical to the host batch emitter (VERDICT round-1 item #1)."""

    @pytest.mark.parametrize("blocks_axis", [1, 2, 4])
    def test_mesh_bytes_identical_to_host(self, blocks_axis):
        from flac_raster_tpu.parallel.tile_engine import encode_flac_batch_mesh

        rng = np.random.default_rng(9)
        T, frames = 5, 3
        n = frames * N + 100  # + tail frame
        xs = []
        for t in range(T):
            L = np.cumsum(rng.integers(-20, 21, n)).astype(np.int32)
            R = (L + rng.integers(-3, 4, n)).astype(np.int32)
            xs.append(np.stack([L, R], axis=1))
        batch = np.stack(xs)
        mesh = tile_mesh(8, blocks_axis=blocks_axis)
        mesh_streams = encode_flac_batch_mesh(
            batch, 44100, 16, 5, blocksize=N, mesh=mesh
        )
        host_streams = encode_flac_batch(
            batch, 44100, 16, 5, blocksize=N, use_mesh=False
        )
        for t, (m, h) in enumerate(zip(mesh_streams, host_streams)):
            assert m == h, t
            dec = decode_flac(m, verify_crc=True, verify_md5=True)
            assert np.array_equal(dec.samples, batch[t])

    def test_mesh_bytes_identical_to_host_wide(self):
        """bps-32 (wide lane) tiles ride the mesh emit step (VERDICT r4 #2):
        byte-identical to the host batch encoder's int64 planner, and the
        mesh decode mirror returns the exact PCM -- no silent host fallback
        for float32/int32-class tile batches anymore."""
        from flac_raster_tpu.parallel import decode_flac_batch_mesh
        from flac_raster_tpu.parallel.tile_engine import encode_flac_batch_mesh

        rng = np.random.default_rng(11)
        T, frames = 4, 2
        n = frames * N + 33  # + tail frame
        t_ax = np.arange(n)
        xs = []
        for t in range(T):
            smooth = (1.5e9 * np.sin(t_ax / 150.0 + t)).astype(np.int64)
            noise = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
            xs.append(np.where(t_ax % (2 * N) < N, smooth, noise)[:, None])
        batch = np.stack(xs)
        mesh = tile_mesh(8, blocks_axis=2)
        mesh_streams = encode_flac_batch_mesh(
            batch, 44100, 32, 5, blocksize=N, mesh=mesh
        )
        host_streams = encode_flac_batch(
            batch, 44100, 32, 5, blocksize=N, use_mesh=False
        )
        for t, (m, h) in enumerate(zip(mesh_streams, host_streams)):
            assert m == h, t
            dec = decode_flac(m, verify_crc=True, verify_md5=True)
            assert np.array_equal(dec.samples, batch[t])
        for t, d in enumerate(decode_flac_batch_mesh(mesh_streams, mesh=mesh)):
            assert isinstance(d.samples, jax.Array)
            assert np.array_equal(np.asarray(d.samples), batch[t])

    def test_auto_dispatch_uses_mesh(self):
        """encode_flac_batch auto-routes to the mesh path when >1 device is
        visible; outputs must match the explicit host path bytes."""
        rng = np.random.default_rng(10)
        batch = rng.integers(-3000, 3000, (3, 2 * N, 3)).astype(np.int32)
        auto = encode_flac_batch(batch, 44100, 16, 5, blocksize=N)
        host = encode_flac_batch(batch, 44100, 16, 5, blocksize=N, use_mesh=False)
        assert all(a == b for a, b in zip(auto, host))


class TestMeshDecode:
    """decode_flac_batch_mesh: the decode mirror of the tile engine --
    sharded over (tiles, blocks), values bit-identical to the host decoder,
    ragged tiles and fallbacks included."""

    @pytest.mark.parametrize("blocks_axis", [1, 2])
    def test_ragged_batch_matches_host(self, blocks_axis):
        from flac_raster_tpu.codec.fast_encoder import encode_flac_fast
        from flac_raster_tpu.parallel import decode_flac_batch_mesh

        rng = np.random.default_rng(21)
        blobs, refs = [], []
        for t in range(10):  # ragged lengths, tails on some tiles
            n = N * (2 + t % 3) + (t % 4) * 17
            x = np.cumsum(rng.integers(-30, 31, (n, 2)), axis=0).astype(np.int32)
            blobs.append(encode_flac_fast(x, 44100, 16, 5, blocksize=N))
            refs.append(x)
        mesh = tile_mesh(8, blocks_axis=blocks_axis)
        outs = decode_flac_batch_mesh(blobs, mesh=mesh)
        for o, r in zip(outs, refs):
            assert isinstance(o.samples, jax.Array)
            assert np.array_equal(np.asarray(o.samples), r)

    def test_mono_and_foreign_fallback(self):
        """A mixed batch (mono tiles + a foreign scalar-encoder stream
        without matching shape class) still decodes every input exactly."""
        from flac_raster_tpu.codec.encoder import encode_flac as encode_scalar
        from flac_raster_tpu.codec.fast_encoder import encode_flac_fast
        from flac_raster_tpu.parallel import decode_flac_batch_mesh

        rng = np.random.default_rng(22)
        xs = [
            np.cumsum(rng.integers(-9, 10, (N * 2 + 31, 1)), axis=0).astype(np.int32)
            for _ in range(3)
        ]
        blobs = [encode_flac_fast(x, 44100, 16, 5, blocksize=N) for x in xs]
        # different blocksize -> second shape class -> per-tile fallback
        y = np.cumsum(rng.integers(-9, 10, (N * 4, 1)), axis=0).astype(np.int32)
        blobs.append(encode_scalar(y, 44100, 16, 5, blocksize=2 * N))
        xs.append(y)
        outs = decode_flac_batch_mesh(blobs, mesh=tile_mesh(8))
        for o, r in zip(outs, xs):
            assert np.array_equal(np.asarray(o.samples), r)

    def test_crc_error_raises(self):
        from flac_raster_tpu.codec.fast_encoder import encode_flac_fast
        from flac_raster_tpu.models.flac_format import parse_flac_metadata
        from flac_raster_tpu.parallel import decode_flac_batch_mesh
        from flac_raster_tpu import native

        if not native.available():
            pytest.skip("native CRC not built")
        rng = np.random.default_rng(23)
        x = np.cumsum(rng.integers(-20, 21, (N * 3, 2)), axis=0).astype(np.int32)
        blob = bytearray(encode_flac_fast(x, 44100, 16, 5, blocksize=N))
        _, _, frame_start = parse_flac_metadata(bytes(blob))
        blob[frame_start + 40] ^= 0x10
        with pytest.raises(ValueError, match="CRC-16"):
            decode_flac_batch_mesh(
                [bytes(blob)], mesh=tile_mesh(8)
            )
