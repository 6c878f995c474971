"""Mesh-parallel tile encode: shard_map over (tiles, blocks), emitting bytes.

This is the device-parallel replacement for the reference's sequential per-tile
loop (``spatial_encoder.py:196-245``, ``cli.py:553-622`` -- SURVEY.md §3.3):
a whole batch of tiles is planned AND emitted in one pjit/shard_map program:

  * FLAC block planning + bitstream emission (ops/device_emit.plan_and_emit)
    running fully device-parallel -- frames of one tile spread over the
    ``blocks`` mesh axis, different tiles over the ``tiles`` axis; each
    shard scatter-packs its frames into a local word buffer (frames are
    byte-aligned, so per-tile streams are plain concatenations of shard
    buffers -- no cross-shard bit shifting);
  * the spatial byte-range index built collectively from the emitted frame
    sizes: ``psum`` of frame bytes over ``blocks``, ``all_gather`` of tile
    sizes over ``tiles``, exclusive prefix sum for the offsets;
  * only compressed words + per-frame sizes leave the device.

``make_tile_emit_step`` returns the compiled emitting step;
``encode_flac_batch_mesh`` is the host-facing wrapper that assembles
complete FLAC streams -- codec/fast_encoder routes batch encodes here
whenever more than one device is visible.  The emitting step is the
framework's ``dryrun_multichip`` payload (__graft_entry__.py): the complete
sharded compute graph of the flagship workload.

Output bytes: the integer stages are exact everywhere, but the float32 LPC
stage (autocorrelation, Levinson, coefficient quantization) may round
differently in each compiled program.  On the CPU every program rounds
alike, so the mesh streams are byte-identical to
codec/fast_encoder.encode_flac_batch (tested).  On a GPU the program
depends on the mesh shape, so the bytes depend on the device count and mesh
layout: the decoded samples are guaranteed, the sizes agree to a fraction
of a percent, and the index always matches the bytes this step emitted.
"""

from __future__ import annotations

import logging

import numpy as np

import jax
import jax.numpy as jnp
try:  # moved out of experimental in newer jax
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.device_codec import MAX_DEVICE_BPS
from ..ops.device_emit import plan_and_emit, worst_case_words
from .mesh import tile_mesh

__all__ = [
    "make_tile_emit_step",
    "encode_flac_batch_mesh",
]


def make_tile_emit_step(
    mesh=None,
    *,
    blocksize: int = 4096,
    bps: int = 16,
    channels: int = 1,
    frames_per_tile: int,
    real_frames: int | None = None,
    sr_code: int = 0,
    bps_code: int = 4,
    bs_code: int = 12,
    bs_tail_bits: int = 0,
    bs_tail_val: int = 0,
    compression_level: int = 5,
    zero_point: int = 0,
):
    """Build the sharded tile plan+emit step (actual FLAC bytes per shard).

    The input group (G, F, C, N) is sharded P("tiles", "blocks") with ONE
    tile per tiles-shard (G = tiles axis size) and F split over the blocks
    axis.  Each shard runs ops/device_emit.plan_and_emit on its local
    frames with the correct absolute frame numbering; because frames are
    byte-aligned, the shard word buffers concatenate into the tile's frame
    bytes (byte-identical to the single-device emitter on the CPU, tested;
    see the module docstring for other platforms).

    The index outputs count the first ``real_frames`` frames of each tile
    (default: all ``frames_per_tile``); frames past them are zero padding
    up to a multiple of the blocks axis, which the host drops on assembly.

    plan_and_emit is NOT vmapped: batched float reductions re-associate
    under vmap and change LPC coefficients, which would break
    byte-identity with the host emitter.

    Returns:
        fn(tiles (G, F, C, N) int) -> dict with
          words (G, BS * W) uint32  -- shard s of tile g at [s*W:(s+1)*W]
          frame_bits (G, F) int32   -- per-frame bit sizes (byte multiples)
          subframe_bits (G, F, C) int32
          tile_body_bytes (G,) int32 -- bytes of the real frames
          offsets (G,) int32         -- exclusive prefix sum, in-group
        W is exposed as ``step._words_per_shard``.
    """
    if mesh is None:
        mesh = tile_mesh()
    from ..codec.encoder import EncoderConfig
    from ..ops.stereo import midside_ok

    cfg = EncoderConfig.from_level(compression_level)
    use_ms = midside_ok(channels, bps, cfg.mid_side, device=True)
    blocks_axis = mesh.shape["blocks"]
    if frames_per_tile % blocks_axis:
        raise ValueError("frames_per_tile must divide the blocks mesh axis")
    tF = frames_per_tile // blocks_axis
    if real_frames is None:
        real_frames = frames_per_tile
    n_words = worst_case_words(tF, channels, blocksize, bps + (1 if use_ms else 0))
    emit_kw = dict(
        blocksize=blocksize,
        bps=bps,
        sr_code=sr_code,
        bps_code=bps_code,
        bs_code=bs_code,
        bs_tail_bits=bs_tail_bits,
        bs_tail_val=bs_tail_val,
        max_lpc_order=cfg.max_lpc_order,
        apodizations=cfg.apodizations,
        max_partition_order=min(cfg.max_partition_order, 6),
        use_lpc=cfg.use_lpc,
        n_words=n_words,
        zero_point=zero_point,
        mid_side=use_ms,
    )

    def local_step(tiles):  # (1, tF, C, N) local shard: one tile's frame slice
        frame0 = jax.lax.axis_index("blocks").astype(jnp.int32) * tF
        out = plan_and_emit(tiles[0], frame0, **emit_kw)
        words = out["words"][None]                              # (1, W)
        frame_bits = out["frame_bits"][None]                    # (1, tF)
        sub_bits = out["subframe_bits"][None]                   # (1, tF, C)
        fidx = frame0 + jax.lax.broadcasted_iota(jnp.int32, frame_bits.shape, 1)
        real_bytes = jnp.where(fidx < real_frames, frame_bits >> 3, 0)
        tile_local = real_bytes.sum(axis=1)                     # (1,)
        tile_body = jax.lax.psum(tile_local, "blocks")          # (1,)
        all_tiles = jax.lax.all_gather(tile_body, "tiles", tiled=True)
        offsets_all = jnp.cumsum(all_tiles) - all_tiles
        t_pos = jax.lax.axis_index("tiles")
        offsets = jax.lax.dynamic_slice_in_dim(offsets_all, t_pos, 1)
        return (words, frame_bits, sub_bits, tile_body.astype(jnp.int32),
                offsets.astype(jnp.int32))

    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("tiles", "blocks", None, None),),
        out_specs=(
            P("tiles", "blocks"),
            P("tiles", "blocks"),
            P("tiles", "blocks"),
            P("tiles"),
            P("tiles"),
        ),
    )

    @jax.jit
    def step(tiles):
        words, frame_bits, sub_bits, tile_body, offsets = sharded(tiles)
        return {
            "words": words,
            "frame_bits": frame_bits,
            "subframe_bits": sub_bits,
            "tile_body_bytes": tile_body,
            "offsets": offsets,
        }

    step._words_per_shard = n_words
    step._blocks_axis = blocks_axis
    return step


def encode_flac_batch_mesh(
    samples_batch: np.ndarray,
    sample_rate: int,
    bits_per_sample: int,
    compression_level: int = 5,
    blocksize: int = 4096,
    comments_list=None,
    vendor: str = "flac-raster-tpu",
    compute_md5: bool = True,
    mesh=None,
) -> list[bytes]:
    """Mesh-sharded batch encode producing complete FLAC streams.

    Byte-identical to codec/fast_encoder.encode_flac_batch on the CPU
    (tested; on a GPU see the module docstring): the full-frame bodies are planned, emitted, and scatter-packed by the
    (tiles x blocks) shard_map step, one group of ``tiles_axis`` tiles per
    call; the host only byteswaps the compressed shard buffers, patches
    CRCs, and prepends headers / appends tail frames.  This replaces the
    reference's per-tile temp-file loop (``spatial_encoder.py:196-245``)
    at mesh scale.
    """
    from ..codec.decoder import md5_of_samples
    from ..codec.encoder import (
        _BPS_CODES,
        _SAMPLE_RATE_CODES,
        EncoderConfig,
    )
    from ..codec.fast_encoder import (
        _blocksize_header,
        _emit_tail_frame,
        encode_flac_batch,
    )
    from ..codec.device_encoder import _patch_crcs, _utf8_nbytes
    from ..models.flac_format import LAYOUT_FLAG_TOK32, StreamInfo, build_flac_header

    samples_batch = np.asarray(samples_batch)
    if samples_batch.ndim == 2:
        samples_batch = samples_batch[:, :, None]
    T, n, channels = samples_batch.shape
    n_full = n // blocksize
    # narrow (<= MAX_DEVICE_BPS) and wide (32, ops/wide_codec limb-pair
    # planner inside plan_and_emit) streams both ride the mesh; only
    # 27..31 -- not emittable FLAC widths anyway (_BPS_CODES) -- fall back
    if (
        T == 0
        or n_full == 0
        or bits_per_sample not in _BPS_CODES
        or MAX_DEVICE_BPS < bits_per_sample < 32
        or (blocksize & (blocksize - 1)) != 0
        or blocksize % 64 != 0
    ):
        logging.getLogger("flac_raster_tpu.tile_engine").info(
            "mesh encode fallback to host batch encoder "
            "(T=%d, n_full=%d, bps=%d, blocksize=%d)",
            T, n_full, bits_per_sample, blocksize,
        )
        return encode_flac_batch(
            samples_batch, sample_rate, bits_per_sample, compression_level,
            blocksize, comments_list, vendor, compute_md5, use_mesh=False,
        )
    if comments_list is None:
        comments_list = [None] * T

    if mesh is None:
        mesh = tile_mesh()
    tiles_axis = mesh.shape["tiles"]
    blocks_axis = mesh.shape["blocks"]

    cfg = EncoderConfig.from_level(compression_level)
    sr_code = _SAMPLE_RATE_CODES.get(sample_rate, 0)
    bps_code = _BPS_CODES[bits_per_sample]
    bs_code, bs_tail_val, bs_tail_bits = _blocksize_header(blocksize)

    smp = samples_batch.astype(np.int64, copy=False)
    full = smp[:, : n_full * blocksize].reshape(T, n_full, blocksize, channels)
    full = np.ascontiguousarray(full.transpose(0, 1, 3, 2)).astype(np.int32)

    # pad frames up to the blocks axis (zero frames, truncated on assembly)
    Fp = -(-n_full // blocks_axis) * blocks_axis
    if Fp != n_full:
        padded = np.zeros((T, Fp, channels, blocksize), np.int32)
        padded[:, :n_full] = full
        full = padded

    step = make_tile_emit_step(
        mesh,
        blocksize=blocksize,
        bps=bits_per_sample,
        channels=channels,
        frames_per_tile=Fp,
        real_frames=n_full,
        sr_code=sr_code,
        bps_code=bps_code,
        bs_code=bs_code,
        bs_tail_bits=bs_tail_bits,
        bs_tail_val=bs_tail_val,
        compression_level=compression_level,
    )
    W = step._words_per_shard
    tFp = Fp // blocks_axis
    sharding = NamedSharding(mesh, P("tiles", "blocks", None, None))

    frame_bits = np.empty((T, Fp), np.int64)
    sub_bits_all = np.empty((T, Fp, channels), np.int64)
    words = np.empty((T, blocks_axis * W), np.uint32)
    for g0 in range(0, T, tiles_axis):
        g1 = min(g0 + tiles_axis, T)
        group = full[g0:g1]
        if g1 - g0 < tiles_axis:  # pad the last group with zero tiles
            group = np.concatenate(
                [group, np.zeros((tiles_axis - (g1 - g0),) + group.shape[1:], np.int32)]
            )
        out = step(jax.device_put(jnp.asarray(group), sharding))
        frame_bits[g0:g1] = np.asarray(out["frame_bits"])[: g1 - g0]
        sub_bits_all[g0:g1] = np.asarray(out["subframe_bits"])[: g1 - g0]
        words[g0:g1] = np.asarray(out["words"])[: g1 - g0]

    streams: list[bytes] = []
    for t in range(T):
        fb = frame_bits[t]
        parts: list[np.ndarray] = []
        for s in range(blocks_axis):
            f_lo = s * tFp
            real = max(0, min(n_full - f_lo, tFp))
            if real == 0:
                break
            used_bits = int(fb[f_lo : f_lo + real].sum())
            used_words = (used_bits + 31) // 32
            seg = words[t, s * W : s * W + used_words]
            parts.append(
                np.frombuffer(seg.astype(">u4").tobytes(), np.uint8)[: used_bits // 8]
            )
        buf = np.concatenate(parts).copy()
        fb_real = fb[:n_full].astype(np.int64)
        fi = np.arange(n_full)
        hdr_bits = 32 + _utf8_nbytes(fi) * 8 + bs_tail_bits
        _patch_crcs(buf, fb_real, hdr_bits.astype(np.int64))
        chunks = [buf.tobytes()]
        sizes = [fb_real >> 3]
        subs = [sub_bits_all[t, :n_full, :-1]]
        if n_full * blocksize < n:
            tail = smp[t, n_full * blocksize :]
            chunks.append(
                _emit_tail_frame(tail, n_full, bits_per_sample, sr_code, bps_code, cfg)
            )
            sizes.append(np.array([len(chunks[-1])], np.int64))
            subs.append(np.zeros((1, channels - 1), np.int64))
        all_sizes = np.concatenate(sizes)
        all_subs = np.concatenate(subs) if channels > 1 else None
        md5 = (
            md5_of_samples(samples_batch[t].astype(np.int32), bits_per_sample)
            if compute_md5
            else b"\x00" * 16
        )
        streaminfo = StreamInfo(
            min_blocksize=blocksize,
            max_blocksize=blocksize,
            min_framesize=int(all_sizes.min()),
            max_framesize=int(all_sizes.max()),
            sample_rate=sample_rate,
            channels=channels,
            bits_per_sample=bits_per_sample,
            total_samples=n,
            md5=md5,
        )
        header = build_flac_header(streaminfo, comments_list[t], vendor,
                                   frame_sizes=all_sizes, sub_bits=all_subs,
                                   layout_flags=LAYOUT_FLAG_TOK32)
        streams.append(bytes(header) + b"".join(chunks))
    return streams
