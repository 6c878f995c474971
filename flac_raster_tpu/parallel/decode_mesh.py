"""Mesh-parallel tile decode: shard_map over (tiles, blocks), PCM stays sharded.

The reference decodes tiles strictly sequentially on the host -- its bbox
query walks intersecting tiles one `pyflac` decode at a time
(``spatial_encoder.py:549-567``) and ships raw PCM back to the consumer.
Here a whole batch of compressed tile streams decodes in one pjit/shard_map
program over the (tiles, blocks) device mesh:

  * the host does O(metadata) work per tile -- header/layout parse, native
    CRC-16 pass, per-frame offsets -- exactly like codec/device_decoder;
  * each shard gathers its frames' word windows from its tiles' bodies
    (local row take; bodies are sharded over ``tiles`` and replicated over
    ``blocks``) and runs ops/device_decode's batched subframe parser on
    tT x tF frame lanes; no cross-shard communication at all (tiles and
    frames are both embarrassingly parallel -- the decode mirror of
    tile_engine's encode sharding);
  * decoded PCM comes back as a SHARDED (T, F, N, C) device array: for a
    pjit training step consuming the tiles with a matching
    NamedSharding(P("tiles", ...)), no resharding collective is needed --
    the compressed upload is the only wire traffic.

Tail frames (partial blocks) decode on host like device_decoder; tiles the
device pipeline cannot take (foreign streams, no FRTP index, >int32 math,
in-graph structure flags) fall back per-tile to decode_flac_device, which
itself degrades to the host decoder -- every input still decodes exactly.
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

from .mesh import tile_mesh

logger = logging.getLogger("flac_raster_tpu.decode_mesh")

__all__ = ["decode_flac_batch_mesh"]

_WROW = 32  # words per gathered window row (mirrors codec/device_decoder)


def _tile_meta(buf: bytes):
    """Parse one tile stream into the device-decode prerequisites.

    Returns None when the tile is ineligible for the mesh pipeline (the
    caller falls back to decode_flac_device for it), else a dict of
    host-side arrays mirroring codec/device_decoder.decode_flac_device.
    """
    from ..models.flac_format import (
        LAYOUT_FLAG_TOK32,
        parse_flac_metadata,
        parse_layout_block,
    )
    from ..ops.device_codec import MAX_DEVICE_BPS

    si, blocks, frame_start = parse_flac_metadata(buf)
    layout = parse_layout_block(blocks)
    N, C, bps = si.max_blocksize, si.channels, si.bits_per_sample
    eligible = (
        layout is not None
        and layout.version >= 2
        and (layout.flags & LAYOUT_FLAG_TOK32)
        and (C == 1 or layout.sub_bits is not None)
        and si.min_blocksize == si.max_blocksize
        and N >= 64
        and (N & (N - 1)) == 0
        and 1 <= C <= 8
        # narrow planner width, or exactly 32 (the wide lane -- never
        # mid-side, mirroring codec/device_decoder's eligibility)
        and (bps + (1 if C == 2 else 0) <= MAX_DEVICE_BPS + 1 or bps == 32)
        and si.total_samples > 0
    )
    if not eligible:
        return None
    total = si.total_samples
    full_frames = total // N
    tail = total - full_frames * N
    if len(layout.sizes) != full_frames + (1 if tail else 0):
        return None
    sizes = np.asarray(layout.sizes, np.int64)
    offsets = layout.absolute_offsets(frame_start)
    if offsets[-1] != len(buf):
        return None
    return {
        "si": si, "blocks": blocks, "layout": layout,
        "frame_start": frame_start, "N": N, "C": C, "bps": bps,
        "full_frames": full_frames, "tail": tail,
        "sizes": sizes, "offsets": offsets,
    }


def _host_tail(buf: bytes, meta, verify_crc: bool):
    """Decode the (tiny) partial tail frame on host, as device_decoder does."""
    from ..codec.decoder import decode_flac
    from ..models.flac_format import StreamInfo, build_flac_header

    si = meta["si"]
    tail_si = StreamInfo(
        min_blocksize=si.min_blocksize, max_blocksize=si.max_blocksize,
        min_framesize=0, max_framesize=0, sample_rate=si.sample_rate,
        channels=meta["C"], bits_per_sample=meta["bps"],
        total_samples=meta["tail"],
    )
    mini = build_flac_header(tail_si) + buf[meta["offsets"][meta["full_frames"]]:]
    return decode_flac(mini, verify_crc=verify_crc).samples


def _make_mesh_decode_step(mesh, *, maxW: int, C: int, bps: int, N: int):
    """Compile the sharded decode step for one (window, stream-shape) class.

    in: body_w (T, Wb) uint32 [P tiles, None], row0/bit_base (T, Fp) int32
    and sf (T, Fp, C) int32 [P tiles, blocks(, None)].
    out: samples (T, Fp, N, C) int32, err (T, Fp) bool, same sharding.
    """
    from ..ops.device_decode import decode_frames_device

    def local(body_l, row0_l, bb_l, fe_l, sf_l):
        tT, Wb = body_l.shape
        tF = row0_l.shape[1]
        rows = body_l.reshape(tT * (Wb // _WROW), _WROW)
        lane = (jnp.arange(tT, dtype=jnp.int32) * (Wb // _WROW))[:, None, None]
        iota = jnp.arange(maxW // _WROW, dtype=jnp.int32)
        idx = jnp.clip(
            row0_l[:, :, None] + iota[None, None, :], 0, Wb // _WROW - 1
        ) + lane
        win = jnp.take(rows, idx.reshape(-1), axis=0).reshape(tT * tF, maxW)
        samples, err = decode_frames_device(
            win, bb_l.reshape(-1), sf_l.reshape(-1, C), fe_l.reshape(-1),
            C=C, bps=bps, N=N,
        )
        return samples.reshape(tT, tF, N, C), err.reshape(tT, tF)

    kw = dict(
        mesh=mesh,
        in_specs=(
            P("tiles", None),
            P("tiles", "blocks"),
            P("tiles", "blocks"),
            P("tiles", "blocks"),
            P("tiles", "blocks", None),
        ),
        out_specs=(P("tiles", "blocks", None, None), P("tiles", "blocks")),
    )
    # no collectives anywhere in the decode (tiles AND frames are fully
    # independent), so the varying-manual-axes check adds nothing -- and
    # the verbatim-subframe lax.cond's constant-zero branch trips it
    try:
        fn = shard_map(local, check_vma=False, **kw)
    except TypeError:  # pragma: no cover - older jax spelling
        fn = shard_map(local, check_rep=False, **kw)
    return jax.jit(fn)


def decode_flac_batch_mesh(
    blobs,
    verify_crc: bool = True,
    mesh=None,
):
    """Decode a batch of FLAC tile streams sharded over the device mesh.

    Args:
        blobs: sequence of complete FLAC streams (e.g. the per-tile output
            of ``encode_flac_batch_mesh`` or a spatial container's tiles).
            Tiles may have different lengths/frame counts; streams must
            share (blocksize, channels, bps) to ride the mesh program
            (mixed batches fall back per-tile).
        verify_crc: host-side native CRC-16 pass over each tile's frames.
        mesh: a (tiles, blocks) Mesh from parallel.mesh.tile_mesh
            (default: all visible devices, blocks_axis=1).

    Returns:
        list of DecodedStream, one per input, whose ``samples`` are
        device-resident jax.Arrays (values bit-identical to the host
        decoder -- tested on the virtual CPU mesh).
    """
    from ..codec.decoder import DecodedStream
    from ..codec.device_decoder import (
        _bs_tail_bits,
        _utf8_len_bytes,
        decode_flac_device,
    )
    from ..models.flac_format import BLOCK_VORBIS_COMMENT, parse_vorbis_comments
    from ..ops.device_decode import _WIN_SLACK_WORDS

    blobs = [bytes(b) for b in blobs]
    T = len(blobs)
    if T == 0:
        return []

    metas = [_tile_meta(b) for b in blobs]
    shapes = {(m["N"], m["C"], m["bps"]) for m in metas if m is not None}
    n_dev = len(jax.local_devices())
    if n_dev < 2 or len(shapes) != 1 or any(m is None for m in metas):
        logger.debug(
            "mesh decode fallback to per-tile device decode "
            "(devices=%d, shape classes=%d, ineligible=%d)",
            n_dev, len(shapes), sum(m is None for m in metas),
        )
        return [decode_flac_device(b, verify_crc=verify_crc) for b in blobs]
    N, C, bps = shapes.pop()

    if verify_crc:
        from .. import native

        if native.available():
            for b, m in zip(blobs, metas):
                arr = np.frombuffer(b, np.uint8)
                o, s = m["offsets"][:-1], m["sizes"]
                calc = native.crc16_spans(arr, o, s - 2)
                stored = (
                    arr[o + s - 2].astype(np.uint16) << 8
                ) | arr[o + s - 1]
                bad = np.nonzero(calc != stored)[0]
                if bad.size:
                    raise ValueError(
                        f"frame CRC-16 mismatch at byte {int(o[bad[0]])}"
                    )

    if mesh is None:
        mesh = tile_mesh()
    tiles_axis = mesh.shape["tiles"]
    blocks_axis = mesh.shape["blocks"]

    # ---- global shape class (ONE compile across ragged tiles) -------------
    Fmax = max(m["full_frames"] for m in metas)
    Fp = max(-(-max(Fmax, 1) // blocks_axis) * blocks_axis, blocks_axis)
    max_size = max(
        (int(m["sizes"][: m["full_frames"]].max()) if m["full_frames"] else 16)
        for m in metas
    )
    maxW = _WROW + (max_size + 3) // 4 + _WIN_SLACK_WORDS
    maxW = 1 << max(5, (maxW - 1).bit_length())
    body_need = max(
        (m["offsets"][-1] - (int(m["offsets"][0]) & ~(4 * _WROW - 1)))
        for m in metas
    ) + 4 * _WIN_SLACK_WORDS
    body_len = 1 << max(8, (int(body_need) - 1).bit_length())
    if body_need <= (body_len * 3) // 4 and ((body_len * 3) // 4) % (4 * _WROW) == 0:
        body_len = (body_len * 3) // 4
    Wb = body_len // 4  # multiple of _WROW (the local row take reshapes by it)

    # ---- per-tile host arrays ---------------------------------------------
    body_w = np.zeros((T, Wb), np.uint32)
    row0 = np.zeros((T, Fp), np.int32)
    bit_base = np.zeros((T, Fp), np.int32)
    frame_end = np.zeros((T, Fp), np.int32)
    sf = np.zeros((T, Fp, C), np.int32)
    for t, (b, m) in enumerate(zip(blobs, metas)):
        F = m["full_frames"]
        byte_lo = int(m["offsets"][0]) & ~(4 * _WROW - 1)
        eff = np.frombuffer(b, np.uint8)[byte_lo : int(m["offsets"][-1])]
        pad = np.zeros(body_len, np.uint8)
        pad[: len(eff)] = eff
        body_w[t] = pad.view(">u4").astype(np.uint32)
        if F == 0:
            continue
        offs = m["offsets"][:F] - byte_lo
        fi = np.arange(F, dtype=np.int64)
        hdr_bits = (32 + _utf8_len_bytes(fi) * 8 + _bs_tail_bits(N) + 8).astype(
            np.int32
        )
        bb = ((offs & (4 * _WROW - 1)) * 8).astype(np.int32)
        sft = np.zeros((F, C), np.int64)
        sft[:, 0] = hdr_bits
        if C > 1:
            sft[:, 1:] = sft[:, :1] + np.cumsum(m["layout"].sub_bits[:F], axis=1)
        row0[t, :F] = (offs >> (2 + 5)).astype(np.int32)
        row0[t, F:] = row0[t, 0]
        bit_base[t, :F] = bb
        bit_base[t, F:] = bb[0]
        # window-local frame end for the last-subframe boundary check;
        # padded rows copy frame 0 so they stay err-free (and are sliced)
        frame_end[t, :F] = bb + (m["sizes"][:F] * 8).astype(np.int32)
        frame_end[t, F:] = frame_end[t, 0]
        sf[t, :F] = sft + bb[:, None]
        sf[t, F:] = sf[t, 0]

    step = _make_mesh_decode_step(mesh, maxW=maxW, C=C, bps=bps, N=N)
    body_sh = NamedSharding(mesh, P("tiles", None))
    grid_sh = NamedSharding(mesh, P("tiles", "blocks"))
    sf_sh = NamedSharding(mesh, P("tiles", "blocks", None))

    # ---- grouped dispatch (pad the last group with copies of tile 0) ------
    parts: list = []
    errs = np.zeros((T, Fp), bool)
    for g0 in range(0, T, tiles_axis):
        g1 = min(g0 + tiles_axis, T)
        sl = list(range(g0, g1)) + [0] * (tiles_axis - (g1 - g0))
        out, err = step(
            jax.device_put(jnp.asarray(body_w[sl]), body_sh),
            jax.device_put(jnp.asarray(row0[sl]), grid_sh),
            jax.device_put(jnp.asarray(bit_base[sl]), grid_sh),
            jax.device_put(jnp.asarray(frame_end[sl]), grid_sh),
            jax.device_put(jnp.asarray(sf[sl]), sf_sh),
        )
        parts.append(out)
        errs[g0:g1] = np.asarray(err)[: g1 - g0]

    # ---- assembly -----------------------------------------------------------
    results: list[DecodedStream] = []
    for t, (b, m) in enumerate(zip(blobs, metas)):
        F = m["full_frames"]
        if errs[t, :F].any():
            logger.debug("mesh decode tile %d: in-graph structure flag", t)
            results.append(decode_flac_device(b, verify_crc=verify_crc))
            continue
        out = parts[t // tiles_axis]
        samples = out[t % tiles_axis, :F].reshape(F * N, C)
        if m["tail"]:
            samples = jnp.concatenate(
                [samples, jnp.asarray(_host_tail(b, m, verify_crc))], axis=0
            )
        vendor, comments = "", {}
        for blk in m["blocks"]:
            if blk.block_type == BLOCK_VORBIS_COMMENT:
                vendor, comments = parse_vorbis_comments(blk.data)
        results.append(
            DecodedStream(samples, m["si"], comments, vendor, engine="device-mesh")
        )
    return results
