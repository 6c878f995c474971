"""Multi-host tile dispatch: scale tile encoding across processes.

The reference has no parallelism at all (SURVEY.md §2.4); its per-tile loop
maps onto a single-host mesh in tile_engine.py.  This module adds the
cross-host level: each host encodes a disjoint, contiguous slice of the
tile grid with its LOCAL devices (the full single-host pipeline, mesh
emission included), and the ONLY cross-host traffic is the per-tile
compressed-size gather that builds the global byte-range index -- a few
bytes per tile, exactly SURVEY.md §2.4's mapping ("jax.distributed only
for the global index gather").

Output is a sharded container: host p writes ``<prefix>.part{p}`` with its
tiles' concatenated FLAC streams; host 0 additionally writes the standard
streaming container index (models/streaming schema) whose byte offsets are
GLOBAL -- concatenating the parts in rank order yields a byte-stream
identical to the single-host writer's data section, so any reference-style
reader consumes the assembled file unchanged.

Tested without real multi-host hardware by launching N coordinated
processes on localhost (Gloo backend), per SURVEY.md §4's strategy.
"""

from __future__ import annotations

import json
import logging
import struct
from pathlib import Path
from typing import List, Tuple

import numpy as np

logger = logging.getLogger("flac_raster_tpu.multihost")

__all__ = [
    "init_multihost",
    "host_tile_slice",
    "encode_tiles_multihost",
    "decode_container_tiles_multihost",
    "write_sharded_streaming_container",
    "assemble_sharded_container",
]


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Initialize jax.distributed (idempotent); returns (process_id, count).

    Pass all three explicitly (``coordinator_address`` as host:port of
    process 0); where a cluster launcher exports them, jax may autodetect
    them from None.
    """
    import jax

    if num_processes is not None and num_processes > 1:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        except RuntimeError as exc:  # already initialized
            logger.debug("jax.distributed.initialize: %s", exc)
    return jax.process_index(), jax.process_count()


def host_tile_slice(n_tiles: int, process_id: int, num_processes: int) -> slice:
    """Contiguous tile assignment (keeps the global byte order == rank
    order, so parts concatenate into the single-host layout)."""
    base, rem = divmod(n_tiles, num_processes)
    start = process_id * base + min(process_id, rem)
    count = base + (1 if process_id < rem else 0)
    return slice(start, start + count)


def encode_tiles_multihost(
    tiles: np.ndarray,
    sample_rate: int,
    bits_per_sample: int,
    compression_level: int = 5,
    blocksize: int = 4096,
    comments_list=None,
    compute_md5: bool = True,
) -> Tuple[List[bytes], np.ndarray, np.ndarray, slice]:
    """Encode this host's slice of a global tile batch.

    Args:
        tiles: the FULL (T, n, channels) batch (every host loads or mmaps
            its own copy/window; only the local slice is encoded).
    Returns:
        (local_blobs, global_sizes (T,), global_offsets (T,), local_slice)
        -- sizes/offsets are identical on every host (allgathered).
    """
    import jax
    from jax.experimental import multihost_utils

    from ..codec.fast_encoder import encode_flac_batch

    pid, pcount = jax.process_index(), jax.process_count()
    T = tiles.shape[0]
    sl = host_tile_slice(T, pid, pcount)
    local = tiles[sl]
    if comments_list is not None:
        comments_local = comments_list[sl]
    else:
        comments_local = None
    local_blobs = (
        encode_flac_batch(
            local, sample_rate, bits_per_sample, compression_level,
            blocksize, comments_local, compute_md5=compute_md5,
        )
        if local.shape[0]
        else []
    )
    # cross-host traffic: ONE allgather of per-tile byte sizes (padded to
    # the max per-host tile count so every row is rectangular)
    base, rem = divmod(T, pcount)
    max_local = base + (1 if rem else 0)
    sizes_local = np.zeros(max_local, np.int64)
    sizes_local[: len(local_blobs)] = [len(b) for b in local_blobs]
    gathered = np.asarray(multihost_utils.process_allgather(sizes_local))
    # flatten rank-major, drop padding back to the true assignment
    global_sizes = np.concatenate(
        [
            gathered[p][: host_tile_slice(T, p, pcount).stop
                        - host_tile_slice(T, p, pcount).start]
            for p in range(pcount)
        ]
    )
    global_offsets = np.cumsum(global_sizes) - global_sizes
    return local_blobs, global_sizes, global_offsets, sl


def decode_container_tiles_multihost(source, verify_crc: bool = True):
    """Decode this host's slice of a streaming container's tiles.

    The decode mirror of encode_tiles_multihost: each host reads ONLY its
    tiles' byte ranges from the container (a path or URL --
    models/streaming range semantics) and decodes them in one sharded
    mesh program over its LOCAL devices (parallel/decode_mesh).  No
    cross-host traffic at all -- the container's index already carries the
    global offsets, so unlike encode there is nothing to gather.

    Returns:
        (local_streams, local_slice): list of DecodedStream for tiles
        [local_slice.start, local_slice.stop) with device-resident
        samples, and the global slice they cover.
    """
    import jax

    from ..models.streaming import load_streaming_index, read_streaming_tile
    from .decode_mesh import decode_flac_batch_mesh

    pid, pcount = jax.process_index(), jax.process_count()
    sindex = load_streaming_index(source)
    frames = sindex.meta["frames"]
    sl = host_tile_slice(len(frames), pid, pcount)
    blobs = [read_streaming_tile(source, sindex, f) for f in frames[sl]]
    if not blobs:
        return [], sl
    return decode_flac_batch_mesh(blobs, verify_crc=verify_crc), sl


def write_sharded_streaming_container(
    prefix,
    index_meta: dict,
    frames_meta: List[dict],
    local_blobs: List[bytes],
    global_sizes: np.ndarray,
    global_offsets: np.ndarray,
    local_slice: slice,
) -> None:
    """Write this host's part file; host 0 also writes the global index.

    ``frames_meta`` is the per-tile metadata (frame_id, bbox, window) for
    ALL tiles, available on every host (it derives from the tile grid, not
    from pixel data).  The index's byte offsets are global.
    """
    import jax

    pid = jax.process_index()
    prefix = Path(prefix)
    part = prefix.with_suffix(prefix.suffix + f".part{pid}")
    with open(part, "wb") as f:
        for b in local_blobs:
            f.write(b)
    if pid == 0:
        index = dict(index_meta)
        index["frames"] = [
            {**fm, "byte_offset": int(global_offsets[i]),
             "byte_size": int(global_sizes[i])}
            for i, fm in enumerate(frames_meta)
        ]
        index_json = json.dumps(index, separators=(",", ":")).encode("utf-8")
        with open(prefix.with_suffix(prefix.suffix + ".index"), "wb") as f:
            f.write(struct.pack(">I", len(index_json)))
            f.write(index_json)


def assemble_sharded_container(prefix, num_parts: int, output_path) -> None:
    """Concatenate index + parts into a standard streaming container
    (models/streaming layout, readable by the reference toolchain's
    ``extract`` walk)."""
    prefix = Path(prefix)
    with open(output_path, "wb") as out:
        out.write(prefix.with_suffix(prefix.suffix + ".index").read_bytes())
        for p in range(num_parts):
            out.write(
                prefix.with_suffix(prefix.suffix + f".part{p}").read_bytes()
            )
