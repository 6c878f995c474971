"""Bit-level packing/unpacking primitives for the FLAC bitstream.

FLAC is an MSB-first bit-packed format.  libFLAC (the reference's codec,
SURVEY.md §2.2) writes it with a sequential bitwriter; that is the wrong shape
for a data-parallel accelerator, so the core primitive here is a *token packer*:

    pack_tokens(values, lengths) -> bytes

where every token is an independent (value, bit-length) pair.  Bit offsets are
an exclusive prefix-sum of the lengths and each token is OR-scattered into a
big-endian uint64 word array -- token bit-ranges are disjoint by construction,
so scatter-add == scatter-or and the whole pack is data-parallel.  The exact
same algorithm runs on device (ops/device_encode.py) — this module is the
numpy reference implementation and host fallback.

Reading has two shapes:
  * ``BitReader``: a small sequential reader for headers (a few bytes each).
  * vectorized helpers over an unpacked bit array (``bits_of``,
    ``read_kbits_at``) used by the decoder's batch Rice path (ops/rice.py).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "pack_tokens",
    "token_bit_offsets",
    "BitReader",
    "bits_of",
    "read_kbits_at",
]


def token_bit_offsets(lengths: np.ndarray) -> tuple[np.ndarray, int]:
    """Exclusive prefix-sum of token bit lengths; returns (offsets, total_bits)."""
    lengths = lengths.astype(np.int64, copy=False)
    offsets = np.empty_like(lengths)
    if lengths.size:
        np.cumsum(lengths[:-1], out=offsets[1:])
        offsets[0] = 0
        total = int(offsets[-1] + lengths[-1])
    else:
        total = 0
    return offsets, total


def pack_tokens(
    values: np.ndarray,
    lengths: np.ndarray,
    bit_offsets: np.ndarray | None = None,
    total_bits: int | None = None,
) -> bytes:
    """Pack tokens MSB-first into bytes.

    Args:
        values: uint64 array; only the low ``lengths[i]`` bits of ``values[i]``
            are written (higher bits are masked off).
        lengths: per-token bit count, each in [0, 64].
        bit_offsets / total_bits: optional precomputed placement (must be
            disjoint and monotonically increasing if provided).
    """
    values = values.astype(np.uint64, copy=False).ravel()
    lengths = lengths.astype(np.int64, copy=False).ravel()
    if bit_offsets is None:
        bit_offsets, total_bits = token_bit_offsets(lengths)
    else:
        bit_offsets = bit_offsets.astype(np.int64, copy=False).ravel()
        if total_bits is None:
            total_bits = int((bit_offsets[-1] + lengths[-1])) if lengths.size else 0
    if total_bits == 0:
        return b""

    nz = lengths > 0
    if not nz.all():
        values, lengths, bit_offsets = values[nz], lengths[nz], bit_offsets[nz]

    # Mask stray high bits (length 64 keeps everything).
    mask = np.where(
        lengths >= 64,
        np.uint64(0xFFFFFFFFFFFFFFFF),
        (np.uint64(1) << lengths.astype(np.uint64)) - np.uint64(1),
    )
    values = values & mask

    n_words = (total_bits + 63) // 64
    words = np.zeros(n_words, dtype=np.uint64)

    word_idx = bit_offsets >> 6
    bit_in = bit_offsets & 63
    shift1 = 64 - bit_in - lengths  # left shift into the first word

    one_word = shift1 >= 0
    if one_word.any():
        np.bitwise_or.at(
            words,
            word_idx[one_word],
            values[one_word] << shift1[one_word].astype(np.uint64),
        )
    split = ~one_word
    if split.any():
        sh = (-shift1[split]).astype(np.uint64)  # in [1, 63]
        np.bitwise_or.at(words, word_idx[split], values[split] >> sh)
        np.bitwise_or.at(
            words,
            word_idx[split] + 1,
            values[split] << (np.uint64(64) - sh),
        )

    n_bytes = (total_bits + 7) // 8
    return words.astype(">u8").tobytes()[:n_bytes]


def bits_of(data: bytes | np.ndarray) -> np.ndarray:
    """Unpack a byte buffer into a uint8 bit array (MSB-first)."""
    arr = data if isinstance(data, np.ndarray) else np.frombuffer(data, dtype=np.uint8)
    return np.unpackbits(arr.astype(np.uint8, copy=False))


def read_kbits_at(bits: np.ndarray, positions: np.ndarray, k: int) -> np.ndarray:
    """Read an unsigned k-bit big-endian integer at each bit position.

    Vectorized gather: k passes over the position array.  Returns int64.
    """
    positions = positions.astype(np.int64, copy=False)
    out = np.zeros(positions.shape, dtype=np.int64)
    for t in range(k):
        out = (out << 1) | bits[positions + t].astype(np.int64)
    return out


class BitReader:
    """Sequential MSB-first bit reader for parsing headers.

    Heavy payloads (Rice partitions) are NOT read through this class -- the
    decoder switches to the vectorized path (ops/rice.py) and then calls
    ``seek_bits`` to jump past them.
    """

    def __init__(self, data: bytes | np.ndarray, bit_pos: int = 0):
        self._bytes = (
            data if isinstance(data, np.ndarray) else np.frombuffer(data, dtype=np.uint8)
        )
        self.bit_pos = bit_pos

    @property
    def total_bits(self) -> int:
        return self._bytes.size * 8

    def remaining_bits(self) -> int:
        return self.total_bits - self.bit_pos

    def seek_bits(self, bit_pos: int) -> None:
        self.bit_pos = bit_pos

    def read_uint(self, n: int) -> int:
        """Read n bits as an unsigned int (n up to ~57 typical, any n works)."""
        pos = self.bit_pos
        end = pos + n
        if end > self.total_bits:
            raise EOFError("bitstream exhausted")
        first_byte = pos >> 3
        last_byte = (end + 7) >> 3
        chunk = self._bytes[first_byte:last_byte]
        val = 0
        for b in chunk.tolist():
            val = (val << 8) | b
        # drop trailing bits beyond `end`, then mask leading bits before `pos`
        val >>= (last_byte << 3) - end
        val &= (1 << n) - 1
        self.bit_pos = end
        return val

    def read_sint(self, n: int) -> int:
        v = self.read_uint(n)
        if v >= (1 << (n - 1)):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        """Count 0 bits until the terminating 1 bit (FLAC unary)."""
        q = 0
        while True:
            if self.read_uint(1):
                return q
            q += 1

    def align_to_byte(self) -> None:
        self.bit_pos = (self.bit_pos + 7) & ~7

    def read_bytes_aligned(self, n: int) -> bytes:
        assert self.bit_pos % 8 == 0
        start = self.bit_pos >> 3
        self.bit_pos += n * 8
        return self._bytes[start : start + n].tobytes()
