"""CRC-8 and CRC-16 for the FLAC bitstream, with batch-vectorized variants.

FLAC uses:
  * CRC-8  (poly x^8 + x^2 + x + 1 = 0x07, init 0, MSB-first)  over each frame
    header, and
  * CRC-16 (poly x^16 + x^15 + x^2 + 1 = 0x8005, init 0, MSB-first) over each
    whole frame (header + subframes + padding bits), appended as the frame
    footer.

The reference implementation delegates this to libFLAC (see SURVEY.md §2.2);
here it is a first-class component.  Because the device-parallel encoder produces
*all frames of a stream at once*, the interesting primitive is not
``crc16(one_buffer)`` but ``crc16_rows(matrix)``: one CRC per row of a
left-zero-padded byte matrix.  Both CRCs have init value 0, so leading zero
bytes do not change the result -- frames of different lengths can be
right-aligned into a rectangular matrix and reduced with a single vectorized
Horner loop over columns (O(max_len) numpy ops regardless of frame count).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "crc8",
    "crc16",
    "crc8_rows",
    "crc16_rows",
]

_CRC8_POLY = 0x07
_CRC16_POLY = 0x8005


def _make_table(poly: int, width: int) -> np.ndarray:
    """Build the standard MSB-first CRC table: T[b] = (b(x) * x^width) mod poly."""
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        crc = b << (width - 8)
        for _ in range(8):
            if crc & top:
                crc = ((crc << 1) ^ poly) & mask
            else:
                crc = (crc << 1) & mask
        table[b] = crc
    return table


_CRC8_TABLE = _make_table(_CRC8_POLY, 8)
_CRC16_TABLE = _make_table(_CRC16_POLY, 16)


def _as_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data.astype(np.uint8, copy=False).ravel()
    return np.frombuffer(bytes(data), dtype=np.uint8)


def crc8(data) -> int:
    """CRC-8/FLAC of a small buffer (frame headers are <= ~16 bytes)."""
    arr = _as_u8(data)
    crc = 0
    t = _CRC8_TABLE
    for b in arr.tolist():
        crc = int(t[crc ^ b])
    return crc


def crc16(data) -> int:
    """CRC-16/FLAC of one buffer.

    Large buffers are folded row-wise so the hot loop is vectorized numpy
    (single-row Horner would be a per-byte Python loop).
    """
    arr = _as_u8(data)
    n = arr.size
    if n == 0:
        return 0
    if n <= 4096:
        crc = 0
        t = _CRC16_TABLE
        for b in arr.tolist():
            crc = (((crc << 8) & 0xFFFF) ^ int(t[(crc >> 8) ^ b])) & 0xFFFF
        return crc
    # Split into rows, CRC each row in parallel, then GF(2)-combine.
    rows = max(1, int(np.sqrt(n / 64)))
    cols = -(-n // rows)
    padded = np.zeros(rows * cols, dtype=np.uint8)
    padded[rows * cols - n :] = arr  # leading zeros are CRC no-ops
    mat = padded.reshape(rows, cols)
    row_crcs = crc16_rows(mat)
    # combine: total = XOR_j gfmul(row_crc_j, x^(8*cols*(rows-1-j)))
    exps = 8 * cols * np.arange(rows - 1, -1, -1, dtype=np.int64)
    powers = _gf16_pow_x(exps)
    return int(np.bitwise_xor.reduce(_gf16_mul(row_crcs.astype(np.uint32), powers)))


def crc8_rows(mat: np.ndarray) -> np.ndarray:
    """CRC-8 of each row of a (rows, cols) uint8 matrix (left-zero-padded ok)."""
    return _crc_rows(mat, _CRC8_TABLE, 8)


def crc16_rows(mat: np.ndarray) -> np.ndarray:
    """CRC-16 of each row of a (rows, cols) uint8 matrix (left-zero-padded ok)."""
    return _crc_rows(mat, _CRC16_TABLE, 16)


def _crc_rows(mat: np.ndarray, table: np.ndarray, width: int) -> np.ndarray:
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    if mat.ndim != 2:
        raise ValueError("expected a 2-D byte matrix")
    rows, cols = mat.shape
    crc = np.zeros(rows, dtype=np.uint32)
    mask = (1 << width) - 1
    shift = width - 8
    for i in range(cols):
        crc = ((crc << 8) & mask) ^ table[(crc >> shift) ^ mat[:, i]]
    return crc.astype(np.uint16 if width == 16 else np.uint8)


# ---------------------------------------------------------------------------
# GF(2)[x] mod 0x18005 helpers (vectorized) used to combine partial CRC-16s.
# ---------------------------------------------------------------------------

_POLY_FULL = 0x18005  # x^16 + x^15 + x^2 + 1 including the x^16 term


def _gf16_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Carry-less multiply of 16-bit values mod the CRC-16 polynomial."""
    a = a.astype(np.uint32)
    b = b.astype(np.uint32)
    r = np.zeros(np.broadcast(a, b).shape, dtype=np.uint32)
    for k in range(16):
        r ^= (a << np.uint32(k)) * ((b >> np.uint32(k)) & np.uint32(1))
    for k in range(31, 15, -1):
        r ^= ((r >> np.uint32(k)) & np.uint32(1)) * np.uint32(_POLY_FULL << (k - 16))
    return r


_X_POW2: list[int] = []  # x^(2^k) mod poly, scalars


def _ensure_pow_table(levels: int) -> None:
    if not _X_POW2:
        _X_POW2.append(2)  # x^1
    while len(_X_POW2) < levels:
        v = np.uint32(_X_POW2[-1])
        _X_POW2.append(int(_gf16_mul(v, v)))


def _gf16_pow_x(exps: np.ndarray) -> np.ndarray:
    """x^exps mod poly for an int64 exponent array (vectorized square-multiply)."""
    exps = exps.astype(np.int64)
    levels = max(1, int(exps.max()).bit_length()) if exps.size else 1
    _ensure_pow_table(levels)
    acc = np.ones(exps.shape, dtype=np.uint32)
    for k in range(levels):
        bit = ((exps >> k) & 1).astype(bool)
        if bit.any():
            mul = _gf16_mul(acc, np.uint32(_X_POW2[k]))
            acc = np.where(bit, mul, acc)
    return acc
