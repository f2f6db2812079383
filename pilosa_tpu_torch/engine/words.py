"""Packed-word layout constants and host-side (numpy) pack/unpack helpers.

A shard is ``SHARD_WIDTH = 2**20`` columns packed into
``WORDS_PER_SHARD = 32768`` little-endian 32-bit words.  Column ``c`` of a
shard lives at word ``c >> 5``, bit ``c & 31`` (LSB-first within a word),
the same layout ``pilosa_tpu.engine.words`` defines, so planes and
snapshots move between the two packages bit for bit.

On the host words are ``uint32``; on the device the port holds the same
bits in ``int32`` tensors (see :mod:`pilosa_tpu_torch.engine.kernels`).
"""

from __future__ import annotations

import numpy as np

SHARD_WIDTH = 1 << 20

WORD_BITS = 32
WORDS_PER_SHARD = SHARD_WIDTH // WORD_BITS  # 32768

def pack_columns(cols: np.ndarray, n_words: int = WORDS_PER_SHARD) -> np.ndarray:
    """Pack column offsets (within one shard, any order) into uint32 words."""
    words = np.zeros(n_words, dtype=np.uint32)
    if len(cols) == 0:
        return words
    cols = np.asarray(cols, dtype=np.uint64)
    if cols.max() >= n_words * WORD_BITS:
        raise ValueError(
            f"column {cols.max()} out of range for {n_words * WORD_BITS} bits"
        )
    # one byte per column, then packed LSB-first: a bit array's cost, not
    # a scatter's
    bits = np.zeros(n_words * WORD_BITS, np.uint8)
    bits[cols] = 1
    words[:] = np.packbits(bits, bitorder="little").view("<u4")
    return words


def unpack_columns(words: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_columns`: set-bit positions, sorted ascending."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint64)


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= max(n, 1): the padded width of slot lists
    and overlays."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return bucket
