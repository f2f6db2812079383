"""Bitmap kernels over packed words: plain PyTorch versions and routing.

The counterpart of ``pilosa_tpu.engine.kernels`` (boolean algebra, the
whole-tree fold and popcount reductions) plus the routing the JAX
package's ``kernel_tier`` knob did: every public count function sends a
CUDA tensor to its hand-written kernel in
:mod:`pilosa_tpu_torch.engine.cuda_kernels` and a CPU tensor to its
plain version here.  There is no other choice and no
fallback: a CUDA tensor that the kernel refuses raises.  A blocked tensor
(:class:`~pilosa_tpu_torch.parallel.mesh.Blocked`, a plane's shard axis
over a placement's devices) runs each function per block on that block's
device: the boolean algebra through the blocked type's own operators and
torch dispatch, every other function through ``per_block``.

Words are ``int32`` tensors carrying the bits of the reference's
``uint32`` words.  ``>>`` on ``int32`` is arithmetic, so the plain SWAR
popcount splits each word into two 16-bit halves first and masks after
every shift: no intermediate can overflow or carry a sign bit.

Counts are ``int32`` per (shard, row) — exact, a shard is 2^20 bits —
and cross-shard totals finish in int64 on the host past
``SAFE_SHARD_SUM`` shards (:func:`shard_totals`).
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.engine import cuda_kernels
from pilosa_tpu_torch.parallel.mesh import (Blocked, PerBlock, gathered,
                                            per_block, shard_prefix,
                                            words_below)

# ---------------------------------------------------------------------------
# Boolean algebra
# ---------------------------------------------------------------------------


def intersect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_and(a, b)


def union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_or(a, b)


def difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_and(a, torch.bitwise_not(b))


def xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_xor(a, b)


def complement(a: torch.Tensor, exists: torch.Tensor) -> torch.Tensor:
    """``Not(a)`` against an existence bitmap."""
    return torch.bitwise_and(exists, torch.bitwise_not(a))


# ---------------------------------------------------------------------------
# Whole-tree programs (``pilosa_tpu.engine.kernels`` tree opcodes)
# ---------------------------------------------------------------------------
#
# A compound boolean query lowers (``exec.tree``) to a POSTFIX program of
# ``(opcode, arg)`` steps over operand bitmaps: rows gathered from one
# resident plane plus extra bitmaps.  ``Not`` needs no opcode: it lowers
# to ``ANDNOT(exists, x)``.  The reference folds the program inside one
# XLA program; here the fold is eager PyTorch bitwise ops, one launch per
# operator, and the popcount of the result is the hand ``count`` kernel.

TREE_NOP = 0     # padding: no-op
TREE_PUSH = 1    # push rows[arg] (gathered plane rows)
TREE_PUSHX = 2   # push extras[arg] (exists / other-field rows)
TREE_ZERO = 3    # push an all-zero bitmap (empty Union, absent rows)
TREE_AND = 4
TREE_OR = 5
TREE_ANDNOT = 6  # a & ~b (Difference; Not via ANDNOT(exists, x))
TREE_XOR = 7
TREE_SHIFT = 8   # unary: shift the top of the stack by n columns
TREE_LIMIT = 9   # unary: keep the bits ranked [offset, offset + limit)
# the unary ops whose argument is program structure (the shift distance,
# the limit bounds), not an operand index
TREE_STATIC_OPS = (TREE_SHIFT, TREE_LIMIT)


def crosses_blocks(op: int, words) -> bool:
    """Whether static op ``op`` over ``words`` reads other blocks' bits,
    so it cannot run inside a per-block program: ``Limit``'s ranks are
    global under any placement, and a ``Shift`` carries bits across the
    word blocks of a 2-D one."""
    if not isinstance(words, Blocked):
        return False
    return op == TREE_LIMIT or (op == TREE_SHIFT and words.words_split())

# postfix evaluation of a depth-d tree needs ~d+1 live values; the
# planner refuses deeper trees
TREE_STACK_DEPTH = 8

_TREE_BIN = {TREE_AND: intersect, TREE_OR: union,
             TREE_ANDNOT: difference, TREE_XOR: xor}


def tree_fold(rows, skeleton, row_args, extras=None, extra_args=None,
              zero: torch.Tensor | None = None) -> torch.Tensor:
    """Fold ONE postfix boolean program over operand bitmaps.

    ``rows``: int32[G, ..., W] gathered plane rows, or a callable
    ``rows(arg) -> int32[..., W]`` that reads one row per push (the solo
    path reads straight off the plane); ``extras``: a sequence of
    int32[..., W] bitmaps indexed by the ``TREE_PUSHX`` args;
    ``skeleton``: the opcodes (binary ops pop two, push one), a static op
    as ``(opcode, arg)``;
    ``row_args`` / ``extra_args``: the operand index of each ``TREE_PUSH``
    / ``TREE_PUSHX``, in order; ``zero``: the ``TREE_ZERO`` bitmap
    (defaults to zeros like ``rows[0]``).  Returns the final bitmap."""
    fetch = rows if callable(rows) else (lambda a: rows[a])
    stack: list = []
    ri = xi = 0
    for entry in skeleton:
        op, sarg = entry if isinstance(entry, tuple) else (entry, None)
        if op == TREE_PUSH:
            stack.append(fetch(row_args[ri]))
            ri += 1
        elif op == TREE_PUSHX:
            stack.append(extras[extra_args[xi]])
            xi += 1
        elif op == TREE_ZERO:
            stack.append(torch.zeros_like(rows[0]) if zero is None
                         else zero)
        elif op == TREE_NOP:
            continue
        elif op == TREE_SHIFT:
            stack.append(shift(stack.pop(), sarg))
        elif op == TREE_LIMIT:
            stack.append(rank_limit(stack.pop(), sarg[0], sarg[1]))
        elif op in _TREE_BIN:
            b = stack.pop()
            a = stack.pop()
            stack.append(_TREE_BIN[op](a, b))
        else:
            raise ValueError(f"tree opcode {op!r} is not supported by "
                             "this port")
    return stack[-1]


# ---------------------------------------------------------------------------
# Shift, Limit and row unions (XLA in the reference, plain PyTorch here)
# ---------------------------------------------------------------------------


@per_block
def union_rows(plane: torch.Tensor, row_mask) -> torch.Tensor:
    """OR of the rows of ``plane`` int32[S, R, W] that the host boolean
    ``row_mask`` [R] selects -> int32[S, W] (``UnionRows``): one in-place
    OR per selected row."""
    rows = np.flatnonzero(np.asarray(row_mask, bool))
    if not len(rows):
        return plane.new_zeros(plane.shape[0], plane.shape[2])
    acc = plane[:, int(rows[0])].clone()
    for r in rows[1:]:
        acc.bitwise_or_(plane[:, int(r)])
    return acc


def shift(words: torch.Tensor, n: int = 1) -> torch.Tensor:
    """Every bit's column moved up by ``n`` within its shard; bits that
    cross the shard's end drop (``Shift(row, n)``).  Per block on a 1-D
    placement (a shard never leaves its block); over word blocks each
    block first takes the words below its range that the shift carries
    into it (:func:`~pilosa_tpu_torch.parallel.mesh.words_below`; ``n``
    may pass a word block's width)."""
    if n < 0:
        raise ValueError("shift n must be non-negative")
    if not (isinstance(words, Blocked) and words.words_split()):
        return _shift_words(words, n)
    word_n, bit_n = divmod(n, 32)
    k = word_n + (1 if bit_n else 0)
    if not k:
        return words
    return words.like(words.map(_shift_carried, words,
                                words_below(words, k), n))


def _shift_carried(words: torch.Tensor, below: torch.Tensor,
                   n: int) -> torch.Tensor:
    """One word block shifted with the ``below`` words carried in."""
    k = below.shape[-1]
    return _shift_words(torch.cat([below, words], -1), n)[..., k:]


@per_block
def _shift_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """Bits are LSB first in a word, so a shift is a left shift with a
    carry between words; the carry is a right shift, masked after it
    (``>>`` on int32 is arithmetic)."""
    word_n, bit_n = divmod(n, 32)
    w = words.shape[-1]
    if word_n:
        words = torch.cat([words.new_zeros(words.shape[:-1] + (word_n,)),
                           words[..., :w - word_n]], dim=-1)
    if bit_n:
        carry = torch.cat([words.new_zeros(words.shape[:-1] + (1,)),
                           words[..., :-1]], dim=-1)
        words = (words << bit_n) | ((carry >> (32 - bit_n))
                                    & ((1 << bit_n) - 1))
    return words


def column_bits(plane: torch.Tensor, word_idx: torch.Tensor,
                bit_idx: torch.Tensor) -> torch.Tensor:
    """Membership of k columns in every row (``Extract`` of a set-like
    field): ``plane`` int32[S, R, W], ``word_idx`` [k] (each column's
    word within its shard), ``bit_idx`` [k] -> int32[S, R, k] of 0/1.  One
    gather per column word; the mask follows the shift because ``>>`` on
    int32 is arithmetic."""
    g = plane[:, :, word_idx.long()]
    return (g >> bit_idx.to(plane.dtype)[None, None, :]) & 1


def column_bits_grouped(plane: torch.Tensor, word_idx: torch.Tensor,
                        bit_idx: torch.Tensor,
                        shard_idx: torch.Tensor) -> torch.Tensor:
    """Per-shard column probes (``Extract`` of a BSI field: every selected
    column's exists, sign and magnitude bits in one gather): row ``i`` of
    ``word_idx`` / ``bit_idx`` [n, k] names columns of shard
    ``shard_idx[i]`` of ``plane`` int32[S, R, W] -> int32[n, R, k] of 0/1.
    Only the shards named are read."""
    rows = torch.arange(plane.shape[1], device=plane.device)
    g = plane[shard_idx.long()[:, None, None], rows[None, :, None],
              word_idx.long()[:, None, :]]
    return (g >> bit_idx.to(plane.dtype)[:, None, :]) & 1


_UNBOUNDED = 1 << 62


def rank_limit(words: torch.Tensor, offset: int, limit: int) -> torch.Tensor:
    """Keep only the bits whose global rank falls in ``[offset, offset +
    limit)`` (``limit < 0``: unbounded): ``Limit(x, limit=, offset=)``.
    ``words`` int32[S, W] in global column order (shard axis in serving
    order, words ascending, bits LSB first), over any number of shards.

    Each shard's bits rank from its base, the int64 exclusive prefix of
    the per-shard ``count`` (over a placement's blocks in serving order,
    :func:`~pilosa_tpu_torch.parallel.mesh.shard_prefix`), so blocks rank
    apart and ranks are global.  Bounds past ``2^62`` (no index holds
    that many bits) are clamped there, so the int64 arithmetic cannot
    overflow."""
    offset = min(offset, _UNBOUNDED)
    end = _UNBOUNDED if limit < 0 else min(offset + limit, _UNBOUNDED)
    counts = count(words)
    # on a 2-D placement each block's counts are over its own word block,
    # the span its base ranks from
    own = PerBlock(counts.blocks) if isinstance(counts, Blocked) else counts
    return _rank_window(words, shard_prefix(counts), own, offset, end)


@per_block
def _rank_window(words: torch.Tensor, base: torch.Tensor,
                 counts: torch.Tensor, offset: int,
                 end: int) -> torch.Tensor:
    """The bits of ``words`` int32[S, W] ranked in ``[offset, end)`` when
    shard ``s`` holds ``counts[s]`` bits and its first has rank
    ``base[s]`` (int64[S] on the device).  Each shard's window of its own
    ranks is clamped to ``[0, counts[s]]`` in int64, so it fits int32 at
    any global rank.  A shard whose window holds all its bits keeps its
    words and one whose window is empty keeps none; only the shards
    holding ranks ``offset`` and ``end - 1`` (at most two) are ranked
    word by word (:func:`_rank_rows`), found by a search over the
    inclusive prefix on the device (no host sync)."""
    s = words.shape[0]
    if not words.numel():
        return words.clone()
    cnt = counts.to(torch.int64)
    lo = torch.minimum((offset - base).clamp(min=0), cnt)
    hi = torch.minimum((end - base).clamp(min=0), cnt)
    whole = (lo == 0) & (hi == cnt)
    out = torch.where(whole[:, None], words, torch.zeros_like(words))
    probe = torch.tensor([offset, end - 1], dtype=torch.int64,
                         device=words.device)
    edge = torch.searchsorted(base + cnt, probe,
                              right=True).clamp(max=s - 1)
    part = _rank_rows(words.index_select(0, edge),
                      lo[edge].to(torch.int32)[:, None],
                      hi[edge].to(torch.int32)[:, None])
    # both edges may name one shard: each row is its exact window, so the
    # copies agree
    return out.index_copy_(0, edge, part)


def _rank_rows(words: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """The bits of each row of ``words`` int32[N, W] whose rank within
    the row lies in ``[lo, hi)`` (int32[N, 1]).  The reference expands
    every word to 32 ranked lanes; here a word wholly inside the window
    keeps all its bits and one wholly outside keeps none, and only the two
    words per row holding its first and last rank in the window are
    expanded, found by a search over the row's inclusive prefix sum."""
    w = words.shape[1]
    pc = popcount(words)
    cum = torch.cumsum(pc, 1, dtype=torch.int32)         # inclusive
    start = cum - pc
    out = torch.where((start >= lo) & (cum <= hi), words,
                      torch.zeros_like(words))
    probe = torch.cat([lo, (hi - 1).clamp(min=0)], 1)     # [N, 2]
    idx = torch.searchsorted(cum, probe, right=True).clamp(max=w - 1)
    lanes = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words.gather(1, idx)[..., None] >> lanes) & 1  # [N, 2, 32]
    rank = (start.gather(1, idx)[..., None]
            + torch.cumsum(bits, -1, dtype=torch.int32) - bits)
    keep = (bits != 0) & (rank >= lo[..., None]) & (rank < hi[..., None])
    packed = torch.where(keep, torch.ones_like(bits) << lanes,
                         torch.zeros_like(bits)).sum(-1, dtype=torch.int64)
    # both probes may name one word: each computes its exact value, so the
    # writes agree
    return out.scatter_(1, idx, packed.to(torch.int32))


# ---------------------------------------------------------------------------
# Plain popcount reductions (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

# plain reductions walk the leading axis in chunks of this many elements
# so their SWAR temporaries stay a few hundred MB at any plane size; on
# the CPU in chunks of a few MB, whose temporaries stay in cache and are
# reused instead of mapped afresh (a [2050, 32768] count took 5.5 s in
# 2^26-word chunks and 1.1 s in 2^20-word ones, on one thread)
_PLAIN_CHUNK_WORDS = 1 << 26
_PLAIN_CPU_CHUNK_WORDS = 1 << 20


def _popcount16(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits per 32-bit word -> int32, SWAR on int32 lanes."""
    return (_popcount16(words & 0xFFFF)
            + _popcount16((words >> 16) & 0xFFFF))


def _chunked(fn, *tensors: torch.Tensor) -> torch.Tensor:
    """``fn`` over leading-axis chunks of ``tensors``, concatenated."""
    lead = tensors[0].shape[0]
    per = max(1, tensors[0][0].numel()) if lead else 1
    chunk = (_PLAIN_CPU_CHUNK_WORDS if tensors[0].device.type == "cpu"
             else _PLAIN_CHUNK_WORDS)
    step = max(1, chunk // per)
    if lead <= step:
        return fn(*tensors)
    return torch.cat([fn(*(t[i:i + step] for t in tensors))
                      for i in range(0, lead, step)])


def count_plain(words: torch.Tensor) -> torch.Tensor:
    """int32[..., W] -> int32[...] set bits over the trailing axis."""
    return _chunked(lambda w: popcount(w).sum(-1, dtype=torch.int32), words)


def row_counts_plain(plane: torch.Tensor,
                     filter_words: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """int32[S, R, W] (& int32[S, W]) -> int32[S, R]."""
    if filter_words is None:
        return count_plain(plane)
    return _chunked(lambda p, f: count_plain(p & f[:, None, :]),
                    plane, filter_words)


def selected_row_counts_plain(plane: torch.Tensor,
                              row_idx: torch.Tensor) -> torch.Tensor:
    """int32[S, R, W] + int32[N] -> int32[S, N] (slots may repeat)."""
    idx = row_idx.to(device=plane.device, dtype=torch.int64)
    return _chunked(lambda p: count_plain(p.index_select(1, idx)), plane)


def intersect_count_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32[S, W] x2 -> int32[S] = popcount(a & b)."""
    return _chunked(lambda x, y: count_plain(x & y), a, b)


# ---------------------------------------------------------------------------
# Routed entry points
# ---------------------------------------------------------------------------


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


@per_block(reduces_words=True)
def count(words: torch.Tensor) -> torch.Tensor:
    """Total set bits over the trailing word axis -> int32[...]."""
    if not _on_cuda(words):
        return count_plain(words)
    lead = words.shape[:-1]
    flat = words.reshape(-1, words.shape[-1]).contiguous()
    return cuda_kernels.count(flat).reshape(lead)


@per_block(reduces_words=True)
def row_counts(plane: torch.Tensor,
               filter_words: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row popcounts, optionally ANDed with a per-shard filter:
    int32[S, R, W] (& int32[S, W]) -> int32[S, R]."""
    if not _on_cuda(plane):
        return row_counts_plain(plane, filter_words)
    return cuda_kernels.row_counts(plane, filter_words)


@per_block(reduces_words=True)
def selected_row_counts(plane: torch.Tensor,
                        row_idx: torch.Tensor) -> torch.Tensor:
    """Popcounts of the selected rows: int32[S, R, W] + int32[N] ->
    int32[S, N]."""
    if not _on_cuda(plane):
        return selected_row_counts_plain(plane, row_idx)
    return cuda_kernels.selected_row_counts(plane, row_idx)


@per_block(reduces_words=True)
def intersect_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Count(Intersect) per shard in one pass: int32[S, W] x2 -> int32[S]."""
    if not _on_cuda(a):
        return intersect_count_plain(a, b)
    return cuda_kernels.intersect_count(a, b)


def intersection_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Count(Intersect(a, b))`` per shard without materializing the
    intersection: the ``intersect_count`` kernel (its plain version on the
    CPU), int32[S, W] x2 -> int32[S]."""
    return intersect_count(a, b)


def union_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Count(Union(a, b))`` per shard: int32[S, W] x2 -> int32[S]."""
    return count(union(a, b))


def top_n(counts: torch.Tensor, n: int):
    """``(values int32[k], slots int64[k])`` of the ``k = min(n, R)``
    largest of ``counts`` int32[R], ties in ascending slot order as
    ``lax.top_k`` gives them (``torch.topk`` sets no order among equal
    values, so the counts are ranked as unique int64 keys ``count * R +
    (R - 1 - slot)``).  Zero counts may appear; callers drop them."""
    r = counts.numel()
    k = min(int(n), r)
    slot = torch.arange(r, dtype=torch.int64, device=counts.device)
    key = counts.to(torch.int64) * r + (r - 1 - slot)
    top = torch.topk(key, k, sorted=True).values
    return (top // r).to(torch.int32), r - 1 - top % r


def apply_word_or(words: torch.Tensor, word_idx: torch.Tensor,
                  word_mask: torch.Tensor) -> torch.Tensor:
    """A copy of ``words`` [..., W] with ``words[..., idx] |= mask``: the
    device half of an ingest step.  ``word_idx`` / ``word_mask`` [..., K]
    broadcast against the leading axes; the host coalesces positions to
    unique word indices per row first, and indices ``>= W`` are padding
    that drops, as the reference's ``mode="drop"`` scatter drops them."""
    w = words.shape[-1]
    lead = words.shape[:-1]
    out = words.clone()
    flat = out.reshape(-1, w)
    k = word_idx.shape[-1]
    idx = word_idx.to(words.device, torch.int64).expand(lead + (k,))
    mask = word_mask.to(words.device).to(words.dtype).expand(lead + (k,))
    idx, mask = idx.reshape(-1, k), mask.reshape(-1, k)
    rows = torch.arange(flat.shape[0], device=words.device)[:, None]
    keep = idx < w
    r, c = rows.expand(-1, k)[keep], idx[keep]
    flat[r, c] = flat[r, c] | mask[keep]
    return out


# ---------------------------------------------------------------------------
# Host-finished reductions
# ---------------------------------------------------------------------------

# int32 per-shard counts summed over more shards than this could overflow
# int32 (2047 full shards of 2^20 bits ~ 2^31)
SAFE_SHARD_SUM = 2047


def shard_totals(counts: torch.Tensor) -> np.ndarray:
    """Reduce int32 per-shard counts over axis 0 exactly -> np.int64[...]:
    device sums of chunks that cannot overflow, finished in int64 on the
    host.  Blocked counts gather onto the first device first."""
    counts = gathered(counts)
    parts = [counts[i:i + SAFE_SHARD_SUM].sum(0, dtype=torch.int32)
             for i in range(0, max(1, counts.shape[0]), SAFE_SHARD_SUM)]
    return torch.stack(parts).cpu().numpy().astype(np.int64).sum(axis=0)
