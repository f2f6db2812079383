"""Query programs over a placement's blocks (``pilosa_tpu.parallel.spmd``).

Each program takes a placement (:mod:`pilosa_tpu_torch.parallel.mesh`)
where the reference takes a ``jax.sharding.Mesh``, and blocked inputs
(``placement.place(host)``; a host array or CPU tensor is placed first).
Every popcount is a hand kernel launched per block on the block's device.
The reference's implicit programs let XLA insert the cross-shard
reduction; the ``make_*_psum`` ones spell out a ``psum`` over ICI.  Here
both reduce the same way: per-block results gather onto the placement's
first device and sum there (a 2-D placement's word blocks hold partial
counts, which sum alike).  Over a placement that spans processes
(:class:`~pilosa_tpu_torch.parallel.multiproc.ProcessPlacement`, host
inputs being each process's own rows) the ``psum`` is a real collective:
the local sum is all-reduced over the process group, per-shard outputs
are all-gathered in rank order, and every process returns the same
values.  ``make_ingest_step`` runs per block and needs none.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.engine import bsi as bsik
from pilosa_tpu_torch.engine import kernels
from pilosa_tpu_torch.parallel.mesh import Blocked, gathered

_I32 = torch.int32


def _blocked(placement, x) -> Blocked:
    return x if isinstance(x, Blocked) else placement.place(x)


# -- implicit-reduction programs (inputs already blocked) -------------------


def intersect_count(a: Blocked, b: Blocked) -> torch.Tensor:
    """``Count(Intersect(Row, Row))`` over every shard: an int64 scalar
    on the first device."""
    return gathered(kernels.intersection_count(a, b)).sum(dtype=torch.int64)


def union_count(a: Blocked, b: Blocked) -> torch.Tensor:
    return gathered(kernels.union_count(a, b)).sum(dtype=torch.int64)


def topn(plane: Blocked, filter_words, n: int):
    """TopN over a blocked [n_shards, R, W] plane: ``(counts[n],
    slots[n])`` of :func:`~pilosa_tpu_torch.engine.kernels.top_n`."""
    counts = gathered(kernels.row_counts(plane, filter_words))
    return kernels.top_n(counts.sum(0, dtype=_I32), n)


def bsi_bit_counts(plane: Blocked, filter_words):
    """Per-shard per-bit BSI counts over a blocked [n_shards, depth+2, W]
    plane, gathered: ``(pos[S, depth], neg[S, depth], cnt[S])``; finish
    with ``engine.bsi.combine_sum`` on the host."""
    outs = plane.map(bsik.bit_counts, plane, filter_words)
    return tuple(plane.gather([o[j] for o in outs]) for j in range(3))


# -- explicit per-block programs (the reference's shard_map + psum) ---------


def make_intersect_count_psum(placement, axis: str = "shard"):
    """``Count(Intersect)``: each block reduces its resident shards, then
    the block totals sum on the first device."""

    def run(a, b) -> torch.Tensor:
        a, b = _blocked(placement, a), _blocked(placement, b)
        return a.total(a.map(
            lambda x, y: kernels.intersection_count(x, y).sum(dtype=_I32),
            a, b))

    return run


def make_topn_psum(placement, n: int, axis: str = "shard"):
    """TopN: per-block row popcounts summed over the block's shards, the
    block sums added on the first device, then the top ``n``."""

    def run(plane, filter_words):
        plane = _blocked(placement, plane)
        if filter_words is not None:
            filter_words = _blocked(placement, filter_words)
        counts = plane.total(plane.map(
            lambda p, f: kernels.row_counts(p, f).sum(0, dtype=_I32),
            plane, filter_words))
        return kernels.top_n(counts, n)

    return run


def make_bsi_sum_psum(placement, axis: str = "shard"):
    """Per-bit count vectors summed over every shard (int32: exact below
    2047 full shards per bit): ``(pos[depth], neg[depth], cnt)``; the host
    ``combine_sum`` finishes."""

    def per_block(p, f):
        pos, neg, cnt = bsik.bit_counts(p, f)
        return (pos.sum(0, dtype=_I32), neg.sum(0, dtype=_I32),
                cnt.sum(dtype=_I32))

    def run(plane, filter_words):
        plane = _blocked(placement, plane)
        if filter_words is not None:
            filter_words = _blocked(placement, filter_words)
        outs = plane.map(per_block, plane, filter_words)
        return tuple(plane.total([o[j] for o in outs]) for j in range(3))

    return run


def make_intersect_count_psum2d(placement, shard_axis: str = "shard",
                                words_axis: str = "words"):
    """``Count(Intersect)`` over a ``(shard, words)`` placement: each
    block's partial popcount over its shards' word slice, the partials
    summed on the first device."""
    return make_intersect_count_psum(placement)


def make_topn_psum2d(placement, n: int, shard_axis: str = "shard",
                     words_axis: str = "words"):
    """TopN over a ``(shard, words)`` placement: partial row counts per
    block, summed on the first device, then the top ``n``."""
    return make_topn_psum(placement, n)


def make_ingest_step(placement, axis: str = "shard"):
    """Per-block device mutation: each shard's coalesced ``(word_idx,
    mask)`` updates (``[n_shards, K]``, indices ``>= W`` pad) ORed into
    its resident words, a new blocked ``[n_shards, W]`` tensor."""

    def run(words, word_idx, word_mask) -> Blocked:
        words = _blocked(placement, words)
        word_idx = _blocked(placement, word_idx)
        word_mask = _blocked(placement, word_mask)
        return words.like(words.map(kernels.apply_word_or, words, word_idx,
                                    word_mask))

    return run
